"""colmap_tpu_torch's global-SfM slice against colmap_tpu, on the CPU.

The same inputs, made from a numpy seed, go through colmap_tpu (JAX in
float64, as the suite runs it) and the port (its plain versions, float64 on
the CPU): union-find, the pose graph, K21-K23's and K39's plain versions
and the solvers they carry (rotation averaging's CG with and without
gravity projectors, a global-positioning round whose CG freezes before its
last step, view-graph calibration), clustering and pruning, and the global mapper through the
port's CLI. Both packages run the same float64 algorithm in another
summation order, so the solvers agree to far below their convergence
tolerances; each tolerance is stated in its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators import global_positioning as jgp
from colmap_tpu.estimators import rotation_averaging as jra
from colmap_tpu.estimators import view_graph_calibration as jvgc
from colmap_tpu.scene import database as jdb
from colmap_tpu.scene import pose_graph as jpg
from colmap_tpu.scene import reconstruction_clustering as jclu
from colmap_tpu.scene import synthetic as jsyn
from colmap_tpu.sfm import global_mapper as jgm
from colmap_tpu.sfm import global_pipeline as jgpipe
from colmap_tpu.utils import native as jnative
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.estimators import global_positioning as tgp
from colmap_tpu_torch.estimators import rotation_averaging as tra
from colmap_tpu_torch.estimators import view_graph_calibration as tvgc
from colmap_tpu_torch.estimators.alignment import compare_reconstructions
from colmap_tpu_torch.geometry import rotation as trot
from colmap_tpu_torch.geometry.essential import essential_from_pose
from colmap_tpu_torch.kernels import global_cases as C
from colmap_tpu_torch.kernels import global_sfm as G
from colmap_tpu_torch.scene import database as tdb
from colmap_tpu_torch.scene import pose_graph as tpg
from colmap_tpu_torch.scene import reconstruction_clustering as tclu
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.scene.reconstruction_io import read_model
from colmap_tpu_torch.sfm import global_pipeline as tgpipe
from colmap_tpu_torch.utils.union_find import union_find_labels

# The reference's end-to-end thresholds (BASELINE.md:13).
MAX_ROT_DEG, MAX_CENTER = 1e-2, 1e-4


def _partition(labels):
    """Labels renamed by first appearance: equal iff the partitions are."""
    first = {}
    return np.array([first.setdefault(int(v), len(first)) for v in labels])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_find_partition_matches(seed):
    rng = np.random.default_rng(seed)
    n = 500
    m = [50, 300, 700][seed]
    a, b = rng.integers(0, n, m), rng.integers(0, n, m)
    got = union_find_labels(n, a, b)
    assert np.array_equal(_partition(got), _partition(jnative.union_find_labels(n, a, b)))
    assert np.all(got <= np.arange(n)) and np.all(got[got] == got)


def _verify_db(path, db_cls, syn, has_rel_pose, seed=3, num_points3D=120, **kw):
    db = db_cls(path)
    opts = syn.SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=8, num_points3D=num_points3D,
                                       camera_has_prior_focal_length=True,
                                       two_view_geometry_has_relative_pose=has_rel_pose, **kw)
    gt = syn.synthesize_dataset(opts, db, rng=np.random.default_rng(seed))
    db.close()
    return gt


@pytest.mark.parametrize("has_rel_pose", [True, False], ids=["stored", "decomposed"])
def test_pose_graph_load_matches(tmp_path, has_rel_pose):
    """The same edges and relative poses (1e-9: the decomposition of E is
    the same float64 arithmetic), and the same largest component."""
    path = str(tmp_path / "db.db")
    _verify_db(path, tdb.Database, tsyn, has_rel_pose)
    jg = jpg.PoseGraph.load(jdb.Database(path, must_exist=True))
    tg = tpg.PoseGraph.load(tdb.Database(path, must_exist=True), device="cpu")
    assert sorted(jg.edges) == sorted(tg.edges) and len(tg) == 28
    jr, tr = jg.rel_poses(), tg.rel_poses()
    for pid in jr:
        q1, q2 = np.asarray(jr[pid].quat), tr[pid].quat
        assert min(np.abs(q1 - q2).max(), np.abs(q1 + q2).max()) < 1e-9
        assert np.abs(np.asarray(jr[pid].t) - tr[pid].t).max() < 1e-9
    # Drop one frame's edges but one: the component keeps all 8 images.
    sub_j, sub_t = jg.largest_connected_component(), tg.largest_connected_component()
    assert sub_j.image_ids() == sub_t.image_ids() == list(range(1, 9))


def _ra_inputs(kind):
    """The three cases of tests/test_global_mapper.py: exact, 10% outliers,
    gravity-stratified with 2° noise."""
    rng = np.random.default_rng({"exact": 0, "outliers": 1, "gravity": 7}[kind])
    n = {"exact": 20, "outliers": 25, "gravity": 20}[kind]
    chords = {"exact": 2, "outliers": 4, "gravity": 3}[kind]
    gt = C.random_quats(rng, n)
    gravity = C.gravity_of(gt) if kind == "gravity" else None
    edges = [(i, (i + 1) % n) for i in range(n)]
    for _ in range(chords * n):
        i, j = rng.choice(n, 2, replace=False)
        edges.append((int(i), int(j)))
    rels = []
    for k, (i, j) in enumerate(edges):
        q = tra._qmul(gt[j], gt[i] * np.array([1.0, -1, -1, -1]))
        if kind == "outliers" and k % 10 == 9:
            q = C.random_quats(rng, 1)[0]
        elif kind == "gravity":
            axis = rng.standard_normal(3)
            axis /= np.linalg.norm(axis)
            ang = np.deg2rad(rng.normal(0, 2.0))
            q = tra._qmul(np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis]), q)
            q /= np.linalg.norm(q)
        rels.append(q)
    return gt, n, np.asarray(edges), np.asarray(rels), gravity


@pytest.mark.parametrize("gravity", [False, True], ids=["free", "gravity"])
@pytest.mark.parametrize("use_l1", [True, False], ids=["l1", "geman_mcclure"])
def test_rotation_averaging_plain_entries_match(use_l1, gravity):
    """K21's plain edge pass and CG against colmap_tpu's _edge_residuals and
    _solve_tangent_cg (1e-9 of each output's scale), and the update."""
    gt, n, edges, rels, grav = _ra_inputs("gravity")
    rng = np.random.default_rng(11)
    quats = C.random_quats(rng, n)
    free = np.ones(n)
    free[0] = 0.0
    P = None
    if gravity:
        P = np.tile(np.eye(3), (n, 1, 1))
        P[::2] = np.outer([0.0, 1, 0], [0.0, 1, 0])
    graph = G.ra_graph(n, torch.as_tensor(edges), torch.as_tensor(rels), torch.as_tensor(free),
                       None if P is None else torch.as_tensor(P))
    sigma = np.deg2rad(5.0)
    step = G.ra_edge_pass(graph, torch.as_tensor(quats), use_l1, sigma)
    r = jra._edge_residuals(jnp.asarray(quats), jnp.asarray(edges), jnp.asarray(rels))
    tr = G.edge_residuals(torch.as_tensor(quats), graph.edges, graph.rel_quats)
    assert np.abs(tr.numpy() - np.asarray(r)).max() < 1e-12
    rn = np.linalg.norm(np.asarray(r), axis=1)
    assert abs(float(step.cost) - rn.sum()) < 1e-9 * rn.sum()
    from colmap_tpu.geometry import rotation as jrot

    qj = jnp.asarray(quats)[edges[:, 1]]
    r_world = jrot.quat_rotate(jrot.quat_conjugate(jrot.quat_normalize(qj)), r)
    w = 1.0 / np.maximum(rn, 1e-5) if use_l1 else sigma ** 2 / (rn ** 2 + sigma ** 2) ** 2
    assert np.abs(step.ew[:, 3].numpy() - w).max() < 1e-9 * w.max()
    want = np.asarray(jra._solve_tangent_cg(jnp.asarray(edges), r_world, jnp.asarray(w), n,
                                            jnp.asarray(free), 50,
                                            proj=None if P is None else jnp.asarray(P)))
    got = tra.solve_tangent_cg(graph, step, 50).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
    delta = 0.1 * rng.standard_normal((n, 3))
    upd = jrot.quat_normalize(jrot.quat_multiply(jnp.asarray(quats), jra._quat_exp(delta)))
    assert np.abs(G.ra_update(torch.as_tensor(quats), torch.as_tensor(delta)).numpy()
                  - np.asarray(upd)).max() < 1e-12


@pytest.mark.parametrize("kind", ["exact", "outliers", "gravity"])
def test_estimate_rotations_matches(kind):
    """The port's estimate_rotations gives colmap_tpu's rotations within
    1e-8 rad; in the stratified case R g_world = g_cam holds to 1e-9."""
    gt, n, edges, rels, grav = _ra_inputs(kind)
    want = jra.estimate_rotations(n, edges, rels, gravity_cam=grav)
    got = tra.estimate_rotations(n, edges, rels, gravity_cam=grav, device="cpu")
    want = np.asarray(want)
    # The angle between unit quaternions q and ±q' is 2|q ∓ q'| to first order.
    diff = np.minimum(np.linalg.norm(got - want, axis=1), np.linalg.norm(got + want, axis=1))
    assert 2 * diff.max() < 1e-8
    if kind == "gravity":
        pred = C.quat_rotate(got, np.tile([0.0, 1.0, 0.0], (n, 1)))
        assert np.abs(pred - grav).max() < 1e-9
    else:
        assert np.median(C.rotation_errors_deg(got, gt)) < 0.5


def test_solve_global_positioning_matches():
    """colmap_tpu's case (tests/test_global_mapper.py:100-124): the same
    centres and points within 1e-6 of the scene scale (5), from the same
    numpy initialisation, and both within its bounds of the truth."""
    rng = np.random.default_rng(2)
    n_cams, n_pts = 12, 80
    centers_gt = 5.0 * rng.standard_normal((n_cams, 3))
    points_gt = rng.standard_normal((n_pts, 3))
    obs_cam, obs_point, dirs = [], [], []
    for p in range(n_pts):
        for c in rng.choice(n_cams, 6, replace=False):
            d = points_gt[p] - centers_gt[c]
            dirs.append(d / np.linalg.norm(d))
            obs_cam.append(c)
            obs_point.append(p)
    args = (n_cams, n_pts, np.asarray(obs_cam), np.asarray(obs_point), np.asarray(dirs))
    jc, jp = jgp.solve_global_positioning(*args)
    stats = {}
    tc, tp = tgp.solve_global_positioning(*args, device="cpu", stats=stats)
    assert np.abs(tc - np.asarray(jc)).max() < 1e-6 * 5.0
    assert np.abs(tp - np.asarray(jp)).max() < 1e-6 * 5.0
    assert np.linalg.norm(C.similarity_aligned(tc, centers_gt) - centers_gt, axis=1).max() < 5e-3
    assert stats["irls_iterations"] >= 1


def test_irls_round_with_the_freeze_rule_matches():
    """One IRLS round of the port (K22's and K39's plain versions in
    _irls_round) against colmap_tpu's _irls_solve on a smaller case of the
    same kind (6 cameras, 60 points seen 5 times, the start 0.1 off the
    truth: a round whose result moves less than 1e-10 under a 1e-15 change
    of its input, so the two summation orders may be held to 1e-9 of the
    scene scale) and its cost; with 100 CG steps on 6 x 3 unknowns the
    freeze rule fires before the last step."""
    rng = np.random.default_rng(2)
    n_cams, n_pts = 6, 60
    centers_gt = 5.0 * rng.standard_normal((n_cams, 3))
    points_gt = rng.standard_normal((n_pts, 3))
    obs_cam, obs_point, dirs = [], [], []
    for p in range(n_pts):
        for c in rng.choice(n_cams, 5, replace=False):
            d = points_gt[p] - centers_gt[c]
            dirs.append(d / np.linalg.norm(d))
            obs_cam.append(c)
            obs_point.append(p)
    obs_cam, obs_point, dirs = np.asarray(obs_cam), np.asarray(obs_point), np.asarray(dirs)
    c0 = centers_gt + 0.1 * rng.standard_normal((n_cams, 3))
    X0 = points_gt + 0.1 * rng.standard_normal((n_pts, 3))
    counts = np.bincount(obs_cam, minlength=n_cams)
    a = int(np.nonzero(obs_cam == int(np.argmax(counts)))[0][0])
    opts = jgp.GlobalPositioningOptions()
    (jc, jx), jcost = jgp._irls_solve(
        jnp.asarray(dirs), jnp.asarray(obs_cam, dtype=jnp.int32),
        jnp.asarray(obs_point, dtype=jnp.int32), jnp.ones(len(dirs)),
        (jnp.asarray(c0), jnp.asarray(X0)),
        (jnp.asarray(int(obs_cam[a])), jnp.asarray(int(obs_point[a])), jnp.asarray(dirs[a])),
        n_cams, n_pts, opts)
    t = torch.as_tensor
    prob = G.gp_problem(t(dirs), t(obs_cam), t(obs_point), torch.ones(len(dirs),
                                                                      dtype=torch.float64),
                        a, opts.anchor_weight, n_cams, n_pts, opts.huber_scale)
    (tc, tx), tcost = tgp._irls_round(prob, t(c0), t(X0), opts.cg_iterations, G.PLAIN)
    assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-9 * 5.0
    assert np.abs(tx.numpy() - np.asarray(jx)).max() < 1e-9 * 5.0
    assert abs(float(tcost) - float(jcost)) <= 1e-12 * float(jcost)
    sys = G.gp_setup_plain(prob, t(c0), t(X0))
    st = G.cg_setup_plain(G.CG_POSITIONING, sys.b, sys.diag_c, prob.eps_rel)
    frozen_at = None
    for k in range(opts.cg_iterations):
        if frozen_at is None and not bool(st.scal[0] > 1e-12 * st.scal[1]):
            frozen_at = k
        st = G.cg_step_plain(G.CG_POSITIONING, st,
                             G.gp_schur_matvec_plain(prob, sys, st.p))
    assert frozen_at is not None and frozen_at < opts.cg_iterations - 1


def _jax_vgc_loss(f0, pp, Fs, e1, e2):
    """colmap_tpu's loss (view_graph_calibration.py:58-74), rebuilt here:
    the module keeps it inside calibrate_view_graph."""

    def K_of(x, idx):
        f = f0[idx] * jnp.exp(x[idx])
        z, o = jnp.zeros_like(f), jnp.ones_like(f)
        return jnp.stack([f, z, pp[idx, 0], z, f, pp[idx, 1], z, z, o], -1).reshape(-1, 3, 3)

    def loss(x):
        E = jnp.swapaxes(K_of(x, e2), -1, -2) @ Fs @ K_of(x, e1)
        s = jnp.linalg.svd(E, compute_uv=False)
        res = (s[:, 0] - s[:, 1]) / jnp.maximum(s[:, 0] + s[:, 1], 1e-12)
        return jnp.sum(res ** 2)

    return jax.value_and_grad(loss)


def _vgc_case():
    """tests/test_aux_estimators.py:67-93 with the port's essential_from_pose."""
    rng = np.random.default_rng(0)
    true_focals = {1: 800.0, 2: 1100.0, 3: 950.0}
    pps = {1: (400, 300), 2: (500, 400), 3: (450, 350)}
    edges = []
    for (a, b) in [(1, 2), (2, 3), (1, 3), (1, 2), (2, 3)]:
        q = trot.quat_from_axis_angle(torch.as_tensor(rng.standard_normal(3)),
                                      rng.uniform(0.2, 0.6))
        t = rng.standard_normal(3)
        E = essential_from_pose(q, torch.as_tensor(t / np.linalg.norm(t))).numpy()
        Ka = np.array([[true_focals[a], 0, pps[a][0]], [0, true_focals[a], pps[a][1]], [0, 0, 1]])
        Kb = np.array([[true_focals[b], 0, pps[b][0]], [0, true_focals[b], pps[b][1]], [0, 0, 1]])
        edges.append((a, b, np.linalg.inv(Kb).T @ E @ np.linalg.inv(Ka)))
    return true_focals, {1: 650.0, 2: 1300.0, 3: 1050.0}, pps, edges


def test_view_graph_calibration_matches():
    """K23's plain loss and gradient against jax.value_and_grad at three
    points (1e-9 relative), and the optimised focals (1e-6 relative)."""
    true_focals, priors, pps, edges = _vgc_case()
    ids = [1, 2, 3]
    f0 = np.array([priors[c] for c in ids])
    pp = np.array([pps[c] for c in ids], dtype=np.float64)
    e1 = np.array([a - 1 for a, _, _ in edges])
    e2 = np.array([b - 1 for _, b, _ in edges])
    Fs = np.stack([F for _, _, F in edges])
    vg = _jax_vgc_loss(jnp.asarray(f0), jnp.asarray(pp), jnp.asarray(Fs), jnp.asarray(e1),
                       jnp.asarray(e2))
    graph = G.vgc_graph(*(torch.as_tensor(a) for a in (Fs, e1, e2, f0, pp)))
    for x in (np.zeros(3), np.array([0.2, -0.15, -0.1]), np.array([-0.3, 0.25, 0.05])):
        want_l, want_g = vg(jnp.asarray(x))
        loss, grad = G.vgc_loss_grad(graph, torch.as_tensor(x))
        assert abs(float(loss) - float(want_l)) <= 1e-9 * float(want_l)
        assert np.abs(grad.numpy() - np.asarray(want_g)).max() <= 1e-9 * np.abs(want_g).max()
    want = jvgc.calibrate_view_graph(ids, priors, pps, edges)
    got = tvgc.calibrate_view_graph(ids, priors, pps, edges, device="cpu")
    for c in ids:
        assert abs(got[c] - want[c]) <= 1e-6 * want[c]
        assert abs(got[c] - true_focals[c]) < 0.05 * true_focals[c]


def test_clustering_and_pruning_match():
    """On one reconstruction carried across by convert_reconstruction: the
    same clusters, the same split and the same pruned frames. Frames 7 and
    8 keep only a few points with frames 1-6, so they fall out."""
    recon = jsyn.synthesize_dataset(jsyn.SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=8, num_points3D=150), rng=np.random.default_rng(4))
    weak = {i for i, img in recon.images.items() if img.frame_id in (7, 8)}
    for k, pid in enumerate(sorted(recon.points3D)):
        track = recon.points3D[pid].track
        if k % 12 and any(el.image_id in weak for el in track):
            for el in [el for el in track if el.image_id in weak]:
                recon.delete_observation(el.image_id, el.point2D_idx)
    port = convert.convert_reconstruction(recon)
    want = jclu.cluster_reconstruction_frames(recon)
    assert tclu.cluster_reconstruction_frames(port) == want
    assert set(want.values()) == {0, -1}
    split_j = jclu.split_reconstruction_into_clusters(recon)
    split_t = tclu.split_reconstruction_into_clusters(port)
    assert [s.num_reg_frames() for s in split_t] == [s.num_reg_frames() for s in split_j]
    assert [s.num_points3D() for s in split_t] == [s.num_points3D() for s in split_j]
    assert sorted(tclu.prune_weakly_connected_frames(port)) == sorted(
        jclu.prune_weakly_connected_frames(recon))
    assert port.reg_frame_ids() == recon.reg_frame_ids()
    assert port.num_points3D() == recon.num_points3D()


def test_global_mapper_command_on_the_verify_scene(tmp_path):
    """Decomposed-E path (no stored relative poses): 8/8 frames within the
    reference's 1e-2 deg and 1e-4 units, with time in every phase."""
    path = str(tmp_path / "db.db")
    gt = _verify_db(path, tdb.Database, tsyn, False)
    pipe = tcli.main(["global_mapper", "--database_path", path, "--output_path",
                      str(tmp_path / "out"), "--device", "cpu", "--quiet"])
    cmp = compare_reconstructions(read_model(str(tmp_path / "out" / "0")), gt)
    assert cmp["num_common_images"] == 8
    assert cmp["max_rotation_error_deg"] < MAX_ROT_DEG
    assert cmp["max_center_error"] < MAX_CENTER
    for phase in ("rotation_averaging", "tracks", "positioning", "ba_stage1", "ba_joint",
                  "filter", "retriangulate", "complete_merge", "pose_graph", "pruning"):
        assert pipe.timer.calls.get(phase, 0) >= 1, phase


def test_rotation_averager_command(tmp_path):
    """Rotations within 0.5 deg of the truth (tests/test_cli_tools3.py:96-115)."""
    path = str(tmp_path / "db.db")
    gt = _verify_db(path, tdb.Database, tsyn, True)
    out = str(tmp_path / "rots")
    tcli.main(["rotation_averager", "--database_path", path, "--output_path", out,
               "--device", "cpu"])
    recon = read_model(out)
    assert recon.num_reg_frames() == 8
    iids = sorted(recon.reg_image_ids())
    for iid in iids[1:]:
        R = recon.cam_from_world(iid).rotmat() @ recon.cam_from_world(iids[0]).rotmat().T
        R_gt = gt.cam_from_world(iid).rotmat() @ gt.cam_from_world(iids[0]).rotmat().T
        cos = (np.trace(R @ R_gt.T) - 1.0) / 2.0
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5


def test_view_graph_calibrator_command(tmp_path):
    """Both focals within 5% (tests/test_cli_tools3.py:118-170), written to
    the database."""
    path = str(tmp_path / "db.db")
    true_focals = C.write_calibrator_database(path)
    focals = tcli.main(["view_graph_calibrator", "--database_path", path, "--device", "cpu"])
    cams = tdb.Database(path, must_exist=True).read_cameras()
    for cid, f in true_focals.items():
        assert abs(focals[cid] - f) < 0.05 * f
        assert abs(cams[cid].params[0] - focals[cid]) < 1e-9


@pytest.mark.parametrize("command", ["global_mapper", "rotation_averager",
                                     "view_graph_calibrator"])
def test_global_commands_default_device_is_cuda(tmp_path, command):
    # Without --device the commands run on cuda; without a card they raise
    # rather than run on the CPU.
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    path = str(tmp_path / "db.db")
    _verify_db(path, tdb.Database, tsyn, True)
    argv = [command, "--database_path", path]
    if command != "view_graph_calibrator":
        argv += ["--output_path", str(tmp_path / "o")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(argv)


def test_convert_options_round_trip():
    """The global options carry across both ways, nested ones included."""
    jo = jgpipe.GlobalPipelineOptions(min_num_matches=20, mapper=jgm.GlobalMapperOptions(
        num_retriangulation_rounds=1,
        rotation_averaging=jra.RotationAveragingOptions(cg_iterations=40),
        positioning=jgp.GlobalPositioningOptions(seed=5, huber_scale=0.2)))
    to = convert.convert_options(jo)
    assert isinstance(to, tgpipe.GlobalPipelineOptions)
    assert to.mapper.rotation_averaging.cg_iterations == 40
    assert to.mapper.positioning.seed == 5 and to.mapper.ba.loss == "huber"
    back = convert.convert_options(to, jgpipe.GlobalPipelineOptions)
    assert dataclasses.asdict(back) == dataclasses.asdict(jo)
    for opts in (jra.RotationAveragingOptions(max_num_l1_iterations=3),
                 jgp.GlobalPositioningOptions(anchor_weight=50.0),
                 jvgc.ViewGraphCalibrationOptions(num_iterations=10),
                 jgm.GlobalMapperOptions(keep_max_num_tracks=7)):
        t = convert.convert_options(opts)
        assert type(t).__module__.startswith("colmap_tpu_torch.")
        assert dataclasses.asdict(convert.convert_options(t, type(opts))) == \
            dataclasses.asdict(opts)


@pytest.mark.slow
@pytest.mark.parametrize("has_rel_pose", [True, False], ids=["stored", "decomposed"])
def test_jax_and_port_global_pipelines_agree(tmp_path, has_rel_pose):
    """Both packages' GlobalPipeline on one database (colmap_tpu's
    end-to-end case, seed 31): the same registered frames, both within the
    JAX test's bounds of the truth (0.5 deg, 0.05 units)."""
    path = str(tmp_path / "db.db")
    gt = _verify_db(path, tdb.Database, tsyn, has_rel_pose, seed=31, num_points3D=150,
                    num_points2D_without_point3D=5)
    jrec = jgpipe.GlobalPipeline(jgpipe.GlobalPipelineOptions(),
                                 jdb.Database(path, must_exist=True)).run()
    trec = tgpipe.GlobalPipeline(tgpipe.GlobalPipelineOptions(),
                                 tdb.Database(path, must_exist=True), device="cpu").run()
    assert trec.reg_frame_ids() == jrec.reg_frame_ids()
    for rec in (trec, convert.convert_reconstruction(jrec)):
        cmp = compare_reconstructions(rec, gt)
        assert cmp["num_common_images"] == 8
        assert cmp["max_rotation_error_deg"] < 0.5
        assert cmp["max_center_error"] < 0.05
