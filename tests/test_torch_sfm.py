"""colmap_tpu_torch's incremental mapper slice against colmap_tpu, on the CPU.

The same inputs, made from a numpy seed, go through colmap_tpu (JAX in
float64, as the suite runs it) and the port (its plain versions, float64 on
the CPU). RANSAC draws its samples from jax.random in colmap_tpu and from a
torch.Generator in the port, so RANSAC is compared by outcome (the model
against the truth and the inlier set), never by sample stream. Tolerances
are stated per test with their reason.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators import alignment as jalign
from colmap_tpu.estimators import pose as jpose
from colmap_tpu.estimators.triangulation import TriangulationOptions as JTriOptions
from colmap_tpu.estimators.triangulation import estimate_triangulation as j_est_tri
from colmap_tpu.geometry import triangulation as jtri
from colmap_tpu.scene import database as jdb
from colmap_tpu.scene import database_cache as jcache
from colmap_tpu.scene import reconstruction_io as jio
from colmap_tpu.scene import synthetic as jsyn
from colmap_tpu.scene import types as jtypes
from colmap_tpu.scene.reconstruction import Reconstruction as JReconstruction
from colmap_tpu.sfm import filtering as jfilter
from colmap_tpu.sfm import incremental_pipeline as jpipe
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.estimators import alignment as talign
from colmap_tpu_torch.estimators import pose as tpose
from colmap_tpu_torch.estimators.triangulation import TriangulationOptions as TTriOptions
from colmap_tpu_torch.estimators.triangulation import estimate_triangulation as t_est_tri
from colmap_tpu_torch.estimators.two_view_geometry import _ransac_e as t_ransac_e
from colmap_tpu_torch.geometry.essential import cross_product_matrix, sampson_error
from colmap_tpu_torch.kernels import sfm as K
from colmap_tpu_torch.kernels import sfm_cases as C
from colmap_tpu_torch.optim.ransac import RansacOptions, ransac
from colmap_tpu_torch.scene import database as tdb
from colmap_tpu_torch.scene import database_cache as tcache
from colmap_tpu_torch.scene import reconstruction_io as tio
from colmap_tpu_torch.scene import synthetic as tsyn
from colmap_tpu_torch.sfm import filtering as tfilter
from colmap_tpu_torch.sfm import incremental_pipeline as tpipe

# The reference's end-to-end thresholds (BASELINE.md:13).
MAX_ROT_DEG, MAX_CENTER = 1e-2, 1e-4


def _T(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _verify_options(syn):
    return syn.SyntheticDatasetOptions(num_rigs=1, num_cameras_per_rig=1, num_frames_per_rig=8,
                                       num_points3D=120, camera_has_prior_focal_length=True)


def _write_db(path, syn, db_cls, options=None, seed=3):
    db = db_cls(path)
    recon = syn.synthesize_dataset(options or _verify_options(syn), db,
                                   rng=np.random.default_rng(seed))
    db.close()
    return recon


def _db_content(path):
    """Everything the mapper reads from a database, through the port's reader."""
    db = tdb.Database(path, must_exist=True)
    cams = {cid: (c.model_id, c.width, c.height, c.params.tolist(), c.has_prior_focal_length)
            for cid, c in db.read_cameras().items()}
    images = db.read_images()
    kps = {iid: db.read_keypoints(iid) for iid, _, _ in images}
    tvgs = {}
    for id1, id2, g in db.read_all_two_view_geometries():
        tvgs[(id1, id2)] = (g.config, np.asarray(g.inlier_matches))
    frames = [(f.frame_id, f.rig_id, [tuple(d) for d in f.data_ids]) for f in db.read_frames()]
    rigs = [(r.rig_id, tuple(r.ref_sensor_id)) for r in db.read_rigs()]
    db.close()
    return cams, images, kps, tvgs, frames, rigs


def _same_db(a, b, atol):
    ca, ia, ka, ta, fa, ra = a
    cb, ib, kb, tb, fb, rb = b
    assert ca == cb and ia == ib and fa == fb and ra == rb
    assert ka.keys() == kb.keys()
    for k in ka:
        np.testing.assert_allclose(ka[k], kb[k], atol=atol)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k][0] == tb[k][0]
        np.testing.assert_array_equal(ta[k][1], tb[k][1])


def _same_recon(a, b, atol):
    assert sorted(a.reg_frame_ids()) == sorted(b.reg_frame_ids())
    assert a.points3D.keys() == b.points3D.keys()
    for iid in a.reg_image_ids():
        pa, pb = a.cam_from_world(iid), b.cam_from_world(iid)
        np.testing.assert_allclose(pa.quat, pb.quat, atol=atol)
        np.testing.assert_allclose(pa.t, pb.t, atol=atol)
        np.testing.assert_allclose(a.images[iid].points2D_xy, b.images[iid].points2D_xy, atol=atol)
        np.testing.assert_array_equal(a.images[iid].points2D_p3d, b.images[iid].points2D_p3d)
    for pid, p in a.points3D.items():
        np.testing.assert_allclose(p.xyz, b.points3D[pid].xyz, atol=atol)
        assert [(e.image_id, e.point2D_idx) for e in p.track] == [
            (e.image_id, e.point2D_idx) for e in b.points3D[pid].track]


def test_synthesize_dataset_matches_jax(tmp_path):
    # The same numpy seed gives the same ground truth and database; keypoints
    # come from one float64 projection on each side: 1e-9 px.
    jr = _write_db(str(tmp_path / "j.db"), jsyn, jdb.Database)
    tr = _write_db(str(tmp_path / "t.db"), tsyn, tdb.Database)
    _same_recon(tr, jr, 1e-9)
    _same_db(_db_content(str(tmp_path / "t.db")), _db_content(str(tmp_path / "j.db")), 1e-9)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_database_round_trip(tmp_path, writer):
    # A database written by either package reads back the same through the
    # other's reader: cameras, images, keypoints, matches and two-view
    # geometries are stored as the same blobs, so they agree exactly.
    syn, db_cls = (jsyn, jdb.Database) if writer == "jax" else (tsyn, tdb.Database)
    path = str(tmp_path / "db.db")
    _write_db(path, syn, db_cls)
    other = tdb.Database if writer == "jax" else jdb.Database
    a, b = db_cls(path, must_exist=True), other(path, must_exist=True)
    for x, y in ((a.read_cameras(), b.read_cameras()),):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].model_id == y[k].model_id and np.array_equal(x[k].params, y[k].params)
    assert a.read_images() == b.read_images()
    for iid, _, _ in a.read_images():
        np.testing.assert_array_equal(a.read_keypoints(iid), b.read_keypoints(iid))
    ma, mb = a.read_all_matches(), b.read_all_matches()
    assert [p for p, _ in ma] == [p for p, _ in mb]
    for (_, x), (_, y) in zip(ma, mb):
        np.testing.assert_array_equal(x, y)
    ga, gb = list(a.read_all_two_view_geometries()), list(b.read_all_two_view_geometries())
    assert [(i, j, g.config) for i, j, g in ga] == [(i, j, g.config) for i, j, g in gb]
    for (_, _, x), (_, _, y) in zip(ga, gb):
        np.testing.assert_array_equal(x.inlier_matches, y.inlier_matches)
    a.close()
    b.close()


def test_database_cache_matches_jax(tmp_path):
    # The correspondence graph of the same database: identical CSR arrays.
    path = str(tmp_path / "db.db")
    _write_db(path, tsyn, tdb.Database)
    ja = jcache.DatabaseCache.create(jdb.Database(path, must_exist=True), min_num_matches=15)
    ta = tcache.DatabaseCache.create(tdb.Database(path, must_exist=True), min_num_matches=15)
    assert sorted(ja.correspondence_graph.image_pairs()) == sorted(
        ta.correspondence_graph.image_pairs())
    assert ja.images.keys() == ta.images.keys()
    for iid in ja.images:
        for x, y in zip(ja.correspondence_graph.correspondence_arrays(iid),
                        ta.correspondence_graph.correspondence_arrays(iid)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ja.images[iid].points2D_xy, ta.images[iid].points2D_xy)


def _noisy_jax_recon(seed=5):
    opt = jsyn.SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=6, num_points3D=80, seed=seed)
    recon = jsyn.synthesize_dataset(opt)
    rng = np.random.default_rng(seed)
    for image in recon.images.values():
        image.points2D_xy = image.points2D_xy + rng.normal(0, 0.5, image.points2D_xy.shape)
        bad = rng.random(len(image.points2D_xy)) < 0.05
        image.points2D_xy[bad] += 20.0
    return recon


def test_convert_reconstruction_round_trip(tmp_path):
    # JAX -> port -> JAX rebuilds the same model: the written files match byte
    # for byte.
    jr = _noisy_jax_recon()
    back = convert.convert_reconstruction(convert.convert_reconstruction(jr), jtypes,
                                          JReconstruction)
    jio.write_model(jr, str(tmp_path / "a"), fmt="bin")
    jio.write_model(back, str(tmp_path / "b"), fmt="bin")
    for name in os.listdir(tmp_path / "a"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


def test_reconstruction_edits_match_jax(tmp_path):
    # The mapper's edits, applied the same way to both packages' models,
    # leave the same model (written files byte for byte).
    jr = _noisy_jax_recon()
    tr = convert.convert_reconstruction(jr)
    for r in (jr, tr):
        pids = sorted(r.points3D)
        el = r.points3D[pids[0]].track[0]
        r.delete_observation(el.image_id, el.point2D_idx)
        r.delete_point3D(pids[1])
        merged = r.merge_points3D(pids[2], pids[3])
        el = r.points3D[merged].track[0]
        r.delete_observation(el.image_id, el.point2D_idx)
        r.add_observation(merged, type(el)(el.image_id, el.point2D_idx))
        r.deregister_frame(r.reg_frame_ids()[-1])
        r.transform(1.7, np.array([0.9, 0.1, -0.2, 0.3]), np.array([0.5, -1.0, 2.0]))
        r.normalize()
    jio.write_model(jr, str(tmp_path / "j"), fmt="bin")
    tio.write_model(tr, str(tmp_path / "t"), fmt="bin")
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()


def test_filter_kernel_matches_jax():
    # K9's plain version against _filter_kernel on the same (point x view)
    # arrays: the same float64 formulas, 1e-9; the same infinite errors.
    d = C.as_double(C.filter_case(200, 1, "cpu"))
    args = [d[k].numpy() for k in ("quat", "t", "cam_params", "xyz", "obs_xy", "valid")]
    ej, dj, mj = jfilter._filter_kernel(2, *map(jnp.asarray, args))
    et, dt, mt = K.filter_points_plain(2, *(d[k] for k in ("quat", "t", "cam_params", "xyz",
                                                           "obs_xy", "valid")))
    np.testing.assert_array_equal(np.isinf(np.asarray(ej)), np.isinf(et.numpy()))
    fin = np.isfinite(np.asarray(ej))
    np.testing.assert_allclose(et.numpy()[fin], np.asarray(ej)[fin], atol=1e-9)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-9)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-12)


def test_filter_points3D_same_deletions():
    # filter_points3D on the same noisy model deletes the same observations
    # and points in both packages.
    jr = _noisy_jax_recon(seed=6)
    tr = convert.convert_reconstruction(jr)
    n_j = jfilter.filter_points3D(jr, max_reproj_error=4.0, min_tri_angle_deg=1.5)
    n_t = tfilter.filter_points3D(tr, max_reproj_error=4.0, min_tri_angle_deg=1.5, device="cpu")
    assert n_j == n_t > 0
    assert jr.points3D.keys() == tr.points3D.keys()
    for pid in jr.points3D:
        assert [(e.image_id, e.point2D_idx) for e in jr.points3D[pid].track] == [
            (e.image_id, e.point2D_idx) for e in tr.points3D[pid].track]


def test_estimate_triangulation_matches_jax():
    # K8's plain version against colmap_tpu's vmapped estimate_triangulation
    # on tracks with outlier views and two-view tracks. Both take LAPACK's
    # SVD per pair and eigh for the refit in float64: the same success and
    # inlier masks, xyz to 1e-8.
    d = C.as_double(C.tracks_case(200, 2, "cpu"))
    out_j = jax.vmap(lambda R, t, x, m: j_est_tri(R, t, x, m, JTriOptions()))(
        *(jnp.asarray(d[k].numpy()) for k in ("R", "t", "x", "mask")))
    out_t = t_est_tri(d["R"], d["t"], d["x"], d["mask"], TTriOptions())
    ok = np.asarray(out_j["success"])
    np.testing.assert_array_equal(out_t["success"].numpy(), ok)
    assert ok.sum() > 150
    np.testing.assert_array_equal(out_t["inlier_mask"].numpy()[ok],
                                  np.asarray(out_j["inlier_mask"])[ok])
    np.testing.assert_allclose(out_t["xyz"].numpy()[ok], np.asarray(out_j["xyz"])[ok], atol=1e-8)


def test_multi_view_tracks_matches_jax():
    # K8 without RANSAC against colmap_tpu's triangulate_multi_view on the
    # same tracks (outlier views included): LAPACK's eigh on both sides in
    # float64, 1e-9.
    d = C.as_double(C.tracks_case(200, 3, "cpu"))
    P = torch.cat([d["R"], d["t"][..., None]], dim=-1)
    xj = jtri.triangulate_multi_view(jnp.asarray(P.numpy()), jnp.asarray(d["x"].numpy()),
                                     jnp.asarray(d["mask"].numpy().astype(float)))
    xt = K.triangulate_multi_view_tracks(d["R"], d["t"], d["x"], d["mask"])
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-9)


@pytest.mark.parametrize("robust", [True, False])
def test_triangulator_creates_points_like_jax(tmp_path, robust):
    # Both triangulators on the verify scene with three frames registered at
    # their ground-truth poses and no points yet: triangulate_image on the
    # third frame, with and without RANSAC over view pairs at creation,
    # creates the same tracks; on noise-free data each point lies on its
    # ground-truth point (1e-6) and both packages agree to 1e-8 (the same
    # float64 formulas).
    from colmap_tpu.sfm import incremental_mapper as jmapper
    from colmap_tpu.sfm.incremental_triangulator import TriangulatorOptions as JTriangulatorOptions
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.sfm import incremental_mapper as tmapper
    from colmap_tpu_torch.sfm.incremental_triangulator import TriangulatorOptions

    db = str(tmp_path / "db.db")
    gt = _write_db(db, tsyn, tdb.Database)
    frames = sorted(gt.frames)[:3]
    made = []
    for pkg, cache_mod, recon_cls, opts in (
            (jmapper, jcache, JReconstruction, JTriangulatorOptions),
            (tmapper, tcache, Reconstruction, TriangulatorOptions)):
        db_cls = jdb.Database if pkg is jmapper else tdb.Database
        cache = cache_mod.DatabaseCache.create(db_cls(db, must_exist=True), min_num_matches=15)
        mapper = (pkg.IncrementalMapper(cache) if pkg is jmapper
                  else pkg.IncrementalMapper(cache, device="cpu"))
        recon = recon_cls()
        mapper.begin_reconstruction(recon)
        for fid in frames:
            pose = gt.frames[fid].rig_from_world
            recon.frames[fid].rig_from_world = type(pose)(np.array(pose.quat), np.array(pose.t))
            recon.register_frame(fid)
        image_id = gt.frames[frames[-1]].image_ids()[0]
        n = mapper.triangulator.triangulate_image(
            image_id, opts(robust_creation=robust, ignore_two_view_tracks=False))
        assert n > 0 and recon.num_points3D() > 0
        made.append({tuple(sorted((e.image_id, e.point2D_idx) for e in p.track)): p.xyz
                     for p in recon.points3D.values()})
        for track, xyz in made[-1].items():
            iid, idx = track[0]
            np.testing.assert_allclose(xyz, gt.points3D[int(gt.images[iid].points2D_p3d[idx])].xyz,
                                       atol=1e-6)
    assert made[0].keys() == made[1].keys()
    for track in made[0]:
        np.testing.assert_allclose(made[1][track], made[0][track], atol=1e-8)


def test_structure_less_registration_stops_at_the_estimator(tmp_path):
    # The port checks what the reference checks before the structure-less
    # estimator (two registered partners, twice the inliers of the
    # structured path); past them the estimator registers the image, here at
    # its ground-truth pose (noise-free scene, float64).
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.sfm import incremental_mapper as tmapper

    db = str(tmp_path / "db.db")
    gt = _write_db(db, tsyn, tdb.Database)
    cache = tcache.DatabaseCache.create(tdb.Database(db, must_exist=True), min_num_matches=15)
    mapper = tmapper.IncrementalMapper(cache, device="cpu")
    recon = Reconstruction()
    mapper.begin_reconstruction(recon)
    frames = sorted(gt.frames)
    image_id = gt.frames[frames[2]].image_ids()[0]
    options = tmapper.IncrementalMapperOptions()
    for fid in frames[:2]:
        assert not mapper.register_next_structure_less_image(image_id, options)
        pose = gt.frames[fid].rig_from_world
        recon.frames[fid].rig_from_world = type(pose)(np.array(pose.quat), np.array(pose.t))
        recon.register_frame(fid)
    many = dataclasses.replace(options, abs_pose_min_num_inliers=10 ** 6)
    assert not mapper.register_next_structure_less_image(image_id, many)
    assert mapper.register_next_structure_less_image(image_id, options)
    assert recon.is_image_registered(image_id)
    got, want = recon.cam_from_world(image_id), gt.cam_from_world(image_id)
    assert np.abs(got.rotmat() - want.rotmat()).max() <= 1e-6
    assert np.abs(got.t - want.t).max() <= 1e-6


def test_registration_gives_a_2d_point_in_two_tracks_to_the_first_within_threshold(tmp_path):
    # A 2D point whose correspondences lie in two tracks is an inlier of both
    # 3D points. Frames 0 and 1 of the verify scene are registered at their
    # ground-truth poses, and every ground-truth point becomes two 3D points:
    # one observed in frame 0, one in frame 1. Registering frame 2 then
    # gives each of its 2D points two 2D-3D correspondences. For every
    # fourth point the first of the two is moved 8 px off in frame 2: a P3P
    # inlier at 12 px that fails the 4 px filter. Each 2D point goes to the
    # first of its 3D points that reprojects within 4 px, and the other
    # 3D point keeps its one observation.
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.sfm import incremental_mapper as tmapper

    db = str(tmp_path / "db.db")
    gt = _write_db(db, tsyn, tdb.Database)
    cache = tcache.DatabaseCache.create(tdb.Database(db, must_exist=True), min_num_matches=15)
    mapper = tmapper.IncrementalMapper(cache, device="cpu")
    recon = Reconstruction()
    mapper.begin_reconstruction(recon)
    frames = sorted(gt.frames)
    image_ids = [gt.frames[fid].image_ids()[0] for fid in frames[:3]]
    for fid in frames[:2]:
        pose = gt.frames[fid].rig_from_world
        recon.frames[fid].rig_from_world = type(pose)(np.array(pose.quat), np.array(pose.t))
        recon.register_frame(fid)
    planted = {}  # ground-truth point -> its 3D point in frame 0 and in frame 1
    for iid in image_ids[:2]:
        for idx, g in enumerate(gt.images[iid].points2D_p3d):
            if g != tmapper.INVALID_POINT3D:
                planted.setdefault(int(g), []).append(recon.add_point3D(
                    gt.points3D[int(g)].xyz, [tmapper.TrackElement(iid, idx)]))
    new = image_ids[2]
    p2d, p3d = mapper._collect_2d3d_for_image(new)
    first = {}
    for p, q in zip(p2d, p3d):
        first.setdefault(p, []).append(q)
    assert len(first) >= 100 and all(len(q) == 2 for q in first.values())
    cam = gt.cam_from_world(new)
    f = gt.cameras[gt.images[new].camera_id].params[0]
    moved = set()
    for p in sorted(first)[::4]:
        q = first[p][0]
        z = cam.apply(recon.points3D[q].xyz[None])[0, 2]
        recon.points3D[q].xyz = recon.points3D[q].xyz + cam.rotmat().T @ np.array([8 * z / f, 0, 0])
        moved.add(p)
    options = tmapper.IncrementalMapperOptions()
    assert mapper.register_next_image(new, options)
    for p, (q0, q1) in first.items():
        took, left = (q1, q0) if p in moved else (q0, q1)
        assert recon.images[new].points2D_p3d[p] == took
        assert [(e.image_id, e.point2D_idx) for e in recon.points3D[took].track][-1] == (new, p)
        assert len(recon.points3D[left].track) == 1
        assert recon.points3D[left].track[0].image_id != new


def test_structure_less_pose_matches_colmap_tpu():
    """estimate_structure_less_absolute_pose against colmap_tpu's on the
    same correspondences (a new camera against three registered ones, 0.5
    px noise, 20% outliers; the RANSAC samples differ): the same inliers
    up to 2% of the rows, and both poses within 3 deg and 0.25 units of
    the truth."""
    from colmap_tpu.estimators import generalized_pose as jgp
    from colmap_tpu.scene.types import Camera as JCamera
    from colmap_tpu.scene.types import Pose as JPose
    from colmap_tpu_torch.estimators import generalized_pose as tgp
    from colmap_tpu_torch.scene.types import Camera, Pose

    rng = np.random.default_rng(4)
    X = rng.uniform(-1, 1, (600, 3)) + np.array([0, 0, 5.0])
    f, w, h = 800.0, 640, 480
    params = np.array([f, f, w / 2, h / 2])

    def pose(angle, t):
        axis = np.array([0.3, 1.0, 0.1]) / np.linalg.norm([0.3, 1.0, 0.1])
        return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis]), np.asarray(t)

    def project(q, t):
        P = Pose(q, t).apply(X)
        return P[:, :2] / P[:, 2:] * f + params[2:]

    world = [pose(0.0, [0, 0, 0]), pose(0.15, [-0.8, 0.1, 0.1]), pose(-0.12, [0.7, -0.1, 0.05])]
    new = pose(0.08, [0.4, 0.2, -0.1])
    xy_new = project(*new) + rng.normal(0, 0.5, (600, 2))
    cam_idx = np.arange(600) % 3
    xy_w = np.stack([project(*world[c])[i] for i, c in enumerate(cam_idx)])
    bad = rng.random(600) < 0.2
    xy_new[bad] = rng.uniform(0, [w, h], (bad.sum(), 2))
    common = (xy_new, xy_w, cam_idx)
    tp, tin = tgp.estimate_structure_less_absolute_pose(
        *common, [Pose(*p) for p in world], [Camera.create(0, 1, f, w, h)] * 3,
        Camera.create(0, 1, f, w, h), device="cpu")
    jp, jin = jgp.estimate_structure_less_absolute_pose(
        *common, [JPose(*p) for p in world], [JCamera.create(0, 1, f, w, h)] * 3,
        JCamera.create(0, 1, f, w, h))
    assert tp is not None and jp is not None
    # A random outlier passes an epipolar test now and then: both keep a
    # few, and the two inlier sets differ on at most 2% of the rows.
    assert (tin & ~bad).sum() >= 0.95 * (~bad).sum() and (tin & bad).sum() <= 0.1 * bad.sum()
    assert (tin != np.asarray(jin)).mean() <= 0.02
    # The pose is the best sample's, unrefined: over seeds 0-5 both packages
    # land 0.08-2.4 deg from the truth (measured), which BA then refines.
    want = Pose(*new)
    for got in (tp, jp):
        dR = np.asarray(got.rotmat()) @ want.rotmat().T
        assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) <= 3.0
        assert np.abs(np.asarray(got.t) - want.t).max() <= 0.25


def _absolute_pose_data(seed=0, n=300):
    c = C.p3p_case(n, 64, seed, "cpu")
    X = c["X"].double().numpy()[:-3]
    xy = c["uv"].double().numpy()[:-3] * C.FOCAL + np.array([C.WIDTH / 2, C.HEIGHT / 2])
    return X, xy, c["R"], c["t"]


def test_p3p_ransac_outcome_matches_jax():
    # 300 2D-3D rows with 30% outliers: both packages recover the pose to
    # 1e-6 and agree on the inlier set (their final models both sit on the
    # truth, so no row is near the 12 px threshold).
    X, xy, R, t = _absolute_pose_data()
    opts = dict(max_error_px=12.0, min_inlier_ratio=0.25)
    jcam = jtypes.Camera(1, 0, C.WIDTH, C.HEIGHT, np.array([C.FOCAL, C.WIDTH / 2, C.HEIGHT / 2]))
    pj, inl_j, _ = jpose.estimate_absolute_pose(jcam, xy, X, jpose.AbsolutePoseOptions(**opts))
    pt, inl_t, _ = tpose.estimate_absolute_pose(convert.convert_camera(jcam), xy, X,
                                                tpose.AbsolutePoseOptions(**opts), device="cpu")
    np.testing.assert_array_equal(inl_t, inl_j)
    np.testing.assert_allclose(pt.rotmat(), R, atol=1e-6)
    np.testing.assert_allclose(pt.t, t, atol=1e-6)
    np.testing.assert_allclose(pj.rotmat(), R, atol=1e-6)


def test_refine_absolute_pose_matches_jax():
    # The one-frame LM refinement with constant points, from the same
    # perturbed start on the same noisy inliers: the same solver on both
    # sides (30 LM steps, Cauchy loss), the poses agree to 1e-6.
    X, xy, R, t = _absolute_pose_data(seed=1)
    xy = xy + np.random.default_rng(2).normal(0, 0.3, xy.shape)
    Xc = X @ R.T + t
    proj = Xc[:, :2] / Xc[:, 2:] * C.FOCAL + np.array([C.WIDTH / 2, C.HEIGHT / 2])
    inl = np.linalg.norm(xy - proj, axis=1) < 5
    q = _quat(R) + np.array([0.0, 0.01, -0.01, 0.005])
    q /= np.linalg.norm(q)
    jcam = jtypes.Camera(1, 0, C.WIDTH, C.HEIGHT, np.array([C.FOCAL, C.WIDTH / 2, C.HEIGHT / 2]))
    pj, _, okj = jpose.refine_absolute_pose(jcam, jtypes.Pose(q, t + 0.02), xy, X, inl)
    pt, _, okt = tpose.refine_absolute_pose(convert.convert_camera(jcam),
                                            _port_pose(jtypes.Pose(q, t + 0.02)), xy, X, inl,
                                            device="cpu")
    assert okj and okt
    np.testing.assert_allclose(pt.rotmat(), pj.rotmat(), atol=1e-6)
    np.testing.assert_allclose(pt.t, pj.t, atol=1e-6)
    np.testing.assert_allclose(pt.rotmat(), R, atol=1e-3)


def _quat(R):
    from colmap_tpu_torch.geometry import rotation as rot

    return rot.rotmat_to_quat(_T(R)).numpy()


def _port_pose(p):
    from colmap_tpu_torch.scene.types import Pose

    return Pose(np.array(p.quat), np.array(p.t))


def test_essential_ransac_outcome():
    # 300 matches with 30% outliers: the E LO-RANSAC finds the true E up to
    # sign, to 1e-4 (the 8-point refit also fits the few random outliers that
    # fall within the 4 px threshold), and exactly the rows whose Sampson
    # error under the true E is within the threshold. (colmap_tpu's _ransac_e takes a minute
    # to compile on the CPU: a slow test holds the two packages' outcomes together.)
    c = C.as_double(C.essential_case(300, 128, 3, "cpu"))
    R1, t1 = C._look_at(np.array([0.0, 0.0, -5.0]))
    R2, t2 = C._look_at(np.array([1.5, 0.3, -4.8]))
    R = R2 @ R1.T
    t = t2 - R @ t1
    E_true = (cross_product_matrix(_T(t / np.linalg.norm(t))) @ _T(R))
    opts = RansacOptions(confidence=0.999, min_num_trials=100, max_num_trials=10000,
                         min_inlier_ratio=0.25, batch_size=128)
    res = t_ransac_e(torch.Generator().manual_seed(0), c["x1"], c["x2"], c["mask"],
                     np.sqrt(c["max_sq"]), opts)
    assert res.success
    E = res.model / torch.linalg.norm(res.model) * np.sqrt(2.0)
    E = E * torch.sign((E * E_true).sum())
    np.testing.assert_allclose(E.numpy(), E_true.numpy(), atol=1e-4)
    true_inl = (sampson_error(E_true, c["x1"], c["x2"]) <= c["max_sq"]).numpy()
    np.testing.assert_array_equal(res.inlier_mask.numpy(), true_inl)


@pytest.mark.slow
def test_essential_ransac_outcome_matches_jax():
    # colmap_tpu's _ransac_e (about a minute to compile on the CPU) and the
    # port's on the same 300 matches with 30% outliers: both succeed, their
    # E agree up to sign and scale to 1e-4 (each is the 8-point refit on its
    # inliers, which may take in a few outliers within the 4 px threshold),
    # and their inlier sets are the same.
    from colmap_tpu.estimators.two_view_geometry import _ransac_e as j_ransac_e
    from colmap_tpu.optim.ransac import RansacOptions as JRansacOptions

    c = C.as_double(C.essential_case(300, 128, 3, "cpu"))
    kw = dict(confidence=0.999, min_num_trials=100, max_num_trials=10000, min_inlier_ratio=0.25,
              batch_size=128)
    max_error = float(np.sqrt(c["max_sq"]))
    x1, x2, mask = (jnp.asarray(c[k].numpy()) for k in ("x1", "x2", "mask"))
    rj = j_ransac_e(jax.random.PRNGKey(0), x1, x2, mask, max_error, JRansacOptions(**kw))
    Ej, inl_j, ok_j = np.asarray(rj.model), np.asarray(rj.inlier_mask), bool(rj.success)
    rt = t_ransac_e(torch.Generator().manual_seed(0), c["x1"], c["x2"], c["mask"], max_error,
                    RansacOptions(**kw))
    assert ok_j and rt.success
    Ej = Ej / np.linalg.norm(Ej)
    Et = rt.model.numpy() / np.linalg.norm(rt.model.numpy())
    np.testing.assert_allclose(Et * np.sign((Et * Ej).sum()), Ej, atol=1e-4)
    np.testing.assert_array_equal(rt.inlier_mask.numpy(), inl_j)


def test_ransac_keeps_unported_options_out():
    """Progressive sampling and MSAC support are ported (their comparisons
    with colmap_tpu are in tests/test_torch_options.py): both run through
    the harness on a 1-D problem, and option values the reference does not
    know are kept out with a ValueError."""
    from colmap_tpu_torch.optim.ransac import pack_best, pack_best_scores, score_models

    x = torch.tensor([0.0] * 8 + [5.0, 9.0], dtype=torch.float64)
    mask = torch.ones(10, dtype=torch.bool)

    def propose(idxs, msac=False):
        models = x[idxs.long()[:, :1]]
        counts, scores = score_models(models, (models - x[None]) ** 2, mask, 1.0, msac)
        best = pack_best_scores(scores) if msac else pack_best(counts)
        return (models, counts, best, scores) if msac else (models, counts, best)

    def inliers(model):
        return (model - x) ** 2 <= 1.0

    for opts, msac in ((RansacOptions(sampling="progressive", batch_size=8), False),
                       (RansacOptions(support="m_estimator", batch_size=8), True)):
        res = ransac(torch.Generator().manual_seed(0), mask, 1, lambda i: propose(i, msac),
                     inliers, opts)
        assert res.success and res.num_inliers == 8 and float(res.model[0]) == 0.0
    for opts in (RansacOptions(sampling="prosac"), RansacOptions(support="ransac")):
        with pytest.raises(ValueError):
            ransac(torch.Generator(), mask, 3, None, None, opts)


def test_compare_reconstructions_matches_jax():
    # The same models compared with the same float64 Umeyama: 1e-12.
    gt = _noisy_jax_recon(seed=8)
    moved = convert.convert_reconstruction(gt)
    moved.transform(2.0, np.array([0.8, 0.2, 0.1, -0.3]), np.array([1.0, 2.0, -1.0]))
    for frame in moved.frames.values():
        frame.rig_from_world.t = frame.rig_from_world.t + 1e-3
    out_t = talign.compare_reconstructions(moved, convert.convert_reconstruction(gt))
    out_j = jalign.compare_reconstructions(
        convert.convert_reconstruction(moved, jtypes, JReconstruction), gt)
    assert out_t["num_common_images"] == out_j["num_common_images"] == 6
    for key in ("rotation_errors_deg", "center_errors"):
        np.testing.assert_allclose(out_t[key], out_j[key], atol=1e-12)


def test_convert_options_round_trip():
    jo = jpipe.IncrementalPipelineOptions(min_num_matches=20)
    jo.mapper.init_min_num_inliers = 50
    to = convert.convert_options(jo)
    assert isinstance(to, tpipe.IncrementalPipelineOptions)
    assert to.mapper.init_min_num_inliers == 50 and to.min_num_matches == 20
    back = convert.convert_options(to, jpipe.IncrementalPipelineOptions,
                                   mapper=type(jo.mapper), triangulator=type(jo.triangulator))
    assert dataclasses.asdict(back) == dataclasses.asdict(jo)


def _check_model(out, gt, num_frames):
    recon = tio.read_model(out)
    cmp = talign.compare_reconstructions(recon, convert.convert_reconstruction(gt))
    assert recon.num_reg_frames() == num_frames
    assert cmp["num_common_images"] == num_frames
    assert cmp["max_rotation_error_deg"] <= MAX_ROT_DEG
    assert cmp["max_center_error"] <= MAX_CENTER
    return recon


def test_mapper_cpu_verify_scene(tmp_path):
    # The verify recipe through the port's CLI on the CPU: every frame
    # registered within the reference thresholds (1e-2 deg, 1e-4 units).
    db = str(tmp_path / "db.db")
    gt = _write_db(db, tsyn, tdb.Database)
    pipeline = tcli.main(["mapper", "--database_path", db, "--output_path",
                          str(tmp_path / "sparse"), "--device", "cpu", "--quiet"])
    _check_model(str(tmp_path / "sparse" / "0"), gt, 8)
    assert pipeline.timer.seconds["init_pair_search"] > 0


def test_mapper_default_device_is_cuda(tmp_path):
    # Without --device the mapper runs on cuda; without a card it raises
    # rather than run on the CPU.
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    db = str(tmp_path / "db.db")
    _write_db(db, tsyn, tdb.Database)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["mapper", "--database_path", db, "--output_path", str(tmp_path / "o")])


@pytest.mark.slow
def test_jax_and_port_mappers_agree(tmp_path):
    # Both mappers on the same database: the same registered frames, both
    # within the reference thresholds of the ground truth.
    db = str(tmp_path / "db.db")
    gt = _write_db(db, tsyn, tdb.Database)
    jmodels = jpipe.IncrementalPipeline(jpipe.IncrementalPipelineOptions(),
                                        jdb.Database(db, must_exist=True)).run()
    tcli.main(["mapper", "--database_path", db, "--output_path", str(tmp_path / "t"),
               "--device", "cpu", "--quiet"])
    trec = _check_model(str(tmp_path / "t" / "0"), gt, 8)
    jcmp = jalign.compare_reconstructions(jmodels[0], convert.convert_reconstruction(
        gt, jtypes, JReconstruction))
    assert jcmp["max_rotation_error_deg"] <= MAX_ROT_DEG
    assert jcmp["max_center_error"] <= MAX_CENTER
    assert sorted(jmodels[0].reg_image_ids()) == sorted(trec.reg_image_ids())
