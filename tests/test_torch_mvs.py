"""colmap_tpu_torch's dense slice against colmap_tpu, on the CPU.

image_undistorter -> patch_match_stereo -> stereo_fusion: the plain versions
of the PatchMatch kernels K17-K20 against the JAX functions in float64, the
whole PatchMatch, fusion, undistortion, the file formats, the caches, the
convert helpers and the CLI chain. Inputs come from a numpy seed; options
reach the port through convert_options. The scenes are the constructions of
tests/test_mvs.py (_textured_plane_scene) and tests/test_mvs_workspace.py
(_plane_workspace), copied here.

Border ties: the textured-plane scene's sources differ from the reference by
an x translation only, so a window tap in the first or last row projects
exactly onto a source's border row, and the last bits of each package's
arithmetic decide whether it counts. ``mvs_cases.cost_ties(..., 1e-9)`` marks
the (view, pixel) entries with a tap within 1e-9 px of a border; they are
left out of the cost comparisons, and pixels whose choice they (or a gap
under 1e-9 between the two best candidates) may decide are left out of the
iteration comparison, as near-ties.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from colmap_tpu.image import undistortion as JU
from colmap_tpu.mvs import consistency_graph as JCG
from colmap_tpu.mvs import depth_map as JD
from colmap_tpu.mvs import fusion as JF
from colmap_tpu.mvs import patch_match as J
from colmap_tpu.scene.reconstruction import Reconstruction
from colmap_tpu.scene.types import Camera, Frame, Image, Pose, Rig, TrackElement
from colmap_tpu.utils import cache as JC
from colmap_tpu.utils import ply as JPLY
from colmap_tpu.utils.types import SensorType
from colmap_tpu_torch import convert
from colmap_tpu_torch.cli import main as tcli
from colmap_tpu_torch.image import undistortion as TU
from colmap_tpu_torch.kernels import mvs as K
from colmap_tpu_torch.kernels import mvs_cases as C
from colmap_tpu_torch.mvs import consistency_graph as TCG
from colmap_tpu_torch.mvs import depth_map as TD
from colmap_tpu_torch.mvs import fusion as TF
from colmap_tpu_torch.mvs import patch_match as T
from colmap_tpu_torch.mvs import workspace as TW
from colmap_tpu_torch.utils import cache as TC
from colmap_tpu_torch.utils import image_io
from colmap_tpu_torch.utils import ply as TPLY

TIE_PX = 1e-9


def _textured_plane_scene(rng, size=48, depth0=5.0, slope=0.02):
    """Reference camera at origin; a textured slanted plane; two side views."""
    f = 60.0
    K_ = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1.0]])
    tex_size = 512
    texture = gaussian_filter(rng.uniform(0, 1, (tex_size, tex_size)), 1.0)

    def render(R, t):
        ys, xs = np.mgrid[0:size, 0:size]
        Kinv = np.linalg.inv(K_)
        rays = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Kinv.T
        Rt = R.T
        o = -Rt @ t
        d = rays @ Rt.T
        denom = d[..., 2] - slope * d[..., 0] - slope * d[..., 1]
        num = depth0 + slope * o[0] + slope * o[1] - o[2]
        s = num / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        X_ref = o + s[..., None] * d
        u = (X_ref[..., 0] * 40 + tex_size / 2).astype(np.int64) % tex_size
        v = (X_ref[..., 1] * 40 + tex_size / 2).astype(np.int64) % tex_size
        return texture[v, u].astype(np.float32), s.astype(np.float32)

    ref_img, ref_depth = render(np.eye(3), np.zeros(3))
    srcs, Rs, ts = [], [], []
    for dx in (-0.5, 0.5):
        R = np.eye(3)
        t = -R @ np.array([dx, 0.0, 0.0])
        img, _ = render(R, t)
        srcs.append(img)
        Rs.append(R)
        ts.append(t)
    return K_, ref_img, ref_depth, srcs, Rs, ts


def _plane_workspace(size=48, depth0=5.0):
    """Three fronto-parallel-ish cameras viewing a textured plane z=depth0
    (colmap_tpu's Reconstruction)."""
    rng = np.random.default_rng(0)
    f = 60.0
    tex = gaussian_filter(rng.uniform(0, 1, (512, 512)), 1.0)
    recon = Reconstruction()
    recon.add_camera(Camera(camera_id=1, model_id=1, width=size, height=size,
                            params=np.array([f, f, size / 2, size / 2]),
                            has_prior_focal_length=True))
    images = {}
    for i, c in enumerate([np.array([dx, 0.0, 0.0]) for dx in (0.0, -0.5, 0.5)]):
        iid = i + 1
        recon.add_rig(Rig(rig_id=iid, ref_sensor_id=(int(SensorType.CAMERA), 1)))
        recon.add_frame(Frame(frame_id=iid, rig_id=iid,
                              rig_from_world=Pose(np.array([1.0, 0, 0, 0]), -c),
                              data_ids=[(int(SensorType.CAMERA), 1, iid)]))
        img = Image(image_id=iid, name=f"v{i}.png", camera_id=1, frame_id=iid)
        ys, xs = np.mgrid[0:size, 0:size]
        X = c[0] + (xs - size / 2) / f * depth0
        Y = c[1] + (ys - size / 2) / f * depth0
        u = (X * 40 + 256).astype(np.int64) % 512
        v = (Y * 40 + 256).astype(np.int64) % 512
        images[iid] = tex[v, u].astype(np.float32)
        img.set_points2D(rng.uniform(5, size - 5, (30, 2)))
        recon.add_image(img)
        recon.register_frame(iid)
    for k in range(25):
        X = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), depth0])
        recon.add_point3D(X, [TrackElement(iid, k) for iid in images])
    return recon, images, depth0


@pytest.fixture(scope="module")
def scene():
    """The textured plane as numpy problem fields (float64), with source
    depths, and a random plane state near the truth."""
    rng = np.random.default_rng(0)
    K_, ref, ref_depth, srcs, Rs, ts = _textured_plane_scene(rng)
    H, W = ref.shape
    fields = dict(ref_image=ref.astype(np.float64), src_images=np.stack(srcs).astype(np.float64),
                  K_ref=K_, K_src=np.stack([K_, K_]), R_rel=np.stack(Rs), t_rel=np.stack(ts),
                  src_depths=np.stack([ref_depth, ref_depth]).astype(np.float64)
                  * (1 + 0.01 * rng.standard_normal((2, H, W))))
    depth = ref_depth.astype(np.float64) * (1 + 0.05 * rng.standard_normal((H, W)))
    normal = rng.standard_normal((H, W, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[..., 2] = -np.abs(normal[..., 2])
    return dict(fields=fields, depth=depth, normal=normal, ref_depth=ref_depth,
                sel=rng.uniform(0.05, 0.95, (2, H, W)), raw=(K_, ref, srcs, Rs, ts))


def _pair(fields, geometric):
    """(colmap_tpu problem, port problem) of the same numpy fields."""
    f = dict(fields) if geometric else {k: v for k, v in fields.items() if k != "src_depths"}
    return (J.PatchMatchProblem(**{k: jnp.asarray(v) for k, v in f.items()}),
            convert.patch_match_problem_from_numpy(f, "cpu"))


def _options(**kw):
    jo = J.PatchMatchOptions(depth_min=2.0, depth_max=10.0, **kw)
    return jo, convert.convert_options(jo)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("geometric", [False, True], ids=["photometric", "geometric"])
@pytest.mark.parametrize("radius", [2, 3])
def test_per_view_costs_match(scene, radius, geometric):
    """K17's plain version against _per_view_costs to 1e-9, away from
    border ties."""
    jp, tp = _pair(scene["fields"], geometric)
    jo, to = _options(window_radius=radius)
    want = np.asarray(J._per_view_costs(jp, jnp.asarray(scene["depth"]),
                                        jnp.asarray(scene["normal"]), jo))
    got = K.costs_plain(tp, _t(scene["depth"]), _t(scene["normal"]), to).numpy()
    tie = C.cost_ties(tp, _t(scene["depth"]), _t(scene["normal"]), to, TIE_PX).numpy()
    assert tie.mean() < 0.2, tie.mean()
    np.testing.assert_allclose(got[~tie], want[~tie], rtol=0, atol=1e-9)
    # The wrapper runs the plain version on CPU tensors.
    np.testing.assert_array_equal(
        K.costs(tp, _t(scene["depth"]), _t(scene["normal"]), to).numpy(), got)


def test_view_weights_match(scene):
    jp, tp = _pair(scene["fields"], False)
    jo, to = _options()
    want = J._view_weights(jp, jnp.asarray(scene["depth"]), jnp.asarray(scene["normal"]),
                           jnp.asarray(scene["sel"]), jo)
    got = K.view_weights(tp, _t(scene["depth"]), _t(scene["normal"]), _t(scene["sel"]), to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)


@pytest.mark.parametrize("axis", [0, 1], ids=["along_H", "along_W"])
def test_update_sel_prob_matches(scene, axis):
    jp, tp = _pair(scene["fields"], False)
    jo, to = _options()
    cost = np.asarray(J._per_view_costs(jp, jnp.asarray(scene["depth"]),
                                        jnp.asarray(scene["normal"]), jo))
    want = J._update_sel_prob(jnp.asarray(cost), jnp.asarray(scene["sel"]), 1 + axis, 0.3, jo)
    got = K.update_sel_prob(_t(cost), _t(scene["sel"]), axis, 0.3, to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)


def _jax_draws(key, H, W, options):
    """_pm_iteration's draws from its key, by colmap_tpu's own calls."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    f64 = jnp.float64
    return K.Draws(
        depth=_t(jax.random.uniform(k1, (H, W), f64, options.depth_min, options.depth_max)),
        normal=_t(J._random_normals(k2, (H, W), f64)),
        factor=_t(jax.random.uniform(k3, (H, W), f64, -1.0, 1.0)),
        noise=_t(jax.random.normal(k4, (H, W, 3), f64)))


@pytest.mark.parametrize("view_selection", [True, False], ids=["weights", "best_half"])
@pytest.mark.parametrize("parity", [0, 1])
def test_pm_iteration_matches(scene, parity, view_selection):
    """One half-iteration with colmap_tpu's draws injected: the same choice
    at every pixel but near-ties (which stay under 10% of the pixels), and
    there the same cost and per-view costs within 1e-8; the selection
    probabilities are K20's of the port's own per-view costs."""
    jp, tp = _pair(scene["fields"], False)
    jo, to = _options(view_selection=view_selection)
    H, W = scene["depth"].shape
    d, n, sel = (jnp.asarray(scene[k]) for k in ("depth", "normal", "sel"))
    ca = J._per_view_costs(jp, d, n, jo)
    w = J._view_weights(jp, d, n, sel, jo) if view_selection else None
    state = (d, n, J._aggregate(ca, w), ca, sel)
    key = jax.random.PRNGKey(11 + parity)
    want = [np.asarray(x) for x in J._pm_iteration(jp, state, jo, key, parity, parity,
                                                   jnp.asarray(0.5), jnp.asarray(0.3))]
    draws = _jax_draws(key, H, W, jo)
    tstate = tuple(_t(x) for x in state)
    got = [x.numpy() for x in T.pm_iteration(tp, tstate, to, draws, parity, parity, 0.5, 0.3)]
    w_t = None if w is None else _t(w)
    ties = C.choice_ties(tp, tstate[0], tstate[1], tstate[2], w_t, draws, parity, 0.5, to,
                         TIE_PX, 1e-9).numpy()
    same = ((np.abs(got[0] - want[0]) <= 1e-8) & (np.abs(got[1] - want[1]).max(-1) <= 1e-8))
    assert same[~ties].all(), f"{(~same & ~ties).sum()} pixels choose differently"
    assert ties.mean() < 0.1, ties.mean()
    assert (got[0] != scene["depth"]).sum() > 0.3 * H * W / 2  # the sweep did move planes
    agree = same & ~ties
    np.testing.assert_allclose(got[2][agree], want[2][agree], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[3][:, agree], want[3][:, agree], rtol=0, atol=1e-8)
    if view_selection:
        sel_ref = J._update_sel_prob(jnp.asarray(got[3]), sel, 1 + parity, 0.3, jo)
        np.testing.assert_allclose(got[4], np.asarray(sel_ref), rtol=0, atol=1e-9)


@pytest.mark.parametrize("view_selection", [True, False], ids=["weights", "best_half"])
def test_consistency_filter_matches(scene, view_selection):
    """The same masks and kept maps, but at pixels within 1e-9 of a threshold."""
    jp, tp = _pair(scene["fields"], True)
    jo, to = _options(view_selection=view_selection)
    d, n, sel = (jnp.asarray(scene[k]) for k in ("depth", "normal", "sel"))
    ca = J._per_view_costs(jp, d, n, jo)
    want = [np.asarray(x) for x in J._consistency_filter(jp, d, n, ca, sel, jo)]
    args = (_t(scene["depth"]), _t(scene["normal"]), _t(ca), _t(scene["sel"]))
    got = [x.numpy() for x in K.consistency_filter(tp, *args, to)]
    ok = ~C.filter_ties(tp, *args, to, 1e-9).numpy()
    assert want[2].any() and ok.mean() > 0.9
    np.testing.assert_array_equal(got[2][:, ok], want[2][:, ok])
    np.testing.assert_array_equal(got[0][ok], want[0][ok])
    np.testing.assert_array_equal(got[1][ok], want[1][ok])


def test_patch_match_on_the_textured_plane(scene):
    """The whole PatchMatch: the port (its own generator) and colmap_tpu
    each meet tests/test_mvs.py's bounds on the textured plane."""
    K_, ref, srcs, Rs, ts = scene["raw"]
    fields = dict(ref_image=ref, src_images=np.stack(srcs), K_ref=K_.astype(np.float32),
                  K_src=np.stack([K_, K_]).astype(np.float32),
                  R_rel=np.stack(Rs).astype(np.float32), t_rel=np.stack(ts).astype(np.float32))
    jo, to = _options(num_iterations=6, window_radius=3)
    jp = J.PatchMatchProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = convert.patch_match_problem_from_numpy(fields, "cpu")
    ref_depth = scene["ref_depth"]
    b = 6
    numbers = {}
    for name, (depth, _, cost) in (
            ("colmap_tpu", J.patch_match(jp, jo, seed=1)),
            ("port", [x.numpy() for x in T.patch_match(tp, to, seed=1)])):
        err = np.abs(depth[b:-b, b:-b] - ref_depth[b:-b, b:-b]) / ref_depth[b:-b, b:-b]
        good = cost[b:-b, b:-b] < 0.3
        numbers[name] = (float(good.mean()), float(np.median(err[good])))
    msg = f"converged share, median relative depth error: {numbers}"
    for share, med in numbers.values():
        assert share > 0.5 and med < 0.02, msg


def test_patch_match_consistency_outputs(scene):
    """return_consistency gives the filtered maps and an (S, H, W) mask on
    the problem's device; filter_depth_map is colmap_tpu's."""
    K_, ref, srcs, Rs, ts = scene["raw"]
    fields = dict(ref_image=ref, src_images=np.stack(srcs), K_ref=K_, K_src=np.stack([K_, K_]),
                  R_rel=np.stack(Rs), t_rel=np.stack(ts))
    tp = convert.patch_match_problem_from_numpy(fields, "cpu", torch.float32)
    to = T.PatchMatchOptions(depth_min=2.0, depth_max=10.0, num_iterations=2)
    depth, normal, cost, mask = T.patch_match(tp, to, seed=3, return_consistency=True)
    assert depth.dtype == torch.float32 and mask.shape == (2, 48, 48) and mask.dtype == torch.bool
    assert torch.equal(depth > 0, mask.sum(0) >= to.filter_min_num_consistent)
    want = J.filter_depth_map(depth.numpy(), cost.numpy(), convert.convert_options(
        to, J.PatchMatchOptions))
    got = T.filter_depth_map(depth.numpy(), cost.numpy(), to)
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a, b_)
    bad = tp._replace(src_images=tp.src_images[:, :40])
    with pytest.raises(ValueError, match="reference's size"):
        T.patch_match(bad, to)


def _fusion_images(seed):
    """Three depth maps of the plane z = 4 seen from shifted cameras, with
    noise and holes (colmap_tpu's FusionImage)."""
    rng = np.random.default_rng(seed)
    size, f = 24, 30.0
    K_ = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1.0]])
    out = []
    for i, cx in enumerate((0.0, 0.3, -0.3)):
        d = (4.0 + 0.004 * rng.standard_normal((size, size))).astype(np.float32)
        d[rng.random((size, size)) < 0.1] = 0
        n = np.zeros((size, size, 3), np.float32)
        n[..., 2] = -1
        n[..., :2] = 0.05 * rng.standard_normal((size, size, 2))
        out.append(JF.FusionImage(i + 1, K_, np.eye(3), np.array([-cx, 0, 0]), d, n))
    return out


def test_fuse_depth_maps_matches(tmp_path):
    """The same points and normals within 1e-6, the same visibility lists,
    the same .vis bytes."""
    images = _fusion_images(3)
    jopts = JF.FusionOptions(max_normal_error_deg=5.0)
    want = JF.fuse_depth_maps(images, jopts)
    got = TF.fuse_depth_maps([convert.convert_fusion_image(fi) for fi in images],
                             convert.convert_options(jopts), device="cpu")
    assert len(want[0]) > 500
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert got[2].tolist() == want[2]
    JF.write_fused_vis(str(tmp_path / "j.vis"), want[2])
    TF.write_fused_vis(str(tmp_path / "t.vis"), got[2])
    TF.write_fused_vis(str(tmp_path / "l.vis"), want[2])  # a list of lists too
    data = (tmp_path / "j.vis").read_bytes()
    assert (tmp_path / "t.vis").read_bytes() == data == (tmp_path / "l.vis").read_bytes()
    assert [list(v) for v in TF.read_fused_vis(str(tmp_path / "t.vis"))] == want[2]
    assert TF.fuse_depth_maps([], device="cpu")[2].tolist() == []


@pytest.mark.parametrize("model", ["SIMPLE_RADIAL", "RADIAL", "OPENCV"])
def test_undistort_camera_and_image_match(model):
    """Both camera maps (cam_from_img of the pinhole, img_from_cam of the
    distorted model) and the bilinear warp at 64 x 48 within 1e-6; uint8
    images truncate as colmap_tpu's astype does."""
    from colmap_tpu.scene.types import Camera as JCamera
    from colmap_tpu.sensor.models import MODEL_NAME_TO_ID

    params = {"SIMPLE_RADIAL": [70.0, 32.0, 24.0, -0.08],
              "RADIAL": [70.0, 32.0, 24.0, -0.06, 0.01],
              "OPENCV": [70.0, 72.0, 32.5, 23.5, -0.05, 0.01, 0.001, -0.002]}[model]
    cam = JCamera(camera_id=1, model_id=MODEL_NAME_TO_ID[model], width=64, height=48,
                  params=np.array(params))
    jcam = JU.undistort_camera(cam)
    tcam = TU.undistort_camera(convert.convert_camera(cam), device="cpu")
    assert tcam.model_id == jcam.model_id and (tcam.width, tcam.height) == (64, 48)
    np.testing.assert_allclose(tcam.params, jcam.params, rtol=0, atol=1e-6)
    rng = np.random.default_rng(1)
    for img in (rng.uniform(0, 255, (48, 64)), rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)):
        want = JU.undistort_image(img, cam, jcam)
        got = TU.undistort_image(img, convert.convert_camera(cam), tcam, device="cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0,
                                   atol=1e-6 if img.dtype != np.uint8 else 0)


def test_map_and_graph_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    for name, arr in (("d", rng.random((24, 32)).astype(np.float32)),
                      ("n", rng.random((24, 32, 3)).astype(np.float32))):
        JD.write_map(str(tmp_path / f"{name}.j.bin"), arr)
        TD.write_map(str(tmp_path / f"{name}.t.bin"), arr)
        assert (tmp_path / f"{name}.j.bin").read_bytes() == (tmp_path / f"{name}.t.bin").read_bytes()
        np.testing.assert_array_equal(TD.read_map(str(tmp_path / f"{name}.j.bin")), arr)
    mask = rng.random((3, 20, 30)) < 0.3
    mask[:, 5] = False
    jg, tg = JCG.ConsistencyGraph.from_mask(mask, [7, 2, 5]), TCG.ConsistencyGraph.from_mask(
        mask, [7, 2, 5])
    jg.write(str(tmp_path / "g.j.bin"))
    tg.write(str(tmp_path / "g.t.bin"))
    assert (tmp_path / "g.j.bin").read_bytes() == (tmp_path / "g.t.bin").read_bytes()
    back = TCG.ConsistencyGraph.read(str(tmp_path / "g.j.bin"))
    for r, c in [(0, 0), (5, 3), (19, 29), (7, 11)]:
        np.testing.assert_array_equal(back.image_idxs(r, c), jg.image_idxs(r, c))
        np.testing.assert_array_equal(tg.image_idxs(r, c), jg.image_idxs(r, c))
    empty = TCG.ConsistencyGraph.from_mask(np.zeros((2, 4, 4), bool), [0, 1])
    assert len(empty.data) == 0 and len(empty.image_idxs(1, 1)) == 0


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_ply_files_are_byte_identical(tmp_path, binary):
    rng = np.random.default_rng(4)
    pts = (rng.standard_normal((50, 3)) * 3).astype(np.float32)
    nrm = rng.standard_normal((50, 3)).astype(np.float32)
    col = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    faces = rng.integers(0, 50, (30, 3))
    for args in ((pts,), (pts, nrm), (pts, None, col), (pts, nrm, col)):
        JPLY.write_ply(str(tmp_path / "j.ply"), *args, binary=binary)
        TPLY.write_ply(str(tmp_path / "t.ply"), *args, binary=binary)
        assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
        back = TPLY.read_ply(str(tmp_path / "t.ply"))
        np.testing.assert_allclose(back["points"], pts, atol=1e-5)
    for colors in (None, col):
        JPLY.write_ply_mesh(str(tmp_path / "j.ply"), pts, faces, colors, binary=binary)
        TPLY.write_ply_mesh(str(tmp_path / "t.ply"), pts, faces, colors, binary=binary)
        assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
        mesh = TPLY.read_ply_mesh(str(tmp_path / "t.ply"))
        np.testing.assert_array_equal(mesh["faces"], faces)


def test_lru_caches_match():
    for mod in (JC, TC):
        loads = []
        c = mod.LRUCache(2, lambda k: loads.append(k) or k * 10)
        assert c.get(1) == 10 and c.get(2) == 20 and c.get(1) == 10 and loads == [1, 2]
        c.get(3)
        assert not c.exists(2) and c.exists(1) and c.exists(3) and c.num_elems() == 2
        m = mod.MemoryConstrainedLRUCache(100, lambda k: np.zeros(k, np.uint8))
        m.get(60)
        m.get(30)
        m.get(50)  # 140 bytes: the oldest goes
        assert not m.exists(60) and m.exists(30) and m.exists(50) and m.num_bytes == 80
        m.evict(30)
        assert m.num_bytes == 50


def test_convert_round_trip():
    """Problem fields, options and fusion images cross intact."""
    case = C.plane_case(12, 16, 2, seed=1)
    p = convert.patch_match_problem_from_numpy(case.problem, "cpu", torch.float32)
    for k, v in case.problem.items():
        np.testing.assert_array_equal(getattr(p, k).numpy(), v.astype(np.float32))
    jo = J.PatchMatchOptions(window_radius=3, view_selection=False, filter_min_ncc=0.2)
    to = convert.convert_options(jo)
    assert isinstance(to, T.PatchMatchOptions)
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    assert dataclasses.asdict(convert.convert_options(to, J.PatchMatchOptions)) == \
        dataclasses.asdict(jo)
    fo = convert.convert_options(JF.FusionOptions(min_num_consistent=3))
    assert isinstance(fo, TF.FusionOptions) and fo.min_num_consistent == 3
    fi = _fusion_images(0)[1]
    back = convert.convert_fusion_image(convert.convert_fusion_image(fi), JF.FusionImage)
    for k in ("K", "R", "t", "depth", "normal"):
        np.testing.assert_array_equal(getattr(back, k), getattr(fi, k))
    assert back.image_id == fi.image_id


def test_select_problems_matches():
    recon, _, depth0 = _plane_workspace()
    want = [dataclasses.asdict(p) for p in
            __import__("colmap_tpu.mvs.workspace", fromlist=["x"]).select_patch_match_problems(
                recon, 2)]
    got = [dataclasses.asdict(p) for p in
           TW.select_patch_match_problems(convert.convert_reconstruction(recon), 2)]
    assert got == want and len(got) == 3
    assert all(p["depth_min"] < depth0 < p["depth_max"] for p in got)


def test_dense_cli_chain_on_the_plane_workspace(tmp_path):
    """image_undistorter -> patch_match_stereo --geom_consistency
    --write_consistency_graph -> stereo_fusion with --device cpu; colmap_tpu
    reads the maps, the graph and the cloud; the cloud lies on the plane."""
    from colmap_tpu.mvs.consistency_graph import ConsistencyGraph
    from colmap_tpu_torch.scene.reconstruction_io import write_model

    recon, images, depth0 = _plane_workspace()
    os.makedirs(tmp_path / "images")
    for iid, img in images.items():
        image_io.write_png(str(tmp_path / "images" / recon.images[iid].name),
                           (img * 255).astype(np.uint8))
    write_model(convert.convert_reconstruction(recon), str(tmp_path / "sparse"), fmt="bin")
    ws = str(tmp_path / "dense")
    assert tcli.main(["image_undistorter", "--image_path", str(tmp_path / "images"),
                      "--input_path", str(tmp_path / "sparse"), "--output_path", ws,
                      "--device", "cpu"]) == 3
    problems = tcli.main(["patch_match_stereo", "--workspace_path", ws, "--geom_consistency",
                          "--write_consistency_graph", "--device", "cpu"])
    assert len(problems) == 3
    out = str(tmp_path / "fused.ply")
    pts, _, vis = tcli.main(["stereo_fusion", "--workspace_path", ws, "--output_path", out,
                             "--device", "cpu"])
    d = JD.read_map(os.path.join(ws, "stereo", "depth_maps", "v0.png.geometric.bin"))
    interior = d[6:-6, 6:-6]
    good = interior[interior > 0]
    assert len(good) > 0.4 * interior.size
    assert abs(np.median(good) - depth0) / depth0 < 0.03
    graph = ConsistencyGraph.read(
        os.path.join(ws, "stereo", "consistency_graphs", "v0.png.geometric.bin"))
    assert graph.width == 48 and len(graph.data) > 0
    cloud = JPLY.read_ply(out)
    assert len(cloud["points"]) == len(pts) > 200 and len(vis) == len(pts)
    assert abs(np.median(cloud["points"][:, 2]) - depth0) / depth0 < 0.03
    assert len(JF.read_fused_vis(out + ".vis")) == len(pts)


@pytest.mark.parametrize("command", [
    ["image_undistorter", "--image_path", "i", "--input_path", "s", "--output_path", "o"],
    ["patch_match_stereo", "--workspace_path", "w"],
    ["stereo_fusion", "--workspace_path", "w", "--output_path", "o"]])
def test_dense_commands_default_to_cuda(command):
    """Without --device the dense commands ask for the card, and raise here
    where there is none (``image_undistorter`` with each output type)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(command)
    if command[0] == "image_undistorter":
        for output_type in ("PMVS", "CMP-MVS"):
            with pytest.raises(RuntimeError, match="CUDA"):
                tcli.main(command + ["--output_type", output_type])
