"""colmap_tpu_torch's line detector, coordinate frames and gravity
refinement against colmap_tpu on the CPU.

K49's plain version (kernels/lines.py) against colmap_tpu's jitted
``_gradients`` in float32 on images of gray levels: magnitudes within
1e-6 relative, angles within 1e-6 rad modulo pi. The angles differ from
XLA's in the last bits (XLA's float32 atan2 is its own approximation), and
a pixel whose angle lies within a few ulps of an edge of the orientation
bins can fall into the neighbouring bin (ROADMAP §3): the tests show that
every pixel whose bin differs is such a pixel, and that the detector's host
part (the grouping of pixels by label once, instead of a scan of the label
image per component), fed colmap_tpu's gradients, gives colmap_tpu's
segments: the same count and endpoints within 1e-4 px. Fed those gradients
too, the Manhattan frame equals colmap_tpu's within 1e-9; end to end, both
frames meet colmap_tpu's test gate (0.99 dots). The vanishing point,
gravity from image orientation, the principal-plane, ENU and
orientation-frame alignments and gravity refinement agree with
colmap_tpu's within 1e-9 (host float64 on both sides), and
``model_orientation_aligner`` writes the same model as colmap_tpu's
command with IMAGE-ORIENTATION, PRINCIPAL-PLANE and ENU; with
MANHATTAN-WORLD both models' frames meet the gate.
"""

import numpy as np
import pytest
import torch

from colmap_tpu.cli.main import main as ref_main
from colmap_tpu.estimators import coordinate_frame as RCF
from colmap_tpu.estimators import gravity_refinement as RGR
from colmap_tpu.image import lines as RL
from colmap_tpu.scene.reconstruction_io import read_model as ref_read_model
from colmap_tpu.scene.reconstruction_io import write_model as ref_write_model
from colmap_tpu.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

from colmap_tpu_torch.cli.main import main as port_main
from colmap_tpu_torch.convert import convert_reconstruction
from colmap_tpu_torch.estimators import coordinate_frame as PCF
from colmap_tpu_torch.estimators import gravity_refinement as PGR
from colmap_tpu_torch.image import lines as PL
from colmap_tpu_torch.kernels import lines as KL
from colmap_tpu_torch.scene.reconstruction_io import read_model as port_read_model
from colmap_tpu_torch.utils.image_io import write_png
from test_coordinate_frame import _draw_segment, _manhattan_scene


def _line_image(seed=0, size=(200, 240)):
    img = np.zeros(size, dtype=np.float32)
    rng = np.random.default_rng(seed)
    for _ in range(8):
        p0 = rng.uniform(10, min(size) - 10, 2)
        p1 = rng.uniform(10, min(size) - 10, 2)
        _draw_segment(img, p0, p1, value=float(rng.integers(120, 256)))
    return img


def _images():
    # Gray levels, as the detector's images hold (the Scharr sums of integer
    # levels are exact in float32 in any order).
    noise = np.random.default_rng(4).integers(0, 256, (61, 83)).astype(np.float32)
    return [_line_image(0), _line_image(1), noise]


@pytest.mark.parametrize("which", range(3))
def test_line_gradients_plain_matches_colmap_tpu(which):
    img = _images()[which]
    mag_r, ang_r = (np.asarray(a, dtype=np.float64) for a in RL._gradients(img))
    mag, ang = (a.double().numpy() for a in KL.line_gradients_plain(torch.from_numpy(img)))
    assert mag.dtype == np.float64 and mag.shape == img.shape
    strong = mag_r > 0
    assert np.abs(mag - mag_r)[strong].max() <= 1e-6 * mag_r[strong].max()
    d = np.remainder(ang - ang_r + np.pi / 2, np.pi) - np.pi / 2
    assert np.abs(d[strong]).max() <= 1e-6


def _bin_edge_distance(angle, nbins=8):
    """Distance of angle (float32) to the nearest edge of either binning,
    in bin units."""
    a = angle.astype(np.float64) / np.pi * nbins
    b = a + 0.5
    return np.minimum(np.abs(a - np.round(a)), np.abs(b - np.round(b)))


@pytest.mark.parametrize("seed,min_length", [(0, 20.0), (1, 40.0), (2, 3.0)])
def test_detect_line_segments_matches_colmap_tpu(seed, min_length):
    img = _line_image(seed)
    ref = RL.detect_line_segments(img, min_length)
    mag_r, ang_r = (np.asarray(a) for a in RL._gradients(img))
    got = PL.segments_from_gradients(mag_r, ang_r, min_length)
    assert len(got) == len(ref) > 2
    for a, b in zip(got, ref):
        assert np.abs(a.start - b.start).max() <= 1e-4 and np.abs(a.end - b.end).max() <= 1e-4
    assert [int(o) for o in PL.classify_line_segment_orientations(got, 0.2)] == \
        [int(o) for o in RL.classify_line_segment_orientations(ref, 0.2)]
    # End to end, a pixel changes bin only at a bin edge.
    mag, ang = PL.image_gradients(img, "cpu")
    nb = lambda a: np.minimum((a / np.pi * 8).astype(np.int32), 7)  # noqa: E731
    sh = lambda a: np.minimum((((a + np.pi / 16) % np.pi) / np.pi * 8).astype(np.int32), 7)  # noqa
    moved = ((nb(ang) != nb(ang_r)) | (sh(ang) != sh(ang_r))) & (mag_r >= 5.0)
    assert np.array_equal(mag >= 5.0, mag_r >= 5.0)
    assert (_bin_edge_distance(ang_r[moved]) < 1e-5).all()
    assert len(PL.detect_line_segments(img, min_length, device="cpu")) > 2


def test_deduplication_matches_colmap_tpus_loop():
    """The vectorized de-duplication against colmap_tpu's loop (lines.py:153-
    167, copied here as the oracle) on segments with planted near-copies."""
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 300, (150, 2, 2))
    copies = base[rng.integers(0, 150, 200)] + rng.normal(0, 1.2, (200, 2, 2))
    flips = rng.random(200) < 0.5
    copies[flips] = copies[flips][:, ::-1]
    segs = [PL.LineSegment(a.copy(), b.copy()) for a, b in np.concatenate([base, copies])]
    kept = []
    for seg in sorted(segs, key=lambda s: -s.length):
        if not any((np.linalg.norm(seg.start - o.start) < 2.0
                    and np.linalg.norm(seg.end - o.end) < 2.0)
                   or (np.linalg.norm(seg.start - o.end) < 2.0
                       and np.linalg.norm(seg.end - o.start) < 2.0) for o in kept):
            kept.append(seg)
    got = PL._deduplicate(segs)
    assert [id(s) for s in got] == [id(s) for s in kept] and 150 <= len(got) < 350


def test_vanishing_point_matches_colmap_tpu():
    rng = np.random.default_rng(3)
    vp = np.array([400.0, 120.0])
    segs_r, segs_p = [], []
    for _ in range(30):
        a = rng.uniform(0, 200, 2)
        b = a + 0.3 * (vp - a) + rng.normal(0, 0.2, 2)
        segs_r.append(RL.LineSegment(a, b))
        segs_p.append(PL.LineSegment(a.copy(), b.copy()))
    for _ in range(10):
        a, b = rng.uniform(0, 200, (2, 2))
        segs_r.append(RL.LineSegment(a, b))
        segs_p.append(PL.LineSegment(a.copy(), b.copy()))
    vr, mr = RCF.estimate_vanishing_point(segs_r)
    vp_, mp = PCF.estimate_vanishing_point(segs_p)
    np.testing.assert_allclose(vp_, vr, rtol=1e-9, atol=1e-12)
    assert np.array_equal(mp, mr) and mp[:30].mean() > 0.9


def _gate(frame):
    assert abs(abs(np.linalg.det(frame)) - 1.0) < 1e-6
    assert abs(frame[:, 0] @ np.array([1.0, 0, 0])) > 0.99
    assert abs(frame[:, 1] @ np.array([0.0, 1, 0])) > 0.99


def test_manhattan_frame_matches_colmap_tpu(monkeypatch):
    recon, images = _manhattan_scene([0.0, 8.0, -8.0])
    opts_r = RCF.ManhattanWorldFrameOptions(min_line_length=30.0)
    frame_r = RCF.estimate_manhattan_world_frame(recon, images, opts_r)
    port = convert_reconstruction(recon)
    opts = PCF.ManhattanWorldFrameOptions(min_line_length=30.0)
    frame = PCF.estimate_manhattan_world_frame(port, images, opts, device="cpu")
    _gate(frame_r)
    _gate(frame)
    monkeypatch.setattr(PL, "image_gradients",
                        lambda img, device=None: tuple(np.asarray(a) for a in RL._gradients(img)))
    frame_same = PCF.estimate_manhattan_world_frame(port, images, opts, device="cpu")
    np.testing.assert_allclose(frame_same, frame_r, atol=1e-9)


def _model(seed, frames, points):
    return synthesize_dataset(SyntheticDatasetOptions(num_rigs=1, num_frames_per_rig=frames,
                                                      num_points3D=points, seed=seed))


def _same_model(a, b, tol=1e-9):
    assert sorted(a.reg_image_ids()) == sorted(b.reg_image_ids())
    for iid in a.reg_image_ids():
        pa, pb = a.cam_from_world(iid), b.cam_from_world(iid)
        assert np.abs(pa.rotmat() - pb.rotmat()).max() <= tol
        assert np.abs(pa.t - pb.t).max() <= tol * max(1.0, np.abs(pb.t).max())
    assert sorted(a.points3D) == sorted(b.points3D)
    for pid, p in a.points3D.items():
        assert np.abs(p.xyz - b.points3D[pid].xyz).max() <= tol * max(1.0, np.abs(p.xyz).max())


def test_gravity_and_alignments_match_colmap_tpu():
    from colmap_tpu.geometry.gps import ellipsoid_to_ecef

    recon = _model(1, 6, 30)
    g_r = RCF.estimate_gravity_from_image_orientation(recon, 0.05)
    g = PCF.estimate_gravity_from_image_orientation(convert_reconstruction(recon), 0.05)
    np.testing.assert_allclose(g, g_r, atol=1e-12)
    # Principal plane on a squashed cloud.
    recon = _model(4, 5, 60)
    n = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    for p in recon.points3D.values():
        p.xyz = p.xyz - (p.xyz @ n) * n
    port = convert_reconstruction(recon)
    s_r, q_r, t_r = RCF.align_to_principal_plane(recon)
    s, q, t = PCF.align_to_principal_plane(port)
    np.testing.assert_allclose(q, q_r, atol=1e-12)
    np.testing.assert_allclose(t, t_r, atol=1e-12)
    _same_model(port, recon)
    # ENU at an ECEF location.
    recon = _model(6, 4, 40)
    recon.transform(1.0, np.array([1.0, 0, 0, 0]),
                    np.asarray(ellipsoid_to_ecef(47.37, 8.54, 400.0)).reshape(3))
    port = convert_reconstruction(recon)
    s_r, q_r, t_r = RCF.align_to_enu_plane(recon)
    s, q, t = PCF.align_to_enu_plane(port)
    np.testing.assert_allclose(q, q_r, atol=1e-12)
    np.testing.assert_allclose(t, t_r, rtol=1e-12, atol=1e-6)
    _same_model(port, recon, tol=1e-9)
    # An estimated frame's inverse.
    recon = _model(2, 4, 20)
    port = convert_reconstruction(recon)
    frame, _ = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))
    frame *= np.sign(np.linalg.det(frame))
    _, q_r, _ = RCF.align_to_orientation_frame(recon, frame)
    _, q, _ = PCF.align_to_orientation_frame(port, frame)
    np.testing.assert_allclose(q, q_r, atol=1e-12)
    _same_model(port, recon)


def test_gravity_refinement_matches_colmap_tpu():
    from colmap_tpu.scene.types import Pose
    from colmap_tpu.utils.types import image_pair_to_pair_id

    rng = np.random.default_rng(0)
    n = 10
    g_world = np.array([0.0, 1.0, 0.0])
    Rs = []
    for _ in range(n):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.1, 0.5)
        Rs.append(Pose(np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis]),
                       np.zeros(3)).rotmat())
    gravities = {i: Rs[i] @ g_world for i in range(n)}
    bad = np.array([1.0, 0.2, 0.1])
    gravities[3] = bad / np.linalg.norm(bad)
    rel = {image_pair_to_pair_id(i, j): Rs[j] @ Rs[i].T for i in range(n) for j in range(i + 1, n)}
    frames = {i: i for i in range(n)}
    opts_r, opts = RGR.GravityRefinerOptions(min_num_neighbors=5), \
        PGR.GravityRefinerOptions(min_num_neighbors=5)
    assert PGR.identify_error_prone_gravity(rel, frames, gravities, opts) == \
        RGR.identify_error_prone_gravity(rel, frames, gravities, opts_r) == {3}
    ref = RGR.refine_gravity(rel, frames, gravities, opts_r)
    got = PGR.refine_gravity(rel, frames, gravities, opts)
    assert set(got) == set(ref) == {3}
    np.testing.assert_allclose(got[3], ref[3], atol=1e-12)
    np.testing.assert_allclose(PGR.gravity_aligned_rotation(bad),
                               RGR.gravity_aligned_rotation(bad), atol=1e-15)


@pytest.mark.parametrize("method", ["MANHATTAN-WORLD", "IMAGE-ORIENTATION", "PRINCIPAL-PLANE",
                                    "ENU"])
def test_model_orientation_aligner_matches_colmap_tpu(method, tmp_path):
    from colmap_tpu.geometry.gps import ellipsoid_to_ecef

    if method == "MANHATTAN-WORLD":
        recon, images = _manhattan_scene([0.0, 6.0, -6.0])
        img_dir = tmp_path / "images"
        img_dir.mkdir()
        for iid, canvas in images.items():
            write_png(str(img_dir / recon.images[iid].name), canvas.astype(np.uint8))
        extra = ["--image_path", str(img_dir)]
    else:
        recon, extra = _model(9, 5, 50), []
        if method == "ENU":
            recon.transform(1.0, np.array([1.0, 0, 0, 0]),
                            np.asarray(ellipsoid_to_ecef(47.37, 8.54, 400.0)).reshape(3))
    src = str(tmp_path / "src")
    ref_write_model(recon, src, fmt="bin")
    args = ["model_orientation_aligner", "--input_path", src, "--method", method, *extra]
    ref_main(args + ["--output_path", str(tmp_path / "ref")])
    port_main(args + ["--output_path", str(tmp_path / "port"), "--device", "cpu"])
    ref, got = ref_read_model(str(tmp_path / "ref")), port_read_model(str(tmp_path / "port"))
    if method != "MANHATTAN-WORLD":
        _same_model(got, ref, tol=1e-9)
        return
    # The aligned world's X and Y are the Manhattan frame's rightward and
    # downward axes: the source world's X and Y within the gate's 0.99 dot.
    for model in (got, ref):
        assert sorted(model.reg_image_ids()) == sorted(recon.reg_image_ids())
        iid = model.reg_image_ids()[0]
        frame = recon.cam_from_world(iid).rotmat().T @ model.cam_from_world(iid).rotmat()
        _gate(frame)
