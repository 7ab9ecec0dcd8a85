"""colmap_tpu_torch's MVS tools against colmap_tpu on the CPU: texturing,
stereo rectification, the PMVS / CMP-MVS exports and the seven meshing and
MVS-tool commands (``--device cpu``).

Texturing runs in float64 on both sides: the same labels, uvs within
1e-12, the atlas within 1 count (a texel's colour is truncated to uint8).
Rectification: H1, H2 and Q within 1e-12 (the same float64 numpy), the
warped image within 1e-4 (float) or 1 count (uint8; the camera maps of the
two packages round differently). The exports: the same file tree, the
text files byte for byte, the JPEGs byte for byte where the undistorted
images agree.
"""

import os

import numpy as np
import pytest
import torch

from colmap_tpu.cli.main import main as ref_main
from colmap_tpu.image import rectification as RR
from colmap_tpu.mvs import meshing as RM
from colmap_tpu.mvs import simplification as RS
from colmap_tpu.mvs import texturing as RT
from colmap_tpu.scene.types import Camera as RCamera
from colmap_tpu.scene.types import Pose as RPose

from colmap_tpu_torch.cli.main import main as port_main
from colmap_tpu_torch.image import rectification as PR
from colmap_tpu_torch.kernels import meshing_cases as C
from colmap_tpu_torch.mvs import texturing as PT
from colmap_tpu_torch.scene.types import Camera, Pose
from colmap_tpu_torch.utils.ply import read_ply_mesh, write_ply, write_ply_mesh


def _reference_simplifier():
    """colmap_tpu builds its simplifier into the temp directory with no lock;
    build it once under a file lock, as test workers run in parallel, and
    require that it built (its fallback is vertex clustering)."""
    import fcntl
    import tempfile

    with open(os.path.join(tempfile.gettempdir(), "colmap_tpu_native.lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        assert RS._load() is not None


def _look_at(C_):
    z = -C_ / np.linalg.norm(C_)
    up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return R, -R @ C_


def _tex_scene(seed=0, n_views=6, w=160, h=120):
    """A ~200-face sphere mesh, n_views cameras around it and random images."""
    pts, nrm = C.sphere(3000, seed=seed)
    v, f, _ = RM.poisson_mesh(pts, nrm, options=RM.PoissonMeshingOptions(depth=4, trim=3))
    v, f = RS._cluster_simplify(v.astype(np.float64), f.astype(np.int64), 100)
    rng = np.random.default_rng(seed)
    centers = np.array([[3, 0.2, 0.1], [-3, 0.1, 0.3], [0.2, 3, 0.1], [0.1, -3, 0.2],
                        [0.2, 0.3, 3], [0.1, 0.2, -3]], dtype=float)[:n_views]
    K = np.array([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]])
    views, images = [], {}
    for i, c in enumerate(centers):
        R, t = _look_at(c)
        views.append({"K": K, "R": R, "t": t, "width": w, "height": h, "image_key": i + 1})
        images[i + 1] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return v, f, views, images


def test_select_views_and_smooth_labels_match_reference():
    v, f, views, _ = _tex_scene()
    assert 100 <= len(f) <= 200
    lr, qr = RT.select_views(v.astype(np.float64), f, views)
    lp, qp = PT.select_views(v, f, views, device="cpu")
    np.testing.assert_array_equal(lp.numpy(), lr)
    np.testing.assert_allclose(qp.numpy(), qr, rtol=1e-12, atol=1e-12)
    assert (lr >= 0).mean() > 0.9
    np.testing.assert_array_equal(
        PT.smooth_labels(f, lp, qp, 2, device="cpu").numpy(), RT.smooth_labels(f, lr, qr, 2))
    # Labels and qualities that make the relabel rules decide: -1 labels
    # (read as the last view), ties in the majority, the 0.7 ratio.
    rng = np.random.default_rng(3)
    q = rng.uniform(0.1, 1.0, qr.shape)
    q[rng.uniform(size=q.shape) < 0.2] = -np.inf
    lab = rng.integers(-1, len(views), len(f))
    for it in (1, 3):
        np.testing.assert_array_equal(
            PT.smooth_labels(f, lab, q, it, device="cpu").numpy(), RT.smooth_labels(f, lab, q, it))


@pytest.mark.parametrize("max_atlas,patch", [(4096, 16), (32, 16)], ids=["atlas", "overflow"])
def test_texture_mesh_matches_reference(max_atlas, patch):
    v, f, views, images = _tex_scene()
    del images[3]  # a view without its image leaves its faces grey
    ar, ur, lr = RT.texture_mesh(v.astype(np.float64), f, views, images,
                                 RT.TextureMappingOptions(patch_size=patch,
                                                          max_atlas_size=max_atlas))
    a, u, lab = PT.texture_mesh(v, f, views, images,
                                PT.TextureMappingOptions(patch_size=patch,
                                                         max_atlas_size=max_atlas),
                                device="cpu")
    np.testing.assert_array_equal(lab, lr)
    np.testing.assert_allclose(u, ur, rtol=0, atol=1e-12)
    assert a.shape == ar.shape and a.dtype == np.uint8
    assert np.abs(a.astype(int) - ar.astype(int)).max() <= 1
    assert (a != 128).any()


def test_write_obj_matches_reference(tmp_path):
    from PIL import Image

    v, f, views, images = _tex_scene()
    atlas, uvs, _ = RT.texture_mesh(v.astype(np.float64), f, views, images)
    RT.write_obj(str(tmp_path / "ref.obj"), v, f, uvs, atlas)
    PT.write_obj(str(tmp_path / "port.obj"), v, f, uvs, atlas)
    ref = open(tmp_path / "ref.obj").read().replace("ref.mtl", "port.mtl")
    assert open(tmp_path / "port.obj").read() == ref
    assert open(tmp_path / "port.mtl").read() == open(tmp_path / "ref.mtl").read().replace(
        "ref.png", "port.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), atlas)


def _stereo(model_id=1, params=(500.0, 500.0, 320.0, 240.0), angle=0.05,
            t=(-1.0, 0.05, 0.02), w=64, h=48):
    q = np.array([np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0])
    mk = lambda cls, cid, p: cls(cid, model_id, w, h, np.array(p))  # noqa: E731
    return ((mk(RCamera, 1, params), mk(RCamera, 2, params), RPose(q, np.array(t))),
            (mk(Camera, 1, params), mk(Camera, 2, params), Pose(q, np.array(t))))


@pytest.mark.parametrize("angle,t", [(0.05, (-1.0, 0.05, 0.02)), (0.0, (0.8, 0.0, 0.0)),
                                     (0.3, (0.1, -0.7, 0.2))])
def test_rectify_stereo_cameras_matches_reference(angle, t):
    ref, port = _stereo(angle=angle, t=t)
    for a, b in zip(PR.rectify_stereo_cameras(*port), RR.rectify_stereo_cameras(*ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_rectify_and_undistort_matches_reference():
    ref, port = _stereo(model_id=2, params=(60.0, 32.0, 24.0, -0.05))
    rng = np.random.default_rng(2)
    img1 = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    img2 = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    r1, r2, cam_r, Q_r = RR.rectify_and_undistort_stereo_images(img1, img2, *ref)
    p1, p2, cam_p, Q_p = PR.rectify_and_undistort_stereo_images(img1, img2, *port, device="cpu")
    np.testing.assert_allclose(Q_p, Q_r, rtol=0, atol=1e-12)
    np.testing.assert_allclose(cam_p.params, cam_r.params, rtol=1e-12)
    for a, b in ((p1, r1), (p2, r2)):
        assert a.dtype == np.uint8 and a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    H1 = RR.rectify_stereo_cameras(cam_r, cam_r, ref[2])[0]
    f = rng.uniform(0, 1, (48, 64))
    wr = RR.warp_image_with_homography_between_cameras(f, H1, ref[0], cam_r)
    wp = PR.warp_image_with_homography_between_cameras(f, H1, port[0], cam_p, device="cpu")
    np.testing.assert_allclose(wp, wr, rtol=0, atol=1e-4)


def _export_scene(root):
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset
    from colmap_tpu_torch.scene.synthetic_images import render_images

    gt = synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=4, num_points3D=60, seed=5, camera_model_id=1,
        camera_params=(90.0, 90.0, 40.0, 30.0), camera_width=80, camera_height=60), None)
    write_model(gt, os.path.join(root, "sparse"), fmt="bin")
    render_images(gt, os.path.join(root, "images"), patch_world=0.3)
    return gt


def _tree(path):
    out = {}
    for r, _, names in os.walk(path):
        for n in names:
            with open(os.path.join(r, n), "rb") as fh:
                out[os.path.relpath(os.path.join(r, n), path)] = fh.read()
    return out


@pytest.mark.parametrize("output_type", ["PMVS", "CMP-MVS"])
def test_pmvs_and_cmp_mvs_exports_match_reference(tmp_path, monkeypatch, output_type):
    """The port's undistorted images within 1 count of colmap_tpu's; given
    colmap_tpu's undistorted images, the same file tree byte for byte."""
    from colmap_tpu.image import undistortion as RU

    from colmap_tpu_torch.cli import export as PE
    from colmap_tpu_torch.image import undistortion as PU

    gt = _export_scene(str(tmp_path))
    args = ["image_undistorter", "--image_path", str(tmp_path / "images"), "--input_path",
            str(tmp_path / "sparse"), "--output_type", output_type]
    ref_main(args + ["--output_path", str(tmp_path / "ref")])
    n = port_main(args + ["--output_path", str(tmp_path / "port"), "--device", "cpu"])
    assert n == len(gt.reg_image_ids()) == 4
    ref, port = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    assert len([k for k in ref if k.endswith(".jpg")]) == 4
    for k in ref:
        if not k.endswith(".jpg"):
            assert port[k] == ref[k], k

    def ref_undistort(img, cam, ucam, device):
        as_ref = lambda c: RCamera(c.camera_id, c.model_id, c.width, c.height, c.params)  # noqa
        got = PU.undistort_image(img, cam, ucam, device=device)
        want = RU.undistort_image(img, as_ref(cam), as_ref(ucam))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        return want

    monkeypatch.setattr(PE, "undistort_image", ref_undistort)
    port_main(args + ["--output_path", str(tmp_path / "port2"), "--device", "cpu"])
    assert _tree(tmp_path / "port2") == ref


def _write_sphere_ply(path, n=1500, seed=3):
    pts, nrm = C.sphere(n, seed=seed)
    write_ply(path, pts, nrm, (np.abs(nrm) * 255).astype(np.uint8))
    return pts, nrm


def test_poisson_and_advancing_front_commands_match_reference(tmp_path):
    from scipy.spatial import cKDTree

    inp = str(tmp_path / "fused.ply")
    _write_sphere_ply(inp)
    for cmd, extra in (("poisson_mesher", ["--depth", "5"]),
                       ("advancing_front_mesher", ["--radius_ratio_bound", "4"])):
        args = [cmd, "--input_path", inp] + extra
        ref_main(args + ["--output_path", str(tmp_path / f"{cmd}_ref.ply")])
        v, f = port_main(args + ["--output_path", str(tmp_path / f"{cmd}.ply"),
                                 "--device", "cpu"])[:2]
        r = read_ply_mesh(str(tmp_path / f"{cmd}_ref.ply"))
        p = read_ply_mesh(str(tmp_path / f"{cmd}.ply"))
        if cmd == "poisson_mesher":
            assert abs(len(p["vertices"]) - len(r["vertices"])) <= 0.01 * len(r["vertices"])
            assert cKDTree(r["vertices"]).query(p["vertices"])[0].max() <= 1e-3
            assert p["colors"].shape == (len(p["vertices"]), 3)
        else:
            for key in ("vertices", "faces", "colors"):
                np.testing.assert_array_equal(p[key], r[key])


def test_delaunay_and_simplifier_commands_match_reference(tmp_path):
    from colmap_tpu_torch.mvs.fusion import write_fused_vis
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.scene.types import Frame, Image, Rig
    from colmap_tpu_torch.utils.types import SensorType

    ws = tmp_path / "ws"
    os.makedirs(ws)
    pts, _ = _write_sphere_ply(str(ws / "fused.ply"), 400)
    recon = Reconstruction()
    recon.add_camera(Camera(1, 1, 100, 100, np.array([80.0, 80.0, 50.0, 50.0])))
    centers = {}
    for i, c in enumerate([[4, 0, 0], [-4, 0, 0], [0, 4, 0], [0, -4, 0], [0, 0, 4]]):
        iid = i + 1
        R, t = _look_at(np.asarray(c, dtype=float))
        from colmap_tpu_torch.geometry.rotation import rotmat_to_quat

        recon.add_rig(Rig(rig_id=iid, ref_sensor_id=(int(SensorType.CAMERA), 1)))
        recon.add_frame(Frame(frame_id=iid, rig_id=iid,
                              rig_from_world=Pose(rotmat_to_quat(torch.from_numpy(R)).numpy(), t),
                              data_ids=[(int(SensorType.CAMERA), 1, iid)]))
        recon.add_image(Image(image_id=iid, name=f"v{iid}.png", camera_id=1, frame_id=iid))
        recon.register_frame(iid)
        centers[iid] = np.asarray(c, dtype=float)
    write_model(recon, str(ws / "sparse"), fmt="bin")
    write_fused_vis(str(ws / "fused.ply.vis"), C.visibility(pts, centers))
    args = ["delaunay_mesher", "--input_path", str(ws), "--quality_regularization", "0.5"]
    ref_main(args + ["--output_path", str(tmp_path / "d_ref.ply")])
    port_main(args + ["--output_path", str(tmp_path / "d.ply"), "--device", "cpu"])
    r, p = read_ply_mesh(str(tmp_path / "d_ref.ply")), read_ply_mesh(str(tmp_path / "d.ply"))
    assert len(r["faces"]) > 200
    np.testing.assert_array_equal(p["faces"], r["faces"])
    np.testing.assert_array_equal(p["vertices"], r["vertices"])

    v, f = _tex_scene()[:2]
    write_ply_mesh(str(tmp_path / "m.ply"), v, f)
    _reference_simplifier()
    args = ["mesh_simplifier", "--input_path", str(tmp_path / "m.ply"), "--factor", "0.3"]
    ref_main(args + ["--output_path", str(tmp_path / "s_ref.ply")])
    port_main(args + ["--output_path", str(tmp_path / "s.ply"), "--device", "cpu"])
    assert _tree(tmp_path)["s.ply"] == _tree(tmp_path)["s_ref.ply"]


def test_texturer_rectifier_and_standalone_undistorter_match_reference(tmp_path):
    from PIL import Image as PILImage

    gt = _export_scene(str(tmp_path))
    imgs = str(tmp_path / "images")
    # mesh_texturer on a small mesh in front of the cameras.
    v, f = _tex_scene()[:2]
    centroid = np.mean([p.xyz for p in gt.points3D.values()], axis=0)
    write_ply_mesh(str(tmp_path / "m.ply"), v * 0.5 + centroid, f)
    args = ["mesh_texturer", "--input_path", str(tmp_path / "m.ply"), "--sparse_path",
            str(tmp_path / "sparse"), "--image_path", imgs, "--patch_size", "8"]
    ref_main(args + ["--output_path", str(tmp_path / "t_ref.obj")])
    atlas, _, labels = port_main(args + ["--output_path", str(tmp_path / "t.obj"),
                                         "--device", "cpu"])
    assert (labels >= 0).any()
    assert (open(tmp_path / "t.obj").read()
            == open(tmp_path / "t_ref.obj").read().replace("t_ref.", "t."))
    ref_atlas = np.asarray(PILImage.open(tmp_path / "t_ref.png"))
    assert np.abs(np.asarray(PILImage.open(tmp_path / "t.png")).astype(int)
                  - ref_atlas.astype(int)).max() <= 1

    names = sorted(os.listdir(imgs))
    with open(tmp_path / "pairs.txt", "w") as fh:
        fh.write(f"{names[0]} {names[1]}\n{names[2]} missing.png\n")
    args = ["image_rectifier", "--image_path", imgs, "--input_path", str(tmp_path / "sparse"),
            "--stereo_pairs_list", str(tmp_path / "pairs.txt")]
    ref_main(args + ["--output_path", str(tmp_path / "rect_ref")])
    assert port_main(args + ["--output_path", str(tmp_path / "rect"), "--device", "cpu"]) == 1
    ref, port = _tree(tmp_path / "rect_ref"), _tree(tmp_path / "rect")
    assert sorted(port) == sorted(ref) and len(ref) == 3
    for k in ref:
        if k.endswith("Q.txt"):
            assert port[k] == ref[k]
        else:
            a = np.asarray(PILImage.open(tmp_path / "rect" / k)).astype(int)
            b = np.asarray(PILImage.open(tmp_path / "rect_ref" / k)).astype(int)
            assert np.abs(a - b).max() <= 1 and (a == b).mean() > 0.99

    with open(tmp_path / "list.txt", "w") as fh:
        fh.write(f"{names[0]} SIMPLE_RADIAL 90 40 30 -0.08\n{names[1]} PINHOLE 90 90 40 30\n")
    args = ["image_undistorter_standalone", "--image_path", imgs, "--input_file",
            str(tmp_path / "list.txt")]
    ref_main(args + ["--output_path", str(tmp_path / "und_ref")])
    assert port_main(args + ["--output_path", str(tmp_path / "und"), "--device", "cpu"]) == 2
    for n in names[:2]:
        a = np.asarray(PILImage.open(tmp_path / "und" / n)).astype(int)
        b = np.asarray(PILImage.open(tmp_path / "und_ref" / n)).astype(int)
        assert np.abs(a - b).max() <= 1 and (a == b).mean() > 0.99
