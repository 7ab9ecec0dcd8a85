"""colmap_tpu and the port on the 360-degree matcher database with keypoint noise.

chip_smoke.py's 360-degree matcher phase writes its database with
``spherical_cases.write_database`` (24 EQUIRECTANGULAR frames of 5760 x
2880, 8192 points, seed 9, 3% planted outliers). This script takes eight of
its 276 pairs, among them the rotation-only pair 1-2, and verifies them on
the CPU twice: with colmap_tpu's estimate_two_view_geometry (JAX, float64,
pose recovery on) and with the port's block verifier (float64) followed by
``recover_spherical_pose``. For each pair it prints both configurations, the
relative rotation's error and the planted outlier matches among the inliers,
then the share of planted outliers kept over the eight pairs by each.

    JAX_PLATFORMS=cpu python tests/spherical_noise_witness.py [noise_px]

(noise_px 0.25 by default; a few minutes on two CPU cores).
"""

import os
import sys
import tempfile

import numpy as np

PAIRS = [(1, 2), (1, 3), (3, 4), (10, 11), (5, 17), (2, 14), (20, 21), (7, 19)]


def main(noise_px: float = 0.25) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    import torch
    from colmap_tpu.estimators import two_view_geometry as jtvg
    from colmap_tpu.scene.types import Camera as JCamera
    from colmap_tpu_torch.estimators.spherical import recover_spherical_pose
    from colmap_tpu_torch.estimators.two_view_batch import estimate_two_view_geometries_batched
    from colmap_tpu_torch.estimators.two_view_geometry import TwoViewGeometryOptions
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.kernels import spherical_cases as Q
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import TwoViewGeometryConfig as CFG

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pano.db")
        poses, outliers = Q.write_database(path, 24, 8192, seed=9, noise_px=noise_px)
        db = Database(path, must_exist=True)
        cam = db.read_camera(1)
        kps = {i: db.read_keypoints(i)[:, :2].astype(np.float64) for i in range(1, 25)}
        db.close()
    matches = np.stack([np.arange(8192)] * 2, 1).astype(np.uint32)
    jcam = JCamera.create(1, int(Q.EQUIRECT), 0.0, Q.WIDTH, Q.HEIGHT)
    ours = estimate_two_view_geometries_batched(
        [(cam, kps[a], cam, kps[b], matches) for a, b in PAIRS], TwoViewGeometryOptions(),
        device="cpu")
    kept = {"colmap_tpu": 0, "port": 0}
    planted = 0
    print(f"keypoint noise {noise_px} px")
    for (i1, i2), g in zip(PAIRS, ours):
        recover_spherical_pose(g, cam, kps[i1], cam, kps[i2], device="cpu")
        ref = jtvg.estimate_two_view_geometry(
            jcam, kps[i1], jcam, kps[i2], matches,
            jtvg.TwoViewGeometryOptions(compute_relative_pose=True))
        R = poses[i2 - 1][0] @ poses[i1 - 1][0].T
        bad = outliers[i1] | outliers[i2]
        planted += int(bad.sum())
        line = f"pair {i1}-{i2}:"
        for name, geom in (("colmap_tpu", ref), ("port", g)):
            inl = np.asarray(geom.inlier_matches)
            n = int(bad[inl[:, 0]].sum())
            kept[name] += n
            quat = np.asarray(geom.cam2_from_cam1.quat, dtype=np.float64)
            R_est = rot.quat_to_rotmat(torch.from_numpy(quat)).numpy()
            line += (f"  {name} {CFG(int(geom.config)).name}, rotation error "
                     f"{np.abs(R_est - R).max():.3e}, {n} planted kept;")
        print(line, flush=True)
    for name, n in kept.items():
        print(f"{name}: {n} of {planted} planted outlier matches kept, {n / planted:.5f}")


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 0.25)
