"""PMVS and CMP-MVS workspaces of ``image_undistorter --output_type``
(colmap_tpu/cli/extra_commands2.py:225-335).

reference behavior: controllers/undistorters.cc PMVSUndistorter and
CMPMVSUndistorter. Each registered image is undistorted (the camera maps on
K5 on the card, the gather as torch ops: image/undistortion.py) and written
as JPEG beside its projection matrix P = K [R | t]; PMVS also gets vis.dat
(the images each image shares 3D points with), option-all and run-pmvs.sh.
Given the same undistorted images, the files are colmap_tpu's, byte for
byte.
"""

from __future__ import annotations

import os

import numpy as np

from colmap_tpu_torch.image.rectification import _calibration_matrix
from colmap_tpu_torch.image.undistortion import UndistortOptions, undistort_camera, undistort_image
from colmap_tpu_torch.utils.image_io import read_image, to_rgb, write_image


def _write_projection_matrix(path, camera, cam_from_world, header="CONTOUR"):
    """reference: controllers/undistorters.cc WriteProjectionMatrix —
    P = K [R|t], preceded by a header line."""
    P = _calibration_matrix(camera) @ cam_from_world.matrix3x4()
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        for row in P:
            f.write(" ".join(f"{v:.12g}" for v in row) + "\n")


def _undistort_registered(recon, image_dir, options, device, image_path, matrix_path):
    """Undistort each registered image into image_path(idx) and write its
    projection matrix to matrix_path(idx); returns the registered ids."""
    reg_ids = recon.reg_image_ids()
    ucams = {}
    for idx, iid in enumerate(reg_ids):
        image = recon.images[iid]
        cam = recon.cameras[image.camera_id]
        if image.camera_id not in ucams:
            ucams[image.camera_id] = undistort_camera(cam, options, device=device)
        ucam = ucams[image.camera_id]
        src = os.path.join(image_dir, image.name)
        if os.path.exists(src):
            out = undistort_image(to_rgb(read_image(src)), cam, ucam, device=device)
            write_image(image_path(idx), np.asarray(out, dtype=np.uint8))
        _write_projection_matrix(matrix_path(idx), ucam, recon.cam_from_world(iid))
    return reg_ids


def export_pmvs(recon, image_dir, output_path, options=None, device="cuda"):
    """PMVS workspace layout (reference: controllers/undistorters.cc:315-556):
    pmvs/visualize/%08d.jpg, pmvs/txt/%08d.txt, pmvs/models/, vis.dat,
    option-all, run-pmvs.sh."""
    options = options or UndistortOptions()
    base = os.path.join(output_path, "pmvs")
    for sub in ("visualize", "txt", "models"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    reg_ids = _undistort_registered(
        recon, image_dir, options, device,
        lambda i: os.path.join(base, "visualize", f"{i:08d}.jpg"),
        lambda i: os.path.join(base, "txt", f"{i:08d}.txt"))
    # vis.dat: per image, the set of co-visible images (reference :420-455).
    id_to_idx = {iid: i for i, iid in enumerate(reg_ids)}
    with open(os.path.join(base, "vis.dat"), "w") as f:
        f.write("VISDATA\n")
        f.write(f"{len(reg_ids)}\n")
        for idx, iid in enumerate(reg_ids):
            visible = set()
            for p3d_id in recon.images[iid].points2D_p3d:
                if p3d_id < 0 or p3d_id not in recon.points3D:
                    continue
                for el in recon.points3D[p3d_id].track:
                    if el.image_id != iid and el.image_id in id_to_idx:
                        visible.add(id_to_idx[el.image_id])
            f.write(f"{idx} {len(visible)}" + "".join(f" {v}" for v in sorted(visible)) + "\n")
    # option-all (reference :529-556).
    with open(os.path.join(base, "option-all"), "w") as f:
        f.write("# Generated by colmap_tpu - all images, no clustering.\n")
        f.write("level 1\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n")
        f.write(f"CPU {os.cpu_count() or 1}\n")
        f.write("setEdge 0\nuseBound 0\nuseVisData 1\nsequence -1\n")
        f.write("maxAngle 10\nquad 2.0\n")
        f.write(f"timages {len(reg_ids)}" + "".join(f" {i}" for i in range(len(reg_ids))))
        f.write("\noimages 0\n")
    with open(os.path.join(output_path, "run-pmvs.sh"), "w") as f:
        f.write("# Usage: ./run-pmvs.sh PMVS_EXE_PATH\n")
        f.write("PMVS_EXE_PATH=$1\n")
        f.write("$PMVS_EXE_PATH/pmvs2 pmvs/ option-all\n")
    return reg_ids


def export_cmp_mvs(recon, image_dir, output_path, options=None, device="cuda"):
    """CMP-MVS layout (reference: controllers/undistorters.cc:601-631):
    %05d.jpg + %05d_P.txt with CONTOUR header."""
    options = options or UndistortOptions()
    os.makedirs(output_path, exist_ok=True)
    return _undistort_registered(
        recon, image_dir, options, device,
        lambda i: os.path.join(output_path, f"{i + 1:05d}.jpg"),
        lambda i: os.path.join(output_path, f"{i + 1:05d}_P.txt"))
