"""Synthetic image rendering for full-pipeline testing.

Counterpart of colmap_tpu/scene/synthetic_images.py, with the same pixels
for the same reconstruction and seed (reference behavior:
src/colmap/scene/synthetic.cc SynthesizeImages (:773)). Each 3D point
carries a small textured plane oriented along its direction from the
points' centroid, texture-mapped by exact ray-plane intersection, so
keypoints detected in the views correspond to true 3D points. numpy and
scipy on the host; the PNG files go through utils/image_io.py, not PIL.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.sensor import models as cm
from colmap_tpu_torch.utils.image_io import write_png_gray


def render_images(
    recon: Reconstruction,
    out_dir: str,
    patch_size: int = 13,
    patch_world: float = 0.1,
    seed: int = 0,
) -> List[str]:
    """Render one 8-bit gray PNG per registered view of the reconstruction's
    points; every 3D point gets a fixed random texture patch. Returns the
    file names written."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    P = patch_size

    pids = sorted(recon.points3D.keys())
    pts = np.stack([recon.points3D[p].xyz for p in pids])
    patches = gaussian_filter(rng.uniform(0.0, 1.0, (len(pids), P, P)), (0, 0.7, 0.7))
    patches = (patches - patches.min()) / max(patches.max() - patches.min(), 1e-9)

    names = []
    centroid = pts.mean(axis=0)
    for iid in recon.reg_image_ids():
        image = recon.images[iid]
        cam = recon.cameras[image.camera_id]
        f = cam.mean_focal_length()
        pp = cm.principal_point_idxs(int(cam.model_id))
        cx, cy = cam.params[pp[0]], cam.params[pp[1]]
        w, h = cam.width, cam.height
        pose = recon.cam_from_world(iid)
        R_cw = pose.rotmat()
        cam_center = pose.projection_center()

        Xc = pose.apply(pts)
        img = np.zeros((h, w), dtype=np.float64)
        for j in range(len(pids)):
            if Xc[j, 2] <= 0:
                continue
            x = Xc[j, 0] / Xc[j, 2] * f + cx
            y = Xc[j, 1] / Xc[j, 2] * f + cy
            if not (P < x < w - 2 * P and P < y < h - 2 * P):
                continue
            n_pl = pts[j] - centroid
            nn = np.linalg.norm(n_pl)
            n_pl = n_pl / nn if nn > 1e-9 else np.array([0.0, 0.0, 1.0])
            e1 = np.cross(n_pl, [0.0, 0.0, 1.0])
            if np.linalg.norm(e1) < 1e-6:
                e1 = np.cross(n_pl, [0.0, 1.0, 0.0])
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(n_pl, e1)
            corners = np.stack([pts[j] + patch_world * (su * e1 + sv * e2)
                                for su in (-1, 1) for sv in (-1, 1)])
            cc = pose.apply(corners)
            if np.any(cc[:, 2] <= 0):
                continue
            cuv = (cc[:, :2] / cc[:, 2:]) * f + np.array([cx, cy])
            x0, y0 = np.floor(cuv.min(axis=0)).astype(int) - 1
            x1, y1 = np.ceil(cuv.max(axis=0)).astype(int) + 1
            x0, y0 = max(x0, 0), max(y0, 0)
            x1, y1 = min(x1, w - 1), min(y1, h - 1)
            if x1 <= x0 or y1 <= y0:
                continue
            ys_, xs_ = np.mgrid[y0:y1, x0:x1]
            rays = np.stack([(xs_ - cx) / f, (ys_ - cy) / f, np.ones_like(xs_, dtype=float)],
                            axis=-1)
            d_world = rays @ R_cw
            denom = d_world @ n_pl
            tnum = (pts[j] - cam_center) @ n_pl
            with np.errstate(divide="ignore", invalid="ignore"):
                tpar = tnum / denom
            Xw = cam_center + tpar[..., None] * d_world
            lu = ((Xw - pts[j]) @ e1) / patch_world
            lv = ((Xw - pts[j]) @ e2) / patch_world
            inside = (np.abs(lu) < 1) & (np.abs(lv) < 1) & (denom > 1e-9)
            pu = np.clip(((lu + 1) / 2 * (P - 1)).astype(int), 0, P - 1)
            pv = np.clip(((lv + 1) / 2 * (P - 1)).astype(int), 0, P - 1)
            img[y0:y1, x0:x1] += np.where(inside, patches[j][pv, pu], 0.0)

        img = np.clip(img, 0, 1.5) / 1.5
        name = image.name if image.name.lower().endswith(".png") else image.name + ".png"
        write_png_gray(os.path.join(out_dir, name), (img * 255).astype(np.uint8))
        names.append(name)
    return names
