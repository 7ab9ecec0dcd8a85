"""Sparse model exporters: NVM, Bundler, CAM.

A copy of colmap_tpu/scene/exporters.py (host Python), so that the port
does not import the JAX package; the PLY writer is utils/ply.py.

reference behavior: src/colmap/scene/reconstruction_io.h:46-90 and
exe/model.cc:633-679 (model_converter output types).
"""

from __future__ import annotations

import os

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Reconstruction
from colmap_tpu_torch.sensor import models as camera_models


def write_nvm(recon: Reconstruction, path: str, skip_distortion: bool = False):
    """VisualSfM NVM_V3 export (reference: WriteNVM, reconstruction_io.cc).

    NVM supports a single radial distortion coefficient; other models are
    written with zero distortion.
    """
    reg = recon.reg_image_ids()
    with open(path, "w") as f:
        f.write("NVM_V3\n\n")
        f.write(f"{len(reg)}\n")
        img_row = {}
        for row, iid in enumerate(reg):
            img_row[iid] = row
            image = recon.images[iid]
            cam = recon.cameras[image.camera_id]
            pose = recon.cam_from_world(iid)
            focal = cam.mean_focal_length()
            center = pose.projection_center()
            q = pose.quat / np.linalg.norm(pose.quat)
            # NVM uses radial coefficient with inverted sign convention.
            mid = int(cam.model_id)
            k = 0.0
            if mid in (
                int(camera_models.CameraModelId.SIMPLE_RADIAL),
                int(camera_models.CameraModelId.RADIAL),
            ):
                k = -float(cam.params[3])
            f.write(
                f"{image.name} {focal} {q[0]} {q[1]} {q[2]} {q[3]} "
                f"{center[0]} {center[1]} {center[2]} {k} 0\n"
            )
        f.write(f"\n{recon.num_points3D()}\n")
        for pid, p in recon.points3D.items():
            track = [el for el in p.track if el.image_id in img_row]
            f.write(
                f"{p.xyz[0]} {p.xyz[1]} {p.xyz[2]} "
                f"{int(p.color[0])} {int(p.color[1])} {int(p.color[2])} {len(track)}"
            )
            for el in track:
                image = recon.images[el.image_id]
                cam = recon.cameras[image.camera_id]
                xy = image.points2D_xy[el.point2D_idx]
                # NVM stores measurements relative to the principal point.
                pp = camera_models.principal_point_idxs(int(cam.model_id))
                cx, cy = cam.params[pp[0]], cam.params[pp[1]]
                f.write(f" {img_row[el.image_id]} {el.point2D_idx} {xy[0] - cx} {xy[1] - cy}")
            f.write("\n")


def write_bundler(recon: Reconstruction, path: str, list_path: str = None):
    """Bundler v0.3 export (reference: WriteBundler).

    Bundler convention: camera looks down -z; x right, y up.
    """
    reg = recon.reg_image_ids()
    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(reg)} {recon.num_points3D()}\n")
        img_row = {}
        for row, iid in enumerate(reg):
            img_row[iid] = row
            image = recon.images[iid]
            cam = recon.cameras[image.camera_id]
            pose = recon.cam_from_world(iid)
            R = pose.rotmat()
            t = pose.t
            # Convert COLMAP (x right, y down, z front) to Bundler
            # (x right, y up, z back): flip rows 2 and 3.
            flip = np.diag([1.0, -1.0, -1.0])
            Rb = flip @ R
            tb = flip @ t
            focal = cam.mean_focal_length()
            mid = int(cam.model_id)
            k1 = k2 = 0.0
            if mid == int(camera_models.CameraModelId.SIMPLE_RADIAL):
                k1 = float(cam.params[3])
            elif mid == int(camera_models.CameraModelId.RADIAL):
                k1, k2 = float(cam.params[3]), float(cam.params[4])
            f.write(f"{focal} {k1} {k2}\n")
            for r in Rb:
                f.write(f"{r[0]} {r[1]} {r[2]}\n")
            f.write(f"{tb[0]} {tb[1]} {tb[2]}\n")
        for pid, p in recon.points3D.items():
            f.write(f"{p.xyz[0]} {p.xyz[1]} {p.xyz[2]}\n")
            f.write(f"{int(p.color[0])} {int(p.color[1])} {int(p.color[2])}\n")
            track = [el for el in p.track if el.image_id in img_row]
            f.write(f"{len(track)}")
            for el in track:
                image = recon.images[el.image_id]
                cam = recon.cameras[image.camera_id]
                pp = camera_models.principal_point_idxs(int(cam.model_id))
                cx, cy = cam.params[pp[0]], cam.params[pp[1]]
                xy = image.points2D_xy[el.point2D_idx]
                # Bundler measurements: center-origin, y up.
                f.write(
                    f" {img_row[el.image_id]} {el.point2D_idx} "
                    f"{xy[0] - cx} {-(xy[1] - cy)}"
                )
            f.write("\n")
    if list_path:
        with open(list_path, "w") as f:
            for iid in reg:
                f.write(recon.images[iid].name + "\n")


def write_cam_files(recon: Reconstruction, out_dir: str):
    """One .cam file per registered image (reference: WriteCam)."""
    os.makedirs(out_dir, exist_ok=True)
    for iid in recon.reg_image_ids():
        image = recon.images[iid]
        cam = recon.cameras[image.camera_id]
        pose = recon.cam_from_world(iid)
        R = pose.rotmat()
        t = pose.t
        focal = cam.mean_focal_length()
        w = max(cam.width, cam.height)
        name = os.path.splitext(image.name)[0] + ".cam"
        pp = camera_models.principal_point_idxs(int(cam.model_id))
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(
                f"{t[0]} {t[1]} {t[2]} "
                + " ".join(str(v) for v in R.reshape(-1))
                + "\n"
            )
            f.write(
                f"{focal / w} 0 0 1 "
                f"{cam.params[pp[0]] / cam.width} {cam.params[pp[1]] / cam.height}\n"
            )


def write_recon3d(recon: Reconstruction, out_dir: str, skip_distortion: bool = False):
    """Recon3D export (reference: ExportRecon3D, reconstruction_io.cc):
    Recon/synth_0.out (cameras + points), urd-images.txt, imagemap_0.txt.
    Only pinhole/SIMPLE_RADIAL/RADIAL cameras carry distortion."""
    base = os.path.join(out_dir, "Recon")
    os.makedirs(base, exist_ok=True)
    reg = recon.reg_image_ids()
    img_row = {}
    with open(os.path.join(base, "synth_0.out"), "w") as synth, open(
        os.path.join(base, "urd-images.txt"), "w"
    ) as ilist, open(os.path.join(base, "imagemap_0.txt"), "w") as imap:
        synth.write("colmap 1.0\n")
        synth.write(f"{len(reg)} {recon.num_points3D()}\n")
        for row, iid in enumerate(reg):
            image = recon.images[iid]
            cam = recon.cameras[image.camera_id]
            mid = int(cam.model_id)
            k1 = k2 = 0.0
            if skip_distortion or mid in (
                int(camera_models.CameraModelId.SIMPLE_PINHOLE),
                int(camera_models.CameraModelId.PINHOLE),
            ):
                pass
            elif mid == int(camera_models.CameraModelId.SIMPLE_RADIAL):
                k1 = -float(cam.params[3])
            elif mid == int(camera_models.CameraModelId.RADIAL):
                k1 = -float(cam.params[3])
                k2 = -float(cam.params[4])
            else:
                raise ValueError(
                    "Recon3D only supports SIMPLE_RADIAL, RADIAL and "
                    "pinhole camera models"
                )
            scale = 1.0 / max(cam.width, cam.height)
            pose = recon.cam_from_world(iid)
            R = pose.rotmat()
            synth.write(f"{scale * cam.mean_focal_length():.17g} {k1} {k2}\n")
            for r in R:
                synth.write(f"{r[0]:.17g} {r[1]:.17g} {r[2]:.17g}\n")
            synth.write(f"{pose.t[0]:.17g} {pose.t[1]:.17g} {pose.t[2]:.17g}\n")
            img_row[iid] = row
            ilist.write(f"{image.name}\n{cam.width} {cam.height}\n")
            imap.write(f"{row}\n")
        for pid, p in recon.points3D.items():
            synth.write(f"{p.xyz[0]:.17g} {p.xyz[1]:.17g} {p.xyz[2]:.17g}\n")
            synth.write(
                f"{int(p.color[0])} {int(p.color[1])} {int(p.color[2])}\n"
            )
            seen = set()
            parts = []
            for el in p.track:
                if el.image_id in seen or el.image_id not in img_row:
                    continue
                seen.add(el.image_id)
                image = recon.images[el.image_id]
                cam = recon.cameras[image.camera_id]
                pp = camera_models.principal_point_idxs(int(cam.model_id))
                cx, cy = cam.params[pp[0]], cam.params[pp[1]]
                xy = image.points2D_xy[el.point2D_idx]
                scale = 1.0 / max(cam.width, cam.height)
                parts.append(
                    f"{img_row[el.image_id]} {el.point2D_idx} -1.0 "
                    f"{(xy[0] - cx) * scale:.17g} {(xy[1] - cy) * scale:.17g}"
                )
            synth.write(f"{len(seen)} " + " ".join(parts) + "\n")


def write_vrml(
    recon: Reconstruction,
    images_path: str,
    points3D_path: str,
    image_scale: float = 1.0,
    image_rgb=(1.0, 0.0, 0.0),
):
    """VRML 2.0 export of camera frusta + colored point set
    (reference: ExportVRML, reconstruction_io.cc)."""
    six = image_scale * 0.15
    siy = image_scale * 0.1
    base_pts = np.array(
        [
            [-six, -siy, six * 2.0],
            [+six, -siy, six * 2.0],
            [+six, +siy, six * 2.0],
            [-six, +siy, six * 2.0],
            [0.0, 0.0, 0.0],
            [-six / 3.0, -siy / 3.0, six * 2.0],
            [+six / 3.0, -siy / 3.0, six * 2.0],
            [+six / 3.0, +siy / 3.0, six * 2.0],
            [-six / 3.0, +siy / 3.0, six * 2.0],
        ]
    )
    with open(images_path, "w") as f:
        for iid in recon.reg_image_ids():
            world_from_cam = recon.cam_from_world(iid).inverse()
            pts = world_from_cam.apply(base_pts)
            f.write("Shape{\n appearance Appearance {\n")
            f.write("  material DEF Default-ffRffGffB Material {\n")
            f.write("  ambientIntensity 0\n")
            f.write(
                f"  diffuseColor  {image_rgb[0]} {image_rgb[1]} {image_rgb[2]}\n"
            )
            f.write("  emissiveColor 0.1 0.1 0.1 } }\n")
            f.write(" geometry IndexedFaceSet {\n solid FALSE \n")
            f.write(" colorPerVertex TRUE \n ccw TRUE \n")
            f.write(" coord Coordinate {\n point [\n")
            for pt in pts:
                f.write(f"{pt[0]} {pt[1]} {pt[2]}\n")
            f.write(" ] }\n")
            f.write("color Color {color [\n")
            for _ in range(len(base_pts)):
                f.write(f" {image_rgb[0]} {image_rgb[1]} {image_rgb[2]}\n")
            f.write("\n] }\n")
            f.write("coordIndex [\n")
            f.write(" 0, 1, 2, 3, -1\n 5, 6, 4, -1\n 6, 7, 4, -1\n")
            f.write(" 7, 8, 4, -1\n 8, 5, 4, -1\n \n] \n")
            f.write(" texCoord TextureCoordinate { point [\n")
            f.write("  1 1,\n  0 1,\n  0 0,\n  1 0,\n  0 0,\n")
            f.write("  0 0,\n  0 0,\n  0 0,\n  0 0,\n ] }\n")
            f.write("} }\n")
    with open(points3D_path, "w") as f:
        f.write("#VRML V2.0 utf8\n")
        f.write("Background { skyColor [1.0 1.0 1.0] } \n")
        f.write("Shape{ appearance Appearance {\n")
        f.write(" material Material {emissiveColor 1 1 1} }\n")
        f.write(" geometry PointSet {\n coord Coordinate {\n  point [\n")
        for p in recon.points3D.values():
            f.write(f"{p.xyz[0]}, {p.xyz[1]}, {p.xyz[2]}\n")
        f.write(" ] }\n color Color { color [\n")
        for p in recon.points3D.values():
            f.write(
                f"{p.color[0] / 255.0}, {p.color[1] / 255.0}, {p.color[2] / 255.0}\n"
            )
        f.write(" ] } } }\n")
