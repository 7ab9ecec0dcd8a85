"""CLI commands, third module: feature_importer and guided_geometric_verifier.

Counterpart of colmap_tpu/cli/extra_commands2.py (reference behavior:
exe/feature.cc RunFeatureImporter and exe/colmap.cc's
guided_geometric_verifier registration). The other commands colmap_tpu
keeps in this module (image_rectifier, image_undistorter_standalone,
advancing_front_mesher and the PMVS / CMP-MVS exports) are in cli/main.py
and cli/export.py. ``guided_geometric_verifier`` takes ``--device``;
``feature_importer`` reads text files into the database on the host.
"""

from __future__ import annotations

import os

import numpy as np


def _load_sift_features_from_text(path):
    """Text format (reference: feature/sift.cc:1696
    LoadSiftFeaturesFromTextFile): header ``NUM DIM``, then a line a feature
    ``x y scale orientation d0 ... d127`` with DIM == 128 values in
    [0, 255]."""
    with open(path, "r") as f:
        header = f.readline().split()
        n, dim = int(header[0]), int(header[1])
        if dim != 128:
            raise ValueError(f"SIFT features must have 128 dims, got {dim}")
        kp = np.zeros((n, 4), dtype=np.float32)
        desc = np.zeros((n, dim), dtype=np.uint8)
        for i in range(n):
            vals = f.readline().split()
            kp[i] = [float(v) for v in vals[:4]]
            d = np.asarray([float(v) for v in vals[4:4 + dim]])
            if (d < 0).any() or (d > 255).any():
                raise ValueError("descriptor values must be in [0, 255]")
            desc[i] = np.clip(np.round(d), 0, 255).astype(np.uint8)
    return kp, desc


def _image_size(path):
    """(width, height) of an image file (utils/image_io.py)."""
    from colmap_tpu_torch.utils.image_io import read_image

    img = read_image(path)
    return img.shape[1], img.shape[0]


def _cmd_feature_importer(args):
    from colmap_tpu_torch.controllers.feature_pipeline import ImageReaderOptions
    from colmap_tpu_torch.scene.database import Database
    from colmap_tpu_torch.scene.types import Camera
    from colmap_tpu_torch.sensor import models as camera_models

    db = Database(args.database_path)
    reader = ImageReaderOptions(camera_model=args.camera_model,
                                single_camera=not args.per_image_camera,
                                camera_params=args.camera_params)
    if args.image_list_path:
        with open(args.image_list_path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    else:
        names = sorted(f for f in os.listdir(args.image_path)
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")))
    model_id = camera_models.MODEL_NAME_TO_ID[reader.camera_model]
    existing = {name: iid for (iid, name, _) in db.read_images()}
    camera_id = None
    n_imported = 0
    for name in names:
        feat_path = os.path.join(args.import_path, name + ".txt")
        if not os.path.exists(feat_path):
            print(f"SKIP: no features at {feat_path}")
            continue
        if camera_id is None or not reader.single_camera:
            w, h = _image_size(os.path.join(args.image_path, name))
            cam = Camera.create(0, model_id, 1.2 * max(w, h), w, h)
            if reader.camera_params:
                cam.params = np.array([float(v) for v in reader.camera_params.split(",")])
                cam.has_prior_focal_length = True
            camera_id = db.write_camera(cam, use_camera_id=False)
        image_id = existing.get(name) or db.write_image(name, camera_id)
        kp, desc = _load_sift_features_from_text(feat_path)
        if not db.exists_keypoints(image_id):
            db.write_keypoints(image_id, kp)
            db.write_descriptors(image_id, desc)
            n_imported += 1
    db.commit()
    db.close()
    print(f"Imported features for {n_imported} images")
    return n_imported


def _guided_geometric_verifier(args):
    from colmap_tpu_torch.cli.main import _cmd_geometric_verifier

    args.guided_matching = True
    return _cmd_geometric_verifier(args)


def register(sub, device_help):
    c = sub.add_parser("feature_importer")
    c.add_argument("--database_path", required=True)
    c.add_argument("--image_path", required=True)
    c.add_argument("--import_path", required=True)
    c.add_argument("--image_list_path", default=None)
    c.add_argument("--camera_model", default="SIMPLE_RADIAL")
    c.add_argument("--camera_params", default=None)
    c.add_argument("--per_image_camera", action="store_true")
    c.set_defaults(fn=_cmd_feature_importer)

    c = sub.add_parser("guided_geometric_verifier")
    c.add_argument("--database_path", required=True)
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=_guided_geometric_verifier)
