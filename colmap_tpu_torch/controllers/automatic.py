"""One-click automatic reconstruction.

reference behavior: src/colmap/controllers/automatic_reconstruction.h:44-80 —
quality presets (LOW/MEDIUM/HIGH/EXTREME) mutate the option tree, then the
full chain runs: feature extraction → matching (exhaustive / sequential /
vocab-tree by data type) → incremental mapping → undistortion → stereo →
fusion.

Counterpart of colmap_tpu/controllers/automatic.py: every stage is the
port's, on ``device`` (extraction K13-K16, matching and verification
K5/K7/K10-K12, vocabulary-tree pairs K28-K30 for ``internet``, the mapper's
kernels, undistortion K5, PatchMatch K17-K20 and fusion). Images are read
with utils/image_io.py, ``read_image_gray`` standing for PIL's
``convert("L")``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional

import numpy as np

from colmap_tpu_torch.scene.database import Database


class DataType(enum.Enum):
    INDIVIDUAL = "individual"
    VIDEO = "video"
    INTERNET = "internet"


class Quality(enum.Enum):
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    EXTREME = "extreme"


@dataclasses.dataclass
class AutomaticReconstructionOptions:
    workspace_path: str = ""
    image_path: str = ""
    data_type: DataType = DataType.INDIVIDUAL
    quality: Quality = Quality.HIGH
    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = True
    sparse: bool = True
    dense: bool = False
    num_threads: int = -1
    # Override for the incremental pipeline (None = defaults).
    mapper_options: Optional[object] = None


_QUALITY_MAX_FEATURES = {
    Quality.LOW: 2048,
    Quality.MEDIUM: 4096,
    Quality.HIGH: 8192,
    Quality.EXTREME: 8192,
}

_QUALITY_PM_ITERS = {
    Quality.LOW: 3,
    Quality.MEDIUM: 5,
    Quality.HIGH: 5,
    Quality.EXTREME: 7,
}


def run_automatic_reconstruction(options: AutomaticReconstructionOptions, device=None):
    """Run the full chain on ``device``; returns the list of reconstructions."""
    from colmap_tpu_torch.controllers.feature_pipeline import (
        ImageReaderOptions,
        run_exhaustive_matching,
        run_feature_extraction,
        run_matches_import,
        run_sequential_matching,
    )
    from colmap_tpu_torch.feature.sift import SiftOptions
    from colmap_tpu_torch.scene.reconstruction_io import write_model
    from colmap_tpu_torch.sfm.incremental_pipeline import (
        IncrementalPipeline,
        IncrementalPipelineOptions,
    )
    from colmap_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(device)
    ws = options.workspace_path
    os.makedirs(ws, exist_ok=True)
    db_path = os.path.join(ws, "database.db")
    db = Database(db_path)

    run_feature_extraction(
        db, options.image_path,
        reader_options=ImageReaderOptions(
            camera_model=options.camera_model,
            single_camera=options.single_camera,
        ),
        sift_options=SiftOptions(
            max_num_features=_QUALITY_MAX_FEATURES[options.quality]
        ),
        device=device,
    )

    if options.data_type == DataType.VIDEO:
        run_sequential_matching(db, device=device)
    elif options.data_type == DataType.INTERNET:
        # Vocab-tree pairing + verification.
        descs = {
            iid: db.read_descriptors(iid) for (iid, _, _) in db.read_images()
        }
        from colmap_tpu_torch.retrieval.visual_index import vocab_tree_pairs

        pairs = vocab_tree_pairs(descs, num_neighbors=10, device=device)
        run_matches_import(db, pairs, device=device)
    else:
        run_exhaustive_matching(db, device=device)

    models = []
    if options.sparse:
        pipeline_options = options.mapper_options or IncrementalPipelineOptions()
        pipeline = IncrementalPipeline(pipeline_options, db, device)
        models = pipeline.run()
        sparse_dir = os.path.join(ws, "sparse")
        os.makedirs(sparse_dir, exist_ok=True)
        for i, recon in enumerate(models):
            write_model(recon, os.path.join(sparse_dir, str(i)), fmt="bin")

    if options.dense and models:
        from colmap_tpu_torch.image.undistortion import undistort_camera, undistort_image
        from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions
        from colmap_tpu_torch.mvs.workspace import (
            run_fusion_workspace,
            run_patch_match_workspace,
        )
        from colmap_tpu_torch.utils.image_io import read_image_gray

        recon = models[0]
        dense_dir = os.path.join(ws, "dense")
        os.makedirs(os.path.join(dense_dir, "images"), exist_ok=True)
        new_cams = {
            cid: undistort_camera(cam, device=device) for cid, cam in recon.cameras.items()
        }
        images = {}
        for iid in recon.reg_image_ids():
            img = recon.images[iid]
            src = os.path.join(options.image_path, img.name)
            if not os.path.exists(src):
                continue
            raw = read_image_gray(src)
            und = undistort_image(raw, recon.cameras[img.camera_id],
                                  new_cams[img.camera_id], device=device)
            images[iid] = und.astype(np.float32) / 255.0
        import copy

        drecon = copy.deepcopy(recon)
        for cid in drecon.cameras:
            drecon.cameras[cid] = new_cams[cid]
        write_model(drecon, os.path.join(dense_dir, "sparse"), fmt="bin")
        run_patch_match_workspace(
            drecon, images, dense_dir,
            PatchMatchOptions(
                num_iterations=_QUALITY_PM_ITERS[options.quality]
            ),
            device=device,
        )
        run_fusion_workspace(drecon, dense_dir, os.path.join(dense_dir, "fused.ply"),
                             device=device)

    db.close()
    return models
