"""Feature pipelines: images -> features, and database features -> matches
-> two-view geometries.

Counterpart of colmap_tpu/controllers/feature_pipeline.py (reference
behavior: src/colmap/controllers/feature_extraction.cc, reader ->
extractor -> writer, and feature_matching.cc, pair blocks -> matcher
workers -> verifier pool -> database).

Extraction: one reader thread decodes images (utils/image_io.py, no PIL)
and reads their EXIF up to four images ahead of the extractor; each image
goes through extract_sift (feature/sift.py, kernels K13-K16) or, with an
``aliked`` extractor type, extract_aliked (feature/aliked.py, K50-K52) on
the chosen device, and cameras, images, pose priors, keypoints and
descriptors land in the SQLite database on this thread.

Matching: pairs stream in blocks of 256: each block is one call of the
matcher kernel K10 over the block's descriptor table (or, with
``matcher_type="lightglue"``, LightGlue pair by pair: feature/lightglue.py,
K53), then blocks of up to 64 pairs through the E, F and H RANSAC kernels
(estimators/two_view_batch.py), and the results go to the database.
Descriptors live on the device only for their block.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from colmap_tpu_torch.estimators.two_view_batch import estimate_two_view_geometries_batched
from colmap_tpu_torch.estimators.two_view_geometry import (
    TwoViewGeometryOptions,
    estimate_two_view_geometry,
)
from colmap_tpu_torch.feature.aliked import AlikedOptions, Aliked, extract_aliked
from colmap_tpu_torch.feature.aliked import load_torch_weights as load_aliked_weights
from colmap_tpu_torch.feature.lightglue import LightGlue, LightGlueOptions, match_lightglue
from colmap_tpu_torch.feature.lightglue import load_torch_weights as load_lightglue_weights
from colmap_tpu_torch.feature.matcher import MatchingOptions, match_guided, match_pairs_batched
from colmap_tpu_torch.feature.pairing import (
    ExhaustivePairingOptions,
    SequentialPairingOptions,
    exhaustive_pairs,
    sequential_pairs,
)
from colmap_tpu_torch.feature.sift import SiftOptions, extract_sift
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.types import Camera
from colmap_tpu_torch.sensor import models as camera_models
from colmap_tpu_torch.sensor.specs import focal_length_px_from_exif
from colmap_tpu_torch.utils.dtypes import resolve_device
from colmap_tpu_torch.utils.exif import read_exif
from colmap_tpu_torch.utils.image_io import read_image_gray

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


@dataclasses.dataclass
class ImageReaderOptions:
    """reference: controllers/image_reader.h — camera initialization from
    EXIF or defaults; one camera for all images or one per image."""

    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = True
    default_focal_length_factor: float = 1.2
    camera_params: Optional[str] = None  # comma-separated explicit params
    # Per-image masks: the mask of "abc/012.jpg" is "<mask_path>/abc/012.jpg.png"
    # (or "<stem>.png"); zero mask pixels suppress features
    # (reference: image_reader.h:49-52).
    mask_path: Optional[str] = None
    # One mask for every image (reference: image_reader.h:57).
    camera_mask_path: Optional[str] = None
    # "sift", or "aliked" (any name starting so) for ALIKED; without a
    # weights path ALIKED runs on init_params' random weights.
    extractor_type: str = "sift"
    aliked_weights_path: Optional[str] = None


def _load_image_gray(path: str) -> np.ndarray:
    return read_image_gray(path)


def _load_mask(reader_options: ImageReaderOptions, name: str) -> Optional[np.ndarray]:
    """The feature mask of an image, or None (reference:
    image_reader.cc:148-172)."""
    path = None
    if reader_options.mask_path:
        cand = os.path.join(reader_options.mask_path, name + ".png")
        if os.path.exists(cand):
            path = cand
        else:
            alt = os.path.join(reader_options.mask_path, os.path.splitext(name)[0] + ".png")
            if not os.path.exists(alt):
                raise FileNotFoundError(f"Mask at {cand} does not exist")
            path = alt
    elif reader_options.camera_mask_path:
        path = reader_options.camera_mask_path
    return None if path is None else read_image_gray(path)


def _apply_mask(kp: np.ndarray, desc: np.ndarray, mask_img: np.ndarray):
    """Drop keypoints on zero mask pixels."""
    x = np.clip(kp[:, 0].astype(np.int64), 0, mask_img.shape[1] - 1)
    y = np.clip(kp[:, 1].astype(np.int64), 0, mask_img.shape[0] - 1)
    keep = mask_img[y, x] != 0
    return kp[keep], desc[keep]


# ALIKED networks by (weights path, options, device). colmap_tpu keeps the
# first call's parameters on the function for the life of the process,
# whatever weights path a later call names (ROADMAP §3); the port keys them.
_ALIKED_MODELS: Dict[tuple, Aliked] = {}


def _aliked_model(reader_options: ImageReaderOptions, sift_options: SiftOptions, device):
    options = AlikedOptions(max_num_keypoints=sift_options.max_num_features)
    path = reader_options.aliked_weights_path
    key = (path, options, str(device))
    if key not in _ALIKED_MODELS:
        params = load_aliked_weights(path, options) if path else None
        _ALIKED_MODELS[key] = Aliked(params, options).to(device)
    return _ALIKED_MODELS[key]


def _extract(img, reader_options, sift_options, device):
    if not reader_options.extractor_type.startswith("aliked"):
        return extract_sift(img, sift_options, device=device)
    model = _aliked_model(reader_options, sift_options, device)
    kp, desc = extract_aliked(img, model, model.options, device)
    # Float descriptors into the uint8 range of the database, truncated.
    return kp, np.clip((desc + 1.0) * 127.5, 0, 255).astype(np.uint8)


def run_feature_extraction(
    database: Database,
    image_dir: str,
    image_names: Optional[Sequence[str]] = None,
    reader_options: Optional[ImageReaderOptions] = None,
    sift_options: Optional[SiftOptions] = None,
    device=None,
) -> List[int]:
    """Extract SIFT (or ALIKED) features for the images of a directory (by
    default all of them, sorted by name) into the database; returns the
    image ids. ALIKED takes its keypoint cap from
    sift_options.max_num_features, as colmap_tpu does."""
    reader_options = reader_options or ImageReaderOptions()
    sift_options = sift_options or SiftOptions()
    device = resolve_device(device)
    if image_names is None:
        image_names = sorted(f for f in os.listdir(image_dir)
                             if f.lower().endswith(IMAGE_EXTENSIONS))
    image_names = list(image_names)
    model_id = camera_models.MODEL_NAME_TO_ID[reader_options.camera_model]

    def read_one(name):
        path = os.path.join(image_dir, name)
        return name, _load_image_gray(path), read_exif(path)

    # The reader thread keeps up to AHEAD images decoded ahead of the
    # extractor (the bounded reader -> extractor queue of
    # controllers/feature_extraction.cc:86-470); database writes stay on
    # this thread, which owns the SQLite connection.
    AHEAD = 4
    camera_id, image_ids = None, []
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="img-read") as reader:
        pending = [reader.submit(read_one, n) for n in image_names[:AHEAD]]
        upcoming = iter(image_names[AHEAD:])
        while pending:
            name, img, exif = pending.pop(0).result()
            nxt = next(upcoming, None)
            if nxt is not None:
                pending.append(reader.submit(read_one, nxt))
            h, w = img.shape
            if camera_id is None or not reader_options.single_camera:
                # EXIF focal length (35 mm equivalent, or mm and the sensor
                # width), else the default factor (reference:
                # controllers/image_reader.cc, sensor/specs.*).
                focal, has_prior = focal_length_px_from_exif(
                    exif, w, h, reader_options.default_focal_length_factor)
                cam = Camera.create(0, model_id, focal, w, h)
                cam.has_prior_focal_length = has_prior
                if reader_options.camera_params:
                    cam.params = np.array(
                        [float(v) for v in reader_options.camera_params.split(",")])
                    cam.has_prior_focal_length = True
                camera_id = database.write_camera(cam, use_camera_id=False)
            image_id = database.write_image(name, camera_id)
            # EXIF GPS -> a WGS84 pose prior (coordinate_system 0).
            if "latitude" in exif and "longitude" in exif:
                database.write_pose_prior(
                    image_id, position=np.array([exif["latitude"], exif["longitude"],
                                                 exif.get("altitude", 0.0)]),
                    coordinate_system=0)
            kp, desc = _extract(img, reader_options, sift_options, device)
            mask_img = _load_mask(reader_options, name)
            if mask_img is not None:
                kp, desc = _apply_mask(kp, desc, mask_img)
            database.write_keypoints(image_id, kp)
            database.write_descriptors(image_id, desc)
            image_ids.append(image_id)
    database.commit()
    return image_ids


@dataclasses.dataclass
class MatchingPipelineOptions:
    matching: MatchingOptions = dataclasses.field(default_factory=MatchingOptions)
    verification: TwoViewGeometryOptions = dataclasses.field(
        default_factory=TwoViewGeometryOptions)
    min_num_inliers: int = 15
    # Match again with the verified epipolar geometry as a constraint
    # (guided matching, controllers/feature_matching_utils.h:133).
    guided_matching: bool = False
    # Matcher type (feature/types.h:47-50: SIFT_BRUTEFORCE, SIFT_LIGHTGLUE,
    # ALIKED_BRUTEFORCE, ALIKED_LIGHTGLUE): "lightglue", else brute force.
    matcher_type: str = "bruteforce"
    lightglue_weights_path: Optional[str] = None
    # Overrides LightGlueOptions (layer count, filter threshold, ...).
    lightglue_options: Optional[LightGlueOptions] = None


def _lightglue_model(options: MatchingPipelineOptions, device) -> LightGlue:
    lg_options = options.lightglue_options or LightGlueOptions()
    params = (load_lightglue_weights(options.lightglue_weights_path, lg_options)
              if options.lightglue_weights_path else None)
    return LightGlue(params, lg_options).to(device)


def _match_and_verify_pairs(
    database: Database,
    pairs: Sequence[Tuple[int, int]],
    options: MatchingPipelineOptions,
    block_pairs: int = 256,
    device=None,
) -> int:
    """Match and verify a pair list block by block on ``device``; writes
    matches and two-view geometries, returns the number of verified pairs."""
    device = resolve_device(device)
    cameras = database.read_cameras()
    images = {iid: (name, cid) for (iid, name, cid) in database.read_images()}
    kp_cache: Dict[int, np.ndarray] = {}

    def get_kp(iid):
        if iid not in kp_cache:
            kp_cache[iid] = database.read_keypoints(iid)[:, :2]
        return kp_cache[iid]

    lightglue = _lightglue_model(options, device) if options.matcher_type == "lightglue" else None
    pairs = list(pairs)
    n_verified = 0
    # Per-image normalized keypoints are kept across all blocks.
    normalized_cache: Dict[tuple, np.ndarray] = {}
    for blk_start in range(0, len(pairs), block_pairs):
        block = pairs[blk_start:blk_start + block_pairs]
        block_ids = sorted({i for p in block for i in p})
        descs = {iid: database.read_descriptors(iid) for iid in block_ids}
        if lightglue is not None:
            shape = {iid: (cameras[images[iid][1]].height, cameras[images[iid][1]].width)
                     for iid in block_ids}
            match_lists = [match_lightglue(descs[a].astype(np.float32), get_kp(a),
                                           descs[b].astype(np.float32), get_kp(b), shape[a],
                                           shape[b], lightglue, lightglue.options, device)
                           for (a, b) in block]
        else:
            local = {iid: k for k, iid in enumerate(block_ids)}
            pair_idxs = np.asarray([(local[a], local[b]) for (a, b) in block], dtype=np.int64)
            match_lists = match_pairs_batched([descs[iid] for iid in block_ids], pair_idxs,
                                              options.matching, device)

        items, verify_slots = [], []
        for k, (id1, id2) in enumerate(block):
            matches = match_lists[k]
            database.write_matches(id1, id2, matches)
            if len(matches) < options.min_num_inliers:
                continue
            items.append((cameras[images[id1][1]], get_kp(id1), cameras[images[id2][1]],
                          get_kp(id2), matches))
            verify_slots.append(k)

        geoms = estimate_two_view_geometries_batched(
            items, options.verification, normalized_cache=normalized_cache, device=device)

        for slot, g, item in zip(verify_slots, geoms, items):
            id1, id2 = block[slot]
            cam1, kp1, cam2, kp2, _ = item
            if options.guided_matching and g.F is not None and len(g.inlier_matches) > 0:
                guided = match_guided(descs[id1], descs[id2], kp1, kp2, g.F, options.matching,
                                      device)
                if len(guided) > len(g.inlier_matches):
                    g2 = estimate_two_view_geometry(cam1, kp1, cam2, kp2, guided,
                                                    options.verification, device=device)
                    if len(g2.inlier_matches) > len(g.inlier_matches):
                        g = g2
            if len(g.inlier_matches) >= options.min_num_inliers:
                database.write_two_view_geometry(id1, id2, g)
                n_verified += 1
    database.commit()
    return n_verified


def run_exhaustive_matching(
    database: Database,
    options: Optional[MatchingPipelineOptions] = None,
    pairing: Optional[ExhaustivePairingOptions] = None,
    device=None,
) -> int:
    """reference behavior: CreateExhaustiveFeatureMatcher
    (controllers/feature_matching.cc:330)."""
    options = options or MatchingPipelineOptions()
    image_ids = [iid for (iid, _, _) in database.read_images()]
    n = 0
    for block in exhaustive_pairs(image_ids, pairing or ExhaustivePairingOptions()):
        n += _match_and_verify_pairs(database, block, options, device=device)
    return n


def run_sequential_matching(
    database: Database,
    options: Optional[MatchingPipelineOptions] = None,
    pairing: Optional[SequentialPairingOptions] = None,
    device=None,
) -> int:
    """reference behavior: CreateSequentialFeatureMatcher; the sequence is
    the images ordered by name."""
    rows = sorted(database.read_images(), key=lambda r: r[1])
    pairs = sequential_pairs([iid for (iid, _, _) in rows], pairing or SequentialPairingOptions())
    return _match_and_verify_pairs(database, pairs, options or MatchingPipelineOptions(),
                                   device=device)


def run_matches_import(
    database: Database,
    pairs: Sequence[Tuple[int, int]],
    options: Optional[MatchingPipelineOptions] = None,
    device=None,
) -> int:
    """reference behavior: the matches_importer path (match and verify the
    given pairs)."""
    return _match_and_verify_pairs(database, pairs, options or MatchingPipelineOptions(),
                                   device=device)
