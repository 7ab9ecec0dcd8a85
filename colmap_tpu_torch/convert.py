"""Carry state between colmap_tpu and this package.

Both packages solve the same problem when they are handed the same arrays:
``problem_from_numpy`` builds the port's BAProblem (or BAMasks) from the
numpy form of colmap_tpu's fields (``np.asarray`` of each), and
``problem_to_numpy`` gives the inverse. ``options_from_fields`` carries a
BAOptions across field by field.

The scene and the mapper's options are host objects with the same fields in
both packages: ``convert_reconstruction`` and ``convert_camera`` rebuild a
Reconstruction or a Camera of either package with the classes of the other
(by default the port's), ``convert_options`` does the same for dataclass
options, nested ones included (the mapper's, MatchingOptions,
TwoViewGeometryOptions with its RansacOptions, MatchingPipelineOptions), and
``convert_two_view_geometry`` for a TwoViewGeometry. A database needs no
conversion: both packages read and write the same SQLite schema.

Dense stereo: ``patch_match_problem_from_numpy`` builds the port's
PatchMatchProblem from the numpy form of colmap_tpu's fields,
``convert_fusion_image`` carries a FusionImage across, and
``convert_options`` carries PatchMatchOptions and FusionOptions.

Global SfM: ``convert_options`` carries RotationAveragingOptions,
GlobalPositioningOptions (frozen), ViewGraphCalibrationOptions,
GlobalMapperOptions (with its nested rotation_averaging, positioning and
ba) and GlobalPipelineOptions, both ways.

Retrieval: ``tree_vocabulary_from_numpy`` builds the port's TreeVocabulary
from colmap_tpu's levels, and ``visual_index_from_numpy`` the port's index
(postings in CSR order by word) from the numpy state of a colmap_tpu
VisualIndex, so that both packages can query one index state.

Nothing here imports colmap_tpu: callers pass its objects and, for the way
back, its classes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from colmap_tpu_torch.estimators.bundle_adjustment import BAMasks, BAOptions, BAProblem

_INT_FIELDS = ("obs_frame", "obs_cam", "obs_point")


def problem_from_numpy(d: Dict[str, np.ndarray], device, dtype=None):
    """BAProblem (or BAMasks, when ``d`` holds the mask fields) on ``device``.

    Float fields keep their numpy dtype unless ``dtype`` is given; id fields
    become int32.
    """
    cls = BAProblem if set(BAProblem._fields) <= set(d) else BAMasks
    out = {}
    for name in cls._fields:
        t = torch.from_numpy(np.array(d[name]))
        dt = torch.int32 if name in _INT_FIELDS else (dtype or t.dtype)
        out[name] = t.to(device=device, dtype=dt).contiguous()
    return cls(**out)


def problem_to_numpy(p) -> Dict[str, np.ndarray]:
    """Field name -> numpy array of a BAProblem or BAMasks."""
    return {name: getattr(p, name).detach().cpu().numpy() for name in p._fields}


def options_from_fields(fields: Dict[str, object]) -> BAOptions:
    """BAOptions from a mapping of its fields (e.g. dataclasses.asdict of
    colmap_tpu's BAOptions); unknown keys raise."""
    names = {f.name for f in dataclasses.fields(BAOptions)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"unknown BAOptions fields: {sorted(extra)}")
    return BAOptions(**fields)


def _pose(pose, types):
    return None if pose is None else types.Pose(np.array(pose.quat, dtype=np.float64),
                                                np.array(pose.t, dtype=np.float64))


def convert_camera(camera, types=None):
    """A Camera of either package as a Camera of ``types`` (default: the
    port's scene.types module)."""
    if types is None:
        from colmap_tpu_torch.scene import types
    return types.Camera(camera_id=camera.camera_id, model_id=int(camera.model_id),
                        width=camera.width, height=camera.height,
                        params=np.array(camera.params, dtype=np.float64),
                        has_prior_focal_length=camera.has_prior_focal_length)


def convert_reconstruction(recon, types=None, reconstruction_cls=None):
    """A Reconstruction of either package rebuilt with ``types`` and
    ``reconstruction_cls`` (default: the port's), with the same ids, poses,
    registrations, 2D points, tracks and next point id."""
    if types is None:
        from colmap_tpu_torch.scene import types
    if reconstruction_cls is None:
        from colmap_tpu_torch.scene.reconstruction import Reconstruction as reconstruction_cls
    out = reconstruction_cls()
    for rig in recon.rigs.values():
        out.add_rig(types.Rig(rig_id=rig.rig_id, ref_sensor_id=tuple(rig.ref_sensor_id),
                              sensors={tuple(k): _pose(v, types) for k, v in rig.sensors.items()}))
    for camera in recon.cameras.values():
        out.add_camera(convert_camera(camera, types))
    for frame in recon.frames.values():
        out.add_frame(types.Frame(frame_id=frame.frame_id, rig_id=frame.rig_id,
                                  rig_from_world=_pose(frame.rig_from_world, types),
                                  data_ids=[tuple(d) for d in frame.data_ids]))
    for image in recon.images.values():
        out.add_image(types.Image(image_id=image.image_id, name=image.name,
                                  camera_id=image.camera_id, frame_id=image.frame_id,
                                  points2D_xy=np.array(image.points2D_xy, dtype=np.float64),
                                  points2D_p3d=np.array(image.points2D_p3d, dtype=np.int64)))
    for pid, point in recon.points3D.items():
        out.points3D[pid] = types.Point3D(
            xyz=np.array(point.xyz, dtype=np.float64), color=np.array(point.color),
            error=float(point.error),
            track=[types.TrackElement(el.image_id, el.point2D_idx) for el in point.track])
    for frame_id in recon.reg_frame_ids():
        out.register_frame(frame_id)
    out._next_point3D_id = recon._next_point3D_id
    return out


def convert_two_view_geometry(g, types=None):
    """A TwoViewGeometry of either package as one of ``types`` (default: the
    port's scene.types module), with copies of its arrays."""
    if types is None:
        from colmap_tpu_torch.scene import types

    def mat(m):
        return None if m is None else np.array(m, dtype=np.float64)

    def cam(c):
        return None if c is None else convert_camera(c, types)

    return types.TwoViewGeometry(
        config=int(g.config), E=mat(g.E), F=mat(g.F), H=mat(g.H),
        cam2_from_cam1=_pose(g.cam2_from_cam1, types),
        inlier_matches=np.array(g.inlier_matches, dtype=np.uint32).reshape(-1, 2),
        tri_angle=float(g.tri_angle), camera1=cam(g.camera1), camera2=cam(g.camera2))


def convert_options(options, cls: Optional[type] = None, **nested):
    """A dataclass of options rebuilt field by field as ``cls`` (by default
    the port's class of the same module path and name). Nested dataclass
    fields are converted the same way, each as the class ``cls`` itself
    builds for that field by default; ``nested`` maps a field name to
    another class to build it as."""
    if cls is None:
        import importlib

        module = options.__class__.__module__.replace("colmap_tpu.", "colmap_tpu_torch.", 1)
        cls = getattr(importlib.import_module(module), options.__class__.__name__)
    targets = {f.name: f for f in dataclasses.fields(cls)}
    values = {}
    for f in dataclasses.fields(options):
        if f.name not in targets:
            raise ValueError(f"{cls.__name__} has no field {f.name}")
        v = getattr(options, f.name)
        if dataclasses.is_dataclass(v):
            sub = nested.get(f.name)
            factory = targets[f.name].default_factory
            if sub is None and factory is not dataclasses.MISSING:
                sub = type(factory())
            v = convert_options(v, sub)
        values[f.name] = v
    return cls(**values)


def patch_match_problem_from_numpy(d: Dict[str, Optional[np.ndarray]], device, dtype=None):
    """The port's PatchMatchProblem on ``device`` from the numpy form of
    colmap_tpu's fields (``np.asarray`` of each; ``src_depths`` may be
    None). Fields keep their numpy dtype unless ``dtype`` is given."""
    from colmap_tpu_torch.mvs.patch_match import PatchMatchProblem

    def tensor(a):
        if a is None:
            return None
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype).contiguous()

    return PatchMatchProblem(**{name: tensor(d.get(name)) for name in PatchMatchProblem._fields})


def convert_fusion_image(fi, cls=None):
    """A FusionImage of either package as one of ``cls`` (default: the
    port's), with copies of its arrays."""
    if cls is None:
        from colmap_tpu_torch.mvs.fusion import FusionImage as cls
    color = None if fi.color is None else np.array(fi.color)
    return cls(fi.image_id, np.array(fi.K), np.array(fi.R), np.array(fi.t), np.array(fi.depth),
               np.array(fi.normal), color)


def tree_vocabulary_from_numpy(levels, device=None):
    """The port's TreeVocabulary of (B^l, B, D) level arrays, in the device's
    float type (float64 on the CPU)."""
    from colmap_tpu_torch.retrieval.visual_index import TreeVocabulary, _rows
    from colmap_tpu_torch.utils.dtypes import floatx, resolve_device

    device = resolve_device(device)
    return TreeVocabulary([_rows(lv, device, floatx(device)) for lv in levels])


def visual_index_from_numpy(vocabulary, thresholds, inverted, image_word_counts, num_images,
                            device=None):
    """The port's VisualIndex holding a colmap_tpu VisualIndex's state:
    ``vocabulary`` its (W, D) vocabulary or its tree's list of levels,
    ``thresholds`` its signature_thresholds, ``inverted`` its {word: [(image
    id, uint64 signature)]} in posting order, ``image_word_counts`` its
    {image id: {word: count}} and ``num_images``. Signatures become eight
    little-endian bytes."""
    import torch

    from colmap_tpu_torch.retrieval.visual_index import VisualIndex

    if isinstance(vocabulary, (list, tuple)):
        vocabulary = tree_vocabulary_from_numpy(vocabulary, device)
    index = VisualIndex(vocabulary, device=device)
    dev = index.device
    index.signature_thresholds = torch.as_tensor(np.asarray(thresholds, np.float32), device=dev)
    words = [w for w in sorted(inverted) for _ in inverted[w]]
    images = [iid for w in sorted(inverted) for iid, _ in inverted[w]]
    sigs = np.array([int(s) for w in sorted(inverted) for _, s in inverted[w]], dtype="<u8")
    if words:
        index._added = [(torch.as_tensor(words, dtype=torch.long, device=dev),
                         torch.as_tensor(images, dtype=torch.long, device=dev),
                         torch.as_tensor(sigs.view(np.uint8).reshape(-1, 8), device=dev))]
    for iid, counts in image_word_counts.items():
        ws = sorted(counts)
        index.image_word_counts[iid] = (torch.as_tensor(ws, dtype=torch.long, device=dev),
                                        torch.as_tensor([counts[w] for w in ws],
                                                        dtype=torch.long, device=dev))
    index.num_images = int(num_images)
    return index
