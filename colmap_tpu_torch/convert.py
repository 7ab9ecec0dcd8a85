"""Carry bundle-adjustment state between colmap_tpu and this package.

Both packages solve the same problem when they are handed the same arrays:
``problem_from_numpy`` builds the port's BAProblem (or BAMasks) from the
numpy form of colmap_tpu's fields (``np.asarray`` of each), and
``problem_to_numpy`` gives the inverse. ``options_from_fields`` carries a
BAOptions across field by field. Nothing here imports colmap_tpu: callers
pass plain dicts and numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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
