"""View-graph calibration: estimate focal lengths from fundamental matrices.

Counterpart of colmap_tpu/estimators/view_graph_calibration.py (reference
behavior: src/colmap/estimators/view_graph_calibration.h:39-73): per pair
the residual (σ₁−σ₂)/(σ₁+σ₂) of the upgraded essential matrix E = K₂ᵀ F K₁,
which vanishes at the true intrinsics, minimised over per-camera log focal
scales by Adam. The loss and its gradient are K23 (kernels/global_sfm.py)
under torch autograd; Adam runs as torch ops on the solve's device with
colmap_tpu's constants and clip, and reads nothing back until the end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from colmap_tpu_torch.kernels import global_sfm as K
from colmap_tpu_torch.utils.dtypes import floatx, resolve_device


@dataclasses.dataclass
class ViewGraphCalibrationOptions:
    num_iterations: int = 200
    learning_rate: float = 0.02
    min_focal_ratio: float = 0.2
    max_focal_ratio: float = 5.0


def calibrate_view_graph(
    camera_ids: List[int],
    prior_focals: Dict[int, float],
    principal_points: Dict[int, Tuple[float, float]],
    edges: List[Tuple[int, int, np.ndarray]],  # (camera_id1, camera_id2, F)
    options: ViewGraphCalibrationOptions = ViewGraphCalibrationOptions(),
    device=None,
    dtype=None,
    kernels=K.KERNELS,
) -> Dict[int, float]:
    """Per-camera focal lengths {camera_id: focal} optimised over the view
    graph; the priors when there is no edge. Runs on ``device`` (default
    cuda) in ``dtype`` (default its floatx); ``kernels`` as in
    rotation_averaging.estimate_rotations."""
    if not edges:
        return dict(prior_focals)
    device = resolve_device(device)
    dtype = dtype or floatx(device)
    row = {cid: i for i, cid in enumerate(camera_ids)}
    n = len(camera_ids)
    f0 = np.array([prior_focals[c] for c in camera_ids], dtype=np.float64)
    pp = np.array([principal_points[c] for c in camera_ids], dtype=np.float64)
    e1 = np.array([row[a] for (a, _, _) in edges], dtype=np.int32)
    e2 = np.array([row[b] for (_, b, _) in edges], dtype=np.int32)
    Fs = np.stack([np.asarray(F, dtype=np.float64) for (_, _, F) in edges])
    graph = K.vgc_graph(*(torch.as_tensor(a).to(device) for a in (Fs, e1, e2, f0, pp)))

    lo, hi = float(np.log(options.min_focal_ratio)), float(np.log(options.max_focal_ratio))
    lr = options.learning_rate
    x = torch.zeros(n, dtype=dtype, device=device)
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    for it in range(options.num_iterations):
        xg = x.detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(kernels.vgc_loss(graph, xg), xg)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** (it + 1))
        vh = v / (1 - 0.999 ** (it + 1))
        x = torch.clamp(x - lr * mh / (torch.sqrt(vh) + 1e-8), lo, hi)
    scales = np.exp(x.double().cpu().numpy())
    return {cid: float(f0[row[cid]] * scales[row[cid]]) for cid in camera_ids}
