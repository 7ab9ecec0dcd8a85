"""ALIKED learned keypoints and descriptors.

Counterpart of colmap_tpu/feature/aliked.py (reference behavior:
src/colmap/feature/aliked.{h,cc}, which runs the ALIKED ONNX graphs; the
network follows X. Zhao et al., "ALIKED: A Lighter Keypoint and Descriptor
Extraction Network via Deformable Transformation", IEEE TIM 2023).

The n16 network: a 4-stage conv backbone (16/32/64/128 channels, 2 x 2
average pooling before stages 2-4, SELU), 1 x 1 aggregation convs upsampled
to the image and concatenated into a 128-channel feature map, a 4-conv
score head (SMH), keypoint detection (DKD: NMS, top-K, 5 x 5 soft-argmax)
and the SDDH descriptor head (M = 16 deformed samples a keypoint). On the
card the backbone and score head run on K50, DKD on K51 and SDDH on K52
(kernels/aliked.py); on the CPU the same wrappers run their plain versions.

The parameter tree has colmap_tpu's layout (conv weights (Cout, Cin, k, k),
biases (Cout,), sddh_agg (M, D, D)). ``init_params`` draws it from a
``torch.Generator``, so the port's default weights differ from colmap_tpu's
(jax.random keys); ``convert.aliked_params_from_numpy`` carries colmap_tpu's
across. No weights ship: ``load_torch_weights`` imports an official
checkpoint's backbone and aggregation convs when the user has one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from colmap_tpu_torch.kernels import aliked as KA
from colmap_tpu_torch.utils.dtypes import resolve_device
from colmap_tpu_torch.utils.param_tree import module_tree, tree_module


@dataclasses.dataclass(frozen=True)
class AlikedOptions:
    """reference: feature/aliked.h:40-44 (model names and limits)."""

    model_name: str = "aliked-n16"  # "aliked-n16" | "aliked-n32"
    max_num_keypoints: int = 4096
    detection_threshold: float = 0.2
    nms_radius: int = 2
    descriptor_dim: int = 128
    num_sample_offsets: int = 16  # M in SDDH (32 for n32)


def init_params(options: AlikedOptions = AlikedOptions(), seed: int = 0) -> Dict:
    """Deterministic random parameters with colmap_tpu's layout and scales
    (He-normal convs, zero biases, the aggregation at sqrt(1 / D))."""
    c1, c2, c3, c4 = (16, 32, 64, 128)
    dim = options.descriptor_dim
    M = options.num_sample_offsets
    gen = torch.Generator().manual_seed(seed)

    def conv(k, cin, cout):
        w = torch.randn((cout, cin, k, k), generator=gen) * math.sqrt(2.0 / (k * k * cin))
        return {"w": w, "b": torch.zeros(cout)}

    return {
        "block1": {"conv1": conv(3, 1, c1), "conv2": conv(3, c1, c1)},
        "block2": {"conv1": conv(3, c1, c2), "conv2": conv(3, c2, c2)},
        "block3": {"conv1": conv(3, c2, c3), "conv2": conv(3, c3, c3)},
        "block4": {"conv1": conv(3, c3, c4), "conv2": conv(3, c4, c4)},
        "agg1": conv(1, c1, dim // 4),
        "agg2": conv(1, c2, dim // 4),
        "agg3": conv(1, c3, dim // 4),
        "agg4": conv(1, c4, dim // 4),
        "smh1": conv(3, dim, 8),
        "smh2": conv(3, 8, 4),
        "smh3": conv(3, 4, 4),
        "smh4": conv(3, 4, 1),
        "sddh_offset": {"conv1": conv(3, dim, dim), "conv2": conv(3, dim, 2 * M)},
        "sddh_weight": conv(1, dim, dim),
        "sddh_agg": {"w": torch.randn((M, dim, dim), generator=gen) * math.sqrt(1.0 / dim)},
    }


def backbone_and_score(p: Dict, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """image (H, W) in [0, 1] -> (feat (D, H, W), score (H, W)) through K50
    (colmap_tpu l.120-138): the aggregation convs write their channel
    slices of feat directly, so the concat is never copied."""
    H, W = image.shape
    S = KA.ACT_SELU

    def block(x, q, pool=False):
        x = KA.conv(x, q["conv1"]["w"], q["conv1"]["b"], S, pool)
        return KA.conv(x, q["conv2"]["w"], q["conv2"]["b"], S)

    f1 = block(image[None], p["block1"])
    f2 = block(f1, p["block2"], pool=True)
    f3 = block(f2, p["block3"], pool=True)
    f4 = block(f3, p["block4"], pool=True)
    q = p["agg1"]["w"].shape[0]
    feat = torch.empty((4 * q, H, W), dtype=image.dtype, device=image.device)
    KA.conv(f1, p["agg1"]["w"], p["agg1"]["b"], S, out=feat[:q])
    for i, f in enumerate((f2, f3, f4), start=1):
        a = KA.conv(f, p[f"agg{i + 1}"]["w"], p[f"agg{i + 1}"]["b"])
        KA.upsample_selu(a, feat[i * q:(i + 1) * q])
    s = feat
    for name in ("smh1", "smh2", "smh3"):
        s = KA.conv(s, p[name]["w"], p[name]["b"], S)
    score = KA.conv(s, p["smh4"]["w"], p["smh4"]["b"], KA.ACT_SIGMOID)[0]
    return feat, score


class Aliked(nn.Module):
    """The ALIKED network on one device: forward(image) -> (xy (n, 2),
    scores (n,), descriptors (n, D)) for the n = min(K, peaks) keypoints,
    in lax.top_k's order. The fixed-K padding of colmap_tpu's
    aliked_forward (a TPU shape constraint) is not kept."""

    def __init__(self, params: Optional[Dict] = None, options: AlikedOptions = AlikedOptions()):
        super().__init__()
        self.options = options
        self.net = tree_module(params if params is not None else init_params(options))

    def params(self) -> Dict:
        return module_tree(self.net)

    def forward(self, image: torch.Tensor):
        o = self.options
        with torch.inference_mode():
            p = self.params()
            feat, score = backbone_and_score(p, image)
            xy, scores = KA.dkd(score, o.max_num_keypoints, o.nms_radius, o.detection_threshold)
            return xy, scores, KA.sddh(feat, xy, p)


def extract_aliked(image: np.ndarray, params=None, options: AlikedOptions = AlikedOptions(),
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 grayscale (H, W) -> (keypoints (n, 4) float32 (x, y, 1, 0),
    descriptors (n, D) float32), colmap_tpu's extract_aliked on ``device``
    (default cuda). ``params`` is a parameter tree, an Aliked module, or
    None for init_params(options)."""
    device = resolve_device(device)
    model = params if isinstance(params, Aliked) else Aliked(params, options)
    model = model.to(device)
    img = torch.from_numpy(np.asarray(image, dtype=np.float32) / 255.0).to(device)
    xy, _, desc = model(img)
    xy = xy.cpu().numpy()
    kp = np.concatenate([xy, np.ones((len(xy), 1)), np.zeros((len(xy), 1))], axis=1)
    return kp.astype(np.float32), desc.cpu().numpy().astype(np.float32)


def load_torch_weights(path: str, options: AlikedOptions = AlikedOptions()) -> Dict:
    """Import an official ALIKED PyTorch checkpoint into the parameter tree
    with colmap_tpu's mapping (l.255-302): block1-4's convs and the
    aggregation convs conv1-4 (to agg1-4), shapes checked; every other
    layer keeps init_params' values, as in colmap_tpu."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    params = init_params(options)

    def put(dst, name):
        t = state[name]
        if tuple(dst["w"].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(t.shape)} vs "
                             f"{tuple(dst['w'].shape)}")
        dst["w"] = t.detach().clone()
        bias = name.replace("weight", "bias")
        if bias in state:
            dst["b"] = state[bias].detach().clone()

    for blk in ("block1", "block2", "block3", "block4"):
        for sub in ("conv1", "conv2"):
            name = f"{blk}.{sub}.weight"
            if name in state:
                put(params[blk][sub], name)
    for i in range(1, 5):
        if f"conv{i}.weight" in state:
            put(params[f"agg{i}"], f"conv{i}.weight")
    return params
