"""LightGlue feature matcher.

Counterpart of colmap_tpu/feature/lightglue.py (reference behavior:
src/colmap/feature/onnx_matchers.h:36-62; the network follows P.
Lindenberger, P.-E. Sarlin, M. Pollefeys, "LightGlue: Local Feature Matching
at Light Speed", ICCV 2023).

Per layer: self-attention within each set, with a 2D rotary encoding of
the keypoints, then cross-attention between the sets, each followed by a
2-layer GELU MLP on the concatenation of state and message. The head gives
each feature a matchability and the pair a similarity whose double
log-softmax forms the partial assignment; matches are mutual best scores
above ``filter_threshold``. The attention runs on K53 (a) and the
log-assignment with the match extraction on K53 (b) (kernels/lightglue.py);
the linear layers stay torch.matmul. GELU is the tanh approximation, as
``jax.nn.gelu``'s default. The sets run at their true sizes: colmap_tpu
pads them to ``max_num_keypoints`` (a TPU shape constraint), which changes
nothing for the valid rows (masked logits are -1e9, whose exp is 0), but
the port still raises where colmap_tpu raises, on a set larger than the cap.

The parameter tree has colmap_tpu's layout (linear ``w`` (cin, cout), ``b``
(cout,)); ``init_params`` draws it from a ``torch.Generator``, and
``convert.lightglue_params_from_numpy`` carries colmap_tpu's across. No
weights ship; ``load_torch_weights`` imports an official checkpoint's
input projection and attention projections.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from colmap_tpu_torch.kernels import lightglue as KLG
from colmap_tpu_torch.utils.dtypes import resolve_device
from colmap_tpu_torch.utils.param_tree import module_tree, tree_module


@dataclasses.dataclass(frozen=True)
class LightGlueOptions:
    descriptor_dim: int = 128
    hidden_dim: int = 256
    num_layers: int = 9
    num_heads: int = 4
    filter_threshold: float = 0.1
    max_num_keypoints: int = 2048


def init_params(options: LightGlueOptions = LightGlueOptions(), seed: int = 0) -> Dict:
    """Deterministic random parameters with colmap_tpu's layout and scales
    (normal weights at sqrt(1 / cin), zero biases)."""
    d = options.hidden_dim
    gen = torch.Generator().manual_seed(seed)

    def lin(cin, cout):
        return {"w": torch.randn((cin, cout), generator=gen) * math.sqrt(1.0 / cin),
                "b": torch.zeros(cout)}

    layers = [{
        "self": {"qkv": lin(d, 3 * d), "out": lin(d, d), "ffn1": lin(2 * d, 2 * d),
                 "ffn2": lin(2 * d, d)},
        "cross": {"qk": lin(d, d), "v": lin(d, d), "out": lin(d, d), "ffn1": lin(2 * d, 2 * d),
                  "ffn2": lin(2 * d, d)},
    } for _ in range(options.num_layers)]
    return {"input_proj": lin(options.descriptor_dim, d), "layers": layers,
            "final_proj": lin(d, d), "matchability": lin(d, 1)}


def _linear(p, x):
    return x @ p["w"] + p["b"]


def rotary_encode(kpts, dim, num_heads):
    """(cos, sin), each (N, head_dim / 2), of keypoints (N, 2) in [-1, 1]:
    head_dim / 4 frequencies over [1, 100] for x, the same for y
    (lightglue.py:85-96)."""
    n_freq = dim // num_heads // 4
    freqs = torch.exp(torch.linspace(0.0, math.log(100.0), n_freq, dtype=kpts.dtype,
                                     device=kpts.device))
    ang = torch.cat([kpts[:, 0:1] * freqs[None], kpts[:, 1:2] * freqs[None]], dim=1)
    return torch.cos(ang), torch.sin(ang)


def _mlp(p, x, msg):
    y = torch.cat([x, msg], dim=-1)
    return x + _linear(p["ffn2"], F.gelu(_linear(p["ffn1"], y), approximate="tanh"))


def _self_block(p, x, enc, mask, num_heads):
    """colmap_tpu's _self_block (l.127-138) with K53 (a) reading q, k and v
    as column blocks of the qkv product."""
    qkv = _linear(p["qkv"], x)
    d = x.shape[-1]
    msg = KLG.attention(qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:], mask, mask, num_heads, *enc)
    return _mlp(p, x, _linear(p["out"], msg))


def _cross_blocks(p, x1, x2, mask1, mask2, num_heads):
    """Both sets' _cross_block (l.141-149) from the previous states; each
    set's qk and v projections are computed once and serve both
    directions."""
    qk1, qk2 = _linear(p["qk"], x1), _linear(p["qk"], x2)
    v1, v2 = _linear(p["v"], x1), _linear(p["v"], x2)
    m1 = KLG.attention(qk1, qk2, v2, mask1, mask2, num_heads)
    m2 = KLG.attention(qk2, qk1, v1, mask2, mask1, num_heads)
    return _mlp(p, x1, _linear(p["out"], m1)), _mlp(p, x2, _linear(p["out"], m2))


class LightGlue(nn.Module):
    """The LightGlue network on one device."""

    def __init__(self, params: Optional[Dict] = None,
                 options: LightGlueOptions = LightGlueOptions()):
        super().__init__()
        self.options = options
        self.net = tree_module(params if params is not None else init_params(options))

    def params(self) -> Dict:
        return module_tree(self.net)

    def head(self, desc1, kpts1, mask1, desc2, kpts2, mask2):
        """(sim (N1, N2) unmasked, matchability1 (N1,), matchability2
        (N2,)): the layers and the head of lightglue_forward (l.164-180)."""
        o, p = self.options, self.params()
        nh = o.num_heads
        x1, x2 = _linear(p["input_proj"], desc1), _linear(p["input_proj"], desc2)
        enc1 = rotary_encode(kpts1, o.hidden_dim, nh)
        enc2 = rotary_encode(kpts2, o.hidden_dim, nh)
        for layer in p["layers"]:
            x1 = _self_block(layer["self"], x1, enc1, mask1, nh)
            x2 = _self_block(layer["self"], x2, enc2, mask2, nh)
            x1, x2 = _cross_blocks(layer["cross"], x1, x2, mask1, mask2, nh)
        f1, f2 = _linear(p["final_proj"], x1), _linear(p["final_proj"], x2)
        sim = (f1 @ f2.T) / math.sqrt(f1.shape[-1])
        m1 = torch.sigmoid(_linear(p["matchability"], x1))[:, 0]
        m2 = torch.sigmoid(_linear(p["matchability"], x2))[:, 0]
        return sim, m1, m2

    def forward(self, desc1, kpts1, mask1, desc2, kpts2, mask2):
        """(n, 2) matches (row, column) on the device: mutual best scores
        above the filter threshold."""
        with torch.inference_mode():
            sim, m1, m2 = self.head(desc1, kpts1, mask1, desc2, kpts2, mask2)
            return KLG.log_assignment(sim, mask1, mask2, m1, m2,
                                      self.options.filter_threshold)[0]


def lightglue_forward(model: LightGlue, desc1, kpts1, mask1, desc2, kpts2, mask2):
    """colmap_tpu's lightglue_forward: (scores (N1, N2) log-assignment,
    matchability1, matchability2) of two masked sets."""
    with torch.inference_mode():
        sim, m1, m2 = model.head(desc1, kpts1, mask1, desc2, kpts2, mask2)
        _, scores = KLG.log_assignment(sim, mask1, mask2, m1, m2,
                                       model.options.filter_threshold, want_scores=True)
        return scores, m1, m2


def _prep(desc, kpts, shape, cap):
    """Normalized descriptors and keypoints of one set, as colmap_tpu's
    prep (l.202-216), at the set's true size."""
    n = len(desc)
    if n > cap:
        raise ValueError(f"{n} keypoints exceed LightGlueOptions.max_num_keypoints = {cap}")
    d = np.asarray(desc, dtype=np.float32).copy()
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    h, w = shape
    k = ((np.asarray(kpts[:, :2], dtype=np.float32) - np.array([w / 2.0, h / 2.0]))
         / (0.5 * max(h, w))).astype(np.float32)
    return d, k


def match_lightglue(desc1: np.ndarray, kpts1: np.ndarray, desc2: np.ndarray,
                    kpts2: np.ndarray, image_shape1: Tuple[int, int],
                    image_shape2: Tuple[int, int], params=None,
                    options: LightGlueOptions = LightGlueOptions(), device=None) -> np.ndarray:
    """(M, 2) uint32 matches (mutual best above the threshold) between two
    feature sets on ``device`` (default cuda); ``params`` is a parameter
    tree, a LightGlue module, or None for init_params(options). Raises
    ValueError on a set larger than options.max_num_keypoints, as
    colmap_tpu does."""
    device = resolve_device(device)
    cap = options.max_num_keypoints
    d1, k1 = _prep(desc1, kpts1, image_shape1, cap)
    d2, k2 = _prep(desc2, kpts2, image_shape2, cap)
    if len(d1) == 0 or len(d2) == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    model = params if isinstance(params, LightGlue) else LightGlue(params, options)
    model = model.to(device)
    dtype = next(model.parameters()).dtype
    t = [torch.from_numpy(a).to(device=device, dtype=dtype) for a in (d1, k1, d2, k2)]
    m1 = torch.ones(len(d1), dtype=torch.bool, device=device)
    m2 = torch.ones(len(d2), dtype=torch.bool, device=device)
    return model(t[0], t[1], m1, t[2], t[3], m2).cpu().numpy().astype(np.uint32)


def load_torch_weights(path: str, options: LightGlueOptions = LightGlueOptions()) -> Dict:
    """Import an official LightGlue PyTorch checkpoint with colmap_tpu's
    mapping (l.233-262): input_proj and each layer's self_attn.Wqkv,
    self_attn.out_proj, cross_attn.to_qk, to_v and to_out (torch's (out,
    in) weights transposed to (in, out)); every other layer keeps
    init_params' values, as in colmap_tpu."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = init_params(options)

    def lin_from(name):
        return {"w": state[name + ".weight"].detach().t().contiguous(),
                "b": state[name + ".bias"].detach().clone()}

    if "input_proj.weight" in state:
        params["input_proj"] = lin_from("input_proj")
    for i in range(options.num_layers):
        pre = f"transformers.{i}"
        for (block, sub), theirs in (
            (("self", "qkv"), f"{pre}.self_attn.Wqkv"),
            (("self", "out"), f"{pre}.self_attn.out_proj"),
            (("cross", "qk"), f"{pre}.cross_attn.to_qk"),
            (("cross", "v"), f"{pre}.cross_attn.to_v"),
            (("cross", "out"), f"{pre}.cross_attn.to_out"),
        ):
            if theirs + ".weight" in state:
                params["layers"][i][block][sub] = lin_from(theirs)
    return params
