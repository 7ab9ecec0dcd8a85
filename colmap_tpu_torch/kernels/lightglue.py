"""LightGlue kernel: wrappers, plain versions, launch count.

One CUDA kernel with two entries carries the device program of
colmap_tpu/feature/lightglue.py ``lightglue_forward`` (source
``colmap_tpu_torch/csrc/lightglue_attention.cu``):

    K53 lightglue_attention  (a) masked multi-head attention, head_dim 64,
                             with the 2D rotary encoding applied to q and
                             k as they load (self-attention); masked keys
                             get the logit -1e9, masked queries give 0;
                             (b) the log-assignment: the masked similarity's
                             row and column log-softmax plus
                             log(matchability + 1e-12), then each row's and
                             column's argmax (the first index on ties),
                             the mutual check and exp(score) > threshold,
                             written as the match list (and, when asked,
                             the score matrix)

(a) replaces ``_attention`` (l.118-124) with ``_apply_rotary`` (l.99) on
``_self_block``'s q and k; (b) the log-assignment of ``lightglue_forward``
(l.177-187) and the host match extraction of ``match_lightglue``
(l.221-230). The linear layers, the similarity product and the
matchability stay torch.matmul: plain large matrix products.

Layouts follow colmap_tpu's: q, k, v and the output are (N, H * 64) rows
(``_heads`` / ``_unheads``); the kernel reads any row stride, so q, k and v
may be column blocks of one qkv product. cos and sin are (N, 32) tables of
``_rotary_encode``. As in the other kernel modules, a wrapper runs the
plain version when its tensor lies on the CPU and launches the kernel on a
CUDA tensor, or raises; ``LAUNCHES`` counts launches by kernel name.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from colmap_tpu_torch.kernels import sfm as S

LAUNCHES = {"lightglue_attention": 0}

HEAD_DIM = 64
MASKED = -1e9  # colmap_tpu's finite mask value (lightglue.py:121, :178)
EPS = 1e-12  # log(matchability + EPS) (lightglue.py:184)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lightglue_attention_f32": [_I] * 3 + [_P, _I, _P, _I, _P, _I] + [_P] * 4 + [_P, _I, _P],
    "lightglue_assignment_f32": [_I, _I, ctypes.c_float] + [_P] * 14,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from colmap_tpu_torch.kernels.build import library

    lib = library()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(fn_name, *args):
    err = getattr(_lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")
    LAUNCHES["lightglue_attention"] += 1


def _heads(x, num_heads):
    n, d = x.shape
    return x.reshape(n, num_heads, d // num_heads).movedim(1, 0)


def _unheads(x):
    h, n, dh = x.shape
    return x.movedim(0, 1).reshape(n, h * dh)


def apply_rotary(x, cos, sin):
    """x (H, N, Dh): rotate feature pairs (2i, 2i + 1) by the angles whose
    cos and sin are (N, Dh / 2) (lightglue.py:99-105)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos[None] - x2 * sin[None], x1 * sin[None] + x2 * cos[None]],
                       dim=-1).reshape(x.shape)


def attention_plain(q, k, v, mask_q, mask_k, num_heads, cos=None, sin=None):
    """(Nq, H * Dh): colmap_tpu's _attention on rows q (Nq, H * Dh), k, v
    (Nk, H * Dh), with the rotary encoding applied to q and k when cos and
    sin are given (self-attention)."""
    q, k, v = (_heads(t, num_heads) for t in (q, k, v))
    if cos is not None:
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    logits = torch.einsum("hnd,hmd->hnm", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    logits = torch.where(mask_k[None, None, :], logits, torch.full((), MASKED, dtype=q.dtype,
                                                                   device=q.device))
    out = torch.einsum("hnm,hmd->hnd", torch.softmax(logits, dim=-1), v)
    return _unheads(out * mask_q[None, :, None])


def attention_library(q, k, v, mask_k, num_heads):
    """The same attention (without the rotation and the query mask) through
    F.scaled_dot_product_attention with the additive mask; timed beside K53
    (a) and used nowhere in the port."""
    q, k, v = (_heads(t, num_heads)[None] for t in (q, k, v))
    bias = torch.where(mask_k, 0.0, MASKED).to(q.dtype)[None, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def _rows(name, x, n, dev):
    if x.device != dev or x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"{name} must be a float32 ({n}, C) tensor on {dev}")
    if x.stride(1) != 1 or x.stride(0) % 4 or x.data_ptr() % 16:
        raise ValueError(f"{name} needs unit column stride and 16-byte aligned rows")


def attention(q, k, v, mask_q, mask_k, num_heads, cos=None, sin=None):
    """K53 (a): attention_plain on the card. q, k, v may be column views of
    a larger product (unit column stride, rows 16-byte aligned)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask_q, mask_k, num_heads, cos, sin)
    dev = S._require_cuda(q)
    nq, nk = q.shape[0], k.shape[0]
    width = num_heads * HEAD_DIM
    if q.shape[1] != width:
        raise ValueError(f"K53 (a) takes head_dim {HEAD_DIM}: q has {q.shape[1]} columns for "
                         f"{num_heads} heads")
    for name, x, n in (("q", q, nq), ("k", k, nk), ("v", v, nk)):
        _rows(name, x, n, dev)
        if x.shape[1] != width:
            raise ValueError(f"{name} has {x.shape[1]} columns, expected {width}")
    S._check("mask_q", mask_q, torch.bool, (nq,), dev)
    S._check("mask_k", mask_k, torch.bool, (nk,), dev)
    if cos is not None:
        if nq != nk:
            raise ValueError("the rotary encoding is for self-attention (nq == nk)")
        S._check("cos", cos, torch.float32, (nq, HEAD_DIM // 2), dev)
        S._check("sin", sin, torch.float32, (nq, HEAD_DIM // 2), dev)
    out = torch.empty((nq, width), dtype=torch.float32, device=dev)
    if nq and nk:
        rot = (S._ptr(cos), S._ptr(sin)) if cos is not None else (None, None)
        _launch("lightglue_attention_f32", num_heads, nq, nk, S._ptr(q), q.stride(0), S._ptr(k),
                k.stride(0), S._ptr(v), v.stride(0), S._ptr(mask_q), S._ptr(mask_k), *rot,
                S._ptr(out), width, S._stream(dev))
    elif nq:
        out.zero_()
    return out


def log_assignment_plain(sim, mask1, mask2, m1, m2):
    """(N1, N2) scores of lightglue_forward (l.178-186): the similarity
    masked to -1e9, its row and column log_softmax, plus log(m + 1e-12)."""
    sim = torch.where(mask1[:, None] & mask2[None, :], sim,
                      torch.full((), MASKED, dtype=sim.dtype, device=sim.device))
    s_row = torch.log_softmax(sim, dim=1)
    s_col = torch.log_softmax(sim, dim=0)
    return s_row + s_col + torch.log(m1 + EPS)[:, None] + torch.log(m2 + EPS)[None, :]


def extract_matches_plain(scores, mask1, mask2, threshold):
    """(n, 2) int64 (row, column) matches of match_lightglue (l.224-230)
    over the valid rows and columns: mutual argmax (the first index on
    ties) with exp(score) > threshold, in row order."""
    s = scores.masked_fill(~(mask1[:, None] & mask2[None, :]), -torch.inf)
    best12 = s.argmax(dim=1)
    best21 = s.argmax(dim=0)
    idx1 = torch.arange(len(s), device=s.device)
    keep = (best21[best12] == idx1) & (torch.exp(s[idx1, best12]) > threshold) & mask1
    return torch.stack([idx1[keep], best12[keep]], dim=1)


def log_assignment_library(sim):
    """log_softmax twice and argmax twice; timed beside K53 (b) and used
    nowhere in the port."""
    s = torch.log_softmax(sim, dim=1) + torch.log_softmax(sim, dim=0)
    return s.argmax(dim=1), s.argmax(dim=0)


def log_assignment(sim, mask1, mask2, m1, m2, threshold, want_scores=False):
    """K53 (b): (matches (n, 2), scores (N1, N2) or None). On the CPU the
    plain versions; on the card the kernel writes the match list, and the
    scores only when asked."""
    if sim.device.type == "cpu":
        scores = log_assignment_plain(sim, mask1, mask2, m1, m2)
        return (extract_matches_plain(scores, mask1, mask2, threshold),
                scores if want_scores else None)
    dev = S._require_cuda(sim)
    n1, n2 = sim.shape
    S._check("sim", sim, torch.float32, (n1, n2), dev)
    S._check("mask1", mask1, torch.bool, (n1,), dev)
    S._check("mask2", mask2, torch.bool, (n2,), dev)
    S._check("m1", m1, torch.float32, (n1,), dev)
    S._check("m2", m2, torch.float32, (n2,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    scores = torch.empty((n1, n2), **f32) if want_scores else None
    if not (n1 and n2):
        return torch.zeros((0, 2), **i32), scores
    row = torch.empty((3, n1), **f32)  # max, log of the sum of exp, log(m1 + EPS)
    col = torch.empty((3, n2), **f32)
    best21 = torch.empty(n2, **i32)
    best12 = torch.empty(n1, **i32)
    keep = torch.empty(n1, **i32)
    matches = torch.empty((n1, 2), **i32)
    count = torch.zeros(1, **i32)
    _launch("lightglue_assignment_f32", n1, n2, ctypes.c_float(threshold),
            *map(S._ptr, (sim, mask1, mask2, m1, m2, row, col, best21, best12, keep, matches,
                          count)),
            S._ptr(scores) if want_scores else None, S._stream(dev))
    return matches[:int(count.item())], scores
