"""ALIKED kernels: wrappers, plain versions, launch counts.

Three CUDA kernels carry the device program of colmap_tpu/feature/aliked.py
``aliked_forward`` (sources in ``colmap_tpu_torch/csrc``):

    K50 aliked_conv   (a) a direct k x k convolution (k in {1, 3}, SAME zero
                      padding) with bias and activation (none, SELU,
                      sigmoid), optionally average-pooling its input 2 x 2
                      on the fly, written into a channel slice of its
                      output; (b) bilinear upsampling (half-pixel centres)
                      and SELU into a channel slice
    K51 aliked_dkd    the peak test of the score map (5 x 5 max, -inf
                      outside, >= and the strict threshold), candidates
                      compacted as (score, flat index) keys, a radix
                      select of the first K keys, their sort, and the
                      5 x 5 soft-argmax refinement, all on the card
    K52 aliked_sddh   (a) the SDDH offsets at each keypoint from its 6 x 6
                      feature patch (conv1, SELU, conv2 at the 4 bilinear
                      corners, both zero paddings, then 5 tanh(o / 5));
                      (b) the descriptors: M bilinear samples of the
                      feature map, the 1 x 1 weight conv, SELU, the M
                      aggregation products and the L2 norm

They replace ``backbone_and_score`` (l.120-138, K50), ``_nms_keypoints``
(l.141-176, K51) and ``sddh_descriptors`` (l.179-218, K52). K52 is sparse:
it computes only what the keypoints sample, where colmap_tpu convolves the
whole image for the offsets and the weighted features. Two identities make
that exact. A corner of the offset map needs conv2 over the 3 x 3
neighbourhood of SELU(conv1) values, which need the 5 x 5 neighbourhood of
features: a 6 x 6 patch covers the 4 corners, and every value that lies
outside the image is 0, as SAME padding makes it at both levels. And the
1 x 1 weight conv commutes with the bilinear sample (the four weights sum
to 1), so K52 samples the feature map and applies W + b to each sample.
``sddh_offsets_sparse`` is that algorithm in PyTorch: the CPU tests hold it
against the dense plain version (``sddh_offsets_plain``), which convolves
the whole image as colmap_tpu does, and the card holds K52 against the
dense one.

K51 selects the first K candidates by (score descending, flat index
ascending), the order of ``lax.top_k``. Each candidate's key is
``(0x7FFFFFFF - bits(score)) << 32 | index``: scores are sigmoid outputs,
so they are non-negative and their bits order as the floats do, and one
ascending sort of the unique keys gives that order whatever order the
candidates were compacted in. The card finds the K-th smallest key by an
MSB-first radix select, a byte a pass; ``dkd_keys`` and
``radix_select_model`` are that select in numpy, for the CPU tests (the
card path does not use them).

As in the other kernel modules, a wrapper runs the plain version when its
tensor lies on the CPU and launches the kernel when it lies on a CUDA
device; on a CUDA tensor it launches or raises, it never falls back.
``LAUNCHES`` counts kernel launches by kernel name (one for each C entry
called, nowhere else).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from colmap_tpu_torch.kernels import sfm as S
from colmap_tpu_torch.kernels.tally import ShapeTally

LAUNCHES = {"aliked_conv": 0, "aliked_dkd": 0, "aliked_sddh": 0}
# Launch shapes of the kernels above, counted where LAUNCHES is (kernels/tally.py).
SHAPES = ShapeTally()

ACT_NONE, ACT_SELU, ACT_SIGMOID = 0, 1, 2
# The SDDH offsets are bounded by BOUND * tanh(o / BOUND) (aliked.py:211).
BOUND = 5.0
# Soft-argmax temperature of the refinement (aliked.py:167).
SOFTMAX_SCALE = 20.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "aliked_conv_f32": [_I] * 7 + [_P] * 5,
    "aliked_upsample_selu_f32": [_I] * 5 + [_P] * 3,
    "aliked_dkd_f32": [_I] * 3 + [ctypes.c_float, _I] + [_P] * 6,
    "aliked_sddh_offsets_f32": [_I] * 5 + [_P] * 8,
    "aliked_sddh_describe_f32": [_I] * 5 + [_P] * 8,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.reset()


@functools.cache
def _lib():
    from colmap_tpu_torch.kernels.build import library

    lib = library()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.aliked_dkd_workspace_bytes.argtypes = [_I] * 3
    lib.aliked_dkd_workspace_bytes.restype = ctypes.c_longlong
    return lib


def _launch(kernel, fn_name, *args):
    err = getattr(_lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")
    LAUNCHES[kernel] += 1


def _activate(y, act):
    if act == ACT_SELU:
        return F.selu(y)
    if act == ACT_SIGMOID:
        return torch.sigmoid(y)
    return y


# K50 -----------------------------------------------------------------------


def conv_plain(x, w, b, act=ACT_NONE, pool=False):
    """(Cout, H, W) = act(conv(x) + b) of x (Cin, Hin, Win) with SAME zero
    padding; with ``pool`` the input is first average-pooled 2 x 2 (VALID,
    H = Hin // 2), as aliked.py's _block (l.106-113) and _conv2d (l.93)."""
    if pool:
        x = F.avg_pool2d(x[None], 2)[0]
    return _activate(F.conv2d(x[None], w, b, padding=w.shape[-1] // 2)[0], act)


def conv(x, w, b, act=ACT_NONE, pool=False, out=None):
    """K50 (a): conv_plain into ``out`` (an (Cout, H, W) contiguous view,
    such as a channel slice of feat) or a new tensor; returns it."""
    if x.device.type == "cpu":
        y = conv_plain(x, w, b, act, pool)
        return y if out is None else out.copy_(y)
    dev = S._require_cuda(x)
    cin, hin, win = x.shape
    cout, k = w.shape[0], w.shape[-1]
    if k not in (1, 3):
        raise ValueError(f"K50 takes 1 x 1 and 3 x 3 convolutions, not {k} x {k}")
    h, wd = (hin // 2, win // 2) if pool else (hin, win)
    if out is None:
        out = torch.empty((cout, h, wd), dtype=torch.float32, device=dev)
    S._check("x", x, torch.float32, (cin, hin, win), dev)
    S._check("w", w, torch.float32, (cout, cin, k, k), dev)
    S._check("b", b, torch.float32, (cout,), dev)
    S._check("out", out, torch.float32, (cout, h, wd), dev)
    _launch("aliked_conv", "aliked_conv_f32", cin, hin, win, cout, k, int(pool), act,
            *map(S._ptr, (x, w, b, out)), S._stream(dev))
    SHAPES.add("aliked_conv", "conv", (cin, hin, win, cout, k, pool), conv,
               (x, w, b, act, pool, out))
    return out


def upsample_selu_plain(src, size):
    """SELU of the bilinear resize of src (C, h, w) to size (H, W) with
    half-pixel centres (jax.image.resize "bilinear", aliked.py:116-117)."""
    return F.selu(F.interpolate(src[None], size=size, mode="bilinear", align_corners=False)[0])


def upsample_selu(src, out):
    """K50 (b): upsample_selu_plain of src into ``out`` (C, H, W), a
    contiguous view such as a channel slice of feat; returns it."""
    if src.device.type == "cpu":
        return out.copy_(upsample_selu_plain(src, tuple(out.shape[1:])))
    dev = S._require_cuda(src)
    c, h, w = src.shape
    H, W = out.shape[1:]
    S._check("src", src, torch.float32, (c, h, w), dev)
    S._check("out", out, torch.float32, (c, H, W), dev)
    _launch("aliked_conv", "aliked_upsample_selu_f32", c, h, w, H, W, S._ptr(src), S._ptr(out),
            S._stream(dev))
    SHAPES.add("aliked_conv", "upsample_selu", (c, h, w, H, W), upsample_selu, (src, out))
    return out


# K51 -----------------------------------------------------------------------


def _refine_plain(score, idx, radius):
    """(xy (n, 2), scores (n,)): the soft-argmax refinement of
    _nms_keypoints (l.159-175) at flat indices idx."""
    H, W = score.shape
    offs = torch.arange(-radius, radius + 1, dtype=score.dtype, device=score.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    ys = (idx // W).to(score.dtype)
    xs = (idx % W).to(score.dtype)
    yy = torch.clamp(ys[:, None, None] + oy, 0, H - 1).long()
    xx = torch.clamp(xs[:, None, None] + ox, 0, W - 1).long()
    wgt = torch.softmax(SOFTMAX_SCALE * score[yy, xx].reshape(len(idx), -1), dim=1)
    dy = (wgt * oy.reshape(-1)).sum(1)
    dx = (wgt * ox.reshape(-1)).sum(1)
    xy = torch.stack([torch.clamp(xs + dx, 0.0, W - 1.0), torch.clamp(ys + dy, 0.0, H - 1.0)], 1)
    return xy, score.reshape(-1)[idx]


def select_order(vals, idx):
    """Positions of (vals, idx) by value descending, index ascending (the
    order of lax.top_k): two stable sorts, as K14's selection."""
    by_idx = torch.sort(idx, stable=True).indices
    by_val = torch.sort(vals[by_idx], descending=True, stable=True).indices
    return by_idx[by_val]


def dkd_plain(score, max_num_keypoints, radius, threshold):
    """(xy (n, 2), scores (n,)) of the first n = min(K, peaks) peaks of the
    score map (H, W): 5 x 5 max filter with -inf outside, ``score >=
    pooled & score > threshold``, selected by (score desc, index asc), then
    refined. The padding rows of lax.top_k (non-peaks, vals -inf) are not
    returned: colmap_tpu drops them as invalid."""
    H, W = score.shape
    pooled = F.max_pool2d(score[None, None], 2 * radius + 1, 1, radius)[0, 0]
    peak = (score >= pooled) & (score > threshold)
    idx = torch.nonzero(peak.reshape(-1)).squeeze(1)
    vals = score.reshape(-1)[idx]
    k = min(max_num_keypoints, H * W)
    idx = idx[select_order(vals, idx)[:k]]
    return _refine_plain(score, idx, radius)


def dkd(score, max_num_keypoints, radius, threshold):
    """K51: dkd_plain on the card. One C entry launches the peak test, the
    radix select of the K-th key, the compaction, the sort (runs of 2048
    keys and their merges) and the refinement; one 4-byte read of the
    selected count, after the last launch, sizes the returned rows."""
    if score.device.type == "cpu":
        return dkd_plain(score, max_num_keypoints, radius, threshold)
    dev = S._require_cuda(score)
    H, W = score.shape
    S._check("score", score, torch.float32, (H, W), dev)
    if H * W >= 2 ** 31 - 1:
        raise NotImplementedError(f"K51 takes score maps below 2^31 pixels, not {H} x {W}")
    cap = min(max_num_keypoints, H * W)
    if cap <= 0:
        return (torch.empty((0, 2), dtype=torch.float32, device=dev),
                torch.empty(0, dtype=torch.float32, device=dev))
    ws = torch.empty(_lib().aliked_dkd_workspace_bytes(H, W, cap), dtype=torch.uint8, device=dev)
    xy = torch.empty((cap, 2), dtype=torch.float32, device=dev)
    scores = torch.empty(cap, dtype=torch.float32, device=dev)
    n_out = torch.empty(1, dtype=torch.int32, device=dev)
    _launch("aliked_dkd", "aliked_dkd_f32", H, W, radius, ctypes.c_float(threshold), cap,
            S._ptr(score), S._ptr(ws), S._ptr(xy), S._ptr(scores), S._ptr(n_out), S._stream(dev))
    n = int(n_out.item())
    return xy[:n], scores[:n]


def dkd_keys(vals, idx):
    """K51's candidate keys (numpy uint64) of scores ``vals`` (float32,
    non-negative) at flat indices ``idx``: (0x7FFFFFFF - bits(score)) << 32
    | index. Ascending key order is lax.top_k's order."""
    bits = np.asarray(vals, np.float32).view(np.uint32).astype(np.uint64)
    return ((np.uint64(0x7FFFFFFF) - bits) << np.uint64(32)) | np.asarray(idx, np.uint64)


def radix_select_model(keys, k):
    """K51's select in numpy: (threshold, bytes resolved). The K-th smallest
    of the unique uint64 ``keys`` found MSB first, a byte at a time: each
    pass histograms the next byte of the keys that share the bytes found so
    far and takes the bin that holds the K-th; it stops when that bin holds
    exactly the keys still wanted. The keys <= threshold are exactly the
    min(k, len(keys)) smallest (all of them, threshold 2^64 - 1, when there
    are no more than k)."""
    keys = np.asarray(keys, np.uint64)
    if len(keys) <= k:
        return np.uint64(0xFFFFFFFFFFFFFFFF), 0
    prefix, krem = 0, k
    for d in range(8):
        shift = 56 - 8 * d
        high = np.uint64(shift + 8)
        inbin = keys if d == 0 else keys[(keys >> high) == np.uint64(prefix >> (shift + 8))]
        hist = np.bincount(((inbin >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                           minlength=256)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, krem))  # first bin with cum >= krem
        krem -= int(cum[b] - hist[b])
        prefix |= b << shift
        if hist[b] == krem:
            return np.uint64(prefix | ((1 << shift) - 1)), d + 1
    raise AssertionError("unique keys resolve by the last byte")


def dkd_library(score, max_num_keypoints, radius, threshold):
    """The peak test and selection through F.max_pool2d and torch.topk
    (no refinement); timed beside K51 and used nowhere in the port."""
    pooled = F.max_pool2d(score[None, None], 2 * radius + 1, 1, radius)[0, 0]
    flat = torch.where((score >= pooled) & (score > threshold), score,
                       torch.full_like(score, -torch.inf)).reshape(-1)
    return torch.topk(flat, min(max_num_keypoints, flat.numel()))


# K52 -----------------------------------------------------------------------


def bilinear_sample(feat, xy):
    """(..., C) samples of feat (C, H, W) at pixel positions xy (..., 2),
    clipped to [0, W - 1.001] x [0, H - 1.001] (aliked.py:179-198)."""
    C, H, W = feat.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    out = (feat[:, y0, x0] * (1 - fy) * (1 - fx) + feat[:, y0, x0 + 1] * (1 - fy) * fx
           + feat[:, y0 + 1, x0] * fy * (1 - fx) + feat[:, y0 + 1, x0 + 1] * fy * fx)
    return torch.movedim(out, 0, -1)


def _bound(off):
    return BOUND * torch.tanh(off / BOUND)


def sddh_offsets_plain(feat, xy, w1, b1, w2, b2):
    """(K, 2M) bounded offsets, dense as colmap_tpu (l.206-211): conv1 and
    SELU, conv2 over the whole image, a bilinear sample at each keypoint,
    then 5 tanh(o / 5). Channel 2m is sample m's x, 2m + 1 its y."""
    off_feat = F.selu(F.conv2d(feat[None], w1, b1, padding=1))[0]
    off_map = F.conv2d(off_feat[None], w2, b2, padding=1)[0]
    return _bound(bilinear_sample(off_map, xy))


def sddh_offsets_sparse(feat, xy, w1, b1, w2, b2):
    """sddh_offsets_plain computed from each keypoint's 6 x 6 feature patch
    alone: the algorithm of K52 (a), in PyTorch (see the module's note)."""
    C, H, W = feat.shape
    x = torch.clamp(xy[:, 0], 0.0, W - 1.001)
    y = torch.clamp(xy[:, 1], 0.0, H - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    fx, fy = x - x0, y - y0
    r = torch.arange(-2, 4, device=feat.device)
    ry, rx = y0[:, None] + r, x0[:, None] + r  # (K, 6) patch rows and columns
    inside = (((ry >= 0) & (ry < H))[:, :, None] & ((rx >= 0) & (rx < W))[:, None, :])
    patch = feat[:, ry.clamp(0, H - 1)[:, :, None], rx.clamp(0, W - 1)[:, None, :]]
    patch = (patch * inside).movedim(0, 1)  # (K, C, 6, 6), 0 outside the image
    off_feat = F.selu(F.conv2d(patch, w1, b1)) * inside[:, None, 1:5, 1:5]
    corners = F.conv2d(off_feat, w2, b2)  # (K, 2M, 2, 2): rows y0, y0 + 1; columns x0, x0 + 1
    fx, fy = fx[:, None], fy[:, None]
    off = (corners[..., 0, 0] * (1 - fy) * (1 - fx) + corners[..., 0, 1] * (1 - fy) * fx
           + corners[..., 1, 0] * fy * (1 - fx) + corners[..., 1, 1] * fy * fx)
    return _bound(off)


def _normalize(desc):
    return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12)


def sddh_describe_plain(feat, xy, offsets, w, b, agg):
    """(K, D) L2-normalized descriptors, dense as colmap_tpu (l.208-218):
    the 1 x 1 weight conv over the whole image, M bilinear samples of it
    at xy + offsets, SELU, einsum("kmd,mde->ke") with agg (M, D, D)."""
    M = agg.shape[0]
    w_feat = F.conv2d(feat[None], w, b)[0]
    sample_xy = xy[:, None, :] + offsets.reshape(-1, M, 2)
    samples = bilinear_sample(w_feat, sample_xy)
    return _normalize(torch.einsum("kmd,mde->ke", F.selu(samples), agg))


def sddh_plain(feat, xy, p):
    """The dense SDDH (offsets then descriptors) with the parameter tree p."""
    o = p["sddh_offset"]
    offsets = sddh_offsets_plain(feat, xy, o["conv1"]["w"], o["conv1"]["b"], o["conv2"]["w"],
                                 o["conv2"]["b"])
    return sddh_describe_plain(feat, xy, offsets, p["sddh_weight"]["w"], p["sddh_weight"]["b"],
                               p["sddh_agg"]["w"])


def _tap_major(w):
    """(Cout, Cin, k, k) -> (Cin, k, k, Cout): consecutive threads (output
    channels) read consecutive weights."""
    return w.permute(1, 2, 3, 0).contiguous()


def sddh_offsets(feat, xy, w1, b1, w2, b2):
    """K52 (a): sddh_offsets_plain at each keypoint, from its patch alone."""
    if feat.device.type == "cpu":
        return sddh_offsets_plain(feat, xy, w1, b1, w2, b2)
    dev = S._require_cuda(feat)
    C, H, W = feat.shape
    n, m2 = xy.shape[0], w2.shape[0]
    S._check("feat", feat, torch.float32, (C, H, W), dev)
    S._check("xy", xy, torch.float32, (n, 2), dev)
    S._check("w1", w1, torch.float32, (C, C, 3, 3), dev)
    S._check("b1", b1, torch.float32, (C,), dev)
    S._check("w2", w2, torch.float32, (m2, C, 3, 3), dev)
    S._check("b2", b2, torch.float32, (m2,), dev)
    if C > 256 or 4 * m2 > 2 * C or H < 2 or W < 2:
        raise ValueError(f"K52 (a) takes C <= 256, 4 x 2M <= 2C and a map of at least 2 x 2, "
                         f"not C={C}, 2M={m2}, {H} x {W}")
    out = torch.empty((n, m2), dtype=torch.float32, device=dev)
    if n:
        _launch("aliked_sddh", "aliked_sddh_offsets_f32", C, H, W, n, m2,
                *map(S._ptr, (feat, xy, _tap_major(w1), b1, _tap_major(w2), b2, out)),
                S._stream(dev))
    return out


def sddh_describe(feat, xy, offsets, w, b, agg):
    """K52 (b): sddh_describe_plain, sampling feat and applying W + b to
    each sample (never forming the weighted map)."""
    if feat.device.type == "cpu":
        return sddh_describe_plain(feat, xy, offsets, w, b, agg)
    dev = S._require_cuda(feat)
    C, H, W = feat.shape
    n, M = xy.shape[0], agg.shape[0]
    S._check("feat", feat, torch.float32, (C, H, W), dev)
    S._check("xy", xy, torch.float32, (n, 2), dev)
    S._check("offsets", offsets, torch.float32, (n, 2 * M), dev)
    S._check("w", w, torch.float32, (C, C, 1, 1), dev)
    S._check("b", b, torch.float32, (C,), dev)
    S._check("agg", agg, torch.float32, (M, C, C), dev)
    if C > 256 or C % 32 or M not in (16, 32) or H < 2 or W < 2:
        raise ValueError(f"K52 (b) takes a multiple of 32 up to 256 channels, M 16 or 32 and a "
                         f"map of at least 2 x 2, not C={C}, M={M}, {H} x {W}")
    out = torch.empty((n, C), dtype=torch.float32, device=dev)
    if n:
        wt = w[:, :, 0, 0].t().contiguous()  # (Cin, Cout)
        _launch("aliked_sddh", "aliked_sddh_describe_f32", C, H, W, n, M,
                *map(S._ptr, (feat, xy, offsets, wt, b, agg, out)), S._stream(dev))
    return out


def sddh(feat, xy, p):
    """K52 (a) then (b) with the parameter tree p; sddh_plain on the CPU."""
    o = p["sddh_offset"]
    offsets = sddh_offsets(feat, xy, o["conv1"]["w"], o["conv1"]["b"], o["conv2"]["w"],
                           o["conv2"]["b"])
    return sddh_describe(feat, xy, offsets, p["sddh_weight"]["w"], p["sddh_weight"]["b"],
                         p["sddh_agg"]["w"])
