"""The SPRT kernel: wrapper, plain version, launch count.

    K47 sprt  sprt (colmap_tpu/optim/sprt.py:53 sprt_evaluate)

As the other kernel modules do, the wrapper runs the plain version when its
tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; on a CUDA tensor it launches or raises. ``LAUNCHES`` counts kernel
launches.

The plain version is colmap_tpu's masked cumulative sum: each valid row
adds log_in (an inlier) or log_out (an outlier) to the log likelihood ratio,
in float64, and a hypothesis is rejected at the first row where the running
sum exceeds log A. The kernel gives each hypothesis a block, which walks its
rows in tiles of 2048 and evaluates the ratio from exact integer counts,
n_in log_in + n_out log_out (``sprt_count_model`` is that evaluation on the
CPU), and stops at the first tile that holds a rejection.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from colmap_tpu_torch.kernels import sfm as S

LAUNCHES = {"sprt": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sprt_steps(res, mask, max_sq, log_in, log_out):
    """(M, N) float64 log-ratio steps: log_in on an inlier, log_out on an
    outlier, 0 on an invalid row."""
    inl = (res.double() <= max_sq) & mask[None]
    f64 = dict(dtype=torch.float64, device=res.device)
    step = torch.where(inl, torch.tensor(log_in, **f64), torch.tensor(log_out, **f64))
    return torch.where(mask[None], step, torch.zeros_like(step))


def sprt_plain(res, mask, max_sq, log_A, log_in, log_out):
    """K47's function: (accepted (M,) bool, num_evaluated (M,) int32)."""
    cum = torch.cumsum(sprt_steps(res, mask, max_sq, log_in, log_out), dim=-1)
    rejected_at = cum > log_A
    any_reject = rejected_at.any(-1)
    first = torch.argmax(rejected_at.to(torch.uint8), dim=-1) + 1
    n = res.shape[-1]
    return ~any_reject, torch.where(any_reject, first, n).to(torch.int32)


def sprt_count_model(res, mask, max_sq, log_A, log_in, log_out):
    """The kernel's evaluation on the CPU: the ratio after row i is n_in(i)
    log_in + n_out(i) log_out from the exact int64 counts of inliers and
    outliers up to row i, tested at every row. Returns (accepted (M,) bool,
    num_evaluated (M,) int32); it differs from sprt_plain only where a
    running sum lies within about N ulps of log_A."""
    inl = (res.double() <= max_sq) & mask[None]
    n_in = torch.cumsum(inl.long(), dim=-1)
    n_out = torch.cumsum((mask[None] & ~inl).long(), dim=-1)
    rejected_at = n_in.double() * log_in + n_out.double() * log_out > log_A
    any_reject = rejected_at.any(-1)
    first = torch.argmax(rejected_at.to(torch.uint8), dim=-1) + 1
    return ~any_reject, torch.where(any_reject, first, res.shape[-1]).to(torch.int32)


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {"sprt_f32": [_I, _I, _D, _D, _D, _D] + [_P] * 4 + [_P], "sprt_plan": [_P]}


@functools.cache
def _lib():
    from colmap_tpu_torch.kernels.build import library

    lib = library()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _call(fn_name, *args):
    err = getattr(_lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err}")


def plan():
    """K47's design on the current card: threads a block, rows a tile,
    registers and spilled bytes a thread, static shared bytes a block."""
    info = (ctypes.c_int * 5)()
    _call("sprt_plan", info)
    return dict(zip(("threads", "tile_rows", "registers", "local_bytes", "shared_bytes"), info))


def sprt(res, mask, max_sq, log_A, log_in, log_out):
    """K47: one block per hypothesis of res (M, N) float32 (mask (N,) bool)
    walks its rows in tiles, counting inliers and outliers, and stops at the
    first row whose log ratio exceeds log_A. Returns (accepted (M,) bool,
    num_evaluated (M,) int32)."""
    if res.device.type == "cpu":
        return sprt_plain(res, mask, max_sq, log_A, log_in, log_out)
    dev = S._require_cuda(res)
    M, N = res.shape
    S._check("residuals", res, torch.float32, (M, N), dev)
    S._check("mask", mask, torch.bool, (N,), dev)
    accepted = torch.empty(M, dtype=torch.bool, device=dev)
    num = torch.empty(M, dtype=torch.int32, device=dev)
    if M:
        _call("sprt_f32", M, N, float(max_sq), float(log_A), float(log_in), float(log_out),
              *map(S._ptr, (res, mask, accepted, num)), S._stream(dev))
        LAUNCHES["sprt"] += 1
    return accepted, num
