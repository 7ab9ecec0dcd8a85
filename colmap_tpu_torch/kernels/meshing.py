"""Spectral Poisson kernels: wrappers, plain versions, counts.

Four CUDA kernels carry the device program of colmap_tpu/mvs/meshing.py,
``_poisson_indicator_jax`` (l.45), around cuFFT's rfftn / irfftn (sources
in ``colmap_tpu_torch/csrc``):

    K41 poisson_splat     (a) each sample's eight corner voxels and
                          weights; (b) after a stable sort of the voxel
                          keys, each voxel's sums of w and n w (l.54-75)
    K42 poisson_stencil   (a) one periodic [1, 2, 1] / 4 pass along an axis
                          over V and W; (b) the central-difference
                          divergence (l.78-92)
    K43 poisson_spectral  the screened divide by the 7-point Laplacian's
                          eigenvalues, in place on the spectrum (l.95-106)
    K44 poisson_iso       (a) the iso level, the weighted mean of chi at
                          the samples; (b) chi - iso in place (l.110-126)

As the other kernel modules do, each wrapper runs the plain version when its
tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; on a CUDA tensor it launches or raises. ``LAUNCHES`` counts kernel
launches by kernel name, one an entry call. The plain versions are written
for float32 and float64 and compute what the kernels compute; sums run in
float64 whatever the type.

The grid of the splat and the blur is one (4, N, N, N) tensor: V's three
channels, then W. Voxel keys are flat indices (ix N + iy) N + iz.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from colmap_tpu_torch.kernels import sfm as S

LAUNCHES = {"poisson_splat": 0, "poisson_stencil": 0, "poisson_spectral": 0, "poisson_iso": 0}

MAX_GRID = 1024  # voxel keys are int32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _corners(points01, weights, N):
    """(P, 8) voxel keys (int64) and weights of each sample's corners, in
    colmap_tpu's (dx, dy, dz) loop order, in the inputs' type."""
    p = points01 * N - 0.5
    base = torch.floor(p)
    frac = p - base
    base = base.to(torch.int64)
    keys, ws = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2])) * weights
                ix = torch.clamp(base[:, 0] + dx, 0, N - 1)
                iy = torch.clamp(base[:, 1] + dy, 0, N - 1)
                iz = torch.clamp(base[:, 2] + dz, 0, N - 1)
                keys.append((ix * N + iy) * N + iz)
                ws.append(w)
    return torch.stack(keys, 1), torch.stack(ws, 1)


def splat_corners_plain(points01, weights, N):
    """K41 (a): keys (8P,) int32 and weights (8P,) in (sample, corner) order."""
    keys, w = _corners(points01, weights, N)
    return keys.reshape(-1).to(torch.int32), w.reshape(-1)


def splat_sum_plain(keys_sorted, perm, w, normals, N):
    """K41 (b): the (4, N, N, N) grid of V's channels and W, each voxel's
    contributions n w and w summed in float64 in sorted order."""
    idx = perm.to(torch.int64)
    wv = w[idx]
    contrib = torch.cat([normals[idx // 8] * wv[:, None], wv[:, None]], 1).double()
    grid = torch.zeros((4, N ** 3), dtype=torch.float64, device=w.device)
    keys = keys_sorted.to(torch.int64)
    for c in range(4):
        grid[c].index_add_(0, keys, contrib[:, c])
    return grid.to(w.dtype).reshape(4, N, N, N)


def blur_plain(grid, axis):
    """K42 (a): one periodic (f[i-1] + 2 f[i] + f[i+1]) / 4 pass along axis
    0 (x), 1 (y) or 2 (z) of the (C, N, N, N) grid."""
    d = axis + 1
    return (torch.roll(grid, 1, d) + 2.0 * grid + torch.roll(grid, -1, d)) / 4.0


def divergence_plain(grid):
    """K42 (b): the periodic central-difference divergence of V, (N, N, N)."""
    V0, V1, V2 = grid[0], grid[1], grid[2]
    return ((torch.roll(V0, -1, 0) - torch.roll(V0, 1, 0))
            + (torch.roll(V1, -1, 1) - torch.roll(V1, 1, 1))
            + (torch.roll(V2, -1, 2) - torch.roll(V2, 1, 2))) * 0.5


def laplacian_eigenvalues(N, device="cpu"):
    """(N, N, N/2 + 1) float32 eigenvalues of the periodic 7-point Laplacian
    at the rfftn bins, as colmap_tpu computes them (float32 frequencies)."""
    k = torch.from_numpy((np.fft.fftfreq(N).astype(np.float32) * np.float32(2.0))
                         * np.float32(np.pi)).to(device)
    kr = torch.from_numpy((np.fft.rfftfreq(N).astype(np.float32) * np.float32(2.0))
                          * np.float32(np.pi)).to(device)
    lk, lr = 2.0 * torch.cos(k) - 2.0, 2.0 * torch.cos(kr) - 2.0
    return lk[:, None, None] + lk[None, :, None] + lr[None, None, :]


def laplacian_axis_terms(N, device="cpu"):
    """K43's two tables, in the kernel's arithmetic: e(f) = 2 cos(2 pi f) - 2
    in float32 at the fftfreq bins of axes i and j ((N,)) and the rfftfreq
    bins of axis k ((N/2 + 1,)), each f = i / N taken in float64 and rounded
    to float32. laplacian_eigenvalues(N) is (e_ij[:, None, None] +
    e_ij[None, :, None]) + e_k[None, None, :]."""
    i = np.arange(N)
    f_ij = torch.from_numpy((np.where(i < (N + 1) // 2, i, i - N) / N).astype(np.float32))
    f_k = torch.from_numpy((np.arange(N // 2 + 1) / N).astype(np.float32))
    pi = np.float32(np.pi)
    return tuple((2.0 * torch.cos(f.to(device) * 2.0 * pi) - 2.0) for f in (f_ij, f_k))


def spectral_divide_plain(spec, point_weight):
    """K43: spec / (lambda - point_weight 1e-4), real and imaginary parts
    divided by the float32 denominator (a new tensor)."""
    N = spec.shape[0]
    den = laplacian_eigenvalues(N, spec.device) - np.float32(point_weight * 1e-4)
    den = den.to(spec.real.dtype)
    return torch.complex(spec.real / den, spec.imag / den)


def iso_level_plain(chi, points01, weights):
    """K44 (a): the 0-d iso level, sum chi w / max(sum w, 1e-12) over the
    samples' corners, summed in float64, in chi's type."""
    keys, w = _corners(points01, weights, chi.shape[0])
    w = w.double()
    num = (chi.reshape(-1)[keys].double() * w).sum()
    return (num / torch.clamp(w.sum(), min=1e-12)).to(chi.dtype)


def shift_plain(chi, iso):
    """K44 (b): chi - iso (a new tensor)."""
    return chi - iso


# ---------------------------------------------------------------------------
# CUDA wrappers.
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "poisson_splat_corners_f32": [_LL, _I, _P, _P, _P, _P, _P],
    "poisson_splat_sum_f32": [_LL, _I, _P, _P, _P, _P, _P, _P],
    "poisson_blur_f32": [_I, _I, _P, _P, _P],
    "poisson_divergence_f32": [_I, _P, _P, _P],
    "poisson_spectral_f32": [_I, _F, _I, _I, _I, _P, _P],
    "poisson_iso_blocks": [_LL],
    "poisson_iso_level_f32": [_LL, _I, _P, _P, _P, _P, _P, _P],
    "poisson_iso_shift_f32": [_LL, _P, _P, _P],
}


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


f32 = torch.float32
_p, _s = S._ptr, S._stream


def _check_grid_n(N):
    if not (2 <= N <= MAX_GRID and N % 2 == 0):
        raise ValueError(f"the Poisson kernels take an even grid of 2 to {MAX_GRID}, got {N}")


def _samples(points01, weights, N):
    dev = S._require_cuda(points01)
    _check_grid_n(N)
    P = points01.shape[0]
    S._check("points01", points01, f32, (P, 3), dev)
    S._check("weights", weights, f32, (P,), dev)
    return dev, P


def splat_corners(points01, weights, N):
    """K41 (a): keys (8P,) int32 and weights (8P,) float32; one thread a
    (sample, corner)."""
    if points01.device.type == "cpu":
        return splat_corners_plain(points01, weights, N)
    dev, P = _samples(points01, weights, N)
    keys = torch.empty(8 * P, dtype=torch.int32, device=dev)
    w = torch.empty(8 * P, dtype=f32, device=dev)
    _call("poisson_splat_corners_f32", P, N, _p(points01), _p(weights), _p(keys), _p(w), _s(dev))
    LAUNCHES["poisson_splat"] += 1
    return keys, w


def splat_sum(keys_sorted, perm, w, normals, N):
    """K41 (b): the (4, N, N, N) grid from the sorted keys and their
    permutation (int64) of the (sample, corner) contributions; one thread a
    sorted position, each voxel's run summed by its first."""
    if w.device.type == "cpu":
        return splat_sum_plain(keys_sorted, perm, w, normals, N)
    dev = S._require_cuda(w)
    _check_grid_n(N)
    M = w.shape[0]
    S._check("keys_sorted", keys_sorted, torch.int32, (M,), dev)
    S._check("perm", perm, torch.int64, (M,), dev)
    S._check("w", w, f32, (M,), dev)
    S._check("normals", normals, f32, (M // 8, 3), dev)
    grid = torch.zeros((4, N, N, N), dtype=f32, device=dev)
    _call("poisson_splat_sum_f32", M, N, _p(keys_sorted), _p(perm), _p(w), _p(normals),
          _p(grid), _s(dev))
    LAUNCHES["poisson_splat"] += 1
    return grid


def splat(points01, normals, weights, N):
    """K41 (a), the stable sort of the keys, K41 (b): the (4, N, N, N) grid."""
    keys, w = splat_corners(points01, weights, N)
    keys_sorted, perm = torch.sort(keys, stable=True)
    return splat_sum(keys_sorted, perm, w, normals, N)


def _grid(grid):
    dev = S._require_cuda(grid)
    N = grid.shape[-1]
    _check_grid_n(N)
    return dev, N


def blur(grid, axis):
    """K42 (a): one periodic blur pass along axis 0, 1 or 2 of the (4, N, N,
    N) grid, into a new grid; one thread an entry."""
    if grid.device.type == "cpu":
        return blur_plain(grid, axis)
    dev, N = _grid(grid)
    S._check("grid", grid, f32, (4, N, N, N), dev)
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    out = torch.empty_like(grid)
    _call("poisson_blur_f32", N, int(axis), _p(grid), _p(out), _s(dev))
    LAUNCHES["poisson_stencil"] += 1
    return out


def divergence(grid):
    """K42 (b): the (N, N, N) divergence of the grid's V; one thread a voxel."""
    if grid.device.type == "cpu":
        return divergence_plain(grid)
    dev, N = _grid(grid)
    S._check("grid", grid, f32, (4, N, N, N), dev)
    div = torch.empty((N, N, N), dtype=f32, device=dev)
    _call("poisson_divergence_f32", N, _p(grid), _p(div), _s(dev))
    LAUNCHES["poisson_stencil"] += 1
    return div


def _dense(x):
    """Whether x's entries tile its storage with no gap or overlap, in any
    order of the axes."""
    expect = 1
    for stride, size in sorted(zip(x.stride(), x.shape)):
        if stride != expect:
            return False
        expect *= size
    return True


def spectral_divide_(spec, point_weight):
    """K43: the (N, N, N/2 + 1) complex64 spectrum divided in place by
    lambda - point_weight 1e-4, from per-axis tables of the eigenvalue's
    terms (laplacian_axis_terms), a warp a row of the spectrum's fastest
    storage axis and two bins a lane (cuFFT's rfftn output is dense but not
    C-ordered). Returns spec (on the CPU a new tensor)."""
    if spec.device.type == "cpu":
        return spectral_divide_plain(spec, point_weight)
    dev = S._require_cuda(spec)
    N = spec.shape[0]
    if not 1 <= N <= MAX_GRID:  # any N: the kernel takes odd rows too
        raise ValueError(f"K43 takes a grid of 1 to {MAX_GRID}, got {N}")
    if spec.dtype != torch.complex64 or tuple(spec.shape) != (N, N, N // 2 + 1):
        raise ValueError(f"spec must be complex64 of shape {(N, N, N // 2 + 1)}, got "
                         f"{spec.dtype} {tuple(spec.shape)}")
    if not _dense(spec):
        raise ValueError(f"spec must be dense, got strides {spec.stride()}")
    order = sorted(range(3), key=lambda a: spec.stride(a))  # fastest storage axis first
    _call("poisson_spectral_f32", N, float(point_weight * 1e-4), *order, _p(spec), _s(dev))
    LAUNCHES["poisson_spectral"] += 1
    return spec


def iso_level(chi, points01, weights):
    """K44 (a): the 0-d float32 iso level on the device: a grid-stride gather
    with float64 block sums, then one block over the blocks' sums."""
    if chi.device.type == "cpu":
        return iso_level_plain(chi, points01, weights)
    N = chi.shape[0]
    dev, P = _samples(points01, weights, N)
    S._check("chi", chi, f32, (N, N, N), dev)
    partial = torch.empty(2 * _lib().poisson_iso_blocks(P), dtype=torch.float64, device=dev)
    iso = torch.empty((), dtype=f32, device=dev)
    _call("poisson_iso_level_f32", P, N, _p(points01), _p(weights), _p(chi), _p(partial),
          _p(iso), _s(dev))
    LAUNCHES["poisson_iso"] += 1
    return iso


def shift_(chi, iso):
    """K44 (b): chi - iso in place, iso a 0-d device tensor. Returns chi (on
    the CPU a new tensor)."""
    if chi.device.type == "cpu":
        return shift_plain(chi, iso)
    dev = S._require_cuda(chi)
    S._check("iso", iso, f32, (), dev)
    if chi.dtype != f32 or not chi.is_contiguous():
        raise ValueError("chi must be a contiguous float32 tensor")
    _call("poisson_iso_shift_f32", chi.numel(), _p(iso), _p(chi), _s(dev))
    LAUNCHES["poisson_iso"] += 1
    return chi


def poisson_indicator(points01, normals, weights, grid_n, point_weight):
    """colmap_tpu's ``_poisson_indicator_jax``: (chi - iso (N, N, N), W_s (N,
    N, N)) on the inputs' device, where chi solves the screened Poisson
    equation of the splatted, blurred normal field and W_s is the blurred
    sample density. On the card: K41, K42, cuFFT's rfftn, K43, irfftn, K44,
    with no host read between the splat and the shift; the intermediate
    grids are freed as the solve goes."""
    N = int(grid_n)
    grid = splat(points01, normals, weights, N)
    for axis in (0, 1, 2):
        grid = blur(grid, axis)
    density = grid[3].clone()
    div = divergence(grid)
    del grid
    spec = torch.fft.rfftn(div)
    del div
    spec = spectral_divide_(spec, point_weight)
    chi = torch.fft.irfftn(spec, s=(N, N, N))
    del spec
    chi = shift_(chi, iso_level(chi, points01, weights))
    return chi, density


def poisson_indicator_plain(points01, normals, weights, grid_n, point_weight):
    """``poisson_indicator`` through the plain versions on any device and in
    the inputs' type: what chip_smoke.py holds the card's path against."""
    N = int(grid_n)
    keys, w = splat_corners_plain(points01, weights, N)
    keys_sorted, perm = torch.sort(keys, stable=True)
    grid = splat_sum_plain(keys_sorted, perm, w, normals, N)
    for axis in (0, 1, 2):
        grid = blur_plain(grid, axis)
    density = grid[3].clone()
    spec = spectral_divide_plain(torch.fft.rfftn(divergence_plain(grid)), point_weight)
    del grid
    chi = torch.fft.irfftn(spec, s=(N, N, N))
    return shift_plain(chi, iso_level_plain(chi, points01, weights)), density
