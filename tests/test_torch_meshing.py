"""colmap_tpu_torch meshing against colmap_tpu on the CPU.

The spectral Poisson indicator of the port (K41-K44's plain versions and
torch.fft, through ``kernels.meshing.poisson_indicator``) against
colmap_tpu's ``_poisson_indicator_jax`` at depth 5 on the cases of
``colmap_tpu_torch/kernels/meshing_cases.py``: chi - iso within 1e-4 of its
largest magnitude (JAX's scatter-adds and FFT run in float32 in an order
XLA chooses; the port sums in float64), W_s within 1e-5 relative. Surface
nets on colmap_tpu's own field: the same vertices (1e-6) and faces.
poisson_mesh: counts within 1%, every vertex within 1e-3 of one of the
reference's (a voxel within rounding of 0 may change sides between the two
float paths). Delaunay meshing, the advancing front and both simplifiers: the
same faces as colmap_tpu's.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from colmap_tpu.mvs import meshing as R
from colmap_tpu.mvs import simplification as RS

from colmap_tpu_torch.kernels import meshing as KM
from colmap_tpu_torch.kernels import meshing_cases as C
from colmap_tpu_torch.mvs import meshing as M
from colmap_tpu_torch.mvs import simplification as MS

N5 = 32


def _case(name):
    if name == "sphere":
        pts, nrm = C.sphere(4000, seed=0)
        return C.normalize(pts)[0], nrm
    if name == "planes_and_wall":
        pts, nrm = C.planes_and_wall(4000, seed=1)
        return C.normalize(pts)[0], nrm
    if name == "clip_border":
        return C.clip_border(3000, seed=2)
    return C.crowded_voxel(3000, N5, crowd=100, seed=3)


def _reference(p01, nrm, N=N5):
    chi, W = R._poisson_indicator_jax(jnp.asarray(p01, jnp.float32),
                                      jnp.asarray(nrm, jnp.float32),
                                      jnp.ones(len(p01), jnp.float32), N, 1.0)
    return np.asarray(chi), np.asarray(W)


@pytest.mark.parametrize("case", ["sphere", "planes_and_wall", "clip_border", "crowded_voxel"])
def test_poisson_indicator_matches_reference(case):
    p01, nrm = _case(case)
    chi_r, W_r = _reference(p01, nrm)
    x32 = torch.as_tensor(p01, dtype=torch.float32)
    n32 = torch.as_tensor(nrm, dtype=torch.float32)
    if case == "crowded_voxel":
        keys, _ = KM.splat_corners_plain(x32, torch.ones(len(p01)), N5)
        assert int(torch.bincount(keys.long()).max()) > 64
    if case == "clip_border":
        p = x32 * N5 - 0.5
        assert bool((p < 0).any()) and bool((p >= N5 - 1).any())
    for dtype in (torch.float32, torch.float64):
        KM.reset_launches()
        chi, W = KM.poisson_indicator(x32.to(dtype), n32.to(dtype),
                                      torch.ones(len(p01), dtype=dtype), N5, 1.0)
        assert sum(KM.LAUNCHES.values()) == 0  # plain versions on the CPU
        assert chi.dtype == dtype and chi.shape == (N5,) * 3
        err = np.abs(chi.numpy() - chi_r).max()
        assert err <= 1e-4 * np.abs(chi_r).max(), (case, dtype, err)
        werr = np.abs(W.numpy() - W_r).max()
        assert werr <= 1e-5 * np.abs(W_r).max(), (case, dtype, werr)


@pytest.mark.parametrize("N", [2, 3, 32, 33, 129, 256])
def test_laplacian_axis_terms_sum_to_the_eigenvalues(N):
    """K43's per-axis tables (the kernel's arithmetic: i / N in float64
    rounded to float32) broadcast-summed as (e_i + e_j) + e_k equal
    laplacian_eigenvalues bit for bit, for even and odd N, and colmap_tpu's
    eigenvalues (meshing.py l.95-101, JAX's cos) to 1e-6."""
    e_ij, e_k = KM.laplacian_axis_terms(N)
    assert e_ij.shape == (N,) and e_k.shape == (N // 2 + 1,) and e_k.dtype == torch.float32
    lam = (e_ij[:, None, None] + e_ij[None, :, None]) + e_k[None, None, :]
    assert torch.equal(lam, KM.laplacian_eigenvalues(N))
    k = jnp.fft.fftfreq(N).astype(jnp.float32) * 2.0 * jnp.pi
    kr = jnp.fft.rfftfreq(N).astype(jnp.float32) * 2.0 * jnp.pi
    want = ((2.0 * jnp.cos(k) - 2.0)[:, None, None] + (2.0 * jnp.cos(k) - 2.0)[None, :, None]
            + (2.0 * jnp.cos(kr) - 2.0)[None, None, :])
    np.testing.assert_allclose(lam.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_kernel_entries_compose_the_indicator():
    """The entries one at a time (splat, three blur passes, divergence,
    spectral divide, iso level, shift) give poisson_indicator's field, and
    K43's divide equals a division by the eigenvalue tensor."""
    p01, nrm = _case("sphere")
    x = torch.as_tensor(p01, dtype=torch.float32)
    n = torch.as_tensor(nrm, dtype=torch.float32)
    w = torch.ones(len(x))
    keys, wk = KM.splat_corners(x, w, N5)
    ks, perm = torch.sort(keys, stable=True)
    grid = KM.splat_sum(ks, perm, wk, n, N5)
    ref_W = torch.zeros(N5 ** 3, dtype=torch.float64).index_add_(0, keys.long(), wk.double())
    assert torch.equal(grid[3].reshape(-1), ref_W.float())
    for axis in (0, 1, 2):
        grid = KM.blur(grid, axis)
    spec = torch.fft.rfftn(KM.divergence(grid))
    lam = KM.laplacian_eigenvalues(N5) - np.float32(1e-4)
    got = KM.spectral_divide_(spec, 1.0)
    assert torch.allclose(got, spec / lam, rtol=1e-6, atol=0)
    chi = torch.fft.irfftn(got, s=(N5,) * 3)
    chi = KM.shift_(chi, KM.iso_level(chi, x, w))
    chi2, W2 = KM.poisson_indicator(x, n, w, N5, 1.0)
    assert torch.equal(chi, chi2) and torch.equal(grid[3], W2)


@pytest.mark.parametrize("masked", [False, True], ids=["all_cells", "trim_mask"])
def test_surface_nets_matches_reference_on_its_field(masked):
    from scipy import ndimage

    p01, nrm = _case("sphere")
    chi_r, W_r = _reference(p01, nrm)
    mask = ndimage.binary_dilation(W_r > 0, iterations=2)[:-1, :-1, :-1] if masked else None
    vr, fr, cr = R.surface_nets(-chi_r, mask)
    v, f, c = M.surface_nets(torch.from_numpy(-chi_r),
                             None if mask is None else torch.from_numpy(mask))
    assert len(vr) > 500
    np.testing.assert_allclose(v.numpy(), vr, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(f.numpy(), fr)
    np.testing.assert_array_equal(c.numpy(), cr)


def test_dilate6_is_scipys_binary_dilation():
    from scipy import ndimage

    occ = np.random.default_rng(4).uniform(size=(12, 10, 9)) > 0.97
    occ[0, 0, 0] = occ[-1, 5, -1] = True
    got = M.dilate6(torch.from_numpy(occ), 3).numpy()
    np.testing.assert_array_equal(got, ndimage.binary_dilation(occ, iterations=3))


@pytest.mark.parametrize("trim,hemisphere", [(3.0, False), (2.0, True)],
                         ids=["sphere_trim3", "hemisphere_trim2"])
def test_poisson_mesh_matches_reference(trim, hemisphere):
    from scipy.spatial import cKDTree

    pts, nrm = C.sphere(4000, seed=1)
    if hemisphere:
        keep = pts[:, 2] > 0
        pts, nrm = pts[keep], nrm[keep]
    colors = (np.abs(nrm) * 255).astype(np.uint8)
    opts = dict(depth=5, trim=trim)
    vr, fr, cr = R.poisson_mesh(pts, nrm, colors, R.PoissonMeshingOptions(**opts))
    v, f, c = M.poisson_mesh(pts, nrm, colors, M.PoissonMeshingOptions(**opts), device="cpu")
    assert abs(len(v) - len(vr)) <= 0.01 * len(vr) and abs(len(f) - len(fr)) <= 0.01 * len(fr)
    assert v.dtype == np.float32 and f.dtype == np.int32 and c.shape == (len(v), 3)
    d, _ = cKDTree(vr).query(v)
    assert d.max() <= 1e-3, np.quantile(d, [0.5, 0.99, 1.0])
    if hemisphere:
        assert (v[:, 2] > -0.2).mean() > 0.95


def _sphere_with_cameras(n, seed):
    pts, _ = C.sphere(n, seed=seed)
    centers = {i + 1: c for i, c in enumerate(np.array(
        [[4, 0, 0], [-4, 0, 0], [0, 4, 0], [0, -4, 0], [0, 0, 4], [0, 0, -4]], dtype=float))}
    vis = C.visibility(pts, centers)
    vis[3] = np.array([1, 99, 2])  # an image without a centre is skipped
    return pts, vis, centers


def test_delaunay_meshing_matches_reference():
    pts, vis, centers = _sphere_with_cameras(500, 2)
    vr, fr = R.delaunay_meshing(pts, vis, centers)
    v, f = M.delaunay_meshing(pts, vis, centers)
    assert len(fr) > 300
    np.testing.assert_array_equal(v, vr)
    np.testing.assert_array_equal(f, fr)
    opts = M.DelaunayMeshingOptions(quality_regularization=0.2, num_ray_samples=3)
    _, fr2 = R.delaunay_meshing(pts, vis, centers, R.DelaunayMeshingOptions(
        quality_regularization=0.2, num_ray_samples=3))
    np.testing.assert_array_equal(M.delaunay_meshing(pts, vis, centers, opts)[1], fr2)


def test_advancing_front_matches_reference():
    pts, _ = C.sphere(600, seed=5)
    for bound in (5.0, 1.0):
        vr, fr = R.advancing_front_mesh(pts, R.AdvancingFrontMeshingOptions(
            radius_ratio_bound=bound))
        v, f = M.advancing_front_mesh(pts, M.AdvancingFrontMeshingOptions(
            radius_ratio_bound=bound))
        assert len(fr) > 100
        np.testing.assert_array_equal(f, fr)


def _reference_simplifier():
    """colmap_tpu builds its simplifier into the temp directory with no lock;
    build it once under a file lock, as test workers run in parallel, and
    require that it built (its fallback is vertex clustering)."""
    import fcntl
    import tempfile

    with open(os.path.join(tempfile.gettempdir(), "colmap_tpu_native.lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        assert RS._load() is not None


def _poisson_sphere_mesh():
    pts, nrm = C.sphere(3000, seed=6)
    v, f, _ = R.poisson_mesh(pts, nrm, options=R.PoissonMeshingOptions(depth=5, trim=3))
    return v, f


def test_simplify_mesh_matches_reference():
    v, f = _poisson_sphere_mesh()
    _reference_simplifier()
    sv_r, sf_r = RS.simplify_mesh(v, f, 0.1)
    sv, sf = MS.simplify_mesh(v, f, 0.1)
    assert len(sf) <= 0.12 * len(f)
    np.testing.assert_array_equal(sv, sv_r)
    np.testing.assert_array_equal(sf, sf_r)


def test_cluster_simplify_matches_reference():
    v, f = _poisson_sphere_mesh()
    sv_r, sf_r = RS._cluster_simplify(v.astype(np.float64), f.astype(np.int64), len(f) // 10)
    sv, sf = MS._cluster_simplify(v.astype(np.float64), f.astype(np.int64), len(f) // 10)
    assert 0 < len(sf) < len(f)
    np.testing.assert_array_equal(sv, sv_r)
    np.testing.assert_array_equal(sf, sf_r)
