"""K12's refit eigenvector (csrc/small_linalg.cuh warp_smallest_eigvec9)
through its CPU model, kernels/matching.py warp_jacobi_model, against
colmap_tpu's eigh_small, whose tournament order the warp follows."""

import numpy as np
import pytest
import torch

from colmap_tpu_torch.kernels import matching as KM


def test_the_warp_rounds_are_colmap_tpus_tournament():
    from colmap_tpu.optim.small_linalg import _round_robin

    rounds = KM.jacobi_rounds9()
    assert rounds == _round_robin(9)
    pairs = [pq for r in rounds for pq in r]
    assert len(pairs) == len(set(pairs)) == 36
    for r in rounds:
        assert len(r) == 4 and len({i for pq in r for i in pq}) == 8


def _dlt_normal_matrix(n, noise, seed):
    """The 9 x 9 normal matrix of the DLT rows of n Hartley-normalized
    matches of a homography, with pixel noise (float64)."""
    from colmap_tpu_torch.kernels import matching_cases as C

    c = C.two_view_case("H", n, 4, seed, "cpu", outliers=0.0, valid=n)
    x1, x2 = c["x1"].double(), c["x2"].double()
    x2 = x2 + noise * torch.from_numpy(np.random.default_rng(seed).normal(size=x2.shape))

    def hartley(x):
        x = x - x.mean(0)
        return x * (2 ** 0.5 / x.norm(dim=1).mean())

    a, b = hartley(x1), hartley(x2)
    u1, v1, u2, v2 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], 1)
    r2 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], 1)
    rows = torch.cat([r1, r2])
    return rows.T @ rows


@pytest.mark.parametrize("n, noise, seed", [(8192, 0.5, 1), (600, 0.0, 2), (40, 2.0, 3),
                                            (1000, 0.1, 4)],
                         ids=["8192_rows", "exact", "40_noisy_rows", "1000_rows"])
def test_warp_jacobi_takes_colmap_tpus_smallest_eigenvector(n, noise, seed):
    import jax.numpy as jnp
    from colmap_tpu.optim.small_linalg import eigh_small

    A = _dlt_normal_matrix(n, noise, seed)
    got = KM.warp_jacobi_model(A).double()
    w, V = eigh_small(jnp.asarray(A.numpy(), dtype=jnp.float32), sweeps=10)
    ref = torch.from_numpy(np.asarray(V[:, 0], dtype=np.float64))
    assert abs(float(got.norm()) - 1.0) < 1e-5
    # Both float32: the vector of a well-separated smallest eigenvalue.
    assert 1.0 - abs(float(got @ ref)) < 1e-5
    exact = torch.linalg.eigh(A).eigenvectors[:, 0]
    assert 1.0 - abs(float(got @ exact)) < 1e-5


def test_warp_jacobi_of_a_diagonal_matrix_takes_the_first_smallest_entry():
    A = torch.diag(torch.tensor([3.0, 1.0, 2.0, 1.0, 5.0, 6.0, 7.0, 8.0, 9.0]))
    got = KM.warp_jacobi_model(A)
    assert torch.equal(got, torch.eye(9)[:, 1])
