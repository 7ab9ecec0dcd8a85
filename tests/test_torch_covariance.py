"""colmap_tpu_torch's BA covariance against colmap_tpu's, on the CPU in float64.

colmap_tpu's covariance scene (tests/test_aux_estimators.py:41-64: 8 frames
x 120 points x 5 observations, float64, seed 2, 1 px noise, frames 0/1 as
the gauge, intrinsics fixed), made by colmap_tpu's generator and carried
across with colmap_tpu_torch.convert, goes through both
``estimate_ba_covariance``s: the port's on the CPU runs K1's and K54's
plain versions in float64. Two more cases: a masked point, and free
intrinsics. colmap_tpu's S (the vmap of _schur_matvec over the identity,
covariance.py:57) is held against K54's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.estimators.covariance import estimate_ba_covariance as j_covariance
from colmap_tpu.scene.synthetic_ba import synthetic_ba_problem as j_synthetic
from colmap_tpu_torch import convert
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.estimators.covariance import estimate_ba_covariance
from colmap_tpu_torch.kernels import ba as K

torch.set_num_threads(1)  # one intra-op thread a worker, as the other port test files

CASES = ["gauge", "masked_point", "free_intrinsics"]


def _scene(case):
    """(JAX problem, JAX masks, port problem, port masks, model id)."""
    jp, _, model_id = j_synthetic(num_frames=8, num_points=120, obs_per_point=5,
                                  dtype=jnp.float64, pixel_noise=1.0, seed=2)
    jm = jba.fix_gauge_two_frames(jba.default_masks(jp, model_id, jba.BAOptions()), 0, 1)
    if case != "free_intrinsics":
        jm = jm._replace(cam_mask=jnp.zeros_like(jm.cam_mask))
    if case == "masked_point":
        jm = jm._replace(point_mask=jm.point_mask.at[7].set(0.0))
    to_np = lambda x: {k: np.asarray(v) for k, v in x._asdict().items()}
    return (jp, jm, convert.problem_from_numpy(to_np(jp), "cpu"),
            convert.problem_from_numpy(to_np(jm), "cpu"), model_id)


def _fixed_rows(jm):
    """Rows of S the masks fix: each frame's 3 rotation and 3 translation
    entries, then the camera parameters."""
    fm, ftm = np.asarray(jm.frame_mask), np.asarray(jm.frame_trans_mask)
    pose = np.concatenate([np.repeat(fm[:, None], 3, 1), ftm], axis=1).reshape(-1)
    return np.concatenate([pose, np.asarray(jm.cam_mask).reshape(-1)]) == 0


@pytest.mark.parametrize("case", CASES)
def test_covariance_matches_colmap_tpu(case):
    """Both estimate_ba_covariance's within 1e-9 of the largest entry; the
    rows the masks fix are exactly 0 in both; free pose blocks are
    positive-definite."""
    jp, jm, tp, tm, model_id = _scene(case)
    ref = j_covariance(jp, model_id, jba.BAOptions(), jm)
    got = estimate_ba_covariance(tp, model_id, tba.BAOptions(), tm)
    fixed = _fixed_rows(jm)
    F = jp.quat.shape[0]
    for key in ("pose_covs", "cam_covs"):
        r, g = np.asarray(ref[key]), got[key]
        assert g.shape == r.shape and g.dtype == np.float64, key
        assert np.abs(g - r).max() <= 1e-9 * np.abs(r).max(initial=1e-300), key
    for cov in (ref, got):
        pose = np.asarray(cov["pose_covs"])
        pose_fixed = fixed[:6 * F].reshape(F, 6)
        for f in range(F):
            assert (pose[f][pose_fixed[f]] == 0).all() and (pose[f][:, pose_fixed[f]] == 0).all()
        cam = np.asarray(cov["cam_covs"])
        cam_fixed = fixed[6 * F:].reshape(cam.shape[0], -1)
        assert (cam[0][cam_fixed[0]] == 0).all() and (cam[0][:, cam_fixed[0]] == 0).all()
        for f in range(2, F):
            assert np.linalg.eigvalsh(pose[f]).min() > 0
    if case == "free_intrinsics":
        assert np.abs(got["cam_covs"]).max() > 0


@pytest.mark.parametrize("case", CASES)
def test_k54_plain_matches_colmap_tpu_schur(case):
    """K54's plain version on the port's K1 Jacobians against colmap_tpu's S
    (covariance.py:41-57: the vmap of _schur_matvec over the identity):
    within 1e-10 of S's largest entry, and exactly 0 on the fixed rows."""
    jp, jm, tp, tm, model_id = _scene(case)
    opts = jba.BAOptions()
    r, Jp, Jc, Jx = jba._obs_jacobians(jp, model_id, opts)
    Jp, Jc, Jx = jba._apply_masks(Jp, Jc, Jx, jp, jm, opts)
    F = jp.quat.shape[0]
    C, P = jp.cam_params.shape
    ops = jba._build_schur(jp, Jp, Jc, Jx, jnp.asarray(1e-8, jnp.float64), opts)

    def matvec(v):
        op, oc = jba._schur_matvec(jp, ops, v[:6 * F].reshape(F, 6), v[6 * F:].reshape(C, P))
        return jnp.concatenate([op.reshape(-1), oc.reshape(-1)])

    ref = np.asarray(jax.vmap(matvec)(jnp.eye(6 * F + C * P, dtype=jnp.float64)).T)

    packed, maps, _ = tba.pack_problem(tp)
    om = tba._obs_masks(tm, tba.BAOptions())
    p = packed
    _, tJp, tJc, tJx = K.obs_jacobians_plain(
        p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point, p.obs_xy,
        p.obs_w, om.pose, om.cam, om.point, model_id, "trivial", 1.0)
    S = K.covariance_assemble_plain(tJp, tJc, tJx, maps.frame_pm, maps.cam_pm, 1e-8, F, C)
    assert S.dtype == torch.float64
    S = S.numpy()
    assert np.abs(S - ref).max() <= 1e-10 * np.abs(ref).max()
    fixed = _fixed_rows(jm)
    assert (S[fixed] == 0).all() and (S[:, fixed] == 0).all()
    # The wrapper runs the plain version on CPU tensors, in float64 from float32 too.
    S32 = K.covariance_assemble(tJp.float(), tJc.float(), tJx.float(), maps.frame_pm,
                                maps.cam_pm, 1e-8, F, C)
    assert S32.dtype == torch.float64 and (S32.numpy()[fixed] == 0).all()
