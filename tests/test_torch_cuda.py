"""colmap_tpu_torch CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and the CUDA toolkit and skip without them.
The file imports neither JAX nor colmap_tpu, so on a machine without JAX
it runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Each float32 kernel is held against its plain version run in float64 on
the same inputs. K1 agrees to 1e-5 of each output's largest entry. K2-K4
sum frame and camera terms with atomics, so the order of those float32
sums, and their last bits, vary from run to run: they are held to 1e-4.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


def _close(got, ref, tol, name):
    """max |got - ref| <= tol * max |ref|."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1e-30)
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol:g} * {scale:.3e}"


def _f64(*xs):
    return [x.double() if x.is_floating_point() else x for x in xs]


def _setup(num_frames, num_points, track=0):
    """A synthetic problem on the card, packed, with two-frame gauge masks.
    With ``track`` > 0 its point 0 is also seen by frames 0..track-1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.sensor.models import img_from_cam

    problem, _, model_id = synthetic_ba_problem(num_frames, num_points, 6, seed=1,
                                                device="cuda")
    if track:
        p = problem
        frames = torch.arange(track, device="cuda")
        Xc = rot.quat_rotate(p.quat[frames], p.points[0].expand(track, 3)) + p.t[frames]
        xy, _ = img_from_cam(model_id, p.cam_params[0], Xc)
        zeros = torch.zeros(track, dtype=torch.int32, device="cuda")
        problem = p._replace(
            obs_frame=torch.cat([p.obs_frame, frames.to(torch.int32)]),
            obs_cam=torch.cat([p.obs_cam, zeros]), obs_point=torch.cat([p.obs_point, zeros]),
            obs_xy=torch.cat([p.obs_xy, xy + 0.5]),
            obs_w=torch.cat([p.obs_w, torch.ones_like(xy[:, 0])]))
    opts = ba.BAOptions(max_iterations=3, pcg_iterations=10)
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, opts), 0, 1)
    packed, maps, _ = ba.pack_problem(problem)
    return packed, maps, model_id, opts, masks


@pytest.fixture
def problem():
    return _setup(20, 2000)


@pytest.mark.parametrize("shape", [(20, 2000, 0), (800, 2000, 700)],
                         ids=["20x2000", "800_frames_long_track"])
def test_kernels_match_plain_on_cuda(shape):
    """K1-K4 against their plain versions (float64) on a 20 x 2000 problem,
    and on 800 frames with one track of 706 observations: there K2 adds its
    frame table (above its shared-memory limit) straight into global memory,
    and K4 tiles the long point's slots."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    pk, maps, model_id, opts, masks = _setup(*shape)
    om = ba._obs_masks(masks, opts)
    args = (pk.quat, pk.t, pk.cam_params, pk.points, pk.obs_frame, pk.obs_cam, pk.obs_point,
            pk.obs_xy, pk.obs_w, om.pose, om.cam, om.point)
    J = K.obs_jacobians(*args, model_id, "trivial", 1.0)
    ref = K.obs_jacobians_plain(*_f64(*args), model_id, "trivial", 1.0)
    for name, a, b in zip(("r", "Jp", "Jc", "Jx"), J, ref):
        _close(a, b, 1e-5, f"K1 {name}")
    F, C = pk.quat.shape[0], pk.cam_params.shape[0]
    fpm, cpm = maps.frame_pm, maps.cam_pm
    red = K.lm_reduce(*J, fpm, cpm, F, C, 1e-3)
    ref = K.lm_reduce_plain(*_f64(*J), fpm, cpm, F, C, 1e-3)
    for name, a, b in zip(K.LMReduction._fields, red, ref):
        _close(a, b, 1e-4, f"K2 {name}")
    g = torch.Generator(device="cuda").manual_seed(0)
    xp = torch.randn(F, 6, device="cuda", generator=g)
    xc = torch.randn(C, J[2].shape[-1], device="cuda", generator=g) * 1e-3
    ops = (J[1], J[2], J[3], fpm, cpm, red.Hpp_inv)
    for name, a, b in zip(("out_p", "out_c"), K.schur_matvec(*ops, xp, xc),
                          K.schur_matvec_plain(*_f64(*ops, xp, xc))):
        _close(a, b, 1e-4, f"K3 {name}")
    _close(K.back_substitute(*ops, red.gx, xp, xc),
           K.back_substitute_plain(*_f64(*ops, red.gx, xp, xc)), 1e-4, "K3 dx")
    lam_diag = torch.cat([1e-3 * red.diag_pose.reshape(-1), 1e-3 * red.diag_cam.reshape(-1)])
    _close(K.dense_schur_assemble(*ops, lam_diag, F),
           K.dense_schur_assemble_plain(*_f64(*ops, lam_diag), F), 1e-4, "K4 S")


@pytest.mark.parametrize("solver", ["dense_schur", "pcg"])
def test_solve_matches_plain_on_cuda(problem, solver):
    """Three LM iterations through the kernels and through the plain
    versions on the card: final costs within 1e-3 relative."""
    import dataclasses

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    pk, maps, model_id, opts, masks = problem
    opts = dataclasses.replace(opts, solver_type=solver)
    K.reset_launches()
    _, cost, _ = ba.lm_solve_fused_packed(pk, maps, model_id, opts, masks)
    assert K.LAUNCHES["ba_dense_schur_assemble" if solver == "dense_schur"
                      else "ba_schur_matvec"] > 0
    _, cost_plain, _ = ba._lm_loop(pk, maps, model_id, opts, masks, ba._use_dense(pk, opts),
                                   True, kernels=K.PLAIN)
    assert abs(cost - cost_plain) <= 1e-3 * cost_plain
