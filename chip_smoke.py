#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (colmap_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the kernels (colmap_tpu_torch/csrc) with nvcc;
  3. kernels: hold every kernel against its plain PyTorch version (run in
     float64 on the same inputs) on the card, on the headline problem
     (200 frames x 50k points x 300k observations, float32, SIMPLE_RADIAL)
     and on small problems over camera models 0-4, robust losses, ragged
     tracks, several cameras, tracks longer than a warp, 800 frames with a
     706-observation track and 4200 frames (the kernels' paths for large
     frame tables and long tracks); time kernel and plain version with CUDA
     events;
  4. headline solve: lm_solve_fused_packed for 10 LM iterations with the
     dense Schur solver ("auto") and with PCG, counting kernel launches, held
     against the colmap_tpu reference cost and against the same solve
     through the plain versions;
  5. CLI: bundle_adjuster on a synthetic 120-frame model on cuda, then
     model_analyzer;
  6. profile: device time by kernel and the device's idle share in a warm
     LM iteration of each solver (torch.profiler).
Then it prints the kernels line (JSON), the nvidia-smi line and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) operations/s, for the bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Final cost of colmap_tpu (JAX, CPU, float32) on the headline problem after
# 10 LM iterations, dense Schur or PCG; and its limit relative to the cost
# at the ground-truth state.
REFERENCE_FINAL_COST = 5.6219e4
MAX_FINAL_OVER_GT = 0.76

# Each kernel (float32) is held against its plain version in float64 on the
# same inputs; errors are relative to the largest entry of each output.
K1_RTOL = 1e-5
# Under huber / cauchy the weight depends on the residual, whose float32
# rounding in the kernel (proj - xy: about 1e-4 px on coordinates of 1e3 px)
# the weight carries into every Jacobian entry of small residuals.
K1_ROBUST_RTOL = 1e-4
K234_RTOL = 1e-4  # float32 sums, in an order the atomics change from run to run


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|): the error relative to the tensor's scale."""
    d = (got.double() - ref.double()).abs().max().item()
    s = ref.double().abs().max().item()
    return d, d / max(s, 1e-30)


def time_ms(fn, reps=25):
    """Median GPU time of fn over reps launches, each between two CUDA events.

    A sleep kernel queued first lets the host enqueue all launches ahead of
    the card, so the events time the device work and not the host."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved, ops):
    """(bound_ms, bound_by) from this run's bytes and operations."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, ref, rtol, errs):
    a, r = rel_err(got, ref)
    log(f"  {name}: max_abs_err {a:.3e} rel {r:.3e} (tol {rtol:g})")
    if not r <= rtol:
        raise AssertionError(f"{name}: relative error {r:.3e} > {rtol:g}")
    errs.append(a)


def f64(*xs):
    return tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in xs)


def compare_kernels(problem, maps, model_id, options, masks, errs, label):
    """K1-K4 against their plain versions on one problem; returns the
    float32 inputs and outputs for timing.

    The reference is the plain version evaluated in float64 on the same
    (float32) inputs, so the error is the kernel's own."""
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    log(f"kernels vs plain: {label}")
    om = ba._obs_masks(masks, options)
    p = problem
    args = (p.quat, p.t, p.cam_params, p.points, p.obs_frame, p.obs_cam, p.obs_point,
            p.obs_xy, p.obs_w)
    F, C = problem.quat.shape[0], problem.cam_params.shape[0]
    fpm, cpm = maps.frame_pm, maps.cam_pm
    rest = (om.pose, om.cam, om.point, model_id, options.loss, options.loss_scale)
    out_k = K.obs_jacobians(*args, *rest)
    out_p = K.obs_jacobians_plain(*f64(*args, *rest))
    k1_rtol = K1_RTOL if options.loss == "trivial" else K1_ROBUST_RTOL
    for n, a, b in zip(("r", "Jp", "Jc", "Jx"), out_k, out_p):
        check(f"K1 {n}", a, b, k1_rtol, errs["ba_obs_jacobians"])
    c_k = K.obs_cost(*args, model_id, options.loss, options.loss_scale)
    c_p = K.obs_cost_plain(*f64(*args), model_id, options.loss, options.loss_scale)
    check("K1 cost", c_k, c_p, k1_rtol, errs["ba_obs_jacobians"])

    r, Jp, Jc, Jx = out_k
    lam = 1e-3
    red_k = K.lm_reduce(r, Jp, Jc, Jx, fpm, cpm, F, C, lam)
    red_p = K.lm_reduce_plain(*f64(r, Jp, Jc, Jx), fpm, cpm, F, C, lam)
    for n, a, b in zip(red_k._fields, red_k, red_p):
        check(f"K2 {n}", a, b, K234_RTOL, errs["ba_lm_reduce"])

    g = torch.Generator(device="cuda").manual_seed(0)
    xp = torch.randn(F, 6, device="cuda", generator=g)
    xc = torch.randn(C, Jc.shape[-1], device="cuda", generator=g) * 1e-3
    Hinv, gx = red_k.Hpp_inv, red_k.gx
    mv_k = K.schur_matvec(Jp, Jc, Jx, fpm, cpm, Hinv, xp, xc)
    mv_p = K.schur_matvec_plain(*f64(Jp, Jc, Jx, fpm, cpm, Hinv, xp, xc))
    check("K3 out_p", mv_k[0], mv_p[0], K234_RTOL, errs["ba_schur_matvec"])
    check("K3 out_c", mv_k[1], mv_p[1], K234_RTOL, errs["ba_schur_matvec"])
    dx_k = K.back_substitute(Jp, Jc, Jx, fpm, cpm, Hinv, gx, xp, xc)
    dx_p = K.back_substitute_plain(*f64(Jp, Jc, Jx, fpm, cpm, Hinv, gx, xp, xc))
    check("K3 dx", dx_k, dx_p, K234_RTOL, errs["ba_schur_matvec"])

    lam_diag = torch.cat([lam * red_k.diag_pose.reshape(-1), lam * red_k.diag_cam.reshape(-1)])
    S_k = K.dense_schur_assemble(Jp, Jc, Jx, fpm, cpm, Hinv, lam_diag, F)
    S_p = K.dense_schur_assemble_plain(*f64(Jp, Jc, Jx, fpm, cpm, Hinv, lam_diag), F)
    check("K4 S", S_k, S_p, K234_RTOL, errs["ba_dense_schur_assemble"])
    return dict(args=args, rest=rest, J=out_k, red=red_k, xp=xp, xc=xc, lam=lam,
                lam_diag=lam_diag, F=F, C=C)


def ragged_problem(seed, num_frames, num_points, obs_per_point, num_cams, keep, device):
    """A synthetic problem with dropped observations (padded slots) and
    several cameras."""
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    problem, gt, model_id = synthetic_ba_problem(num_frames, num_points, obs_per_point,
                                                 seed=seed, device=device)
    rng = np.random.default_rng(seed)
    O = problem.obs_xy.shape[0]
    sel = torch.from_numpy(np.flatnonzero(rng.random(O) < keep)).to(device)
    cams = problem.cam_params.repeat(num_cams, 1)
    cams[:, 0] += torch.arange(num_cams, device=device, dtype=cams.dtype) * 10.0
    obs_cam = torch.from_numpy(rng.integers(0, num_cams, len(sel)).astype(np.int32)).to(device)
    p = problem._replace(
        cam_params=cams, obs_frame=problem.obs_frame[sel], obs_cam=obs_cam,
        obs_point=problem.obs_point[sel], obs_xy=problem.obs_xy[sel], obs_w=problem.obs_w[sel],
    )
    return p, model_id


def long_track_problem(seed, num_frames, num_points, track, device):
    """A synthetic problem whose point 0 is also seen by frames 0..track-1,
    measured at its projection in the initial state plus 0.5 px noise."""
    from colmap_tpu_torch.geometry import rotation as rot
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.sensor.models import img_from_cam

    p, _, model_id = synthetic_ba_problem(num_frames, num_points, 6, seed=seed, device=device)
    frames = torch.arange(track, device=device)
    Xc = rot.quat_rotate(p.quat[frames], p.points[0].expand(track, 3)) + p.t[frames]
    xy, _ = img_from_cam(model_id, p.cam_params[0], Xc)
    g = torch.Generator(device=device).manual_seed(seed)
    xy = xy + 0.5 * torch.randn(track, 2, device=device, generator=g)
    ids = lambda a, b: torch.cat([a, b.to(torch.int32)])  # noqa: E731
    return p._replace(
        obs_frame=ids(p.obs_frame, frames), obs_cam=ids(p.obs_cam, torch.zeros_like(frames)),
        obs_point=ids(p.obs_point, torch.zeros_like(frames)),
        obs_xy=torch.cat([p.obs_xy, xy]), obs_w=torch.cat([p.obs_w, torch.ones_like(xy[:, 0])]),
    ), model_id


def phase_kernels(headline):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    errs = {k: [] for k in K.LAUNCHES}
    options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0)

    def setup(problem, model_id, opts=options):
        masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, opts), 0, 1)
        packed, maps, _ = ba.pack_problem(problem)
        return packed, maps, masks

    for model_id in range(5):
        problem, _, _ = synthetic_ba_problem(20, 2000, 6, model_id=model_id, seed=1,
                                             device="cuda")
        packed, maps, masks = setup(problem, model_id)
        compare_kernels(packed, maps, model_id, options, masks, errs, f"model {model_id}, 20x2000")
    for loss in ("huber", "cauchy"):
        opts = ba.BAOptions(loss=loss, loss_scale=2.0)
        problem, _, model_id = synthetic_ba_problem(20, 2000, 6, seed=2, device="cuda")
        packed, maps, masks = setup(problem, model_id, opts)
        compare_kernels(packed, maps, model_id, opts, masks, errs, f"{loss} loss, 20x2000")
    problem, model_id = ragged_problem(3, 20, 2000, 6, 3, 0.7, "cuda")
    packed, maps, masks = setup(problem, model_id)
    compare_kernels(packed, maps, model_id, options, masks, errs, "ragged tracks, 3 cameras")
    problem, model_id = ragged_problem(4, 24, 300, 40, 2, 0.95, "cuda")
    packed, maps, masks = setup(problem, model_id)
    compare_kernels(packed, maps, model_id, options, masks, errs,
                    f"tracks of up to {maps.frame_pm.shape[1]} slots")
    # 800 frames: K2's frame table exceeds its shared-memory limit, so K2 adds
    # straight into global memory; one track of 706 observations makes K4 tile
    # the point's slots. 4200 frames: the same for K3's matvec table.
    for num_frames, num_points, track in ((800, 2000, 700), (4200, 1000, 0)):
        problem, model_id = long_track_problem(5, num_frames, num_points, track, "cuda")
        packed, maps, masks = setup(problem, model_id)
        ctx = compare_kernels(packed, maps, model_id, options, masks, errs,
                              f"{num_frames} frames, tracks of up to {maps.frame_pm.shape[1]} "
                              "slots")
        (_, Jp, Jc, Jx), red = ctx["J"], ctx["red"]
        ms = time_ms(lambda: K.dense_schur_assemble(Jp, Jc, Jx, maps.frame_pm, maps.cam_pm,
                                                    red.Hpp_inv, ctx["lam_diag"], num_frames),
                     reps=5)
        log(f"  K4 time: {ms:.3f} ms")

    problem, model_id, packed, maps, masks = headline
    ctx = compare_kernels(packed, maps, model_id, options, masks, errs,
                          "headline 200x50000x300000")
    return errs, ctx


def time_kernels(ctx, maps, model_id):
    """ms, plain_ms, bound_ms, bound_by per kernel at the headline shapes."""
    from colmap_tpu_torch.kernels import ba as K

    args, rest, (r, Jp, Jc, Jx), red = ctx["args"], ctx["rest"], ctx["J"], ctx["red"]
    F, C, lam, xp, xc = ctx["F"], ctx["C"], ctx["lam"], ctx["xp"], ctx["xc"]
    fpm, cpm = maps.frame_pm, maps.cam_pm
    O, P, N = r.shape[0], Jc.shape[-1], fpm.shape[0]
    capp = fpm.shape[1]
    D = ctx["lam_diag"].shape[0]
    K_ = 6 + P
    J_bytes = nbytes(r, Jp, Jc, Jx)
    ids = nbytes(fpm, cpm)
    rows = {}

    def row(name, fn, plain, bytes_moved, ops):
        ms = time_ms(fn)
        plain_ms = time_ms(plain, reps=20)
        b_ms, by = bound(bytes_moved, ops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {by})")

    log("kernel times at the headline shapes (median of CUDA-event-timed launches):")
    om_bytes = nbytes(*rest[:3])
    row("ba_obs_jacobians",
        lambda: K.obs_jacobians(*args, *rest), lambda: K.obs_jacobians_plain(*args, *rest),
        nbytes(*args) + om_bytes + J_bytes,
        # ~40 ops for the pose/point chain, (4 + 3 + P) x 20 for the dual
        # projection, 2 x (6 + P + 3) x 3 for weighting and masking, per slot.
        O * (40 + (7 + P) * 20 + 6 * (9 + P)))
    row("ba_lm_reduce",
        lambda: K.lm_reduce(r, Jp, Jc, Jx, fpm, cpm, F, C, lam),
        lambda: K.lm_reduce_plain(r, Jp, Jc, Jx, fpm, cpm, F, C, lam),
        J_bytes + ids + nbytes(*red),
        # per slot: Hpp/gx 36, v 12, gp/bp 24, JpT Jp 84, camera 12 P; per point ~60.
        O * (156 + 12 * P) + N * 60)
    row("ba_schur_matvec",
        lambda: K.schur_matvec(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv, xp, xc),
        lambda: K.schur_matvec_plain(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv, xp, xc),
        nbytes(Jp, Jc, Jx, red.Hpp_inv, xp, xc) + ids + nbytes(xp, xc),
        # per slot: u 2(6 + P) x 2 (twice), w 12, v 12, JT z 4(6 + P); per point 18.
        O * (8 * (6 + P) + 24 + 4 * (6 + P)) + N * 18)
    # Per point with n real slots (a non-zero [Jp | Jc] row) and M = nK entries:
    # W = JT Jx (6nK FMAs) and Z = W Hpp^-1 (9nK FMAs); S_corr = Z WT is
    # symmetric, so M(M+1)/2 dot products of 3 (3 FMAs each); the H_cc term
    # on the nK(K+1)/2 entries of the diagonal blocks (2 FMAs each); one add
    # into S per entry of the symmetric half. An FMA is 2 operations.
    n = ((Jp != 0).flatten(1).any(1) | (Jc != 0).flatten(1).any(1)).view(N, capp)
    n = n.sum(1).double()
    M = n * K_
    k4_ops = float((30 * n * K_ + 3 * M * (M + 1) + 2 * n * K_ * (K_ + 1)
                    + M * (M + 1) / 2).sum())
    row("ba_dense_schur_assemble",
        lambda: K.dense_schur_assemble(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv, ctx["lam_diag"], F),
        lambda: K.dense_schur_assemble_plain(Jp, Jc, Jx, fpm, cpm, red.Hpp_inv,
                                             ctx["lam_diag"], F),
        nbytes(Jp, Jc, Jx, red.Hpp_inv, ctx["lam_diag"]) + ids + D * D * 4, k4_ops)
    cost_ms = time_ms(lambda: K.obs_cost(*args, model_id, "trivial", 1.0))
    log(f"  ba_obs_jacobians cost mode: {cost_ms:.4f} ms")
    return rows


def phase_headline_solve(headline, gt_cost, launches):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K

    problem, model_id, packed, maps, masks = headline
    results = {}
    for solver in ("auto", "pcg"):
        options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0,
                               solver_type=solver)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        solved, cost, iters = ba.lm_solve_fused_packed(packed, maps, model_id, options, masks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        log(f"headline solve ({solver}): final cost {cost:.6e} after {iters} iterations in "
            f"{dt:.3f} s = {iters / dt:.3f} LM iter/s; launches {counts}")
        needed = [k for k in K.LAUNCHES if k != "ba_dense_schur_assemble" or solver == "auto"]
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise AssertionError(f"the {solver} solve launched no {missing}")
        if solver == "pcg" and counts["ba_dense_schur_assemble"]:
            raise AssertionError("the pcg solve launched the dense Schur kernel")
        if iters != 10:
            raise AssertionError(f"expected 10 LM iterations, ran {iters}")
        if not abs(cost - REFERENCE_FINAL_COST) <= 0.01 * REFERENCE_FINAL_COST:
            raise AssertionError(f"final cost {cost:.6e} is not within 1% of {REFERENCE_FINAL_COST}")
        if not cost <= MAX_FINAL_OVER_GT * gt_cost:
            raise AssertionError(f"final cost {cost:.6e} > {MAX_FINAL_OVER_GT} x gt {gt_cost:.6e}")
        for x in solved[:4]:
            if not bool(torch.isfinite(x).all()):
                raise AssertionError("non-finite parameters after the solve")
        # The first solve also pays for loading what the path calls the first
        # time (cuSOLVER, cuBLAS); a second one times the steady state.
        t0 = time.perf_counter()
        _, cost_warm, _ = ba.lm_solve_fused_packed(packed, maps, model_id, options, masks)
        torch.cuda.synchronize()
        dt_warm = time.perf_counter() - t0
        log(f"  warm: the same solve again in {dt_warm:.3f} s = {iters / dt_warm:.3f} LM iter/s "
            f"(final cost {cost_warm:.6e})")
        _, cost_plain, iters_plain = ba._lm_loop(packed, maps, model_id, options, masks,
                                                 ba._use_dense(packed, options), True,
                                                 kernels=K.PLAIN)
        rel = abs(cost - cost_plain) / cost_plain
        log(f"  same solve through the plain versions: {cost_plain:.6e} "
            f"({iters_plain} iterations), relative difference {rel:.3e}")
        if not rel <= 1e-3:
            raise AssertionError(f"kernel vs plain solve differ by {rel:.3e} > 1e-3")
        results[solver] = dict(final_cost=cost, iters=iters, iter_per_s=iters / dt,
                               warm_iter_per_s=iters / dt_warm)
    return results


def phase_profile(headline, solves):
    """Where a warm LM iteration's time goes: device time by kernel from
    torch.profiler over 3 iterations per solver, against the warm wall time
    per iteration measured without the profiler; their ratio gives the
    device's busy and idle shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from colmap_tpu_torch.estimators import bundle_adjustment as ba

    _, model_id, packed, maps, masks = headline
    iters = 3
    for solver in ("auto", "pcg"):
        options = ba.BAOptions(max_iterations=iters, pcg_iterations=20, function_tolerance=0.0,
                               solver_type=solver)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ba.lm_solve_fused_packed(packed, maps, model_id, options, masks)
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            if e.device_type == DeviceType.CUDA and us > 0:
                rows.append((us / iters / 1e3, e.count / iters, e.key))
        wall_ms = 1e3 / solves[solver]["warm_iter_per_s"]
        if not rows:
            log(f"profile ({solver}): the profiler recorded no device time; not measured")
            continue
        busy_ms = sum(r[0] for r in rows)
        log(f"profile ({solver}), per LM iteration: device busy {busy_ms:.3f} ms of "
            f"{wall_ms:.3f} ms warm wall time, idle share {1 - busy_ms / wall_ms:.3f}")
        for ms, n, key in sorted(rows, reverse=True)[:10]:
            log(f"    {ms:9.4f} ms  {n:6.1f} launches  {key[:90]}")


def synthetic_reconstruction(num_frames, num_points, seed):
    """A Reconstruction built with the port's modules from a synthetic BA
    problem: one SIMPLE_RADIAL camera, one rig/frame/image per frame, the
    noisy initial state as the model and the measurements as 2D points."""
    from colmap_tpu_torch.scene.reconstruction import Reconstruction
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem
    from colmap_tpu_torch.scene.types import Camera, Frame, Image, Pose, Rig, TrackElement
    from colmap_tpu_torch.utils.types import SensorType

    problem, _, model_id = synthetic_ba_problem(num_frames, num_points, 6, seed=seed,
                                                dtype=torch.float64, device="cpu")
    p = {k: v.numpy() for k, v in problem._asdict().items()}
    recon = Reconstruction()
    recon.add_camera(Camera(camera_id=1, model_id=model_id, width=1024, height=768,
                            params=p["cam_params"][0].copy()))
    ok = p["obs_w"] > 0
    per_frame = [np.flatnonzero(ok & (p["obs_frame"] == f)) for f in range(num_frames)]
    for f in range(num_frames):
        iid = f + 1
        recon.add_rig(Rig(rig_id=iid, ref_sensor_id=(int(SensorType.CAMERA), 1)))
        recon.add_frame(Frame(frame_id=iid, rig_id=iid,
                              rig_from_world=Pose(p["quat"][f].copy(), p["t"][f].copy()),
                              data_ids=[(int(SensorType.CAMERA), 1, iid)]))
        image = Image(image_id=iid, name=f"image{iid:04d}.png", camera_id=1, frame_id=iid)
        image.set_points2D(p["obs_xy"][per_frame[f]])
        recon.add_image(image)
        recon.register_frame(iid)
    tracks = {}
    for f in range(num_frames):
        for idx, o in enumerate(per_frame[f]):
            tracks.setdefault(int(p["obs_point"][o]), []).append(TrackElement(f + 1, idx))
    for pt in sorted(tracks):
        if len(tracks[pt]) >= 2:
            recon.add_point3D(p["points"][pt], tracks[pt])
    return recon


def model_cost(path):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.estimators.ba_setup import problem_from_reconstruction
    from colmap_tpu_torch.scene.reconstruction_io import read_model

    problem, index = problem_from_reconstruction(read_model(path), device="cuda")
    return float(ba.compute_cost(problem, index["model_id"], ba.BAOptions()))


def phase_cli(launches):
    from colmap_tpu_torch.cli import main as cli
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.scene.reconstruction_io import write_model

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        recon = synthetic_reconstruction(120, 6000, seed=5)
        write_model(recon, src)
        log(f"CLI: model with {recon.num_reg_frames()} frames, {recon.num_points3D()} points, "
            f"{recon.compute_num_observations()} observations")
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["bundle_adjuster", "--input_path", src, "--output_path", dst,
                      "--device", "cuda"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        log(buf.getvalue().strip() + f"  ({dt:.2f} s; launches {counts})")
        missing = [k for k in ("ba_obs_jacobians", "ba_lm_reduce", "ba_schur_matvec")
                   if counts[k] == 0]
        if missing:
            raise AssertionError(f"bundle_adjuster launched no {missing}")
        c0, c1 = model_cost(src), model_cost(dst)
        log(f"  cost of the model read back: {c0:.6e} -> {c1:.6e}")
        if not (math.isfinite(c1) and c1 < c0):
            raise AssertionError("bundle_adjuster did not lower the cost")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["model_analyzer", "--path", dst])
        log("  model_analyzer: " + "; ".join(buf.getvalue().strip().splitlines()))
        if f"Registered frames: {recon.num_reg_frames()}" not in buf.getvalue():
            raise AssertionError("model_analyzer does not list every frame")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card")
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.kernels import ba as K
    from colmap_tpu_torch.kernels.build import library
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    t0 = time.perf_counter()
    library()
    log(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    problem, gt, model_id = synthetic_ba_problem(200, 50000, 6, seed=0, device="cuda")
    options = ba.BAOptions(max_iterations=10, pcg_iterations=20, function_tolerance=0.0)
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, options), 0, 1)
    packed, maps, caps = ba.pack_problem(problem)
    # Ground-truth parameters against the noisy measurements.
    gt_state = problem._replace(quat=gt.quat, t=gt.t, cam_params=gt.cam_params, points=gt.points)
    gt_cost = float(ba.compute_cost(gt_state, model_id, options))
    log(f"headline problem: F=200 N=50000 O={problem.obs_xy.shape[0]} capp={caps['capp']}, "
        f"initial cost {float(ba.compute_cost(problem, model_id, options)):.6e}, "
        f"ground-truth cost {gt_cost:.6e} (set-up {time.perf_counter() - t0:.1f} s)")
    headline = (problem, model_id, packed, maps, masks)

    errs, ctx = phase_kernels(headline)
    rows = time_kernels(ctx, maps, model_id)
    launches = {k: 0 for k in K.LAUNCHES}
    solves = phase_headline_solve(headline, gt_cost, launches)
    phase_cli(launches)
    phase_profile(headline, solves)

    sources = {
        "ba_obs_jacobians": ("colmap_tpu_torch/csrc/ba_jacobians.cu",
                             "colmap_tpu/estimators/bundle_adjustment.py:873"),
        "ba_lm_reduce": ("colmap_tpu_torch/csrc/ba_reduce.cu",
                         "colmap_tpu/estimators/bundle_adjustment.py:1039"),
        "ba_schur_matvec": ("colmap_tpu_torch/csrc/ba_matvec.cu",
                            "colmap_tpu/estimators/bundle_adjustment.py:951"),
        "ba_dense_schur_assemble": ("colmap_tpu_torch/csrc/ba_dense_schur.cu",
                                    "colmap_tpu/estimators/bundle_adjustment.py:1490"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=max(errs[name]),
            ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
            bound_ms=rows[name]["bound_ms"], bound_by=rows[name]["bound_by"],
            library_ms=None,
        ))
    log("headline LM iter/s on " + smi + ": " + ", ".join(
        f"{k} {v['iter_per_s']:.3f}, warm {v['warm_iter_per_s']:.3f} "
        f"(final cost {v['final_cost']:.6e})" for k, v in solves.items()))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
