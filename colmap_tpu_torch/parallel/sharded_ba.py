"""Point-sharded bundle adjustment on torch.distributed.

Counterpart of colmap_tpu/parallel/sharded_ba.py's sharded PACKED solver
(pack_problem_sharded, make_sharded_packed_solver, solve_sharded_packed).
Points are range-partitioned over the ranks: each rank holds n_loc =
ceil(N / ranks) points with all of their observations, packed in the
point-major layout of ``pack_problem`` at capacities that are the same on
every rank. Point-side state (H_pp blocks, g_x, dx) never leaves its rank;
the only traffic is sums of camera-system-sized arrays (6F + C*P floats):
colmap_tpu's psums become ``all_reduce`` calls, one flat buffer each. An LM
iteration sums K2's camera-side outputs once, each PCG matvec once (or the
dense path's S once) and the new cost with the point part of the predicted
decrease once: pcg_iterations + 3 all-reduces (dense: 4), plus the start
cost once a solve. Every rank then runs K34 and K35 on the same summed
values, so the ranks take the same steps and hold the same camera
parameters, bit for bit. The loop launches without a CUDA graph: the
collectives are not captured.

colmap_tpu's observation-sharded ``sharded_lm_step`` and ``solve_sharded``
run its unpacked ``lm_step``; the port has no unpacked step (its ``solve``
already runs the packed kernels with the scalar Jacobi preconditioner), so
both run on the point-sharded packed shards here with ``solve``'s
semantics.

Collectives go through multihost.all_reduce and all_gather: NCCL takes
the card's tensors; gloo, which also serves several ranks sharing one
card, is given host copies (each all-reduce copies its buffer to the host
and back).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from colmap_tpu_torch.estimators import bundle_adjustment as ba
from colmap_tpu_torch.parallel import multihost


def pack_problem_sharded(problem: ba.BAProblem, n_ranks: int, align: int = 2,
                         ranks: Optional[Sequence[int]] = None):
    """Partition the points (with their observations) into ``n_ranks``
    ranges of n_loc = ceil(N / n_ranks) points, dummy points (no
    observations) at the end, and pack the shards ``ranks`` (all by default)
    with ``pack_problem`` at the capacity capp that is the largest over all
    shards (colmap_tpu's partition and capacities).

    Returns (packed shards, their PackedMaps, info dict with capf, capp,
    n_loc, N): lists in the order of ``ranks``. A shard's parameters are the
    whole problem's quat, t and cam_params, and its own n_loc points.
    """
    F = int(problem.quat.shape[0])
    N = int(problem.points.shape[0])
    n_loc = -(-N // n_ranks)
    points = problem.points
    if n_loc * n_ranks != N:
        pad = points.new_zeros(n_loc * n_ranks - N, 3)
        points = torch.cat([points, pad])
    obs_point = problem.obs_point.cpu().numpy()
    obs_frame = problem.obs_frame.cpu().numpy()
    shard_of_obs = obs_point // n_loc
    capf, capp = 1, 1
    for d in range(n_ranks):
        sel = shard_of_obs == d
        if not sel.any():
            continue
        capf = max(capf, int(np.bincount(obs_frame[sel], minlength=F).max()))
        capp = max(capp, int(np.bincount(obs_point[sel] - d * n_loc, minlength=n_loc).max()))
    capf = -(-capf // align) * align
    capp = -(-capp // align) * align

    packed, maps = [], []
    for d in range(n_ranks) if ranks is None else ranks:
        sel = torch.from_numpy(np.flatnonzero(shard_of_obs == d)).to(problem.obs_point.device)
        local = problem._replace(
            points=points[d * n_loc:(d + 1) * n_loc],
            obs_frame=problem.obs_frame[sel], obs_cam=problem.obs_cam[sel],
            obs_point=problem.obs_point[sel] - d * n_loc,
            obs_xy=problem.obs_xy[sel], obs_w=problem.obs_w[sel])
        pk, mp, _ = ba.pack_problem(local, align=align, capp=capp)
        packed.append(pk)
        maps.append(mp)
    return packed, maps, {"capf": capf, "capp": capp, "n_loc": n_loc, "N": N}


def _all_reduce(group, tensors: List[torch.Tensor]) -> None:
    """Sum ``tensors`` over the group's ranks in place, as one flat buffer
    (one dtype)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    multihost.all_reduce(flat, group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n


def make_reduce(group=None):
    """The LM loop's all-reduce hook over ``group`` (None: the default
    group): ``reduce(*tensors)`` sums the tensors over the ranks in place."""
    return lambda *tensors: _all_reduce(group, list(tensors))


def _shard(problem, model_id, options, masks, group):
    """(this rank's packed shard, its maps, its masks, info, reduce,
    options) of the whole ``problem``; reduce is None without a process
    group."""
    n_ranks = multihost.process_count(group)
    rank = multihost.process_index(group)
    if options is None:
        options = ba.BAOptions()
    if masks is None:
        masks = ba.default_masks(problem, model_id, options)
    (packed,), (maps,), info = pack_problem_sharded(problem, n_ranks, ranks=[rank])
    n_loc, N = info["n_loc"], info["N"]
    pm = masks.point_mask.new_zeros(n_loc * n_ranks)
    pm[:N] = masks.point_mask
    local_masks = masks._replace(point_mask=pm[rank * n_loc:(rank + 1) * n_loc].contiguous())
    reduce = make_reduce(group) if dist.is_initialized() else None
    return packed, maps, local_masks, info, reduce, options


def _solve(problem, model_id, options, masks, group, use_dense, block_jacobi, verbose=False):
    packed, maps, local_masks, info, reduce, options = _shard(problem, model_id, options,
                                                              masks, group)
    initial_cost = float(ba.compute_cost(problem, model_id, options))
    solved, final_cost, n_iters = ba._lm_loop(
        packed, maps, model_id, options, local_masks,
        ba._use_dense(problem, options) if use_dense is None else use_dense, block_jacobi,
        verbose, reduce=reduce)
    points = (solved.points if reduce is None
              else torch.cat(multihost.all_gather(solved.points, group)))
    out = problem._replace(quat=solved.quat, t=solved.t, cam_params=solved.cam_params,
                           points=points[:info["N"]])
    return out, {
        "initial_cost": initial_cost,
        "final_cost": float(final_cost),
        "num_iterations": int(n_iters),
        "num_devices": multihost.process_count(group),
    }


def solve_sharded_packed(problem: ba.BAProblem, model_id, options: Optional[ba.BAOptions] = None,
                         masks: Optional[ba.BAMasks] = None, group=None):
    """The point-sharded packed LM solve (``solve_packed``'s semantics).

    Every rank of ``group`` (None: the default group; without one the
    solve runs alone) passes the whole problem and gets back the whole
    problem (its points gathered from the ranks) and colmap_tpu's summary
    dict, ``num_devices`` the world size."""
    return _solve(problem, model_id, options, masks, group, None, True)


def solve_sharded(problem: ba.BAProblem, model_id, options: Optional[ba.BAOptions] = None,
                  masks: Optional[ba.BAMasks] = None, group=None, verbose: bool = False):
    """The point-sharded solve with ``solve``'s semantics: always PCG, with
    the scalar Jacobi preconditioner."""
    return _solve(problem, model_id, options, masks, group, False, False, verbose)


def sharded_lm_step(model_id, options: ba.BAOptions, group=None):
    """One LM iteration on a rank's shard: returns step(shard, maps, masks,
    lam, nu) -> (shard, lam, nu, cost, new_cost, accepted), the costs summed
    over the ranks (``bundle_adjustment.lm_step_packed`` with the group's
    all-reduce; ``solve``'s scalar Jacobi preconditioner). ``shard``,
    ``maps`` and ``masks`` are one rank's, as pack_problem_sharded and
    solve_sharded_packed cut them."""
    reduce = make_reduce(group) if dist.is_initialized() else None

    def step(shard, maps, masks, lam, nu):
        return ba.lm_step_packed(shard, maps, model_id, options, masks, lam, nu, reduce,
                                 solve_semantics=True)

    return step
