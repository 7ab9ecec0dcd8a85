"""The ranks of the multi-process checks, and a launcher for them.

``launch(case, world, out)`` starts ``world`` processes of

    python -m colmap_tpu_torch.parallel.dist_cases CASE --rank R --world W \
        --init tcp://127.0.0.1:PORT --out DIR [--device DEV]

which form one process group (``multihost.initialize`` with explicit
arguments) and run CASE; each rank writes its results into DIR. Cases:

    cpu        gloo on the CPU: for each entry name: [solver, options] of
               DIR/cases.json, ``sharded_ba.<solver>`` (solve_sharded_packed
               or solve_sharded) on the problem and masks of
               DIR/problem.npz under those options (rank R writes
               rank{R}_{name}.npz), then
               ``all_gather_bytes`` and ``exchange_sub_reconstructions`` of a
               small synthetic leaf per rank (rank{R}_exchange.json);
    headline   gloo, every rank on ``--device`` (ranks sharing one card):
               the BA headline (200 frames x 50 000 points x 300 000
               observations, SIMPLE_RADIAL, seed 0; the problem of
               chip_smoke.py's BA phases) split over the ranks, 10 LM
               iterations with PCG (20 steps), solved twice (the second
               timed), then 200 all-reduces of the camera system timed,
               into rank{R}_headline.npz.

The CPU tests (tests/test_torch_parallel.py) and chip_smoke.py's phase
``sharded`` run these cases.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parent.parent.parent

HEADLINE_OPTIONS = dict(max_iterations=10, pcg_iterations=20, function_tolerance=0.0,
                        solver_type="pcg")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(case: str, world: int, out, device=None, timeout: float = 300.0,
           wait: bool = True):
    """Start the ``world`` ranks of ``case`` writing into ``out``; with
    ``wait`` wait for them (raising if a rank fails or the time runs out,
    after ending every rank) and return their wall seconds, else return the
    processes (``finish(procs, timeout)`` waits for them)."""
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(_REPO), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world):
        argv = [sys.executable, "-m", "colmap_tpu_torch.parallel.dist_cases", case, "--rank",
                str(rank), "--world", str(world), "--init", init, "--out", str(out)]
        if device is not None:
            argv += ["--device", str(device)]
        log = open(Path(out) / f"rank{rank}_{case}.log", "w")
        procs.append((subprocess.Popen(argv, cwd=_REPO, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    if not wait:
        return procs
    t0 = time.perf_counter()
    finish(procs, timeout)
    return time.perf_counter() - t0


def finish(procs, timeout: float) -> None:
    """Wait for every rank; on a failure or at the time limit end them all
    and raise with the failing rank's log."""
    deadline = time.perf_counter() + timeout
    try:
        for rank, (p, log) in enumerate(procs):
            rc = p.wait(timeout=max(deadline - time.perf_counter(), 0.1))
            if rc != 0:
                log.flush()
                text = Path(log.name).read_text()[-4000:]
                raise RuntimeError(f"rank {rank} exited with {rc}:\n{text}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def _problem_from_npz(path, device):
    from colmap_tpu_torch import convert

    d = dict(np.load(path))
    model_id = int(d.pop("model_id"))
    problem = convert.problem_from_numpy({k: d[k] for k in d if not k.startswith("mask_")},
                                         device)
    masks = convert.problem_from_numpy({k[5:]: d[k] for k in d if k.startswith("mask_")},
                                       device)
    return problem, masks, model_id


def _save(path, problem, summary, **extra):
    np.savez(path, quat=problem.quat.cpu().numpy(), t=problem.t.cpu().numpy(),
             cam_params=problem.cam_params.cpu().numpy(), points=problem.points.cpu().numpy(),
             summary=json.dumps(summary), **extra)


def _leaf(rank):
    from colmap_tpu_torch.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset

    return synthesize_dataset(SyntheticDatasetOptions(
        num_rigs=1, num_frames_per_rig=3, num_points3D=20, seed=10 + rank))


def leaf_summary(recon):
    """(registered frames, points, image names, the points' coordinate sum)."""
    names = sorted(img.name for img in recon.images.values())
    xyz = sum(float(np.sum(p.xyz)) for p in recon.points3D.values())
    return [recon.num_reg_frames(), recon.num_points3D(), names, xyz]


def _cpu(rank, out):
    from colmap_tpu_torch.estimators.bundle_adjustment import BAOptions
    from colmap_tpu_torch.parallel import multihost, sharded_ba
    from colmap_tpu_torch.sfm.hierarchical_pipeline import exchange_sub_reconstructions

    problem, masks, model_id = _problem_from_npz(out / "problem.npz", "cpu")
    for name, (solver, fields) in json.loads((out / "cases.json").read_text()).items():
        solved, summary = getattr(sharded_ba, solver)(problem, model_id, BAOptions(**fields),
                                                      masks)
        _save(out / f"rank{rank}_{name}.npz", solved, summary)
    blobs = multihost.all_gather_bytes(bytes([rank]) * (rank + 3))
    leaves = exchange_sub_reconstructions([_leaf(rank)])
    (out / f"rank{rank}_exchange.json").write_text(json.dumps(dict(
        blobs=[b.hex() for b in blobs], leaves=[leaf_summary(r) for r in leaves],
        objects=multihost.all_gather_host_objects({"rank": rank}))))


def _headline(rank, out, device):
    from colmap_tpu_torch.estimators import bundle_adjustment as ba
    from colmap_tpu_torch.parallel import sharded_ba
    from colmap_tpu_torch.scene.synthetic_ba import synthetic_ba_problem

    problem, _, model_id = synthetic_ba_problem(200, 50000, 6, seed=0, device=device)
    options = ba.BAOptions(**HEADLINE_OPTIONS)
    masks = ba.fix_gauge_two_frames(ba.default_masks(problem, model_id, options), 0, 1)
    sharded_ba.solve_sharded_packed(problem, model_id, options, masks)  # warm-up
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    solved, summary = sharded_ba.solve_sharded_packed(problem, model_id, options, masks)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    # One all-reduce of the camera system through the solve's hook.
    buf = torch.zeros(6 * problem.quat.shape[0] + problem.cam_params.numel(), device=device)
    reduce = sharded_ba.make_reduce()
    reduce(buf)
    t0 = time.perf_counter()
    for _ in range(200):
        reduce(buf)
    torch.cuda.synchronize(device)
    _save(out / f"rank{rank}_headline.npz", solved, summary, seconds=seconds,
          allreduce_us=(time.perf_counter() - t0) / 200 * 1e6)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("case", choices=("cpu", "headline"))
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--init", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    from colmap_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(args.init, args.world, args.rank, backend="gloo")
    try:
        if args.case == "cpu":
            _cpu(args.rank, Path(args.out))
        else:
            _headline(args.rank, Path(args.out), device)
        multihost.all_gather_bytes(b"")  # no rank leaves before the others are done
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
