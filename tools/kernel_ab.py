"""Time calls of two checkouts of the port in turns on one card.

    python3 tools/kernel_ab.py PARENT_DIR CHANGE_DIR CASE [CASE ...] [--out FILE] [--profile]

A CASE is FILE.py:FUNCTION[:ARG], for example tools/ab_cases.py:descend:2000.
Four worker processes run in turn, parent, change, change, parent, each with
its checkout's root first on sys.path, so that it imports and builds that
checkout's colmap_tpu_torch. A worker loads FILE.py by path and calls
FUNCTION(ARG, cache_dir), which returns a list of (label, call, output,
reps): `call` is timed with CUDA events (the median of reps launches, a
sleep kernel queued first); `output` is None or a function whose tensor's
SHA-256 the main process compares between the checkouts. cache_dir (beside
FILE of --out) lets a case make its inputs once for all four workers. The
main process prints each round, each label's median by checkout and whether
both give the same bits; it writes all of it to --out and needs one card.
With --profile each worker also runs each call 20 times under
torch.profiler and records each device kernel's ms and launches a call
(the kernels alone, without the gaps between them), under "parts".
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROUNDS = ("parent", "change", "change", "parent")


def _time_ms(torch, fn, reps):
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


def _parts(torch, fn, reps=20):
    """{kernel name: [device ms, launches]} a call of fn, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = out.get(e.name()[:80], (0.0, 0))
            out[e.name()[:80]] = (ms + e.duration_ns() / 1e6 / reps, n + 1 / reps)
    return out


def _digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def worker(tree, cases, cache_dir, out_path, profile=False):
    sys.path.insert(0, tree)
    import torch

    import colmap_tpu_torch

    if not colmap_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"colmap_tpu_torch from {colmap_tpu_torch.__file__}, not {tree}")
    res = {"tree": tree, "ms": {}, "sha256": {}, "parts": {}}
    if profile:  # the profiler set up before any case records a CUDA graph
        _parts(torch, lambda: torch.ones(1, device="cuda"), reps=1)
    for case in cases:
        path, func, *arg = case.split(":", 2)
        spec = importlib.util.spec_from_file_location(f"ab_case_{len(res['ms'])}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        for label, call, output, reps in getattr(module, func)(arg[0] if arg else None,
                                                               cache_dir):
            res["ms"][label] = _time_ms(torch, call, reps)
            if profile:
                res["parts"][label] = _parts(torch, call)
            if output is not None:
                res["sha256"][label] = _digest(output())
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(res, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("cases", nargs="+", metavar="CASE")
    ap.add_argument("--out", default="_perf/kernel_ab.json")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        tree, cache_dir, out_path = args.worker
        worker(tree, args.cases, cache_dir, out_path, args.profile)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA card")
    out = os.path.abspath(args.out)
    cache_dir = out + ".cache"
    os.makedirs(cache_dir, exist_ok=True)
    cases = []
    for case in args.cases:
        path, rest = case.split(":", 1)
        cases.append(f"{os.path.abspath(path)}:{rest}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rounds = []
    for i, name in enumerate(ROUNDS):
        tree = os.path.abspath(getattr(args, name))
        path = f"{out}.{i}.json"
        subprocess.run([sys.executable, os.path.abspath(__file__), args.parent, args.change,
                        *cases, *(["--profile"] if args.profile else []), "--worker", tree,
                        cache_dir, path], check=True, cwd=tree)
        with open(path) as f:
            rounds.append(dict(json.load(f), name=name))
        print(f"round {i} ({name}): " + json.dumps(rounds[-1]), flush=True)
    medians = {name: {k: statistics.median(r["ms"][k] for r in rounds if r["name"] == name)
                      for k in rounds[0]["ms"]} for name in ("parent", "change")}
    same = {k: len({r["sha256"].get(k) for r in rounds}) == 1 for k in rounds[0]["sha256"]}
    summary = {"card": smi, "medians_ms": medians, "same_bits": same}
    print(json.dumps(summary), flush=True)
    with open(out, "w") as f:
        json.dump(dict(summary, rounds=rounds), f)


if __name__ == "__main__":
    main()
