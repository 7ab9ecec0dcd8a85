"""Capture of one solver step as a CUDA graph, with the kernels' launch
counts kept true.

The solvers' loops (the packed and the rig LM solves, rotation averaging's
and global positioning's CG) record one step once per solve and replay it.
A kernel wrapper adds one to its module's ``LAUNCHES`` (and its launch
shape to ``SHAPES``, where the module keeps one) where it launches;
recording launches nothing, so ``capture`` takes back what the recorded
step added to the given modules' counts, and each replay adds it again, as
the graph launches each recorded kernel once.
"""

from __future__ import annotations

import time


def record(step, graph, modules):
    """Run ``step`` between ``graph.capture_begin`` and ``graph.capture_end``
    and move the launch counts it added to the replay. ``modules`` are the
    kernel modules whose ``LAUNCHES`` the step moves. Returns (replay,
    step's return value, seconds inside the recording)."""
    counts = [m.LAUNCHES for m in modules]
    counts += [m.SHAPES.counts for m in modules if hasattr(m, "SHAPES")]
    before = [dict(c) for c in counts]
    t0 = time.perf_counter()
    # thread_local: a synchronizing call in another thread of the pipeline
    # does not invalidate this capture.
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        out = step()
    finally:
        t1 = time.perf_counter()
        graph.capture_end()
    recorded = [(c, k, c[k] - b.get(k, 0)) for c, b in zip(counts, before) for k in c
                if c[k] != b.get(k, 0)]
    for c, k, n in recorded:
        c[k] -= n

    def replay():
        graph.replay()
        for c, k, n in recorded:
            c[k] += n

    return replay, out, t1 - t0


def capture(step, device, modules):
    """One call of ``step`` captured as a CUDA graph on a side stream (see
    ``record``). Returns (replay, step's return value, record seconds,
    instantiate seconds)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        replay, out, rec_s = record(step, graph, modules)
    t2 = time.perf_counter()
    torch.cuda.current_stream(device).wait_stream(side)
    return replay, out, rec_s, t2 - t0 - rec_s


class StepGraph:
    """``step`` run eagerly on the first call, captured as a CUDA graph on
    the second and replayed from then on; with ``enabled`` False (the CPU,
    or a check's plain versions) every call runs it eagerly. ``step`` reads
    and writes buffers at fixed addresses (the solve's own), so a replay
    computes what a call would; its return value is the recording's. The
    seconds of the recording and instantiation are kept."""

    def __init__(self, step, device, modules, enabled: bool):
        self.step, self.device, self.modules, self.enabled = step, device, modules, enabled
        self.calls, self.replay, self.out = 0, None, None
        self.record_s = self.instantiate_s = 0.0

    def __call__(self):
        if self.enabled and self.calls == 1:
            self.replay, self.out, self.record_s, self.instantiate_s = capture(
                self.step, self.device, self.modules)
        self.calls += 1
        if self.replay is None:
            return self.step()
        self.replay()
        return self.out
