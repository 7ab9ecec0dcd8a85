"""Multi-process plumbing on torch.distributed.

Counterpart of colmap_tpu/parallel/multihost.py. colmap_tpu joins a
``jax.distributed`` cluster and builds device meshes over it; the port joins
a ``torch.distributed`` process group instead, and has no meshes: its
sharded solve (parallel/sharded_ba.py) gives each rank one point shard and
sums the camera system with ``all_reduce``. ``global_mesh``,
``global_mesh_2d`` and sharded_ba's ``make_mesh`` and ``shard_problem`` build
JAX meshes and have no counterpart here.

Launch under torchrun with the opt-in set, one process per card:

    COLMAP_TPU_MULTIHOST=1 torchrun --nproc_per_node 4 \
        -m colmap_tpu_torch.cli.main hierarchical_mapper ...

``initialize`` then joins over NCCL (gloo on the CPU). Without a group every
function here gives the single-process answer, as colmap_tpu's do at
process_count() == 1.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# torchrun's variables; a join needs all three.
_TORCHRUN_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(init_method: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join (or form) a process group.

    With no arguments this joins only when ``COLMAP_TPU_MULTIHOST=1`` (or
    ``true``) is set and torchrun's MASTER_ADDR, WORLD_SIZE and RANK are
    present; otherwise it does nothing, so every entry point can call it.
    Launcher markers alone (SLURM_JOB_ID and the like) never make it join:
    independent commands started as tasks of one job must not form a group.
    With arguments, or once opted in, a group that fails to form raises.
    ``backend`` None takes NCCL when a card is present and gloo otherwise.
    With NCCL and torchrun's LOCAL_RANK set, the process takes that card.
    """
    if dist.is_initialized():
        return
    explicit = init_method is not None or num_processes is not None or process_id is not None
    if not explicit:
        if os.environ.get("COLMAP_TPU_MULTIHOST", "") not in ("1", "true"):
            return
        if not all(v in os.environ for v in _TORCHRUN_VARS):
            return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def local_work_slice(items: Sequence, process_id: Optional[int] = None,
                     n_processes: Optional[int] = None) -> List:
    """Strided partition of a host-side work list across processes (the
    hierarchical mapper's leaves, one slice a process): strided, not
    blocked, so clusters of unequal size balance."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if n_processes is None else n_processes
    return list(items)[pid::n]


def _collective_device(group=None) -> torch.device:
    """Where a collective's tensors live: the current card for NCCL; the
    host for gloo, which reduces host memory, so a CUDA tensor given to a
    gloo group is staged through the host and back."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(x: torch.Tensor, group=None) -> None:
    """Sum ``x`` over the group's ranks, in place (staged as
    _collective_device says)."""
    y = x.to(_collective_device(group))
    dist.all_reduce(y, group=group)
    if y is not x:
        x.copy_(y)


def all_gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """The ranks' equal-shaped ``x`` in rank order, on x's device (staged as
    _collective_device says)."""
    src = x.to(_collective_device(group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


def all_gather_bytes(payload: bytes, group=None) -> List[bytes]:
    """One byte blob from each process, ordered by process index, on every
    process: the lengths, then the blobs as uint8 tensors padded to the
    longest (colmap_tpu's ``process_allgather`` of padded arrays)."""
    if process_count(group) == 1:
        return [payload]
    lens = [int(x) for x in all_gather(torch.tensor([len(payload)], dtype=torch.int64), group)]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    return [b[:k].numpy().tobytes() for b, k in zip(all_gather(buf, group), lens)]


def all_gather_host_objects(obj, group=None) -> list:
    """Small host-side objects (any picklable value) of every process, in
    process order; [obj] without a group."""
    return [pickle.loads(b) for b in all_gather_bytes(pickle.dumps(obj), group)]
