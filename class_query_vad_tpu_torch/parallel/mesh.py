"""Process groups: one process per GPU (or per CPU rank) under
``torch.distributed`` (counterpart of ``class_query_vad_tpu/parallel/mesh.py``).

The JAX package runs one process per host over a ``jax.sharding`` mesh
whose gradient psum XLA inserts.  Here every rank is a process with one
device: the batch is split by the loaders (``host_id=rank``,
``num_hosts=world``), ``engine.Trainer`` wraps the model in
``DistributedDataParallel`` with a summing comm hook, the criterion's
normalizers and CSN's train-mode batch statistics are all-reduced, so
one step over the ranks is the JAX package's step on the concatenated
batch.

Environment (as ``torchrun`` sets it), against the JAX package's:

* ``WORLD_SIZE`` -- ``NUM_PROCESSES``;
* ``RANK`` -- ``PROCESS_ID``;
* ``MASTER_ADDR`` / ``MASTER_PORT`` -- ``COORDINATOR_ADDRESS`` (host:port);
* ``LOCAL_RANK`` -- which GPU of the host the rank drives (JAX has no
  counterpart: a process there owns all of its host's chips).

NCCL runs the collectives between GPUs, gloo between CPU ranks (the
tests, ``--device cpu``).
"""

from __future__ import annotations

import os
import socket
from typing import Any, List, Optional

import torch
import torch.distributed as dist


def initialize_distributed(device: str = "cuda", rank: Optional[int] = None,
                           world: Optional[int] = None,
                           init_method: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank`` / ``world`` default to ``RANK`` / ``WORLD_SIZE``; with
    neither given nor set this is a single process and nothing is
    initialized.  ``init_method`` defaults to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``).  A CUDA rank drives ``cuda:LOCAL_RANK`` over NCCL;
    with no card it raises, it never falls back to the CPU.  A CPU rank
    (``device="cpu"``) uses gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device is available; pass "
            f"--device cpu to run the plain PyTorch path on the CPU")
    if world is None and "WORLD_SIZE" not in os.environ:
        return dev
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ["WORLD_SIZE"]) if world is None else int(world)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://", rank=rank, world_size=world,
            device_id=dev if dev.type == "cuda" else None)
    return dev


def is_distributed() -> bool:
    """Whether a process group is up (at any world size)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def sync_hosts() -> None:
    """A barrier over the ranks (the JAX package's ``sync_hosts``); a
    no-op without a process group."""
    if is_distributed():
        dist.barrier()


def process_allgather(obj: Any) -> List[Any]:
    """Every rank's ``obj`` (picklable), in rank order; ``[obj]`` without
    a process group."""
    if not is_distributed():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # d(sum over ranks)/dx_r: every rank's loss saw the sum, so x_r's
        # cotangent is the sum of the ranks' cotangents
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (its backward sums
    the ranks' cotangents); ``x`` itself without a process group."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x)


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on this host, for a local ``MASTER_PORT``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
