"""Run functions on several local CPU ranks over gloo, each rank its own
``python -m`` process, as ``torchrun`` would start it (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):

    ranks = start_ranks(2, [("pkg.module:function", {"arg": value}), ...])
    ...                        # the caller's own work meanwhile
    results = ranks.join()

Each rank joins the group (``initialize_distributed(device="cpu")``),
calls the jobs in order with ``**kwargs`` and writes their return values
with ``torch.save``; ``join`` returns ``results[rank][job]``.  The
arguments and results travel through ``torch.save`` files, so tensors,
numpy arrays and config dumps pass as they are.  The children import
only what the jobs' modules import.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
from typing import Any, List, Sequence, Tuple

import torch

from .mesh import destroy, free_port, initialize_distributed, rank


class Ranks:
    """``world`` CPU rank processes running ``jobs`` (``start_ranks``);
    ``join()`` waits for them and returns ``results[rank][job]``, raising
    with a rank's output if one failed."""

    def __init__(self, world: int, jobs: Sequence[Tuple[str, dict]],
                 threads: int = 1, timeout: float = 600.0):
        self.timeout = timeout
        self._tmp = tempfile.TemporaryDirectory(prefix="cqvad_ranks_")
        tmp = self._tmp.name
        torch.save(list(jobs), os.path.join(tmp, "jobs.pt"))
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "class_query_vad_tpu_torch.parallel.launch",
             tmp], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]

    def join(self) -> List[List[Any]]:
        try:
            outs = [p.communicate(timeout=self.timeout) for p in self.procs]
            for r, (p, (out, err)) in enumerate(zip(self.procs, outs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                       f"{out[-2000:]}\n{err[-6000:]}")
            return [torch.load(os.path.join(self._tmp.name, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(len(self.procs))]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self._tmp.cleanup()


def start_ranks(world: int, jobs: Sequence[Tuple[str, dict]],
                threads: int = 1, timeout: float = 600.0) -> Ranks:
    """Start ``jobs`` on ``world`` CPU ranks; the caller may work while
    they run, then ``join()``."""
    return Ranks(world, jobs, threads, timeout)


def _main(tmp: str) -> None:
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    jobs = torch.load(os.path.join(tmp, "jobs.pt"), weights_only=False)
    initialize_distributed(device="cpu")
    results = []
    for target, kwargs in jobs:
        mod, name = target.split(":")
        results.append(getattr(importlib.import_module(mod), name)(**kwargs))
    torch.save(results, os.path.join(tmp, f"rank{rank()}.pt"))
    destroy()


if __name__ == "__main__":
    _main(sys.argv[1])
