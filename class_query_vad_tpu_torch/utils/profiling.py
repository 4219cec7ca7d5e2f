"""Tracing and timing (counterpart of the JAX package's
``utils/profiling.py``): ``torch.profiler`` traces in place of
``jax.profiler``'s, and timed calls that synchronize the card."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU activity and, with a card,
    CUDA activity (kernel rows); the Chrome trace is written to
    ``log_dir/trace_<time>_rank<rank>.json`` (view it in Perfetto or
    ``chrome://tracing``).  Yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    from ..parallel import rank

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_rank{rank()}.json"))


def timed_call(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call of ``fn(*args)``: the card is synchronized
    before and after the timed window, so queued work is inside it."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters
