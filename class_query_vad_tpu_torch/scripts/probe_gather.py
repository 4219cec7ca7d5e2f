"""Gather options for the exact encoder's sampler, and K14 (the repo
root's ``scripts/probe_gather.py`` on the port).

    python -m class_query_vad_tpu_torch.scripts.probe_gather \\
        [xla|kernel|all] [--rows S] [--indices G] [--iters 20] \\
        [--device cuda|cpu]

At the exact encoder's level 0 (S = 40960 = 8x64x80 rows of one head's
depth D = 32; G = 435,200 = 54,400 queries x 8 points, uniform random
indices from a seed), one JSON line per measurement, each with the
card's name and power limit:

* ``xla``, the JAX script's library rows as PyTorch calls:
  ``torch.index_select`` of G rows at D = 32, 128 and 256 in float32 and
  bf16 (ms, Mrows/s, GB/s of output); the blocked (2,2,2,32) corner
  gather over a [10, 66, 82, 32] float32 volume in the port's form, the
  exact sampler's ``F.embedding_bag`` over each point's 8 corner rows with
  per-sample weights (``ops/deform_attn.py``; ms, Mslices/s); and
  ``torch.gather`` on the index expanded to [G, D], D = 32, both dtypes.
* ``kernel``, the JAX script's Pallas row: K14 (``ops.row_gather``) on the
  bf16 table, ``exact`` (bit for bit against ``index_select``), its bound
  (the bytes that must cross HBM once, table + indices + output, at 3.35
  TB/s) and its share of it, beside ``index_select`` at the same shape.
  On the CPU ``row_gather`` is its plain version, and no bound is given.

Each time is the mean of ``--iters`` calls after one warm-up call
(``utils.profiling.timed_call``, synchronized: on the card a host clock
around launches and a synchronize, so it holds each call's host
overhead).  Runs on the card (raises without one) unless ``--device
cpu``; ``main`` returns the records.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.row_gather import row_gather
from ..utils.profiling import timed_call
from .timing import add_device_arg, card, device, emit

S, D, G = 40960, 32, 435_200       # level 0: 8*64*80 rows; 54400 queries x 8
VOL = (10, 66, 82, 32)             # the JAX script's blocked-gather volume
WIDTHS = (32, 128, 256)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA's data sheet)


def corner_rows(rng, g: int):
    """Each of ``g`` points' 8 corner rows in the flattened ``VOL`` (origin
    t < 8, y < 64, x < 80, as the JAX script draws them) in (dt, dy, dx)
    order, int64 [g, 8]."""
    t0, y0, x0 = (rng.integers(0, n, g) for n in (8, 64, 80))
    _, h, w, _ = VOL
    offs = np.array([(dt * h + dy) * w + dx for dt in (0, 1) for dy in (0, 1)
                     for dx in (0, 1)])
    return ((t0 * h + y0) * w + x0)[:, None] + offs[None, :]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", choices=("xla", "kernel", "all"),
                    default="all")
    ap.add_argument("--rows", type=int, default=S)
    ap.add_argument("--indices", type=int, default=G)
    ap.add_argument("--iters", type=int, default=20)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    s, g, iters = args.rows, args.indices, args.iters
    where = card(dev)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, s, g).astype(np.int32)).to(dev)
    rec = []

    def put(what, fn, *fargs, out_bytes, **extra):
        sec = timed_call(fn, *fargs, iters=iters)
        rec.append(emit({"probe": what, "ms": 1e3 * sec,
                         "mrows_per_s": g / sec / 1e6,
                         "gb_per_s": out_bytes / sec / 1e9, **extra,
                         "S": s, "G": g, "card": where}))
        return sec

    def name(dt):
        return str(dt).removeprefix("torch.")

    if args.which in ("all", "xla"):
        tables = {}
        for d in WIDTHS:
            for dt in (torch.float32, torch.bfloat16):
                v = torch.from_numpy(rng.normal(size=(s, d)).astype(
                    np.float32)).to(dev, dt)
                tables[d, dt] = v
                put("index_select", torch.index_select, v, 0, idx,
                    out_bytes=g * d * v.element_size(), D=d, dtype=name(dt))
        vol = torch.from_numpy(rng.normal(size=VOL).astype(np.float32)).to(dev)
        flat = vol.reshape(-1, VOL[-1])
        bags = torch.from_numpy(corner_rows(rng, g)).to(dev)
        weights = torch.from_numpy(rng.uniform(size=(g, 8)).astype(
            np.float32)).to(dev)
        sec = timed_call(lambda: F.embedding_bag(
            bags, flat, mode="sum", per_sample_weights=weights), iters=iters)
        rec.append(emit({"probe": "blocked (2,2,2,32) as embedding_bag",
                         "ms": 1e3 * sec, "mslices_per_s": g / sec / 1e6,
                         "G": g, "card": where}))
        wide = idx.long()[:, None].expand(g, D)
        for dt in (torch.float32, torch.bfloat16):
            v = tables[D, dt]
            put("gather", torch.gather, v, 0, wide,
                out_bytes=g * D * v.element_size(), D=D, dtype=name(dt))

    if args.which in ("all", "kernel"):
        tab = torch.from_numpy(rng.normal(size=(s, D)).astype(np.float32)).to(
            dev, torch.bfloat16)
        exact = torch.equal(row_gather(tab, idx).view(torch.int16),
                            torch.index_select(tab, 0, idx).view(torch.int16))
        nbytes = tab.numel() * 2 + idx.numel() * 4 + g * D * 2
        lib = timed_call(torch.index_select, tab, 0, idx, iters=iters)
        extra = {"exact": exact, "index_select_ms": 1e3 * lib,
                 "bytes": nbytes}
        if dev.type == "cuda":
            bound = nbytes / HBM_BYTES_PER_S
            extra.update(bound_ms=1e3 * bound)
        sec = put("K14 row_gather", row_gather, tab, idx, out_bytes=g * D * 2,
                  D=D, dtype="bfloat16", **extra)
        if dev.type == "cuda":
            rec[-1]["share_of_bound"] = bound / sec
            print(f"K14 {1e3 * sec:.4f} ms, bound {1e3 * bound:.4f} ms "
                  f"({bound / sec:.1%}), index_select {1e3 * lib:.4f} ms, "
                  f"exact={exact}", flush=True)
    return rec


if __name__ == "__main__":
    main()
