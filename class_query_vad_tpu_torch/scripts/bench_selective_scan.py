"""Selective-scan (K5) speed harness (the repo root's
``scripts/bench_selective_scan.py`` on the port).

    python -m class_query_vad_tpu_torch.scripts.bench_selective_scan \\
        [quick] [--lengths L ...] [--iters 20] [--device cuda|cpu]

Times the forward and the forward + backward (the gradients of u and
delta) of three implementations over the dtype x L grid the JAX script
sweeps, at the two shape families of the port's Mamba paths (VSS encoder:
B=4, KD=1024, N=4; VideoMamba backbone: B=1, KD=128, N=16), with the
softplus on, D and delta_bias given:

  K5       ``ops.selective_scan``: on the card K5's kernels, forward and
           (``SelectiveScanFn``) backward; on the CPU its plain versions
  chunked  ``selective_scan_chunked``, K5's chunked order in plain
           PyTorch, backward by autograd
  ref      ``selective_scan_reference``, the sequential plain version,
           backward by autograd; skipped past L = 1024, as the JAX script
           skips its sequential oracle

The grid is L in (64, 256, 1024, 4096) in float32 and bf16, or with
``quick`` L in (320, 1024) in bf16; ``--lengths`` replaces the L's.  Each
entry is the mean of ``--iters`` calls after one warm-up call
(``utils.profiling.timed_call``, synchronized).  Prints the JAX script's
table and one JSON line per row, with the card's name and power limit.
Runs on the card (raises without one) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.selective_scan import (
    selective_scan,
    selective_scan_chunked,
    selective_scan_reference,
)
from ..utils.profiling import timed_call
from .timing import add_device_arg, card, device, emit

SHAPES = (("vss", 4, 1024, 4),        # (tag, B, KD, N): VSS / SS2D encoder
          ("mamba", 1, 128, 16))      # VideoMamba backbone blocks
IMPLS = {"K5": selective_scan, "chunked": selective_scan_chunked,
         "ref": selective_scan_reference}
REF_MAX_L = 1024


def make_inputs(rng, bsz: int, kd: int, n: int, length: int, dtype, dev):
    """The JAX script's inputs: u, delta, B, C in ``dtype``; A, D and
    delta_bias float32."""
    def put(x, dt=dtype):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev, dt)

    return (put(rng.normal(size=(bsz, kd, length))),
            put(0.5 * rng.uniform(size=(bsz, kd, length))),
            put(-0.5 - rng.uniform(size=(kd, n)), torch.float32),
            put(rng.normal(size=(bsz, 1, n, length))),
            put(rng.normal(size=(bsz, 1, n, length))),
            put(rng.normal(size=(kd,)), torch.float32),
            put(0.1 * rng.normal(size=(kd,)), torch.float32))


def forward(impl, args):
    with torch.no_grad():
        return impl(*args, delta_softplus=True).float().sum()


def forward_backward(impl, args):
    u, delta = (x.detach().requires_grad_() for x in args[:2])
    y = impl(u, delta, *args[2:], delta_softplus=True)
    du, _ = torch.autograd.grad(y.float().sum(), (u, delta))
    return du.float().sum()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=("quick", "full"),
                    default="full")
    ap.add_argument("--lengths", type=int, nargs="+")
    ap.add_argument("--iters", type=int, default=20)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    quick = args.mode == "quick"
    lengths = args.lengths or ((320, 1024) if quick else (64, 256, 1024, 4096))
    dtypes = (torch.bfloat16,) if quick else (torch.float32, torch.bfloat16)
    where = card(dev)
    rng = np.random.default_rng(0)
    print(f"device: {where}")
    print(f"{'shape':<26s}" + "".join(f"{k + ' fwd':>14s}{k + ' f+b':>14s}"
                                      for k in IMPLS), flush=True)
    rows = []
    for tag, bsz, kd, n in SHAPES:
        for length in lengths:
            for dtype in dtypes:
                inputs = make_inputs(rng, bsz, kd, n, length, dtype, dev)
                name = str(dtype).removeprefix("torch.")
                label = f"{tag} L={length} {name}"
                line = f"{label:<26s}"
                rec = {"shape": tag, "B": bsz, "KD": kd, "N": n, "L": length,
                       "dtype": name, "card": where}
                for impl_name, impl in IMPLS.items():
                    if impl_name == "ref" and length > REF_MAX_L:
                        line += f"{'-':>14s}{'-':>14s}"
                        continue
                    for kind, fn in (("fwd", forward),
                                     ("fb", forward_backward)):
                        ms = 1e3 * timed_call(fn, impl, inputs,
                                              iters=args.iters)
                        rec[f"{impl_name}_{kind}_ms"] = ms
                        line += f"{ms:>12.2f}ms"
                print(line, flush=True)
                rows.append(emit(rec))
    return rows


if __name__ == "__main__":
    main()
