"""Device times of this checkout's K3 and K4 (the 2d blend's d vol and d
components, the main path's train-step backward) against another
checkout's, in turns on one card, at the shapes ``chip_smoke.py`` times.

    python -m class_query_vad_tpu_torch.scripts.compare_k3_k4 --against DIR [--all-blocks]

Run from this checkout's root.  DIR is the root of another checkout (a
parent commit unpacked with ``git archive``, say).  Both checkouts'
``csrc/blend2d_bwd_dvol.cu`` and ``csrc/blend2d_bwd_dcomps.cu`` are built
with this checkout's nvcc flags and called through their own C launchers
(each checkout's ``cuda_build.KERNELS`` gives the argument types: the
tiled launchers take a block shape, ``ops/blend2d.py`` ``k3_block`` /
``k4_block``, where the earlier, warp-per-output launchers took none) on
the same inputs, in the order other, this, this, other
(``compare_k5_k11.compare``).  bf16, B=1, T=2 over the main path's four
query grids, offsets on exact ties included (``chip_smoke.blend_inputs``);
sums per encoder layer (one launch per grid).  ``--all-blocks`` also times
this checkout's kernels at every other block shape their launchers take
(``K3_SHAPES``, ``K4_SHAPES``), each beside the other checkout's kernel
once more.  Prints the card's name and
power limit, one line per shape, and one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

import chip_smoke

from ..ops.blend2d import K3_SHAPES, K4_SHAPES, k3_block, k4_block
from .compare_k5_k11 import compare

SOURCES = ("blend2d_bwd_dvol", "blend2d_bwd_dcomps")


def with_block(fn, args, shape):
    """``args`` (before the stream) for ``fn``'s signature: then the block
    shape (tile rows, tile columns, heads), if ``fn`` takes it."""
    extra = len(fn.argtypes) - 1 - len(args)
    return args + list(shape)[:extra]


def cases(built, dev, keep, blocks=None):
    """(tag, kernel, {who: launcher arguments}, (per-layer total, 1)).
    ``blocks``: {kernel: [shape, ...]} to time this checkout's kernels at
    other block shapes than ``k3_block`` / ``k4_block`` pick (tagged, and
    left out of the totals)."""
    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, t = chip_smoke.TRAIN_B, chip_smoke.K1_T
    for h, w in chip_smoke.K1_LEVELS:
        (vol, dx, dy, a), g = chip_smoke.blend_inputs(rng, b, h, w, torch.bfloat16, dev)
        dvol = torch.empty_like(vol)
        outs = [torch.empty_like(dx) for _ in range(3)]
        keep += [vol, dx, dy, a, g, dvol, *outs]
        ints = [1, b, vol.shape[1], t, h, w, dx.shape[-1] // 8]
        for k, name, ptrs, pick in (
                ("K3", "blend2d_bwd_dvol", (dx, dy, a, g, dvol), k3_block),
                ("K4", "blend2d_bwd_dcomps", (vol, dx, dy, a, g, *outs), k4_block)):
            args = [x.data_ptr() for x in ptrs] + ints
            chosen = pick(b, t, h, w, sms)
            yield (f"{k} B={b} T={t} {h}x{w}", name,
                   {who: with_block(built[who][name], args, chosen) for who in built},
                   (f"{k} per encoder layer", 1))
            for shape in (blocks or {}).get(name, ()):
                if shape == chosen:
                    continue
                yield (f"{k} B={b} T={t} {h}x{w} block {shape}", name,
                       {"this": with_block(built["this"][name], args, shape),
                        "other": with_block(built["other"][name], args, chosen)},
                       (None, 1))


def main() -> dict:
    make = cases
    if "--all-blocks" in sys.argv:
        sys.argv.remove("--all-blocks")
        make = functools.partial(cases, blocks={"blend2d_bwd_dvol": K3_SHAPES,
                                                "blend2d_bwd_dcomps": K4_SHAPES})
    return compare(__doc__, SOURCES, make)


if __name__ == "__main__":
    main()
