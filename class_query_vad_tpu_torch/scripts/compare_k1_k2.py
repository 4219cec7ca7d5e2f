"""Device times of this checkout's K1 and K2 (the 2d blend's forward: from
the fused head lanes, and from components) against another checkout's,
in turns on one card, at the shapes ``chip_smoke.py`` times.

    python -m class_query_vad_tpu_torch.scripts.compare_k1_k2 --against DIR [--all-blocks]

Run from this checkout's root.  DIR is the root of another checkout (a
parent commit unpacked with ``git archive``, say).  Both checkouts'
``csrc/fused_blend2d.cu`` and ``csrc/blend2d.cu`` are built with this
checkout's nvcc flags and called through their own C launchers (each
checkout's ``cuda_build.KERNELS`` gives the argument types: the tiled
launchers take a block shape, ``ops/blend2d.py`` ``fwd_block``, where
the earlier, warp-per-query launchers took none) on
the same inputs, in the order other, this, this, other
(``compare_k5_k11.compare``).  bf16 over the main path's four query grids:
K1 at the eval batch (B=2, T=2, raw head lanes, ``chip_smoke.k1_inputs``),
K2 at the train batch (B=1, T=2) with P = 8 and with P = 4, the
components route's points per head (offsets on exact ties included,
``chip_smoke.blend_inputs``); sums per encoder layer (one launch per
grid).  ``--all-blocks`` also times this checkout's kernels at every other
block shape their launchers take (``FWD_SHAPES``), each beside the other
checkout's kernel once more.  Prints the card's name and
power limit, one line per shape, and one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

import chip_smoke

from ..ops.blend2d import FWD_SHAPES, fwd_block
from .compare_k3_k4 import with_block
from .compare_k5_k11 import compare

SOURCES = ("fused_blend2d", "blend2d")
K2_POINTS = (8, 4)


def cases(built, dev, keep, blocks=None):
    """(tag, kernel, {who: launcher arguments}, (per-layer total, 1)).
    ``blocks``: {kernel: [shape, ...]} to time this checkout's kernels at
    other block shapes than ``fwd_block`` picks (tagged, and left out of
    the totals)."""
    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t = chip_smoke.K1_T
    runs = [("K1", "fused_blend2d", chip_smoke.K1_B, None)]
    runs += [("K2" if p == 8 else f"K2 P={p}", "blend2d", chip_smoke.TRAIN_B, p)
             for p in K2_POINTS]
    for k, name, b, points in runs:
        for h, w in chip_smoke.K1_LEVELS:
            out = torch.empty((b, t, h, w, chip_smoke.K1_C), dtype=torch.float32,
                              device=dev)
            if points is None:
                vol, fused = chip_smoke.k1_inputs(rng, b, h, w, torch.bfloat16, dev)
                keep += [vol, fused, out]
                args = [vol.data_ptr(), fused.data_ptr(), out.data_ptr(), 1, b,
                        chip_smoke.K1_J, t, h, w, 1.0]
            else:
                (vol, dx, dy, a), _ = chip_smoke.blend_inputs(
                    rng, b, h, w, torch.bfloat16, dev, points=points)
                keep += [vol, dx, dy, a, out]
                args = [x.data_ptr() for x in (vol, dx, dy, a, out)] + [
                    1, b, chip_smoke.K1_J, t, h, w, points]
            chosen = fwd_block(b, t, h, w, sms)
            tag = f"{k} B={b} T={t} {h}x{w}"
            yield (tag, name,
                   {who: with_block(built[who][name], args, chosen) for who in built},
                   (f"{k} per encoder layer", 1))
            for shape in (blocks or {}).get(name, ()):
                if shape == chosen:
                    continue
                yield (f"{tag} block {shape}", name,
                       {"this": with_block(built["this"][name], args, shape),
                        "other": with_block(built["other"][name], args, chosen)},
                       (None, 1))


def main() -> dict:
    make = cases
    if "--all-blocks" in sys.argv:
        sys.argv.remove("--all-blocks")
        make = functools.partial(cases, blocks=dict.fromkeys(SOURCES, FWD_SHAPES))
    return compare(__doc__, SOURCES, make)


if __name__ == "__main__":
    main()
