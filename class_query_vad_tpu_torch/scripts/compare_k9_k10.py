"""Device times of this checkout's K9 (the 3d resample blend's d
components), K10 and K11 (the native blend, 2d and 3d windows) against
another checkout's, in turns on one card, at the shapes ``chip_smoke.py``
times.

    python -m class_query_vad_tpu_torch.scripts.compare_k9_k10 --against DIR

Run from this checkout's root.  DIR is the root of another checkout (a
parent commit unpacked with ``git archive``, say).  Both checkouts'
``csrc/blend3d_bwd_dcomps.cu`` and ``csrc/native_blend.cu`` are built with
this checkout's nvcc flags and called through their own C launchers (each
checkout's ``cuda_build.KERNELS`` gives the argument types: K9's launcher
takes the tile side and the frames per block, ``ops/blend3d.py``
``BLEND3D_TILE`` and ``k9_frames_per_block``, where the warp-per-query
launcher took neither) on the same inputs, in the order other, this, this,
other (``compare_k5_k11.compare``).  bf16: K9 at B=1, T=8 over the
resample mode's four query grids, offsets on exact ties included
(``chip_smoke.blend_inputs``); K10 (T=2) and K11 (T=8) at B=2 over the
native mode's four query grids; sums per encoder layer (one launch per
grid).  Prints the card's name and power limit, one line per shape, and
one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

import chip_smoke

from ..ops.blend3d import k9_frames_per_block
from .compare_k5_k11 import compare, native_args
from .compare_k6_k8 import with_tile

SOURCES = ("blend3d_bwd_dcomps", "native_blend2d", "native_blend3d")


def cases(built, dev, keep):
    """(tag, kernel, {who: launcher arguments}, (per-layer total, 1))."""
    rng = np.random.default_rng(15)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, t = chip_smoke.TRAIN_B, chip_smoke.B3_T
    for h, w in chip_smoke.K1_LEVELS:
        (vol, dx, dy, dt, a), g = chip_smoke.blend_inputs(
            rng, b, h, w, torch.bfloat16, dev, nc=3, t=t)
        outs = [torch.empty_like(dx) for _ in range(4)]
        keep += [vol, dx, dy, dt, a, g, *outs]
        args = ([x.data_ptr() for x in (vol, dx, dy, dt, a, g, *outs)]
                + [1, b, vol.shape[1], t, h, w, dx.shape[-1] // 8])
        frames = k9_frames_per_block(b, t, h, w, sms)
        name = "blend3d_bwd_dcomps"
        yield (f"K9 B={b} T={t} {h}x{w}", name,
               {who: with_tile(built[who][name], args, frames) for who in built},
               ("K9 per encoder layer", 1))
    for k, name, nc in (("K10", "native_blend2d", 2), ("K11", "native_blend3d", 3)):
        t = chip_smoke.NATIVE_T[k]
        for grid in chip_smoke.NATIVE_GRIDS:
            args = native_args(grid, t, nc, dev, keep)
            yield (f"{k} T={t} {grid[0]}x{grid[1]}", name,
                   {who: args for who in built}, (f"{k} per encoder layer", 1))


def main() -> dict:
    return compare(__doc__, SOURCES, cases)


if __name__ == "__main__":
    main()
