"""Device times of this checkout's K6 (the 3d resample blend, which also
serves K7) and K8 (its d vol) against another checkout's, in turns on one
card, at the shapes ``chip_smoke.py`` times.

    python -m class_query_vad_tpu_torch.scripts.compare_k6_k8 --against DIR

Run from this checkout's root.  DIR is the root of another checkout (a
parent commit unpacked with ``git archive``, say).  Both checkouts'
``csrc/blend3d.cu`` and ``csrc/blend3d_bwd_dvol.cu`` are built with this
checkout's nvcc flags and called through their own C launchers (each
checkout's ``cuda_build.KERNELS`` gives the argument types: K6's launcher
takes the tile side and the frames per block, ``ops/blend3d.py``
``BLEND3D_TILE`` and ``k6_frames_per_block``, and K8's the tile side,
where the earlier, warp-per-query launchers take neither) on the same
inputs, in the order other, this, this, other (CUDA events
around launches queued behind a device sleep,
``chip_smoke.kernel_device_ms``).  bf16, T=8, offsets on exact ties
included (``chip_smoke.blend_inputs``): K6 at B=2 over the resample
mode's four query grids and at K7's 128x160 grid (B=1), K8 at B=1 over
the four grids; sums per encoder layer (one launch per grid).  Prints the
card's name and power limit, one line per shape, and one JSON object.
Needs a CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

import chip_smoke

from ..ops.blend3d import BLEND3D_TILE, k6_frames_per_block
from .compare_k5_k11 import compare

SOURCES = ("blend3d", "blend3d_bwd_dvol")


def with_tile(fn, args, frames):
    """``args`` (before the stream) for ``fn``'s signature: then the tile
    side and K6's frames per block, as far as ``fn`` takes them."""
    extra = len(fn.argtypes) - 1 - len(args)
    return args + [BLEND3D_TILE, frames][:extra]


def cases(built, dev, keep):
    """(tag, kernel, {who: launcher arguments}, (per-layer total or None,
    1))."""
    rng = np.random.default_rng(15)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grids = [("K6", 2, hw) for hw in chip_smoke.K1_LEVELS]
    grids.append(("K7 regime", 1, chip_smoke.B3_K7_GRID))
    grids += [("K8", chip_smoke.TRAIN_B, hw) for hw in chip_smoke.K1_LEVELS]
    for k, b, (h, w) in grids:
        (vol, dx, dy, dt, a), g = chip_smoke.blend_inputs(
            rng, b, h, w, torch.bfloat16, dev, nc=3, t=chip_smoke.B3_T)
        jl, kp = vol.shape[1], dx.shape[-1]
        comps = [x.data_ptr() for x in (dx, dy, dt, a)]
        ints = [1, b, jl, chip_smoke.B3_T, h, w, kp // 8]
        if k == "K8":
            name = "blend3d_bwd_dvol"
            out = torch.empty_like(vol)
            args = comps + [g.data_ptr(), out.data_ptr()] + ints
        else:
            name = "blend3d"
            out = torch.empty((b, chip_smoke.B3_T, h, w, vol.shape[-1]),
                              dtype=torch.float32, device=dev)
            args = [vol.data_ptr()] + comps + [out.data_ptr()] + ints
        keep += [vol, dx, dy, dt, a, g, out]
        total = None if k == "K7 regime" else f"{k} per encoder layer"
        frames = k6_frames_per_block(b, chip_smoke.B3_T, h, w, sms)
        yield (f"{k} B={b} T={chip_smoke.B3_T} {h}x{w}", name,
               {who: with_tile(built[who][name], args, frames) for who in built},
               (total, 1))


def main() -> dict:
    return compare(__doc__, SOURCES, cases)


if __name__ == "__main__":
    main()
