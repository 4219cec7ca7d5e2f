"""Cross-level value alignment for the windowed (fast) encoder (counterpart
of the alignment half of ``class_query_vad_tpu/ops/fast_deform.py``).

Every value level is resampled onto each query grid with the dyadic
half-pixel bilinear up / pairwise-mean down cascade, composed into ONE
[n_out, n_in] matrix per axis and applied as a plain matmul.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] matrix composing the dyadic up2/down2 cascade.  Rows
    sum to 1.  Built in float64, stored float32."""
    if not (n_in % n_out == 0 or n_out % n_in == 0):
        raise ValueError(f"non power-of-two ratio {n_in}->{n_out}")
    m = np.eye(n_in, dtype=np.float64)
    size = n_in
    while size < n_out:
        idx = np.arange(size)
        u = np.zeros((2 * size, size))
        u[2 * idx, idx] += 0.75
        u[2 * idx, np.maximum(idx - 1, 0)] += 0.25
        u[2 * idx + 1, idx] += 0.75
        u[2 * idx + 1, np.minimum(idx + 1, size - 1)] += 0.25
        m = u @ m
        size *= 2
    while size > n_out:
        idx = np.arange(size // 2)
        d = np.zeros((size // 2, size))
        d[idx, 2 * idx] = 0.5
        d[idx, 2 * idx + 1] = 0.5
        m = d @ m
        size //= 2
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrix_on(n_in: int, n_out: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """``_resize_matrix`` as a tensor, copied to ``device`` once: a copy
    from pageable host memory waits for the stream, so a fresh copy per
    call would stall the forward ~24 times per encoder layer.  Made outside
    inference mode, so that a matrix first cached while serving can later
    enter autograd in training."""
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device=device,
                                                               dtype=dtype)


def _resize_axis(feat: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    mm = _resize_matrix_on(feat.shape[axis], n_out, feat.device, feat.dtype)
    return torch.tensordot(mm, feat, dims=([1], [axis])).movedim(0, axis)


def align_level(feat: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resample [B, T, H, W, ...] to [B, T, h, w, ...] with one composed
    matmul per axis (shrinking axis first, growing axis last)."""
    h, w = out_hw
    hi, wi = feat.shape[2], feat.shape[3]
    if hi == h and wi == w:
        return feat
    if h * wi <= hi * w:
        order = ((2, hi, h), (3, wi, w))
    else:
        order = ((3, wi, w), (2, hi, h))
    for axis, n_in, n_out in order:
        if n_in != n_out:
            feat = _resize_axis(feat, n_out, axis)
    return feat


def align_all_levels(
    values: Sequence[torch.Tensor],          # per level [B, T, Hl, Wl, ...]
    grids: Sequence[Tuple[int, int]],        # target (H, W) per query grid
) -> List[List[torch.Tensor]]:
    """aligned[i][j] = value level j resampled onto query grid i."""
    return [[align_level(v, tuple(hw)) for v in values] for hw in grids]
