"""Cross-level value access for the windowed (fast) encoder (counterpart
of ``class_query_vad_tpu/ops/fast_deform.py``: the alignment and the
native-resolution blend).

``FAST_CROSS_LEVEL: resample``: every value level is resampled onto each
query grid with the dyadic half-pixel bilinear up / pairwise-mean down
cascade, composed into ONE [n_out, n_in] matrix per axis and applied as a
plain matmul.

``FAST_CROSS_LEVEL: native``: every level is sampled at its own resolution
(``native_blend_level``, the plain version of kernels K10 and K11, whose
wrapper is ``ops.native_blend``).

``FAST_RADIUS`` > 1 (resample mode): ``windowed_blend_fused``, the JAX
package's general-radius blend, which has no Pallas kernel there and is
plain PyTorch here.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .blend2d import hat, hat_grad


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


def native_phase(n_q: int, n_v: int) -> Tuple[np.ndarray, np.ndarray]:
    """Base cell and fractional phase mapping query index q of an n_q grid
    onto an n_v value grid, p0(q) = (q + 0.5) * (n_v / n_q) - 0.5 (the
    reference sampler's align_corners=False map): (base [n_q] int64, phi
    [n_q] float32) with p0 = base + phi, phi in [0, 1).  Built in float64,
    phi stored float32, as the JAX package does."""
    p0 = (np.arange(n_q) + 0.5) * (n_v / n_q) - 0.5
    base = np.floor(p0).astype(np.int64)
    return base, (p0 - base).astype(np.float32)


@functools.lru_cache(maxsize=None)
def native_tables_on(hq: int, wq: int, vshapes: Tuple[Tuple[int, int], ...],
                     device: torch.device):
    """``native_phase`` for a (hq, wq) query grid over value levels of
    (Hv, Wv) ``vshapes``, copied to ``device`` once (as
    ``_resize_matrix_on``): base int32 [J, 2 + hq + wq], each row (Hv, Wv,
    base_y..., base_x...), and phi float32 [J, hq + wq], each row
    (phi_y..., phi_x...).  The plain version and the kernels read the same
    tables."""
    bases, phis = [], []
    for hv, wv in vshapes:
        by, py = native_phase(hq, hv)
        bx, px = native_phase(wq, wv)
        bases.append(np.concatenate([[hv, wv], by, bx]).astype(np.int32))
        phis.append(np.concatenate([py, px]))
    with torch.inference_mode(False):
        return (torch.from_numpy(np.stack(bases)).to(device),
                torch.from_numpy(np.stack(phis)).to(device))


class _Hat(torch.autograd.Function):
    """``hat`` differentiated by XLA's rules (``blend2d.hat_grad``), so that
    autograd through the plain native blend gives the JAX package's
    gradient at the ties (offsets on 0 or +-1), which bf16 hits often."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return hat(u)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return g * hat_grad(u)


def windowed_blend_fused(aligned: Sequence[torch.Tensor],
                         offsets: torch.Tensor, weights: torch.Tensor,
                         radius: int) -> torch.Tensor:
    """The general-radius windowed blend (the JAX package's
    ``windowed_blend_fused``, fast_deform.py:186):

        out[g] = sum_j sum_s m[g, j, s] * aligned[j][g + s]
        m[g, j, s] = sum_p a * hat(dt - st) * hat(dy - sy) * hat(dx - sx)

    over the (2R+1)^3 shifts s = (st, sy, sx) in [-R, R], zeros outside the
    map, each shift's mass recomputed from the [..., nh*P] lanes.
    ``aligned``: per level [B, T, H, W, nh, D]; ``offsets`` [B, T, H, W, nh,
    L, P, 3] (x, y, t) or [..., 2] (x, y: the 2d window, which JAX writes as
    dt = 0, so that only the centre frame's shift has mass; the other
    frames' shifts add exact zeros and are skipped); ``weights`` [B, T, H,
    W, nh, L, P].  Computed in the dtype of ``aligned``, as JAX does; the
    hats are differentiated by XLA's rules at the ties (``_Hat``).  Any
    device; returns [B, T, H, W, nh, D]."""
    b, t, h, w, nh, d = aligned[0].shape
    p = weights.shape[-1]
    r = int(radius)
    win = 2 * r + 1
    nc = offsets.shape[-1]
    out = torch.zeros((b, t, h, w, nh, d), dtype=aligned[0].dtype,
                      device=aligned[0].device)
    rt = r if nc == 3 else 0
    for j, vol in enumerate(aligned):
        vp = F.pad(vol, (0, 0, 0, 0, r, r, r, r, rt, rt))
        dx = offsets[..., j, :, 0].reshape(b, t, h, w, nh * p)
        dy = offsets[..., j, :, 1].reshape(b, t, h, w, nh * p)
        a = weights[..., j, :].reshape(b, t, h, w, nh * p)
        if nc == 3:
            dt = offsets[..., j, :, 2].reshape(b, t, h, w, nh * p)
            t_shifts = [(st, _Hat.apply(dt - (st - r))) for st in range(win)]
        else:
            t_shifts = [(0, None)]
        for st, ht in t_shifts:
            for sy in range(win):
                hy = _Hat.apply(dy - (sy - r))
                aty = a * hy if ht is None else a * ht * hy
                for sx in range(win):
                    hx = _Hat.apply(dx - (sx - r))
                    m = (aty * hx).reshape(b, t, h, w, nh, p).sum(-1)
                    out = out + m[..., None] * vp[
                        :, st:st + t, sy:sy + h, sx:sx + w]
    return out


def native_blend_level(vol: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                       a: torch.Tensor, nh: int,
                       dt: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-resolution windowed blend of one value level (the JAX
    package's ``native_blend_level``, fast_deform.py:245): every query of
    the (Hq, Wq) grid samples ``vol`` [B, T, Hv, Wv, C] at its mapped
    position (``native_phase``) plus the offsets dx, dy [B, T, Hq, Wq,
    nh*P] in native pixels (|d| < 1), weighted by a, with zeros outside the
    level: 4 taps per axis at base + {-1, 0, 1, 2}.  ``dt`` (frames, |dt| <
    1) adds 3 temporal taps {-1, 0, +1} over zero frames outside [0, T),
    with temporal phase 0 (the levels share the query's T); without it each
    query reads its own frame.  Accumulates in float32 and returns float32
    [B, T, Hq, Wq, C].  Any device."""
    b, t, hv, wv, c = vol.shape
    hq, wq = dx.shape[2], dx.shape[3]
    d = c // nh
    base, phi = native_tables_on(hq, wq, ((hv, wv),), vol.device)
    base_y, base_x = base[0, 2:2 + hq], base[0, 2 + hq:]
    phi_y, phi_x = phi[0, :hq], phi[0, hq:]

    vp = F.pad(vol, (0, 0, 2, 2, 2, 2)).float()
    dxf = dx.float() + phi_x[None, None, None, :, None]
    dyf = dy.float() + phi_y[None, None, :, None, None]
    af = a.float()
    if dt is None:
        t_taps = [(None, None)]
    else:
        vp_t = F.pad(vp, (0, 0, 0, 0, 0, 0, 1, 1))
        dtf = dt.float()
        t_taps = [(st, _Hat.apply(dtf - st)) for st in (-1, 0, 1)]

    out = torch.zeros((b, t, hq, wq, nh, d), dtype=torch.float32,
                      device=vol.device)
    for st, ht in t_taps:
        vt = vp if st is None else vp_t[:, st + 1:st + 1 + t]
        at = af if st is None else af * ht
        for sy in range(-1, 3):
            vy = vt.index_select(2, base_y + (sy + 2))
            ay = at * _Hat.apply(dyf - sy)
            for sx in range(-1, 3):
                vxy = vy.index_select(3, base_x + (sx + 2))
                m = (ay * _Hat.apply(dxf - sx)).reshape(
                    b, t, hq, wq, nh, -1).sum(-1)
                out = out + m[..., None] * vxy.reshape(b, t, hq, wq, nh, d)
    return out.reshape(b, t, hq, wq, c)
