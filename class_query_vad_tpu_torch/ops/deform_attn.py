"""3D multi-scale deformable attention sampling and the sampling-offset
bias initialisers (counterpart of ``class_query_vad_tpu/ops/deform_attn.py``).

``ms_deform_attn_3d`` is the exact encoder's sampler: trilinear sampling of
every level at unconstrained (x, y, t) locations, weighted and summed over
levels and points.  The JAX package computes it with XLA gathers (its
``_xla``, ``_blocked`` and ``_packed`` forms differ only in TPU layout) and
has no Pallas kernel for it, so plain PyTorch is its port.  One form here:
per point, the eight corners' flat row indices (int32) and weights, and
ONE ``F.embedding_bag`` (mode "sum", per-sample weights) over a row table
of the values [B * H * S, D], a bag per (query, head) holding its
L * P * 8 corners.  The weighted sum is fused: no [.., P, D] corner tensor
is built, and autograd keeps the indices and corner weights, not gathered
rows.  The corner weights are computed in the JAX package's arithmetic
(``loc * size - 0.5``, floors, the all-corners-outside drop guard), so the
floors, and the gradient's side of each, are the same on both.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# queries per sampling call in ``ms_deform_attn_3d``: at B=2, 8 heads, 4
# levels x 8 points one chunk's indices and corner weights take ~0.8 GB
QUERY_CHUNK = 16384


def _corners(loc: torch.Tensor, weights: torch.Tensor,
             shapes: Sequence[Tuple[int, int, int]], starts: torch.Tensor,
             head_rows: torch.Tensor):
    """Row indices and weights of the 8 trilinear corners of every point.

    loc [B, Q, H, L, P, 3] (x, y, t) normalised per level, weights
    [B, Q, H, L, P]; ``starts`` [L] the levels' first rows, ``head_rows``
    [B, 1, H] the first row of each (batch, head) table.  Returns (idx
    int32, cw) [B, Q, H, L * P * 8] in (level, point, dt, dy, dx) order:
    the JAX package's ``_sample_level`` (deform_attn.py:38-89), its
    clipped flat index and ``wt * wy * wx * ok * weight * in_bounds``,
    built from each coordinate's (floor, floor + 1) pair and broadcast
    over the 8 corners."""
    dev = loc.device
    size = torch.tensor([[w, h, t] for t, h, w in shapes], dtype=loc.dtype,
                        device=dev)[:, None, :]         # [L, 1, 3] (x, y, t)
    p = loc * size - 0.5                                # [B, Q, H, L, P, 3]
    p0 = torch.floor(p)
    frac = p - p0
    weights = weights * ((p > -1.0) & (p < size)).all(-1).to(weights.dtype)
    i0 = p0.to(torch.int32)
    dims = size.to(torch.int32)[..., None]              # [L, 1, 3, 1]
    pairs = torch.stack([i0, i0 + 1], -1)               # [..., 3, 2]
    ok = (pairs >= 0) & (pairs <= dims - 1)
    wts = torch.stack([1.0 - frac, frac], -1)
    (ix, iy, it), (okx, oky, okt), (wx, wy, wt) = (
        x.unbind(-2) for x in (pairs, ok, wts))         # each [..., 2]
    cw = ((wt[..., :, None, None] * wy[..., None, :, None])
          * wx[..., None, None, :])                     # [..., 2, 2, 2]
    ok = okt[..., :, None, None] & oky[..., None, :, None] & okx[..., None, None, :]
    cw = cw * ok.to(weights.dtype) * weights[..., None, None, None]
    w_l, h_l, t_l = (dims[:, 0, c, 0][:, None, None, None, None]
                     for c in range(3))                 # [L, 1, 1, 1, 1]
    flat = ((it[..., :, None, None] * h_l + iy[..., None, :, None]) * w_l
            + ix[..., None, None, :])
    flat = torch.minimum(flat.clamp(min=0), t_l * h_l * w_l - 1)
    idx = (flat + starts.to(torch.int32)[:, None, None, None, None]
           + head_rows.to(torch.int32)[..., None, None, None, None, None])
    b, q, nh = loc.shape[:3]
    return idx.reshape(b, q, nh, -1), cw.reshape(b, q, nh, -1)


def ms_deform_attn_3d(value: torch.Tensor,
                      spatial_shapes: Sequence[Tuple[int, int, int]],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor,
                      query_chunk: int = QUERY_CHUNK) -> torch.Tensor:
    """3D multi-scale deformable attention (the JAX package's
    ``ms_deform_attn_3d``, deform_attn.py:412, and its oracle ``_xla``).

    value [B, S, H, D] (levels flattened in order, S = sum t*h*w);
    ``spatial_shapes`` static (t, h, w) per level; sampling_locations
    [B, Q, H, L, P, 3] in (x, y, t) order, normalised to [0, 1] over each
    level; attention_weights [B, Q, H, L, P].  Returns [B, Q, H * D].
    Each level is sampled at ``loc * size - 0.5`` with its 8 trilinear
    corners, zero outside the volume; a point whose corners all lie outside
    is dropped.  Differentiable in all three inputs.  Queries go through in
    chunks of ``query_chunk``."""
    b, s, nh, d = value.shape
    sizes = [t * h * w for t, h, w in spatial_shapes]
    if sum(sizes) != s or sampling_locations.shape[3] != len(sizes):
        raise ValueError(f"value has {s} rows and locations "
                         f"{sampling_locations.shape[3]} levels for level "
                         f"shapes {tuple(spatial_shapes)}")
    if b * nh * s >= 2 ** 31:
        raise ValueError(f"{b * nh * s} value rows do not fit the int32 "
                         f"corner indices")
    dev = value.device
    table = value.transpose(1, 2).reshape(b * nh * s, d)
    starts = torch.tensor([0] + sizes[:-1], device=dev).cumsum(0)
    head_rows = (torch.arange(b * nh, device=dev) * s).reshape(b, 1, nh)
    q = sampling_locations.shape[1]
    outs = []
    for q0 in range(0, q, query_chunk):
        loc = sampling_locations[:, q0 : q0 + query_chunk]
        idx, cw = _corners(loc, attention_weights[:, q0 : q0 + query_chunk],
                           spatial_shapes, starts, head_rows)
        cq = loc.shape[1]
        out = F.embedding_bag(idx.reshape(b * cq * nh, -1), table,
                              mode="sum",
                              per_sample_weights=cw.reshape(b * cq * nh, -1))
        outs.append(out.reshape(b, cq, nh * d))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def directional_offset_init(n_heads: int, n_levels: int,
                            n_points: int) -> torch.Tensor:
    """Bias init for the sampling-offset head: heads spread on a circle in
    (x, y), the first half of the heads carrying temporal extent, scaled
    per point.  Returns [n_heads * n_levels * n_points * 3] in
    (head, level, point, comp) order."""
    half = n_heads // 2
    thetas = torch.arange(half, dtype=torch.float32) * (2.0 * math.pi / half)
    t_extent = torch.cat([torch.ones(half), torch.zeros(n_heads - half)])
    grid = torch.stack(
        [torch.cos(thetas).repeat(2)[:n_heads],
         torch.sin(thetas).repeat(2)[:n_heads],
         t_extent],
        dim=-1,
    )                                                       # [H, 3]
    grid = grid / grid.abs().amax(dim=-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    point_scale = torch.arange(1, n_points + 1, dtype=torch.float32)
    grid = grid * point_scale[None, None, :, None]
    return grid.reshape(-1)


def directional_offset_init_l3hp(n_heads: int, n_levels: int,
                                 n_points: int) -> torch.Tensor:
    """:func:`directional_offset_init` in the fast encoder's (level,
    component x/y/t, head, point) lane order (3d window)."""
    g = directional_offset_init(n_heads, n_levels, n_points)
    g = g.reshape(n_heads, n_levels, n_points, 3)
    return g.permute(1, 3, 0, 2).reshape(-1)


def directional_offset_init_l2hp(n_heads: int, n_levels: int,
                                 n_points: int) -> torch.Tensor:
    """The (x, y) components of :func:`directional_offset_init` in the fast
    encoder's (level, component, head, point) lane order (2d window)."""
    g = directional_offset_init(n_heads, n_levels, n_points)
    g = g.reshape(n_heads, n_levels, n_points, 3)[..., :2]
    return g.permute(1, 3, 0, 2).reshape(-1)
