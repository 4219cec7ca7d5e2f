"""Sampling-offset bias initialisers (counterpart of the init half of
``class_query_vad_tpu/ops/deform_attn.py``)."""

from __future__ import annotations

import math

import torch


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
