"""The exact 3D multi-scale deformable encoder (counterpart of
``class_query_vad_tpu/models/deform_encoder.py``, ``ENCODER_TYPE:
attention``).

* ``MSDeformAttn3D``: value / offset / weight / output projections, the
  padding mask zeroing values, a softmax over levels x points per head,
  and sampling locations formed as the reference does, with its quirk: the
  offset normaliser is stacked (T, W, H) against (x, y, t)-ordered offsets
  (do not "fix" it); 6-wide reference points scale the offsets by their
  extent.  The sampling is ``ops.deform_attn.ms_deform_attn_3d`` (plain
  PyTorch: the JAX package has no Pallas kernel for it).
* ``DeformableEncoderLayer``: post-norm attention, then the FFN, with
  three dropouts; ``q_rows`` restricts its queries (and its output) to
  row spans while the sampling still reads the full value stream.
* ``encoder_reference_points`` / ``get_valid_ratio``: the per-token
  (x, y, t) grid scaled by the levels' valid ratios in (w, h, t) order.

The encoder runs in float32 whatever the backbone's dtype (``build_model``
keeps it so), as the JAX package and the reference's autocast-disabled
island do.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_attn import ms_deform_attn_3d
from .common import LayerNorm, Linear

Shapes = Tuple[Tuple[int, int, int], ...]     # per level (T, H, W)
Rows = Tuple[Tuple[int, int], ...]            # token-row spans [start, stop)


class MSDeformAttn3D(nn.Module):
    """3D multi-scale deformable attention: projections and sampling."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.value_proj = Linear(d_model, d_model)
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 3)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = Linear(d_model, d_model)
        # the sampling locations pass through here, where a forward hook can
        # read them (chip_smoke.py's card-vs-CPU train checks find the
        # coordinates whose trilinear floors differ between the two sides)
        self.sampling_locations = nn.Identity()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value_src: torch.Tensor, shapes: Shapes,
                padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        """query [B, Q, C], reference_points [B, Q, L, 3] (x, y, t) or
        [B, Q, L, 6], value_src [B, S, C] (levels flattened), padding_mask
        [B, S] (True = pad).  Returns [B, Q, C]."""
        b, q, _ = query.shape
        nh, nl, np_ = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_src)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.reshape(b, value_src.shape[1], nh, self.d_model // nh)
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, np_, 3)
        weights = F.softmax(self.attention_weights(query).reshape(
            b, q, nh, nl * np_), dim=-1).reshape(b, q, nh, nl, np_)
        if reference_points.shape[-1] == 3:
            # reference quirk: (T, W, H) against (x, y, t) offsets
            normalizer = torch.tensor([[t, w, h] for t, h, w in shapes],
                                      dtype=offsets.dtype,
                                      device=offsets.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 6:
            ref = reference_points[:, :, None, :, None]
            loc = ref[..., :3] + offsets / np_ * ref[..., 3:] * 0.5
        else:
            raise ValueError("reference_points last dim must be 3 or 6")
        loc = self.sampling_locations(loc)
        return self.output_proj(ms_deform_attn_3d(value, shapes, loc, weights))


def take_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """The token rows ``rows`` of x [B, N, ...], concatenated in order."""
    return torch.cat([x[:, a:b] for a, b in rows], dim=1)


class DeformableEncoderLayer(nn.Module):
    """Post-norm deformable self-attention + FFN (dropout after the
    attention, inside the FFN and after it)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 2048,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MSDeformAttn3D(d_model, n_levels, n_heads, n_points)
        self.dropout1 = nn.Dropout(dropout)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.dropout2 = nn.Dropout(dropout)
        self.linear2 = Linear(d_ffn, d_model)
        self.dropout3 = nn.Dropout(dropout)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, reference_points, shapes: Shapes, mask,
                q_rows: Rows | None = None):
        """``q_rows``: the token-row spans this layer's queries (and its
        output) are cut to; every per-query op is row-independent given the
        full values, which the sampling still reads from ``src``."""
        if q_rows is not None:
            q_src, q_pos, q_ref = (take_rows(x, q_rows)
                                   for x in (src, pos, reference_points))
        else:
            q_src, q_pos, q_ref = src, pos, reference_points
        attn = self.self_attn(q_src + q_pos, q_ref, src, shapes, mask)
        x = self.norm1(q_src + self.dropout1(attn))
        y = self.linear2(self.dropout2(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout3(y))


def encoder_reference_points(shapes: Shapes,
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-token (x, y, t) pixel-centre grid of every level, divided by
    the level's valid extent and scaled by every level's valid ratio:
    valid_ratios [B, L, 3] in (w, h, t) order -> [B, S, L, 3]."""
    refs = []
    dev = valid_ratios.device
    for lvl, (t, h, w) in enumerate(shapes):
        gt, gy, gx = torch.meshgrid(
            *(torch.arange(k, dtype=torch.float32, device=dev) + 0.5
              for k in (t, h, w)), indexing="ij")
        vr = valid_ratios[:, None, lvl]                           # [B, 1, 3]
        refs.append(torch.stack([gx.reshape(-1)[None] / (vr[..., 0] * w),
                                 gy.reshape(-1)[None] / (vr[..., 1] * h),
                                 gt.reshape(-1)[None] / (vr[..., 2] * t)],
                                dim=-1))                           # [B, thw, 3]
    return torch.cat(refs, 1)[:, :, None] * valid_ratios[:, None]


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """mask [B, T, H, W] (True = pad) -> [B, 3] valid fractions in (w, h, t)
    order, probing the first row and column as the reference does."""
    t, h, w = mask.shape[1:]
    valid_t = (~mask[:, :, 0, 0]).sum(1).float() / t
    valid_h = (~mask[:, 0, :, 0]).sum(1).float() / h
    valid_w = (~mask[:, 0, 0, :]).sum(1).float() / w
    return torch.stack([valid_w, valid_h, valid_t], dim=-1)


class DeformableEncoder(nn.Module):
    """Stack of exact deformable layers over the flattened level tokens."""

    def __init__(self, num_layers: int = 6, d_model: int = 256,
                 d_ffn: int = 2048, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 8, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(d_model, d_ffn, n_levels, n_heads,
                                   n_points, dropout)
            for _ in range(num_layers))

    def forward(self, src, shapes: Shapes, valid_ratios, pos, mask,
                last_layer_rows: Rows | None = None) -> torch.Tensor:
        """src, pos [B, S, C]; mask [B, S].  ``last_layer_rows``: the final
        layer's query rows (the returned memory holds only those rows, in
        span order); the layers before it stay full, since the next
        layer's sampling reads every frame."""
        ref = encoder_reference_points(shapes, valid_ratios)
        x = src
        for i, layer in enumerate(self.layers):
            rows = last_layer_rows if i == len(self.layers) - 1 else None
            x = layer(x, pos, ref, shapes, mask, rows)
        return x
