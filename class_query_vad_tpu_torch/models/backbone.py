"""ViT backbone + 4-scale FPN + per-level masks and sine poses
(counterpart of ``class_query_vad_tpu/models/backbone.py``).

Each FPN branch is an ``nn.Sequential`` with the reference's indices
(``lateral_convs.{level}.{i}``) so that its state_dict keys match:

  scale 4   [ConvT, LN, GELU, ConvT, Conv1, LN, Conv3]
  scale 2   [ConvT, Conv1, LN, Conv3]
  scale 1   [Conv1, LN, Conv3]
  scale 0.5 [MaxPool, Conv1, LN, Conv3]

Every stage works channels-last [B, T, H, W, C] while holding the torch
conv layouts (ConvTranspose3d [I, O, t, h, w], Conv3d [O, I, t, h, w]).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.misc import interpolate_mask
from .common import ChannelLayerNorm
from .position_encoding import (
    position_embedding_sine_3d,
    position_embedding_sine_3d_frames,
)
from .vit import ViT

FPN_SCALES = (4.0, 2.0, 1.0, 0.5)


class UpConv2x(nn.ConvTranspose3d):
    """ConvTranspose3d kernel = stride = (1, 2, 2), channels-last.  With
    kernel == stride the output pixels do not overlap: one matmul to
    [.., 2, 2, O] and an interleave."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(in_dim, out_dim, (1, 2, 2), stride=(1, 2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight                                  # [I, O, 1, 2, 2]
        i, o = w.shape[:2]
        wm = w[:, :, 0].permute(2, 3, 1, 0).reshape(4 * o, i)
        b, t, h, wd, _ = x.shape
        y = F.linear(x.to(w.dtype), wm).reshape(b, t, h, wd, 2, 2, o)
        y = y.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, 2 * h, 2 * wd, o)
        return y + self.bias


class PointConv(nn.Conv3d):
    """1x1x1 Conv3d without bias, channels-last."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(in_dim, out_dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return F.linear(x.to(w.dtype), w.reshape(w.shape[0], -1))


class Conv3x3x3(nn.Conv3d):
    """3x3x3 Conv3d, zero padding 1, no bias, channels-last."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(in_dim, out_dim, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.to(self.weight.dtype).permute(0, 4, 1, 2, 3),
                     self.weight, None, padding=1)
        return y.permute(0, 2, 3, 4, 1)


class MaxPool2x(nn.Module):
    """MaxPool3d (1, 2, 2), channels-last (VALID: odd edges dropped)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        x = x[:, :, : h // 2 * 2, : w // 2 * 2]
        return x.reshape(b, t, h // 2, 2, w // 2, 2, c).amax(dim=(3, 5))


def lateral_conv(scale: float, in_dim: int, out_dim: int) -> nn.Sequential:
    """One FPN branch, with the reference's Sequential indices."""
    head: list = []
    if scale == 4.0:
        head = [UpConv2x(in_dim, in_dim // 2), ChannelLayerNorm(in_dim // 2),
                nn.GELU(), UpConv2x(in_dim // 2, in_dim // 4)]
        c = in_dim // 4
    elif scale == 2.0:
        head, c = [UpConv2x(in_dim, in_dim // 2)], in_dim // 2
    elif scale == 1.0:
        c = in_dim
    elif scale == 0.5:
        head, c = [MaxPool2x()], in_dim
    else:
        raise ValueError(f"unsupported FPN scale {scale}")
    return nn.Sequential(*head, PointConv(c, out_dim),
                         ChannelLayerNorm(out_dim), Conv3x3x3(out_dim, out_dim))


def level_masks_and_poses(
    features: List[torch.Tensor], mask: torch.Tensor, d_model: int
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-level pad masks (nearest-resized, replicated over T_l) and 3D
    sine positional encodings, in float32."""
    masks, poses = [], []
    for x in features:
        t_l, h_l, w_l = x.shape[1:4]
        m = interpolate_mask(mask, (h_l, w_l))
        m = m[:, None].expand(m.shape[0], t_l, h_l, w_l)
        masks.append(m)
        poses.append(position_embedding_sine_3d(m, d_model))
    return masks, poses


def level_masks_and_poses_frames(
    features: List[torch.Tensor], mask: torch.Tensor, d_model: int,
    frames, t_total: int,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Masks + sine poses when every level carries only the absolute
    temporal ``frames`` of a ``t_total``-frame pyramid."""
    masks, poses = [], []
    f = len(list(frames))
    for x in features:
        h_l, w_l = x.shape[2:4]
        m2 = interpolate_mask(mask, (h_l, w_l))
        masks.append(m2[:, None].expand(m2.shape[0], f, h_l, w_l))
        poses.append(
            position_embedding_sine_3d_frames(m2, frames, t_total, d_model)
        )
    return masks, poses


class ViTBackboneFPN(nn.Module):
    """ViT body + 4-scale FPN.  Returns (features, masks, poses) —
    features[l] [B, T_l, H_l, W_l, D], masks[l] [B, T_l, H_l, W_l]
    (True = pad), poses[l] like features[l] in float32."""

    def __init__(self, spec, d_model: int):
        super().__init__()
        self.spec = spec
        self.d_model = d_model
        self.body = ViT(spec.vit, spec.gradient_checkpointing)
        self.lateral_convs = nn.ModuleList(
            lateral_conv(s, spec.vit.embed_dim, d_model) for s in FPN_SCALES
        )

    def forward(self, pixels, mask, out_frames=None, dec_frame=None):
        # out_frames: contiguous absolute token-frame indices — produce the
        # pyramid ONLY at those frames.  The branches' temporal receptive
        # field is the single 3x3x3 conv, so output frame i needs token
        # frames i-1..i+1: the ViT computes that halo range (last block
        # query-sliced) and the conv's interior output frames are exact.
        # dec_frame: also return the ref level's (index -2) sine pose at
        # that absolute frame (the decoder's positional frame).
        if out_frames is None:
            tokens = self.body(pixels)
            features = [lc(tokens) for lc in self.lateral_convs]
            masks, poses = level_masks_and_poses(features, mask, self.d_model)
            return features, masks, poses

        of = tuple(sorted(set(out_frames)))
        assert of[-1] - of[0] == len(of) - 1, "out_frames must be contiguous"
        t_tokens = pixels.shape[1] // self.spec.vit.tubelet_size
        v0 = max(of[0] - 1, 0)
        v1 = min(of[-1] + 2, t_tokens)
        tokens = self.body(pixels, out_frame_range=(v0, v1))
        lo, hi = of[0] - v0, of[-1] + 1 - v0
        features = [lc(tokens)[:, lo:hi] for lc in self.lateral_convs]
        masks, poses = level_masks_and_poses_frames(
            features, mask, self.d_model, of, t_tokens
        )
        pos_dec = None
        if dec_frame is not None:
            ref = features[len(FPN_SCALES) - 2]
            m2 = interpolate_mask(mask, tuple(ref.shape[2:4]))
            pos_dec = position_embedding_sine_3d_frames(
                m2, (dec_frame,), t_tokens, self.d_model
            )
        return features, masks, poses, pos_dec
