"""VideoMamba backbone, eval forward (counterpart of
``class_query_vad_tpu/models/videomamba.py``) and the Mamba branch of the
DETR backbone (``detr.py:44-62, 130-148``).

* per-frame 16x16 patch embed (Conv3d kernel (1, 16, 16));
* cls token + learned spatial pos embed + per-frame temporal pos embed,
  tokens ordered (t, hw) with the one cls token first;
* ``depth`` residual blocks: LayerNorm -> bidirectional Mamba (shared in /
  out projections, separate conv / x_proj / dt_proj / A / D per direction,
  the backward branch on the flipped sequence, gated by the flipped z and
  flipped back before the sum);
* final LayerNorm; the per-frame summary is the mean over each frame's
  tokens.

Dtypes follow flax's: ``to_compute_dtype`` casts the matmul and convolution
weights (bf16 when serving), while the LayerNorms (eps 1e-5), ``dt_proj``,
``A_log``, ``D`` and the position tables stay float32.  ``x + pos_embed``
promotes the patch embed to float32, so the residual stream is float32
while each block computes in the compute dtype.

``VideoMambaBackbone`` is what the DETR calls: the token map with the
frame summary concatenated, a 4x temporal max-pool, ``mamba_proj`` (Linear,
LN, exact GELU, Linear, LN, Linear; float32) and one level's masks and
sine poses.  Parameter names follow the reference's torch names
(``backbone.0.body.layers.{i}.mixer.*``, ``backbone.0.mamba_proj.{0..5}``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbone import level_masks_and_poses
from .common import LayerNorm, Linear
from .mamba_block import CausalConv1d, a_log_init, s6_branch

VIDEOMAMBA_SPECS = {
    "videomamba_tiny": dict(embed_dim=192, depth=24),
    "videomamba_small": dict(embed_dim=384, depth=24),
    "videomamba_middle": dict(embed_dim=576, depth=32),
}

_LN_EPS = 1e-5          # VideoMamba's norms (videomamba.py:108, 169)
PATCH = 16


def to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the matmul and convolution weights of a VideoMamba (or of one of
    its blocks) to ``dtype``; everything else stays float32 (see the module
    docstring)."""
    for mod in module.modules():
        if isinstance(mod, (Linear, CausalConv1d, nn.Conv3d)):
            mod.to(dtype)
    return module


class BiMamba(nn.Module):
    """Bidirectional Mamba mixer (Vim / VideoMamba bimamba v2; d_conv 4,
    expand 2, dt rank ceil(d_model / 16))."""

    def __init__(self, d_model: int, d_state: int = 16):
        super().__init__()
        d_inner = 2 * d_model
        self.dt_rank = math.ceil(d_model / 16)
        self.d_state = d_state
        r, n = self.dt_rank, d_state
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = CausalConv1d(d_inner, 4)
        self.conv1d_b = CausalConv1d(d_inner, 4)
        self.x_proj = Linear(d_inner, r + 2 * n, bias=False)
        self.x_proj_b = Linear(d_inner, r + 2 * n, bias=False)
        # plain nn.Linear, not common.Linear: to_compute_dtype keeps them
        # float32 (the delta projection is a float32 matmul in flax)
        self.dt_proj = nn.Linear(r, d_inner)
        self.dt_proj_b = nn.Linear(r, d_inner)
        self.A_log = nn.Parameter(a_log_init(d_inner, n))
        self.A_b_log = nn.Parameter(a_log_init(d_inner, n))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.D_b = nn.Parameter(torch.ones(d_inner))
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, u: torch.Tensor) -> torch.Tensor:       # [B, L, D]
        x, z = self.in_proj(u).chunk(2, dim=-1)
        gate = F.silu(z)
        r, n = self.dt_rank, self.d_state
        y_f = s6_branch(x, self.conv1d, self.x_proj, self.dt_proj,
                        self.A_log, self.D, r, n)
        y_b = s6_branch(x.flip(1), self.conv1d_b, self.x_proj_b,
                        self.dt_proj_b, self.A_b_log, self.D_b, r, n)
        # flax: y_f * silu(z) + (y_b * silu(z[::-1]))[::-1], same roundings
        return self.out_proj(y_f * gate + y_b.flip(1) * gate)


class VideoMambaBlock(nn.Module):
    def __init__(self, dim: int, d_state: int = 16):
        super().__init__()
        self.norm = LayerNorm(dim, _LN_EPS)
        self.mixer = BiMamba(dim, d_state=d_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the norm computes in float32; in_proj casts its output to the
        # compute dtype, where flax's LayerNorm(dtype=...) rounds it
        return x + self.mixer(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, (1, PATCH, PATCH), stride=(1, PATCH, PATCH))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] -> [B, T, h, w, C] in the weight's dtype."""
        x = self.proj(x.permute(0, 4, 1, 2, 3).to(self.proj.weight.dtype))
        return x.permute(0, 2, 3, 4, 1)


class VideoMamba(nn.Module):
    """``num_patches`` is the frame's patch grid size h * w: the learned
    spatial position table has one row per patch (the JAX package shapes it
    from the clip its init sees)."""

    def __init__(self, num_patches: int, embed_dim: int = 192, depth: int = 24,
                 num_frames: int = 16, d_state: int = 16):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + num_patches, embed_dim))
        self.temporal_pos_embedding = nn.Parameter(
            torch.zeros(1, num_frames, embed_dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.layers = nn.ModuleList(
            VideoMambaBlock(embed_dim, d_state) for _ in range(depth))
        self.norm_f = LayerNorm(embed_dim, _LN_EPS)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels [B, T, H, W, 3] -> (token map [B, T, h, w, C], frame
        summary [B, T, C]), both in the compute dtype."""
        cdt = self.patch_embed.proj.weight.dtype
        x = self.patch_embed(pixels)
        b, t, h, w, c = x.shape
        if 1 + h * w != self.pos_embed.shape[1]:
            raise ValueError(
                f"the clip's {h}x{w} patch grid does not match the position "
                f"table's {self.pos_embed.shape[1] - 1} patches (build_model's "
                f"input_hw)")
        x = x.reshape(b, t, h * w, c) + self.pos_embed[:, None, 1:]
        x = x + self.temporal_pos_embedding[:, :t, None]
        x = x.reshape(b, t * h * w, c)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, 1, c)
        x = torch.cat([cls.to(x.dtype), x], dim=1)
        for layer in self.layers:
            x = layer(x)
        x = self.norm_f(x).to(cdt)
        tokens = x[:, 1:].reshape(b, t, h, w, c)
        return tokens, tokens.mean(dim=(2, 3))


def build_videomamba(backbone_type: str, num_frames: int,
                     num_patches: int) -> VideoMamba:
    return VideoMamba(num_patches, num_frames=num_frames,
                      **VIDEOMAMBA_SPECS[backbone_type])


class VideoMambaBackbone(nn.Module):
    """VideoMamba + the DETR's Mamba glue (``detr.py:130-148``): returns
    (srcs, masks, poses) of one level [B, T/4, h, w, d_model], float32."""

    def __init__(self, spec, input_hw: Tuple[int, int]):
        super().__init__()
        num_patches = (input_hw[0] // PATCH) * (input_hw[1] // PATCH)
        self.d_model = spec.d_model
        self.body = build_videomamba(spec.mamba_backbone_type, spec.temp_len,
                                     num_patches)
        c = self.body.norm_f.normalized_shape[0]
        mid = spec.mamba_out_channels
        self.mamba_proj = nn.Sequential(
            Linear(2 * c, mid), LayerNorm(mid), nn.GELU(),
            Linear(mid, spec.d_model, bias=False), LayerNorm(spec.d_model),
            Linear(spec.d_model, spec.d_model, bias=False))

    def forward(self, pixels: torch.Tensor, mask: torch.Tensor):
        tokens, summary = self.body(pixels)
        b, t, h, w, c = tokens.shape
        x = torch.cat([tokens, summary[:, :, None, None].expand_as(tokens)],
                      dim=-1)                              # [B, T, h, w, 2C]
        t4 = t // 4                                         # VALID 4x max-pool
        x = x[:, :4 * t4].reshape(b, t4, 4, h, w, 2 * c).amax(dim=2)
        x = self.mamba_proj(x.float())
        srcs: List[torch.Tensor] = [x]
        masks, poses = level_masks_and_poses(srcs, mask, self.d_model)
        return srcs, masks, poses
