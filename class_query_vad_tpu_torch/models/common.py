"""Shared model building blocks (counterpart of ``class_query_vad_tpu/models/common.py``).

Dtype policy.  A flax module built with ``dtype=bf16`` casts its inputs and
its float32 params to bf16 and computes there.  The port stores each
module's params in its compute dtype (``build_model`` casts the backbone,
the encoder and the decoder separately) and ``Linear``/``LayerNorm`` cast
their input to that dtype, so the same dtype flows through both packages.

flax's ``nn.LayerNorm`` defaults to eps = 1e-6 where torch's defaults to
1e-5: every LayerNorm of the path is 1e-6, so ``LayerNorm`` here defaults
to it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6


def remat_call(remat: bool, module: nn.Module, *args):
    """``module(*args)``; with ``remat``, in training and with gradients
    on, recomputed in the backward instead of keeping its activations
    (``torch.utils.checkpoint``, non-reentrant, the RNG state replayed so
    that dropout draws the same masks): the JAX package's ``nn.remat``."""
    if remat and module.training and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its own parameter dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with flax's eps = 1e-6; computes in its
    own parameter dtype.  Also serves as the reference's channel-wise
    ``ChannelLayerNorm``: the layout here is channels-last."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.to(self.weight.dtype), self.normalized_shape, self.weight,
            self.bias, self.eps,
        )


ChannelLayerNorm = LayerNorm


class DropPath(nn.Module):
    """Stochastic depth (``class_query_vad_tpu/models/common.py:67-82``):
    in ``train()`` mode each sample of the batch is kept with probability
    1 - rate and scaled by 1 / (1 - rate), or zeroed whole.  The draw comes
    from torch's default generator of the tensor's device."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class MLP(nn.Module):
    """ReLU MLP head (``layers.{i}`` as in the reference MLP)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(i, o) for i, o in zip(dims, outs)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def sine_embed_for_position(pos: torch.Tensor, d_half: int = 128) -> torch.Tensor:
    """DAB-DETR anchor sine embedding, in float32.

    pos: [..., 2 or 4] normalized (x, y[, w, h]).  Returns [..., d_half*2]
    or [..., d_half*4], ordered (y, x[, w, h]).  The exponent uses FLOOR
    division (``2 * floor(i / 2) / d_half``), unlike the 3D sine position
    encoding's true division (position_encoding.py) — a reproduced
    reference quirk.
    """
    scale = 2.0 * math.pi
    dim_t = torch.arange(d_half, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / d_half)
    pos = pos.float()

    def embed(coord):
        p = coord[..., None] * scale / dim_t
        return torch.stack(
            [torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1
        ).reshape(*coord.shape, d_half)

    pos_x = embed(pos[..., 0])
    pos_y = embed(pos[..., 1])
    if pos.shape[-1] == 2:
        return torch.cat([pos_y, pos_x], dim=-1)
    pos_w = embed(pos[..., 2])
    pos_h = embed(pos[..., 3])
    return torch.cat([pos_y, pos_x, pos_w, pos_h], dim=-1)
