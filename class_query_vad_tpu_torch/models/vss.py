"""SS2D / VSSBlock (VMamba / Mamba-YOLO blocks), eval forward (counterpart
of ``class_query_vad_tpu/models/vss.py``).

* ``SS2D``: 1x1 in-proj -> split (x, z) -> depthwise 3x3 -> exact GELU ->
  4-direction ``cross_scan`` -> selective scan (K5 on the card) ->
  ``cross_merge`` -> LayerNorm -> gate by GELU(z) -> 1x1 out-proj;
* ``LSBlock``, ``RGBlock`` and ``VSSBlock`` (post-norm, ``mlp_ratio`` 0 in
  the encoder);
* ``FrozenBatchNorm``: the eval branch of the JAX package's
  ``CSNBatchNorm`` (``csn.py:63-96``), running statistics as buffers.

Layout channels-last [B, H, W, C], as in the JAX package.  Module and
parameter names are the reference's torch names (``proj_conv.0/1``,
``norm.norm``, ``op.x_proj_weight`` ...), so a reference state_dict loads
by name; its 1x1 convolutions keep their [O, I, 1, 1] weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.selective_scan import selective_scan
from .common import LayerNorm


class FrozenBatchNorm(nn.Module):
    """BatchNorm in inference form over the last (channel) axis:
    x * w / sqrt(var + eps) + (b - mean * w / sqrt(var + eps))."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        scale = inv.to(x.dtype)
        bias = (self.bias - self.running_mean * inv).to(x.dtype)
        return x * scale + bias


class PointConv2d(nn.Conv2d):
    """1x1 Conv2d ([O, I, 1, 1] weight) applied to channels-last input."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__(in_dim, out_dim, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


class DepthwiseConv2d(nn.Conv2d):
    """Depthwise 3x3 Conv2d, 'same' padding, on channels-last input."""

    def __init__(self, dim: int):
        super().__init__(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def cross_scan(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, D] -> [B, 4, D, L]: row-major, column-major, and their
    reversals."""
    b, h, w, d = x.shape
    row = x.reshape(b, h * w, d).transpose(1, 2)
    col = x.transpose(1, 2).reshape(b, h * w, d).transpose(1, 2)
    return torch.stack([row, col, row.flip(-1), col.flip(-1)], dim=1)


def cross_merge(ys: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 4, D, L] -> [B, D, L]: the four directions un-flipped, the
    column-major pair un-transposed, summed."""
    b, _, d, l = ys.shape
    fwd = ys[:, 0:2] + ys[:, 2:4].flip(-1)
    col = fwd[:, 1].reshape(b, d, w, h).transpose(2, 3).reshape(b, d, l)
    return fwd[:, 0] + col


class SS2D(nn.Module):
    """2-D selective scan over four directions, with the JAX module's
    defaults (``ssm_ratio`` 2, no low-rank projection, 3x3 conv, dt rank
    ceil(d_model / 16)): the configuration every caller uses."""

    K = 4

    def __init__(self, d_model: int, d_state: int = 16):
        super().__init__()
        d_inner = 2 * d_model
        self.dt_rank = math.ceil(d_model / 16)
        self.d_state = d_state
        k, r, n = self.K, self.dt_rank, d_state
        self.in_proj = PointConv2d(d_model, 2 * d_inner, bias=False)
        self.conv2d = DepthwiseConv2d(d_inner)
        self.x_proj_weight = nn.Parameter(torch.zeros(k, r + 2 * n, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.zeros(k, d_inner, r))
        self.dt_projs_bias = nn.Parameter(torch.zeros(k, d_inner))
        self.A_logs = nn.Parameter(torch.zeros(k * d_inner, n))
        self.Ds = nn.Parameter(torch.ones(k * d_inner))
        self.out_norm = LayerNorm(d_inner)
        self.out_proj = PointConv2d(d_inner, d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        k, r, n = self.K, self.dt_rank, self.d_state
        xx, z = self.in_proj(x).chunk(2, dim=-1)
        z1 = F.gelu(z)
        xx = F.gelu(self.conv2d(xx))
        d_inner = xx.shape[-1]
        xs = cross_scan(xx.float())                          # [B, K, D, L]
        x_dbl = torch.einsum("bkdl,kcd->bkcl", xs, self.x_proj_weight)
        dts, bs, cs = x_dbl.split([r, n, n], dim=2)
        dts = torch.einsum("bkrl,kdr->bkdl", dts, self.dt_projs_weight)
        length = h * w
        ys = selective_scan(
            xs.reshape(b, k * d_inner, length),
            dts.reshape(b, k * d_inner, length),
            -torch.exp(self.A_logs.float()), bs, cs, self.Ds,
            delta_bias=self.dt_projs_bias.reshape(-1), delta_softplus=True,
        ).reshape(b, k, d_inner, length)
        y = cross_merge(ys, h, w).transpose(1, 2)            # [B, L, D]
        y = self.out_norm(y).reshape(b, h, w, d_inner)
        return self.out_proj(y * z1)


class LSBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.fc1 = DepthwiseConv2d(features)
        self.norm = FrozenBatchNorm(features, eps=1e-5)
        self.fc2 = PointConv2d(features, features)
        self.fc3 = PointConv2d(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.fc1(x))
        return x + self.fc3(F.gelu(self.fc2(y)))


class RGBlock(nn.Module):
    def __init__(self, features: int, hidden: int):
        super().__init__()
        hidden = int(2 * hidden / 3)
        self.fc1 = PointConv2d(features, 2 * hidden)
        self.dwconv = DepthwiseConv2d(hidden)
        self.fc2 = PointConv2d(hidden, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, v = self.fc1(x).chunk(2, dim=-1)
        y = self.dwconv(y) + y
        return self.fc2(F.gelu(y) * v)


class _LayerNorm2d(nn.Module):
    """The reference's LayerNorm2d: an inner LayerNorm named ``norm``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = LayerNorm(dim, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class VSSBlock(nn.Module):
    def __init__(self, in_channels: int, hidden_dim: int,
                 ssm_d_state: int = 16, mlp_ratio: float = 4.0,
                 post_norm: bool = False):
        super().__init__()
        self.post_norm = post_norm
        self.proj_conv = nn.Sequential(
            PointConv2d(in_channels, hidden_dim),
            FrozenBatchNorm(hidden_dim, eps=1e-5))
        self.lsblock = LSBlock(hidden_dim)
        self.op = SS2D(hidden_dim, d_state=ssm_d_state)
        self.norm = _LayerNorm2d(hidden_dim, 1e-6)
        if mlp_ratio > 0:
            self.norm2 = LayerNorm(hidden_dim)
            self.mlp = RGBlock(hidden_dim, int(hidden_dim * mlp_ratio))
        else:
            self.mlp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.proj_conv(x))
        x1 = self.lsblock(y)
        if self.post_norm:
            out = self.norm(y + self.op(x1))
        else:
            out = y + self.op(self.norm(x1))
        if self.mlp is not None:
            out = out + self.mlp(self.norm2(out))
        return out
