"""Mamba (S6) block, eval forward (counterpart of
``class_query_vad_tpu/models/mamba_block.py``; the reference's
``mamba_simple.Mamba``), and the pieces the bidirectional VideoMamba mixer
shares with it.

    xz = in_proj(u)                     # [B, L, 2 * d_inner], no bias
    x, z = split(xz)
    x = silu(causal_conv1d(x))          # depthwise, kernel d_conv, left pad
    dt, B, C = split(x_proj(x))         # [R], [N], [N], no bias
    y = selective_scan(x, dt @ dt_proj.weight^T, -exp(A_log), B, C, D,
                       delta_bias=dt_proj.bias, delta_softplus=True)
    out = out_proj(y * silu(z))         # no bias

Dtypes follow flax's: the matmuls and the convolution compute in their
weights' dtype (bf16 in a bf16 backbone), while ``dt_proj``, ``A_log`` and
``D`` stay float32, so the delta projection is a float32 matmul and the
scan carries float32 whatever the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.selective_scan import selective_scan
from .common import Linear


class CausalConv1d(nn.Conv1d):
    """Depthwise Conv1d over [B, C, L] with ``k - 1`` zeros on the left;
    computes in its weight's dtype."""

    def __init__(self, dim: int, k: int):
        super().__init__(dim, dim, k, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.to(self.weight.dtype), (self.kernel_size[0] - 1, 0))
        return F.conv1d(x, self.weight, self.bias, groups=self.groups)


def s6_branch(x: torch.Tensor, conv: CausalConv1d, x_proj: Linear,
              dt_proj: nn.Linear, A_log: torch.Tensor, D: torch.Tensor,
              dt_rank: int, d_state: int) -> torch.Tensor:
    """conv -> silu -> x_proj -> selective scan on x [B, L, d_inner];
    returns y [B, L, d_inner] in the conv's dtype."""
    h = F.silu(conv(x.transpose(1, 2)))                   # [B, D, L]
    dbl = x_proj(h.transpose(1, 2))                       # [B, L, R + 2N]
    dt, b, c = dbl.split([dt_rank, d_state, d_state], dim=-1)
    delta = F.linear(dt.float(), dt_proj.weight)          # [B, L, D] float32
    y = selective_scan(h, delta.transpose(1, 2), -torch.exp(A_log.float()),
                       b.transpose(1, 2), c.transpose(1, 2), D,
                       delta_bias=dt_proj.bias, delta_softplus=True)
    return y.transpose(1, 2)


def a_log_init(d_inner: int, d_state: int) -> torch.Tensor:
    """log(1..N) for every channel."""
    return torch.log(torch.arange(1, d_state + 1, dtype=torch.float32)
                     ).repeat(d_inner, 1)


class Mamba(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: int | None = None):
        super().__init__()
        d_inner = expand * d_model
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.d_state = d_state
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = CausalConv1d(d_inner, d_conv)
        self.x_proj = Linear(d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner)
        self.A_log = nn.Parameter(a_log_init(d_inner, d_state))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, u: torch.Tensor) -> torch.Tensor:     # [B, L, D]
        x, z = self.in_proj(u).chunk(2, dim=-1)
        y = s6_branch(x, self.conv1d, self.x_proj, self.dt_proj, self.A_log,
                      self.D, self.dt_rank, self.d_state)
        return self.out_proj(y * F.silu(z))


@torch.no_grad()
def dt_proj_init_(dt_proj: nn.Linear, generator: torch.Generator,
                  dt_min: float = 0.001, dt_max: float = 0.1,
                  dt_init_floor: float = 1e-4) -> None:
    """mamba_simple's dt projection init (the JAX package's
    ``_dt_proj_init``): weight U(-rank^-0.5, rank^-0.5); bias =
    softplus^-1(dt) with dt log-uniform in [dt_min, dt_max], floored at
    ``dt_init_floor``."""
    w = dt_proj.weight
    std = w.shape[1] ** -0.5
    w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * std)
    u = torch.rand(dt_proj.bias.shape, generator=generator)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=dt_init_floor)
    dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
