"""Fast deformable encoder — windowed multi-scale attention over level grids
(counterpart of ``class_query_vad_tpu/models/fast_encoder.py``).

``FastDeformAttn3D`` takes the JAX package's routes (fast_encoder.py:
172-284):

* fused (``FAST_CROSS_LEVEL: resample``, ``FAST_WINDOW: 2d``, radius 1,
  nh=8, C a multiple of 256, points a multiple of 8 — the
  ``AVA22_ViT-B_fast`` main path; :175-194): every value level is aligned
  onto each query grid, and one K1 launch per query grid
  (``ops.fast_deform_cuda.fused_blend2d``) computes the tanh offsets, the
  per-head softmax and the 9-tap blend over all levels;
* components, resample, radius 1 (the 2d window at any other shape, and
  the 3d window, which never takes the fused route; :196-263): tanh and the
  softmax in torch (``fused_components``, K1's plain front end), the
  per-level dx, dy, (dt,) a stacks, and the blend of the aligned levels
  through K2 (2d, ``ops.blend2d.blend2d``) or K6 (3d, 27 taps,
  ``ops.blend3d.blend3d``, which also serves the JAX package's K7);
* general radius, resample (``FAST_RADIUS`` > 1, either window;
  :264-282): the same components, scaled by the radius, and the aligned
  levels blended over the (2R+1)^2 (2d) or (2R+1)^3 (3d) window by
  ``ops.fast_deform.windowed_blend_fused``, plain PyTorch as in JAX (no
  kernel there); it takes precedence over K1, K2 and K6, which are radius 1
  only;
* native (``FAST_CROSS_LEVEL: native``, 2d or 3d window; :196-257): the
  same components (dx, dy, dt, a with the 3d window), no alignment, and
  one launch per query grid of K10 (2d) or K11 (3d) over every level at
  its own resolution (``ops.native_blend.native_blend``).

``MODEL.FAST_USE_PALLAS: false`` (``use_kernels=False``) keeps every
route but takes each one's plain version on any device, its backward too,
as the JAX package's flag takes its XLA-oracle blend (fast_encoder.py:172);
the default sends CUDA tensors to the kernels.

All are differentiable: the radius-1 resample routes' backward runs K3 and
K4 (2d) or K8 and K9 (3d), the general-radius and native routes' are the
VJPs of their plain versions, as in the JAX package.  As in JAX, the
native mode raises ``ValueError`` for radius != 1 and for levels of
unequal T.

The encoder carries ONE flattened token stream [B, sum(t*h*w), C] across
layers; post-norm residual layers as in the reference's deformable
encoder layer, with the JAX package's three dropouts (active in
``train()`` mode).

Lane layouts of the fused offset+weight head (fast_encoder.py:112-119):
offsets in (level, component x/y[/t], head, point) order in lanes
[0, nl*nc*kp) (nc = 2, or 3 with the 3d window), weight logits in (level,
head, point) order after them.  ``window_offsets``/``window_weights`` hold
those two heads; the reference has no counterpart (its unconstrained
sampler's heads have another layout and width).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.blend2d import blend2d
from ..ops.blend3d import blend3d
from ..ops.fast_deform import align_all_levels, windowed_blend_fused
from ..ops.fast_deform_cuda import fused_blend2d, fused_components
from ..ops.native_blend import native_blend
from .common import LayerNorm, Linear

Shapes = Tuple[Tuple[int, int, int], ...]     # per level (T, H, W)


def split_levels(flat: torch.Tensor, shapes: Shapes) -> List[torch.Tensor]:
    """[B, N, ...] -> per level [B, T, H, W, ...] along the token axis."""
    out, start = [], 0
    for t, h, w in shapes:
        n = t * h * w
        out.append(flat[:, start : start + n].reshape(
            (flat.shape[0], t, h, w) + tuple(flat.shape[2:])))
        start += n
    return out


class FastDeformAttn3D(nn.Module):
    """Windowed multi-scale deformable self-attention over level grids
    (``window`` "2d": (x, y) taps; "3d": (x, y, t) taps)."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 8, radius: int = 1,
                 window: str = "2d", cross_level: str = "resample",
                 use_kernels: bool = True):
        super().__init__()
        if window not in ("2d", "3d") or cross_level not in ("resample",
                                                             "native"):
            raise ValueError(f"unknown FAST_WINDOW {window!r} or "
                             f"FAST_CROSS_LEVEL {cross_level!r}")
        self.native = cross_level == "native"
        if self.native and radius != 1:
            raise ValueError("cross_level='native' supports radius=1 only")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points, self.radius = n_heads, n_points, radius
        self.use_kernels = use_kernels
        self.nc = 3 if window == "3d" else 2
        # the JAX package's fused-route conditions (fast_encoder.py:175-176)
        self.fused_route = (not self.native and self.nc == 2 and radius == 1
                            and n_heads == 8 and d_model % 256 == 0
                            and n_points % 8 == 0)
        kp = n_heads * n_points
        self.value_proj = Linear(d_model, d_model)
        self.window_offsets = Linear(d_model, n_levels * self.nc * kp)
        self.window_weights = Linear(d_model, n_levels * kp)
        self.output_proj = Linear(d_model, d_model)
        # the raw offset + weight-logit lanes pass through here, where a
        # forward hook can read them (chip_smoke.py's card-vs-CPU train
        # checks find the lanes whose taps differ between the two sides)
        self.head_lanes = nn.Identity()

    def forward(self, src: torch.Tensor, pos: torch.Tensor, shapes: Shapes,
                mask: torch.Tensor | None) -> torch.Tensor:
        nh, nl, np_, nc = self.n_heads, self.n_levels, self.n_points, self.nc
        kernels = self.use_kernels
        kp = nh * np_
        n_off = nl * nc * kp
        b = src.shape[0]
        dt = self.value_proj.weight.dtype
        if self.native and len({t for t, _, _ in shapes}) != 1:
            # the native sampler reads each level at the query's own frame
            raise ValueError(f"cross_level='native' needs equal T on all "
                             f"levels, got {shapes}")

        values = self.value_proj(src)
        if mask is not None:
            values = values.masked_fill(mask[..., None], 0.0)
        values = split_levels(values, shapes)

        # one fused offset+weight head matmul over the whole stream
        head_w = torch.cat([self.window_offsets.weight,
                            self.window_weights.weight], dim=0)
        head_b = torch.cat([self.window_offsets.bias,
                            self.window_weights.bias])
        fused = self.head_lanes(F.linear((src + pos).to(dt), head_w, head_b))
        # PER-HEAD max subtraction on the weight-logit lanes, once, at the
        # producer, with no gradient (as the JAX package's stop_gradient):
        # the softmax then sees per-head denominators >= 1.  A global max
        # alone lets low heads' exp underflow to denormals once head logit
        # ranges spread, and training NaNs.
        lg = fused[..., n_off:].float().reshape(*fused.shape[:-1], nl, nh, np_)
        lg = lg - lg.amax(dim=(-3, -1), keepdim=True).detach()
        fused = torch.cat(
            [fused[..., :n_off], lg.reshape(*fused.shape[:-1], nl * kp).to(dt)],
            dim=-1)
        fused_levels = split_levels(fused, shapes)

        if self.native:
            outs = []
            for i, (t, h, w) in enumerate(shapes):
                comps = fused_components(fused_levels[i].contiguous(), nl, nh,
                                         float(self.radius), nc)
                out = native_blend(values, comps[0], comps[1], comps[-1], nh,
                                   dt=comps[2] if nc == 3 else None,
                                   kernels=kernels)
                outs.append(out.to(dt).reshape(b, t * h * w, self.d_model))
            return self.output_proj(torch.cat(outs, dim=1))

        grids = [(h, w) for _, h, w in shapes]
        aligned_all = align_all_levels(values, grids)
        outs = []
        for i, (t, h, w) in enumerate(shapes):
            vol = torch.stack(aligned_all[i], dim=1)        # [B, J, T, H, W, C]
            lanes = fused_levels[i].contiguous()
            if self.fused_route:
                out = fused_blend2d(vol, lanes, nh, float(self.radius),
                                    kernels=kernels)
            else:
                comps = fused_components(lanes, nl, nh, float(self.radius), nc)
                if self.radius == 1:
                    out = (blend3d if nc == 3 else blend2d)(vol, *comps, nh,
                                                            kernels)
                else:
                    out = self._general_radius(aligned_all[i], comps)
            outs.append(out.to(dt).reshape(b, t * h * w, self.d_model))
        return self.output_proj(torch.cat(outs, dim=1))

    def _general_radius(self, aligned: Sequence[torch.Tensor],
                        comps) -> torch.Tensor:
        """The JAX package's ``r != 1`` branch (fast_encoder.py:264-282):
        components [B, J, T, H, W, nh*P] to the (head, level, point)
        layout of ``windowed_blend_fused``; the 2d window passes (x, y)
        only, which JAX writes as dt = 0."""
        nh, np_ = self.n_heads, self.n_points
        b, jl, t, h, w, _ = comps[0].shape
        offsets = torch.stack(comps[:-1], dim=-1).reshape(
            b, jl, t, h, w, nh, np_, len(comps) - 1).permute(
            0, 2, 3, 4, 5, 1, 6, 7)
        weights = comps[-1].reshape(b, jl, t, h, w, nh, np_).permute(
            0, 2, 3, 4, 5, 1, 6)
        headed = [v.reshape(*v.shape[:4], nh, -1) for v in aligned]
        out = windowed_blend_fused(headed, offsets, weights, self.radius)
        return out.reshape(b, t, h, w, self.d_model)


class FastEncoderLayer(nn.Module):
    """Windowed deformable self-attention + FFN, post-norm, with dropout
    after the attention, inside the FFN and after it (fast_encoder.py:
    314-332)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 2048,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 8,
                 radius: int = 1, window: str = "2d",
                 cross_level: str = "resample", dropout: float = 0.1,
                 use_kernels: bool = True):
        super().__init__()
        self.self_attn = FastDeformAttn3D(d_model, n_levels, n_heads,
                                          n_points, radius, window,
                                          cross_level, use_kernels)
        self.dropout1 = nn.Dropout(dropout)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.dropout2 = nn.Dropout(dropout)
        self.linear2 = Linear(d_ffn, d_model)
        self.dropout3 = nn.Dropout(dropout)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, shapes: Shapes, mask):
        x = self.norm1(src + self.dropout1(self.self_attn(src, pos, shapes, mask)))
        y = self.linear2(self.dropout2(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout3(y))


class FastDeformableEncoder(nn.Module):
    """Stack of windowed deformable layers over per-level grids."""

    def __init__(self, num_layers: int = 6, d_model: int = 256,
                 d_ffn: int = 2048, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 8, radius: int = 1, window: str = "2d",
                 cross_level: str = "resample", dropout: float = 0.1,
                 use_kernels: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            FastEncoderLayer(d_model, d_ffn, n_levels, n_heads, n_points,
                             radius, window, cross_level, dropout,
                             use_kernels)
            for _ in range(num_layers)
        )

    def forward(self, src_levels: Sequence[torch.Tensor],
                pos_levels: Sequence[torch.Tensor],
                mask_levels: Sequence[torch.Tensor] | None) -> List[torch.Tensor]:
        b, c = src_levels[0].shape[0], src_levels[0].shape[-1]
        shapes = tuple(tuple(s.shape[1:4]) for s in src_levels)
        x = torch.cat([s.reshape(b, -1, c) for s in src_levels], dim=1)
        pos = torch.cat([p.reshape(b, -1, c) for p in pos_levels], dim=1)
        mask = (torch.cat([m.reshape(b, -1) for m in mask_levels], dim=1)
                if mask_levels is not None else None)
        for layer in self.layers:
            x = layer(x, pos, shapes, mask)
        return split_levels(x, shapes)
