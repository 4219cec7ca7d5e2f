"""Channel-separated network (ir-CSN-50 / ir-CSN-152) video backbone
(counterpart of ``class_query_vad_tpu/models/csn.py``).

* stem: 3x7x7 conv, stride (1, 2, 2), padding (1, 3, 3), norm, ReLU, 1x3x3
  max pool, stride (1, 2, 2), padding (0, 1, 1) (padded with -inf, as
  flax's ``max_pool`` pads);
* bottleneck: 1x1x1 conv -> norm -> ReLU -> DEPTHWISE 3x3x3 conv
  (``groups=planes``), stride (t_s, s, s) -> norm -> ReLU -> 1x1x1 conv
  (x4) -> norm, plus the projection shortcut ``down_sample`` (1x1x1 conv,
  norm) on each stage's first block, then ReLU;
* stages (3, 4, 6, 3) (CSN-50) / (3, 8, 36, 3) (CSN-152) of 64, 128, 256
  and 512 planes; layer1 stride 1, layers 2-4 stride 2 in space and time
  (``last_stride`` off: layer4 keeps its spatial size);
* the output is the [layer1 .. layer4] pyramid, channels-last
  [B, T_l, H_l, W_l, C_l].

Layout: the JAX package is channels-last, torch's ``Conv3d`` NCDHW.  The
clip is permuted once on the way in and each level once on the way out.
Inside, the trunk runs in NCDHW (``CSN.memory_format``): in
``torch.channels_last_3d`` (weights and activations) cuDNN took 4-6x as long
for CSN-152's bf16 forward on an H100 (``chip_smoke.py`` phase 34).

Norms (``CSNBatchNorm``, eps 1e-3; ``Affine`` with ``use_affine``) keep
their parameters and running statistics float32 whatever the convolutions'
dtype: scale and bias are formed in float32, then cast to the compute
dtype, as flax's float32 params are.  In ``train()`` the batch statistics
over (B, T, H, W) normalise, in float32, with the variance E[x^2] - mean^2
(biased); the running statistics are buffers and never updated (the JAX
package keeps them frozen too).  Not ``nn.BatchNorm3d``: its train mode
updates the running statistics and computes the variance another way.

With ``remat`` (``CONFIG.GRADIENT_CHECKPOINTING``) each bottleneck is
recomputed in the backward (``torch.utils.checkpoint``, non-reentrant).
Parameter names are the reference's (``backbone.0.body.conv1``,
``layer{s}.{b}.conv3``, ``layer{s}.{b}.down_sample.{0,1}``, ...).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from .. import parallel
from .common import remat_call

CSN_BLOCKS = {"50": (3, 4, 6, 3), "152": (3, 8, 36, 3)}
EXPANSION = 4


class Affine(nn.Module):
    """The frozen-BN replacement: y = x * w + b per channel (``use_affine``;
    its JAX init draws w and b from N(0, 1))."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        return (x * self.weight.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))


class CSNBatchNorm(nn.Module):
    """BatchNorm3d (eps 1e-3) over NCDHW: ``eval()`` normalises by the
    running statistics, ``train()`` by the batch's (biased variance,
    float32); the running statistics are never updated.

    The statistics are taken as float32 sums of x and x² over (B, T, H,
    W) and the element count, then divided.  Sync-BN: under a process
    group those sums are summed over the ranks first
    (``parallel.all_reduce_sum``, through which the gradient flows), so
    the statistics span the global batch, as the JAX package's do under a
    mesh; one rank's sum is the identity, so at world 1 the arithmetic is
    the same bit for bit (``class_query_vad_tpu/models/csn.py:76-82``)."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # float32 statistics (float64 for a float64 input)
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = (0,) + tuple(range(2, x.ndim))
            c = x.shape[1]
            stats = torch.cat([xf.sum(axes), xf.square().sum(axes),
                               xf.new_full((1,), x.numel() // c)])
            if parallel.is_distributed():
                stats = parallel.all_reduce_sum(stats)
            mean = stats[:c] / stats[-1]
            var = stats[c:2 * c] / stats[-1] - mean.square()
        else:
            mean, var = self.running_mean, self.running_var
        inv = self.weight / torch.sqrt(var + self.eps)
        shape = (-1,) + (1,) * (x.ndim - 2)
        scale = inv.to(x.dtype).reshape(shape)
        bias = (self.bias - mean * inv).to(x.dtype).reshape(shape)
        return x * scale + bias


def make_norm(use_affine: bool, features: int) -> nn.Module:
    return Affine(features) if use_affine else CSNBatchNorm(features)


def conv3d(cin: int, cout: int, kernel, stride=1, padding=0,
           groups: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride, padding, groups=groups,
                     bias=False)


class CSNBottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 temporal_stride: int = 1, has_downsample: bool = False,
                 use_affine: bool = False):
        super().__init__()
        strides = (temporal_stride, stride, stride)
        self.conv1 = conv3d(inplanes, planes, 1)
        self.bn1 = make_norm(use_affine, planes)
        self.conv3 = conv3d(planes, planes, 3, strides, 1, groups=planes)
        self.bn3 = make_norm(use_affine, planes)
        self.conv4 = conv3d(planes, planes * EXPANSION, 1)
        self.bn4 = make_norm(use_affine, planes * EXPANSION)
        # one module for the block's three ReLUs (a hook sees each call)
        self.relu = nn.ReLU()
        self.down_sample = (nn.Sequential(
            conv3d(inplanes, planes * EXPANSION, 1, strides),
            make_norm(use_affine, planes * EXPANSION))
            if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn3(self.conv3(out)))
        out = self.bn4(self.conv4(out))
        residual = x if self.down_sample is None else self.down_sample(x)
        return self.relu(out + residual)


class CSN(nn.Module):
    """ir-CSN trunk: clip [B, T, H, W, 3] -> [layer1 .. layer4], each
    [B, T_l, H_l, W_l, C_l] in the convolutions' dtype."""

    # the activations' layout inside the trunk (see the module docstring)
    memory_format = torch.contiguous_format

    def __init__(self, block_nums: Sequence[int] = CSN_BLOCKS["152"],
                 last_stride: bool = True, use_affine: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3))
        self.bn1 = make_norm(use_affine, 64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        stages = [(64, 1, 1), (128, 2, 2), (256, 2, 2),
                  (512, 2 if last_stride else 1, 2)]
        inplanes = 64
        for s, ((planes, stride, t_stride), n) in enumerate(
                zip(stages, block_nums)):
            blocks = []
            for b in range(n):
                blocks.append(CSNBottleneck(
                    inplanes, planes, stride if b == 0 else 1,
                    t_stride if b == 0 else 1, b == 0, use_affine))
                inplanes = planes * EXPANSION
            self.add_module(f"layer{s + 1}", nn.ModuleList(blocks))

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        x = pixels.to(self.conv1.weight.dtype).permute(0, 4, 1, 2, 3)
        x = x.contiguous(memory_format=self.memory_format)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        features = []
        for s in range(1, 5):
            for block in getattr(self, f"layer{s}"):
                x = remat_call(self.remat, block, x)
            features.append(x.permute(0, 2, 3, 4, 1))
        return features


def build_csn(name: str, last_stride: bool = True, use_affine: bool = False,
              remat: bool = False) -> CSN:
    """CSN-152 when ``name`` holds "152", else CSN-50 (as the JAX
    package's ``build_csn``)."""
    return CSN(CSN_BLOCKS["152" if "152" in name else "50"], last_stride,
               use_affine, remat)


class CSNBackbone(nn.Module):
    """``backbone.0`` of a CSN DETR: the trunk as ``body``."""

    def __init__(self, spec):
        super().__init__()
        self.body = build_csn(spec.backbone_name, spec.last_stride,
                              remat=spec.gradient_checkpointing)

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        return self.body(pixels)


class InputProjections(nn.ModuleList):
    """``input_proj.{i}.{0,1}`` (JAX ``detr.py:67-92``, ``:182-194``): a
    1x1x1 conv with bias over each of layers 2-4 and a 3x3x3 conv, stride
    (1, 2, 2), padding 1, over layer 4 as the extra level, each followed by
    GroupNorm(32, eps 1e-5); all float32, on a float32 copy of the feature.
    Levels in and out channels-last."""

    def __init__(self, in_channels: Sequence[int], d_model: int):
        super().__init__()
        for c in in_channels:
            self.append(nn.Sequential(nn.Conv3d(c, d_model, 1),
                                      nn.GroupNorm(32, d_model, eps=1e-5)))
        self.append(nn.Sequential(
            nn.Conv3d(in_channels[-1], d_model, 3, (1, 2, 2), 1),
            nn.GroupNorm(32, d_model, eps=1e-5)))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        levels = list(feats[1:]) + [feats[-1]]
        return [proj(f.float().permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
                for proj, f in zip(self, levels)]


def keep_norms_float32(module: nn.Module) -> nn.Module:
    """After ``module.to(dtype)``: the CSN norms' parameters and running
    statistics back to float32 (the JAX package's params stay float32)."""
    for mod in module.modules():
        if isinstance(mod, (CSNBatchNorm, Affine)):
            mod.float()
    return module

