"""Fused-head windowed blend (K1): CUDA kernel wrapper, plain version and
autograd.

Counterpart of ``class_query_vad_tpu/ops/fast_deform_pallas.py``
``windowed_blend_fused_head`` (``_fused2d`` :1536 and its custom_vjp; TPU
kernel ``_fused_kernel_2d``, :1413).  The kernel is ``csrc/fused_blend2d.cu``;
what it computes, what bounds it and its design are in that file's header.

``fused_blend2d`` is differentiable.  Its forward takes a CUDA tensor to
the kernel and a CPU tensor to ``fused_blend2d_reference``; anything else
raises; ``kernels=False`` (the configuration's ``MODEL.FAST_USE_PALLAS:
false``) takes the plain version on any device, backward included.  Its
backward follows the JAX package's ``_fused2d_bwd`` (:1569):
it recomputes the offsets and weights from the saved head lanes with plain
torch ops (``fused_components``, the front half of ``_fused2d_composite``
:1509), takes the blend's backward on them directly (K3 and K4 on the card,
``ops.blend2d``; the blend's output itself is not needed, so K2 does not
run) and pushes that back through the recompute.  There is no fallback: on
the card it launches the kernels or raises.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .blend2d import (
    blend2d_backward,
    blend2d_reference,
    check_kernel_args,
    fwd_block,
)
from .cuda_build import device_of, launch, plain_version

_POINTS = 8


def _shapes(vol: torch.Tensor, fused: torch.Tensor, nh: int):
    if vol.dim() != 6 or fused.dim() != 5:
        raise ValueError(
            f"vol must be [B, J, T, H, W, C] and fused [B, T, H, W, 3*J*kp]; "
            f"got {tuple(vol.shape)} and {tuple(fused.shape)}")
    b, jl, t, h, w, c = vol.shape
    if tuple(fused.shape[:4]) != (b, t, h, w):
        raise ValueError(f"fused {tuple(fused.shape)} does not match vol "
                         f"{tuple(vol.shape)}")
    if c % nh:
        raise ValueError(f"C={c} is not a multiple of nh={nh}")
    if fused.shape[-1] % (3 * jl):
        raise ValueError(f"fused lanes {fused.shape[-1]} not 3*J*kp (J={jl})")
    kp = fused.shape[-1] // (3 * jl)
    if kp % nh:
        raise ValueError(f"kp={kp} is not a multiple of nh={nh}")
    return b, jl, t, h, w, c, kp


def fused_components(fused: torch.Tensor, jl: int, nh: int = 8,
                     radius: float = 1.0, nc: int = 2):
    """The offsets and weights of the fused head's lanes, as the JAX
    package's fast encoder computes them (fast_encoder.py:196-250; K1's
    front end, ``_fused2d_composite`` :1517-1531, for nc=2).  ``fused``
    [B, T, H, W, (nc+1)*J*kp] holds nc offset components in (level,
    component x/y[/t], head, point) lane order, then the weight logits in
    (level, head, point) order.  Offsets are ``radius * tanh`` in
    ``fused``'s dtype; the weights the softmax over (level, point) per head
    in float32, after subtracting the max over all weight lanes with no
    gradient, cast to ``fused``'s dtype.  Returns dx, dy, a (nc=2) or dx,
    dy, dt, a (nc=3), each [B, J, T, H, W, kp]."""
    kp = fused.shape[-1] // ((nc + 1) * jl)
    n_off = nc * jl * kp
    raw = radius * torch.tanh(fused[..., :n_off])
    logits = fused[..., n_off:].float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    lanes = e.shape[:-1]
    e = e.reshape(*lanes, jl, nh, kp // nh)
    a = (e / e.sum(dim=(-3, -1), keepdim=True)).reshape(*lanes, jl * kp)
    a = a.to(fused.dtype)
    offsets = [torch.stack([raw[..., (nc * j + k) * kp:(nc * j + k + 1) * kp]
                            for j in range(jl)], dim=1) for k in range(nc)]
    a = torch.stack([a[..., j * kp:(j + 1) * kp] for j in range(jl)], dim=1)
    return (*offsets, a)


def fused_blend2d_reference(vol: torch.Tensor, fused: torch.Tensor,
                            nh: int = 8, radius: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    ``_fused2d_composite``): ``fused_components`` — so bf16 head lanes give
    bf16 offsets and weights, as the kernel rounds them — then the 9-tap
    blend with zero borders.  Any device; returns float32 [B, T, H, W, C]."""
    jl = _shapes(vol, fused, nh)[1]
    return blend2d_reference(vol, *fused_components(fused, jl, nh, radius), nh)


def _fused_blend2d_forward(vol, fused, nh: int, radius: float,
                           kernels: bool = True):
    """K1 on CUDA tensors, the plain version on CPU tensors or when not
    ``kernels``."""
    b, jl, t, h, w, c, kp = _shapes(vol, fused, nh)
    if device_of(vol, fused) == "cpu" or not kernels:
        return plain_version(kernels, fused_blend2d_reference, vol, fused, nh,
                             radius)
    check_kernel_args(nh, c, jl, vol.dtype, {"vol": vol, "fused": fused})
    if kp != nh * _POINTS:
        raise ValueError(f"the kernel takes kp=64; got kp={kp}")
    out = torch.empty((b, t, h, w, c), dtype=torch.float32, device=vol.device)
    sms = torch.cuda.get_device_properties(vol.device).multi_processor_count
    launch("fused_blend2d", vol.device, vol.data_ptr(), fused.data_ptr(),
           out.data_ptr(), int(vol.dtype == torch.bfloat16), b, jl, t, h, w,
           float(radius), *fwd_block(b, t, h, w, sms))
    fused_blend2d.launches += 1
    return out


class _FusedBlend2d(torch.autograd.Function):
    """K1 forward with the JAX package's residuals (vol, fused); backward
    by recompute + K3/K4 (see the module docstring)."""

    @staticmethod
    def forward(ctx, vol, fused, nh, radius, kernels):
        ctx.save_for_backward(vol, fused)
        ctx.nh, ctx.radius, ctx.kernels = nh, radius, kernels
        return _fused_blend2d_forward(vol, fused, nh, radius, kernels)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        vol, fused = ctx.saved_tensors
        need_vol, need_fused = ctx.needs_input_grad[:2]
        jl = vol.shape[1]
        with torch.enable_grad():
            f = fused.detach().requires_grad_(need_fused)
            comps = fused_components(f, jl, ctx.nh, ctx.radius)
        dvol, *dcomps = blend2d_backward(
            vol, *(x.detach() for x in comps), g, ctx.nh,
            need_vol=need_vol, need_comps=need_fused, kernels=ctx.kernels)
        dfused = None
        if need_fused:
            (dfused,) = torch.autograd.grad(comps, f, dcomps)
        return dvol, dfused, None, None, None


def fused_blend2d(vol: torch.Tensor, fused: torch.Tensor, nh: int = 8,
                  radius: float = 1.0, kernels: bool = True) -> torch.Tensor:
    """vol [B, J, T, H, W, C] (value levels aligned onto this query grid),
    fused [B, T, H, W, 3*J*kp] (raw offset+weight head lanes) ->
    float32 [B, T, H, W, C], differentiable in vol and fused; the plain
    version on any device when not ``kernels``."""
    return _FusedBlend2d.apply(vol, fused, nh, radius, kernels)


fused_blend2d.launches = 0
