"""Native cross-level windowed blend: kernels K10 (2d window) and K11 (3d
window), their plain PyTorch version and the autograd wiring.

Counterpart of ``class_query_vad_tpu/ops/fast_deform_pallas.py``
``windowed_blend_native`` (:490) with the custom VJPs of its two entries
(``_native_blend2d_pallas_entry`` :587 / ``_native_entry_bwd`` :631 and
``_native_blend3d_pallas_entry`` :650 / ``_native3_bwd`` :690): every
value level is sampled at its own resolution at the query's
align_corners=False-mapped position plus offsets of under one native pixel
(and frame), 4 x 4 spatial taps per level.  The TPU kernels are
``_native_kernel_2d`` (K10, :274) and ``_native_kernel_3d`` (K11, :342); on
the card one CUDA source, ``csrc/native_blend.cu``, holds both, and one
launch per query grid covers every level.  What it computes, what bounds it
and its design are in that file's header.

Shapes: values per level [B, T, Hv, Wv, C] (equal B and T); components dx,
dy, (dt,) a [B, J, T, H, W, nh*P] on the query grid; output float32 [B, T,
H, W, C].

``native_blend`` is differentiable.  Its forward takes CPU tensors to the
plain version (the sum over levels of ``fast_deform.native_blend_level``)
and CUDA tensors to K10 (``dt=None``) or K11; anything else raises.  There
is no fallback: on the card it launches a kernel or raises, unless called
with ``kernels=False`` (the configuration's ``MODEL.FAST_USE_PALLAS:
false``), which takes the plain version on any device.  The JAX
package has no backward kernel for this mode: its VJP is the oracle's, and
so is the port's (the plain version recomputed from the saved inputs under
autograd, one level at a time; on the card that runs eager torch ops).
``native_blend2d`` and ``native_blend3d`` launch the kernels and count
their launches in ``.launches``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from .blend2d import check_kernel_args
from .cuda_build import device_of, launch, plain_version
from .fast_deform import native_blend_level, native_tables_on

_POINTS, _PASS = 8, 256


def _shapes(values: Sequence[torch.Tensor], comps: Sequence[torch.Tensor],
            nh: int):
    dx = comps[0]
    if dx.dim() != 6 or any(x.shape != dx.shape for x in comps):
        raise ValueError(
            f"the components must share one shape [B, J, T, H, W, nh*P]; "
            f"got {[tuple(x.shape) for x in comps]}")
    b, jl, t, h, w, kp = dx.shape
    if len(values) != jl:
        raise ValueError(f"{len(values)} value levels for J={jl} components")
    c = values[0].shape[-1]
    for v in values:
        if v.dim() != 5 or (v.shape[0], v.shape[1], v.shape[4]) != (b, t, c):
            raise ValueError(f"value levels must be [B={b}, T={t}, Hv, Wv, "
                             f"C={c}]; got {tuple(v.shape)}")
    if c % nh or kp % nh:
        raise ValueError(f"C={c} and kp={kp} must be multiples of nh={nh}")
    return b, jl, t, h, w, c, kp


def native_blend_reference(values: Sequence[torch.Tensor], dx: torch.Tensor,
                           dy: torch.Tensor, a: torch.Tensor, nh: int = 8,
                           dt: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K10 (``dt=None``) and K11: the sum over
    levels of ``native_blend_level``.  Any device; float32 [B, T, H, W, C]."""
    out = None
    for j, v in enumerate(values):
        contrib = native_blend_level(v, dx[:, j], dy[:, j], a[:, j], nh,
                                     dt=None if dt is None else dt[:, j])
        out = contrib if out is None else out + contrib
    return out


def _launch(name: str, values, comps, nh: int) -> torch.Tensor:
    """One launch of K10 or K11 on CUDA tensors; checks what the kernel
    takes: nh=8, C a multiple of 256, kp=64, 1<=J<=4, float32 or bf16
    values and components of one dtype, contiguous components, levels dense
    past their batch axis, everything 16-byte aligned."""
    b, jl, t, h, w, c, kp = _shapes(values, comps, nh)
    named = dict(zip(("dx", "dy", "dt", "a") if len(comps) == 4
                     else ("dx", "dy", "a"), comps))
    if c % _PASS or kp != nh * _POINTS:
        raise ValueError(f"the kernels take C a multiple of 256 and kp=64; "
                         f"got C={c}, kp={kp}")
    # K1-K4's rules (nh, J, dtype, layout); C was checked above
    check_kernel_args(nh, _PASS, jl, comps[0].dtype, named)
    for j, v in enumerate(values):
        if v.dtype != comps[0].dtype:
            raise ValueError(f"value level {j} must be {comps[0].dtype}; "
                             f"got {v.dtype}")
        if not v[0].is_contiguous():
            raise ValueError(f"value level {j} must be dense past its batch axis")
        if v.data_ptr() % 16 or (v.stride(0) * v.element_size()) % 16:
            raise ValueError(f"value level {j} must be 16-byte aligned")
    base, phi = native_tables_on(
        h, w, tuple((v.shape[2], v.shape[3]) for v in values), comps[0].device)
    pad = 4 - jl
    out = torch.empty((b, t, h, w, c), dtype=torch.float32,
                      device=comps[0].device)
    launch(name, comps[0].device, *(v.data_ptr() for v in values),
           *([None] * pad), *(v.stride(0) for v in values), *([0] * pad),
           *(x.data_ptr() for x in comps), base.data_ptr(), phi.data_ptr(),
           out.data_ptr(), int(comps[0].dtype == torch.bfloat16), b, jl, t,
           h, w, c)
    return out


def native_blend2d(values: Sequence[torch.Tensor], dx: torch.Tensor,
                   dy: torch.Tensor, a: torch.Tensor,
                   nh: int = 8) -> torch.Tensor:
    """K10 on CUDA tensors: the 2d-window native blend, float32 [B, T, H, W,
    C].  Not differentiable; ``native_blend`` is the entry point."""
    out = _launch("native_blend2d", values, (dx, dy, a), nh)
    native_blend2d.launches += 1
    return out


def native_blend3d(values: Sequence[torch.Tensor], dx: torch.Tensor,
                   dy: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   nh: int = 8) -> torch.Tensor:
    """K11 on CUDA tensors: the 3d-window native blend, float32 [B, T, H, W,
    C].  Not differentiable; ``native_blend`` is the entry point."""
    out = _launch("native_blend3d", values, (dx, dy, dt, a), nh)
    native_blend3d.launches += 1
    return out


native_blend2d.launches = 0
native_blend3d.launches = 0


class _NativeBlend(torch.autograd.Function):
    """K10/K11 (or the plain version on the CPU) forward; the backward of
    the JAX package's ``_native_entry_bwd`` / ``_native3_bwd``: the VJP of
    the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, nh, kernels, dx, dy, dt, a, *values):
        comps = (dx, dy, a) if dt is None else (dx, dy, dt, a)
        ctx.nh = nh
        ctx.save_for_backward(dx, dy, dt, a, *values)
        _shapes(values, comps, nh)
        if device_of(*values, *comps) == "cpu" or not kernels:
            return plain_version(kernels, native_blend_reference, values, dx,
                                 dy, a, nh, dt)
        if dt is None:
            return native_blend2d(values, dx, dy, a, nh)
        return native_blend3d(values, dx, dy, dt, a, nh)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dx, dy, dt, a, *values = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]       # dx, dy, dt, a, values...
        g = g.float()
        grads = [[] for _ in range(4)]
        dvalues = []
        for j, v in enumerate(values):
            with torch.enable_grad():
                comps = [None if x is None else x[:, j].detach()
                         .requires_grad_(n) for x, n in zip((dx, dy, dt, a),
                                                            need)]
                vj = v.detach().requires_grad_(need[4 + j])
                out = native_blend_level(vj, comps[0], comps[1], comps[3],
                                         ctx.nh, dt=comps[2])
                leaves = [x for x in (*comps, vj)
                          if x is not None and x.requires_grad]
                got = iter(torch.autograd.grad(out, leaves, g) if leaves
                           else ())
            for k, x in enumerate(comps):
                grads[k].append(next(got) if x is not None and x.requires_grad
                                else None)
            dvalues.append(next(got) if vj.requires_grad else None)
        stacked = [torch.stack(gs, dim=1) if gs and gs[0] is not None
                   else None for gs in grads]
        return (None, None, *stacked, *dvalues)


def native_blend(values: Sequence[torch.Tensor], dx: torch.Tensor,
                 dy: torch.Tensor, a: torch.Tensor, nh: int = 8,
                 dt: torch.Tensor | None = None,
                 kernels: bool = True) -> torch.Tensor:
    """Native cross-level blend of one query grid: values per level [B, T,
    Hv, Wv, C] at their own resolution, dx, dy, (dt,) a [B, J, T, H, W,
    nh*P] -> float32 [B, T, H, W, C]; ``dt=None`` is the 2d window (K10 on
    the card), else the 3d window (K11); the plain version on any device
    when not ``kernels``.  Differentiable in every input."""
    return _NativeBlend.apply(nh, kernels, dx, dy, dt, a, *values)
