"""Radius-1 spatial (2d) window blend from per-level components and its
backward: kernels K2, K3 and K4, their plain PyTorch versions, and the
autograd wiring.

Counterpart of ``class_query_vad_tpu/ops/fast_deform_pallas.py``
``_blend2d`` (:902) with its ``custom_vjp`` (:918-939): the forward is the
TPU kernel ``_blend_kernel_v2_2d`` (:186), the backward ``_bwd2d_dvol_kernel``
(:786) and ``_bwd2d_dcomps_kernel`` (:733).  The CUDA kernels are
``csrc/blend2d.cu``, ``csrc/blend2d_bwd_dvol.cu`` and
``csrc/blend2d_bwd_dcomps.cu``; what they compute, what bounds them and their
design are in those files' headers.

Shapes: vol [B, J, T, H, W, C]; components dx, dy, a [B, J, T, H, W, nh*P];
output and its cotangent G float32 [B, T, H, W, C].

Each wrapper takes CPU tensors to its plain version and CUDA tensors to its
kernel; anything else raises.  There is no fallback: on the card a wrapper
launches its kernel or raises.  Each counts its launches in ``.launches``.
The kernels take nh=8, C=256, 1<=J<=4 and any P; K2, K3 and K4 take
their block shape from the wrapper (``fwd_block``, ``k3_block``,
``k4_block``; K1's wrapper passes ``fwd_block``'s too).  ``blend2d`` with
``kernels=False`` (the configuration's ``MODEL.FAST_USE_PALLAS: false``)
takes the plain versions on any device, backward included.

Gradients follow XLA's subgradient conventions, as the JAX package's
kernels do (``hat_grad``), not torch autograd's of ``abs``/``clamp``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .cuda_build import device_of, launch, plain_version

_HEADS, _CHANNELS, _MAX_LEVELS = 8, 256, 4

# The block shapes (tile rows, tile columns, heads per block) that K3's and
# K4's launchers take (csrc/blend2d_bwd_dvol.cu, csrc/blend2d_bwd_dcomps.cu
# ``launch_shape``): a block owns a tile of one frame's positions and the
# 32 channels of each of its heads.  The first is for large grids, the
# second for small ones (``k3_block``, ``k4_block``).
# tests/test_torch_blend2d_tiled.py mirrors the kernels' order at each.
K3_SHAPES = ((4, 8, 2), (4, 4, 1))
K4_SHAPES = ((2, 8, 8), (4, 4, 1))


# The block shapes (tile rows, tile columns) that K1's and K2's launchers
# take (csrc/fused_blend2d.cu, csrc/blend2d.cu ``launch_shape``; their one
# tiled body, csrc/blend2d_fwd.cuh ``FwdShape``): a block owns a tile of
# one frame's queries and all eight heads, a warp per query.  The first is
# for large grids, the second for smaller ones (``fwd_block``).
# tests/test_torch_blend2d_fwd_tiled.py mirrors the kernels' order at each.
FWD_SHAPES = ((2, 4), (2, 2))


def _blocks(b: int, t: int, h: int, w: int, shape) -> int:
    """Blocks of K1, K2, K3 or K4 launched with ``shape``."""
    ty, tx, heads = (*shape, _HEADS)[:3]
    return b * t * -(-h // ty) * -(-w // tx) * (_HEADS // heads)


def fwd_block(b: int, t: int, h: int, w: int, sms: int):
    """K1's and K2's block shape at a [b, t, h, w] grid on a card of
    ``sms`` SMs: a 2x4 tile (8 warps; four blocks fit an SM) where its
    blocks fill every SM's four places at least once, else a 2x2 tile (4
    warps), twice the blocks, so that more SMs share a small grid."""
    if _blocks(b, t, h, w, FWD_SHAPES[0]) >= 4 * sms:
        return FWD_SHAPES[0]
    return FWD_SHAPES[1]


def k3_block(b: int, t: int, h: int, w: int, sms: int):
    """K3's block shape at a [b, t, h, w] grid on a card of ``sms`` SMs:
    a 4x8 tile of two heads (each staged component row a whole 32-byte
    sector at P = 8 in bf16), or a 4x4 tile of one head where that would
    leave some SMs without a block."""
    if _blocks(b, t, h, w, K3_SHAPES[0]) >= sms:
        return K3_SHAPES[0]
    return K3_SHAPES[1]


def k4_block(b: int, t: int, h: int, w: int, sms: int):
    """K4's block shape at a [b, t, h, w] grid on a card of ``sms`` SMs:
    a 2x8 tile of all eight heads (each component row written whole by one
    warp) where that gives every SM four blocks, else a 4x4 tile of one
    head."""
    if _blocks(b, t, h, w, K4_SHAPES[0]) >= 4 * sms:
        return K4_SHAPES[0]
    return K4_SHAPES[1]


def hat(u: torch.Tensor) -> torch.Tensor:
    """Bilinear tent max(0, 1 - |u|)."""
    return (1.0 - u.abs()).clamp(min=0.0)


def hat_grad(u: torch.Tensor) -> torch.Tensor:
    """d hat / du as XLA differentiates ``maximum(0, 1 - abs(u))``
    (fast_deform_pallas.py:750-756): abs'(0) = +1 and ``maximum`` splits a
    tie, so -1 on [0, 1), +1 on (-1, 0), -0.5 at u = 1, +0.5 at u = -1 and 0
    elsewhere.  torch's autograd of the same expression gives abs'(0) = 0
    and the whole gradient at |u| = 1."""
    au = u.abs()
    inner = torch.where(u >= 0, -1.0, 1.0).to(u.dtype)
    return torch.where(au < 1, inner, torch.where(au == 1, 0.5 * inner, 0.0))


def _shapes(vol: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
            a: torch.Tensor, nh: int):
    if vol.dim() != 6 or any(x.shape != dx.shape for x in (dy, a)):
        raise ValueError(
            f"vol must be [B, J, T, H, W, C] and dx, dy, a one shape "
            f"[B, J, T, H, W, nh*P]; got {tuple(vol.shape)}, "
            f"{tuple(dx.shape)}, {tuple(dy.shape)}, {tuple(a.shape)}")
    if tuple(dx.shape[:5]) != tuple(vol.shape[:5]):
        raise ValueError(f"components {tuple(dx.shape)} do not match vol "
                         f"{tuple(vol.shape)}")
    b, jl, t, h, w, c = vol.shape
    kp = dx.shape[-1]
    if c % nh or kp % nh:
        raise ValueError(f"C={c} and kp={kp} must be multiples of nh={nh}")
    return b, jl, t, h, w, c, kp


def check_kernel_args(nh: int, c: int, jl: int, dtype: torch.dtype,
                      named: dict) -> None:
    """What every kernel of K1-K4 takes: nh=8, C=256, 1<=J<=4, float32 or
    bf16 inputs of one dtype (a float32 cotangent ``g``), contiguous and
    16-byte aligned."""
    if (nh, c) != (_HEADS, _CHANNELS) or not 1 <= jl <= _MAX_LEVELS:
        raise ValueError(f"the kernels take nh=8, C=256, 1<=J<=4; got "
                         f"nh={nh}, C={c}, J={jl}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernels take float32 or bfloat16; got {dtype}")
    for name, x in named.items():
        want = torch.float32 if name == "g" else dtype
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}; got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _pad_hw(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the H and W axes ([..., H, W, lanes]) by one on each side."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def blend2d_reference(vol: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                      a: torch.Tensor, nh: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K2 (the JAX package's ``_blend_xla_vol_2d``,
    :709): the 9-tap blend with zero borders, in float32.  Any device;
    returns float32 [B, T, H, W, C]."""
    b, jl, t, h, w, c, kp = _shapes(vol, dx, dy, a, nh)
    d, p = c // nh, kp // nh
    vp = _pad_hw(vol.float())
    out = torch.zeros((b, t, h, w, nh, d), dtype=torch.float32,
                      device=vol.device)
    for j in range(jl):
        vj = vp[:, j].reshape(b, t, h + 2, w + 2, nh, d)
        dxj, dyj, aj = dx[:, j].float(), dy[:, j].float(), a[:, j].float()
        for sy in range(3):
            ay = aj * hat(dyj - (sy - 1))
            for sx in range(3):
                m = (ay * hat(dxj - (sx - 1))).reshape(b, t, h, w, nh, p).sum(-1)
                out = out + m[..., None] * vj[:, :, sy:sy + h, sx:sx + w]
    return out.reshape(b, t, h, w, c)


def blend2d_bwd_dvol_reference(dx: torch.Tensor, dy: torch.Tensor,
                               a: torch.Tensor, g: torch.Tensor,
                               vol_dtype: torch.dtype,
                               nh: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K3: dvol_j[q] = sum_d m_j(q + d, -d) *
    G(q + d), the transposed stencil of the forward (:786-820), summed in
    float32 and returned in ``vol_dtype`` [B, J, T, H, W, C]."""
    b, jl, t, h, w, kp = dx.shape
    c = g.shape[-1]
    d, p = c // nh, kp // nh
    gp = _pad_hw(g.float())
    dxp, dyp, ap = (_pad_hw(x.float()) for x in (dx, dy, a))
    out = []
    for j in range(jl):
        acc = torch.zeros((b, t, h, w, nh, d), dtype=torch.float32,
                          device=g.device)
        for iy in range(3):                 # neighbour q + (iy - 1, ix - 1)
            for ix in range(3):
                win = (slice(None), j, slice(None), slice(iy, iy + h),
                       slice(ix, ix + w))
                # the neighbour reaches q through its tap (1 - iy, 1 - ix)
                m = (ap[win] * hat(dyp[win] - (1 - iy))
                     * hat(dxp[win] - (1 - ix))).reshape(b, t, h, w, nh, p)
                gs = gp[:, :, iy:iy + h, ix:ix + w].reshape(b, t, h, w, nh, d)
                acc = acc + m.sum(-1)[..., None] * gs
        out.append(acc.reshape(b, t, h, w, c))
    return torch.stack(out, dim=1).to(vol_dtype)


def blend2d_bwd_dcomps_reference(vol: torch.Tensor, dx: torch.Tensor,
                                 dy: torch.Tensor, a: torch.Tensor,
                                 g: torch.Tensor, nh: int = 8):
    """Plain PyTorch version of K4 (:733-783): per head r = <G(q),
    vol_j(q + s)>, then da += r * hx * hy, ddx += r * a * hy * hx',
    ddy += r * a * hx * hy' over the 9 taps, hat' by ``hat_grad``.  Summed
    in float32; returns (ddx, ddy, da) in dx's dtype."""
    b, jl, t, h, w, c, kp = _shapes(vol, dx, dy, a, nh)
    d, p = c // nh, kp // nh
    vp = _pad_hw(vol.float())
    gh = g.float().reshape(b, t, h, w, nh, d)
    outs = ([], [], [])
    for j in range(jl):
        dxj, dyj, aj = dx[:, j].float(), dy[:, j].float(), a[:, j].float()
        hx = [hat(dxj - (k - 1)) for k in range(3)]
        hy = [hat(dyj - (k - 1)) for k in range(3)]
        dhx = [hat_grad(dxj - (k - 1)) for k in range(3)]
        dhy = [hat_grad(dyj - (k - 1)) for k in range(3)]
        da = torch.zeros_like(aj)
        ddx = torch.zeros_like(aj)
        ddy = torch.zeros_like(aj)
        for sy in range(3):
            for sx in range(3):
                v = vp[:, j, :, sy:sy + h, sx:sx + w].reshape(b, t, h, w, nh, d)
                r = (gh * v).sum(-1)                          # [.., nh]
                rk = r[..., None].expand(b, t, h, w, nh, p).reshape(aj.shape)
                da = da + rk * (hx[sx] * hy[sy])
                ddx = ddx + rk * (aj * hy[sy]) * dhx[sx]
                ddy = ddy + rk * (aj * hx[sx]) * dhy[sy]
        for acc, x in zip(outs, (ddx, ddy, da)):
            acc.append(x)
    return tuple(torch.stack(x, dim=1).to(dx.dtype) for x in outs)


def blend2d_backward_reference(vol: torch.Tensor, dx: torch.Tensor,
                               dy: torch.Tensor, a: torch.Tensor,
                               g: torch.Tensor, nh: int = 8):
    """(dvol, ddx, ddy, da) of ``blend2d_reference`` for the cotangent g:
    the plain versions of K3 and K4."""
    dvol = blend2d_bwd_dvol_reference(dx, dy, a, g, vol.dtype, nh)
    return (dvol,) + blend2d_bwd_dcomps_reference(vol, dx, dy, a, g, nh)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _blend2d_forward(vol, dx, dy, a, nh: int,
                     kernels: bool = True) -> torch.Tensor:
    """K2 on CUDA tensors, the plain version on CPU tensors or when not
    ``kernels``."""
    b, jl, t, h, w, c, kp = _shapes(vol, dx, dy, a, nh)
    if device_of(vol, dx, dy, a) == "cpu" or not kernels:
        return plain_version(kernels, blend2d_reference, vol, dx, dy, a, nh)
    check_kernel_args(nh, c, jl, vol.dtype,
                      {"vol": vol, "dx": dx, "dy": dy, "a": a})
    out = torch.empty((b, t, h, w, c), dtype=torch.float32, device=vol.device)
    sms = torch.cuda.get_device_properties(vol.device).multi_processor_count
    launch("blend2d", vol.device, vol.data_ptr(), dx.data_ptr(),
           dy.data_ptr(), a.data_ptr(), out.data_ptr(),
           int(vol.dtype == torch.bfloat16), b, jl, t, h, w, kp // nh,
           *fwd_block(b, t, h, w, sms))
    blend2d.launches += 1
    return out


def blend2d_bwd_dvol(dx, dy, a, g, vol_dtype: torch.dtype,
                     nh: int = 8) -> torch.Tensor:
    """K3 on CUDA tensors (``vol_dtype`` must be the components' dtype
    there), the plain version on CPU tensors: dvol [B, J, T, H, W, C]."""
    b, jl, t, h, w, kp = dx.shape
    c = g.shape[-1]
    if tuple(g.shape) != (b, t, h, w, c) or dy.shape != dx.shape or (
            a.shape != dx.shape):
        raise ValueError(f"g {tuple(g.shape)} does not match the components "
                         f"{tuple(dx.shape)}")
    if device_of(dx, dy, a, g) == "cpu":
        return blend2d_bwd_dvol_reference(dx, dy, a, g, vol_dtype, nh)
    if vol_dtype != dx.dtype:
        raise ValueError(f"K3 writes dvol in the components' dtype "
                         f"{dx.dtype}; got vol_dtype {vol_dtype}")
    check_kernel_args(nh, c, jl, dx.dtype, {"dx": dx, "dy": dy, "a": a, "g": g})
    dvol = torch.empty((b, jl, t, h, w, c), dtype=vol_dtype, device=dx.device)
    sms = torch.cuda.get_device_properties(dx.device).multi_processor_count
    launch("blend2d_bwd_dvol", dx.device, dx.data_ptr(), dy.data_ptr(),
           a.data_ptr(), g.data_ptr(), dvol.data_ptr(),
           int(dx.dtype == torch.bfloat16), b, jl, t, h, w, kp // nh,
           *k3_block(b, t, h, w, sms))
    blend2d_bwd_dvol.launches += 1
    return dvol


def blend2d_bwd_dcomps(vol, dx, dy, a, g, nh: int = 8):
    """K4 on CUDA tensors, the plain version on CPU tensors: (ddx, ddy, da)
    in the components' dtype."""
    b, jl, t, h, w, c, kp = _shapes(vol, dx, dy, a, nh)
    if tuple(g.shape) != (b, t, h, w, c):
        raise ValueError(f"g {tuple(g.shape)} does not match vol "
                         f"{tuple(vol.shape)}")
    if device_of(vol, dx, dy, a, g) == "cpu":
        return blend2d_bwd_dcomps_reference(vol, dx, dy, a, g, nh)
    check_kernel_args(nh, c, jl, vol.dtype,
                      {"vol": vol, "dx": dx, "dy": dy, "a": a, "g": g})
    ddx, ddy, da = (torch.empty_like(dx) for _ in range(3))
    sms = torch.cuda.get_device_properties(vol.device).multi_processor_count
    launch("blend2d_bwd_dcomps", vol.device, vol.data_ptr(), dx.data_ptr(),
           dy.data_ptr(), a.data_ptr(), g.data_ptr(), ddx.data_ptr(),
           ddy.data_ptr(), da.data_ptr(), int(vol.dtype == torch.bfloat16),
           b, jl, t, h, w, kp // nh, *k4_block(b, t, h, w, sms))
    blend2d_bwd_dcomps.launches += 1
    return ddx, ddy, da


def blend2d_backward(vol, dx, dy, a, g, nh: int = 8, need_vol: bool = True,
                     need_comps: bool = True, kernels: bool = True):
    """(dvol, ddx, ddy, da) for the float32 cotangent g through K3 and K4
    (their plain versions on the CPU or when not ``kernels``); a part not
    needed is None."""
    g = g.float().contiguous()
    dvol_fn = blend2d_bwd_dvol if kernels else blend2d_bwd_dvol_reference
    dcomps_fn = blend2d_bwd_dcomps if kernels else blend2d_bwd_dcomps_reference
    dvol = dvol_fn(dx, dy, a, g, vol.dtype, nh) if need_vol else None
    comps = (dcomps_fn(vol, dx, dy, a, g, nh) if need_comps
             else (None, None, None))
    return (dvol,) + tuple(comps)


class _Blend2d(torch.autograd.Function):
    """K2 forward; K3 + K4 backward (the JAX package's ``_blend2d``
    custom_vjp, whose residuals are the inputs)."""

    @staticmethod
    def forward(ctx, vol, dx, dy, a, nh, kernels):
        ctx.save_for_backward(vol, dx, dy, a)
        ctx.nh, ctx.kernels = nh, kernels
        return _blend2d_forward(vol, dx, dy, a, nh, kernels)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        vol, dx, dy, a = ctx.saved_tensors
        need = ctx.needs_input_grad
        dvol, ddx, ddy, da = blend2d_backward(
            vol, dx, dy, a, g, ctx.nh, need_vol=need[0],
            need_comps=any(need[1:4]), kernels=ctx.kernels)
        return dvol, ddx, ddy, da, None, None


def blend2d(vol: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
            a: torch.Tensor, nh: int = 8, kernels: bool = True) -> torch.Tensor:
    """vol [B, J, T, H, W, C], dx/dy/a [B, J, T, H, W, nh*P] -> float32
    [B, T, H, W, C], differentiable in all four inputs; the plain versions
    on any device when not ``kernels``."""
    return _Blend2d.apply(vol, dx, dy, a, nh, kernels)


blend2d.launches = 0
blend2d_bwd_dvol.launches = 0
blend2d_bwd_dcomps.launches = 0
