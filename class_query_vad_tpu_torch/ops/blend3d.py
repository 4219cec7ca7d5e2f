"""Radius-1 (x, y, t) window blend from per-level components and its
backward: kernels K6 (which also serves K7), K8 and K9, their plain
PyTorch versions, and the autograd wiring.

Counterpart of ``class_query_vad_tpu/ops/fast_deform_pallas.py`` ``_blend``
(:1273) with its ``custom_vjp`` (:1294-1316): the forward is the TPU kernel
``_blend_kernel_v2`` (K6, :96) or, past its VMEM estimate, the h-blocked
``_blend_kernel`` (K7, :54) — the same function, tiled differently — and
the backward ``_bwd_dvol_kernel`` (K8, :1118) and ``_bwd_dcomps_kernel``
(K9, :1053).  The CUDA kernels are ``csrc/blend3d.cu`` (K6 and K7),
``csrc/blend3d_bwd_dvol.cu`` and ``csrc/blend3d_bwd_dcomps.cu``; what they
compute, what bounds them and their design are in those files' headers.

Shapes: vol [B, J, T, H, W, C]; components dx, dy, dt, a [B, J, T, H, W,
nh*P]; output and its cotangent G float32 [B, T, H, W, C].  The border is
zero on t, h and w.

Each wrapper takes CPU tensors to its plain version and CUDA tensors to its
kernel; anything else raises.  There is no fallback: on the card a wrapper
launches its kernel or raises.  Each counts its launches in ``.launches``.
The kernels take nh=8, C=256, 1<=J<=4 and any P (``check_kernel_args``).
``blend3d`` with ``kernels=False`` (the configuration's
``MODEL.FAST_USE_PALLAS: false``) takes the plain versions on any device,
backward included.

Gradients follow XLA's subgradient conventions, as the JAX package's
kernels do (``hat_grad``), not torch autograd's of ``abs``/``clamp``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .blend2d import check_kernel_args, hat, hat_grad
from .cuda_build import device_of, launch

# The side of the square (y, x) tile of one frame that a block of K6, K8 or
# K9 owns (csrc/blend3d.cu, csrc/blend3d_bwd_dvol.cu,
# csrc/blend3d_bwd_dcomps.cu): the wrappers pass it and the kernels check
# it; tests/test_torch_blend3d_tiled.py mirrors the kernels' tile, halo and
# table arithmetic with it.
BLEND3D_TILE = 8
# The most frames a block of K6 or K9 serves: it holds their window of up
# to BLEND3D_FRAMES + 2 frames per level and reads each window row once for
# every frame that reaches it (``k6_frames_per_block``,
# ``k9_frames_per_block``).
BLEND3D_FRAMES = 4


def _blocks(b: int, t: int, h: int, w: int, frames: int) -> int:
    """Blocks of K6 or K9 at ``frames`` frames per block (8 heads)."""
    tiles = -(-h // BLEND3D_TILE) * -(-w // BLEND3D_TILE)
    return b * -(-t // frames) * tiles * 8


def k6_frames_per_block(b: int, t: int, h: int, w: int, sms: int) -> int:
    """The frames per block K6 is launched with: ``BLEND3D_FRAMES`` (a
    block blends each window row into every frame that reaches it), or two
    where four would leave some of the card's ``sms`` SMs without a block
    (the 8x10 query grid)."""
    if _blocks(b, t, h, w, BLEND3D_FRAMES) >= sms:
        return BLEND3D_FRAMES
    return BLEND3D_FRAMES // 2


def k9_frames_per_block(b: int, t: int, h: int, w: int, sms: int) -> int:
    """The frames per block K9 is launched with: the most of 4, 2 and 1
    whose blocks reach at least half of the card's ``sms`` SMs (each row
    of a block's window is read once for all its frames, but a block's
    phases run in turn, so a grid of under half the SMs' count waits on
    its longest blocks; measured at B=1, T=8: 4 frames down to the 16x20
    query grid, 1 at 8x10)."""
    for frames in (BLEND3D_FRAMES, BLEND3D_FRAMES // 2):
        if 2 * _blocks(b, t, h, w, frames) >= sms:
            return frames
    return 1


# _TAPS[s] = (it, ih, iw): tap s = it * 9 + ih * 3 + iw shifts by
# (it - 1, ih - 1, iw - 1) in (t, y, x), and reads a padded tensor's window
# starting at (it, ih, iw)
_TAPS = [(it, ih, iw) for it in range(3) for ih in range(3) for iw in range(3)]


def _shapes(vol: torch.Tensor, comps, nh: int):
    dx = comps[0]
    if vol.dim() != 6 or dx.dim() != 6 or any(x.shape != dx.shape
                                              for x in comps):
        raise ValueError(
            f"vol must be [B, J, T, H, W, C] and dx, dy, dt, a one shape "
            f"[B, J, T, H, W, nh*P]; got {tuple(vol.shape)}, "
            f"{[tuple(x.shape) for x in comps]}")
    if tuple(dx.shape[:5]) != tuple(vol.shape[:5]):
        raise ValueError(f"components {tuple(dx.shape)} do not match vol "
                         f"{tuple(vol.shape)}")
    b, jl, t, h, w, c = vol.shape
    kp = dx.shape[-1]
    if c % nh or kp % nh:
        raise ValueError(f"C={c} and kp={kp} must be multiples of nh={nh}")
    return b, jl, t, h, w, c, kp


def _pad_thw(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the T, H and W axes ([..., T, H, W, lanes]) by one on each
    side."""
    return F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))


def _win(x: torch.Tensor, it: int, ih: int, iw: int, t: int, h: int,
         w: int) -> torch.Tensor:
    """The [T, H, W] window of a padded [..., T+2, H+2, W+2, lanes] tensor
    starting at (it, ih, iw)."""
    return x[..., it:it + t, ih:ih + h, iw:iw + w, :]


def _masses(dx, dy, dt, a, nh: int):
    """Per-head tap masses m[..., head, s] = sum_p a * hat(dt - st) *
    hat(dy - sy) * hat(dx - sx) for the 27 taps s in ``_TAPS`` order
    (float32)."""
    def hats(u):
        u = u.float()
        return torch.stack([hat(u - (k - 1)) for k in range(3)], dim=-1)

    ht, hy, hx = hats(dt), hats(dy), hats(dx)                 # [..., kp, 3]
    m = (a.float()[..., None, None, None] * ht[..., :, None, None]
         * hy[..., None, :, None] * hx[..., None, None, :])    # [.., kp, 3, 3, 3]
    kp = dx.shape[-1]
    return m.reshape(*dx.shape[:-1], nh, kp // nh, 27).sum(-2)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def blend3d_reference(vol: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                      dt: torch.Tensor, a: torch.Tensor,
                      nh: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K6/K7 (the JAX package's ``_blend_xla_vol``,
    :1031): the 27-tap blend with zero borders on t, h and w, in float32.
    Any device; returns float32 [B, T, H, W, C]."""
    b, jl, t, h, w, c, kp = _shapes(vol, (dx, dy, dt, a), nh)
    d = c // nh
    vp = _pad_thw(vol.float())
    out = torch.zeros((b, t, h, w, nh, d), dtype=torch.float32,
                      device=vol.device)
    for j in range(jl):
        m = _masses(dx[:, j], dy[:, j], dt[:, j], a[:, j], nh)  # [.., nh, 27]
        vj = vp[:, j]
        for s, (it, ih, iw) in enumerate(_TAPS):
            v = _win(vj, it, ih, iw, t, h, w).reshape(b, t, h, w, nh, d)
            out = out + m[..., s, None] * v
    return out.reshape(b, t, h, w, c)


def blend3d_bwd_dvol_reference(dx: torch.Tensor, dy: torch.Tensor,
                               dt: torch.Tensor, a: torch.Tensor,
                               g: torch.Tensor, vol_dtype: torch.dtype,
                               nh: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K8: dvol_j[q] = sum_d m_j(q + d, -d) *
    G(q + d) over d in {-1, 0, 1}^3, the transposed stencil of the forward
    (:1118-1168), summed in float32 and returned in ``vol_dtype``
    [B, J, T, H, W, C]."""
    b, jl, t, h, w, kp = dx.shape
    c = g.shape[-1]
    d = c // nh
    gp = _pad_thw(g.float())
    out = []
    for j in range(jl):
        # padded components (a = 0 off the grid) give zero mass there
        m = _masses(*(_pad_thw(x[:, j].float()) for x in (dx, dy, dt, a)),
                    nh)                           # [b, t+2, h+2, w+2, nh, 27]
        acc = torch.zeros((b, t, h, w, nh, d), dtype=torch.float32,
                          device=g.device)
        for s, (it, ih, iw) in enumerate(_TAPS):  # neighbour d = (it-1, ..)
            # the neighbour q + d reaches q through its tap -d, index 26 - s
            ms = m[:, it:it + t, ih:ih + h, iw:iw + w, :, 26 - s]
            gs = _win(gp, it, ih, iw, t, h, w).reshape(b, t, h, w, nh, d)
            acc = acc + ms[..., None] * gs
        out.append(acc.reshape(b, t, h, w, c))
    return torch.stack(out, dim=1).to(vol_dtype)


def blend3d_bwd_dcomps_reference(vol: torch.Tensor, dx: torch.Tensor,
                                 dy: torch.Tensor, dt: torch.Tensor,
                                 a: torch.Tensor, g: torch.Tensor,
                                 nh: int = 8):
    """Plain PyTorch version of K9 (:1053-1115): per head r_s = <G(q),
    vol_j(q + s)> for the 27 shifts s, then da += r * hx * hy * ht, ddx +=
    r * a * hy * ht * hx', ddy and ddt alike, hat' by ``hat_grad``.  Summed
    in float32; returns (ddx, ddy, ddt, da) in dx's dtype."""
    b, jl, t, h, w, c, kp = _shapes(vol, (dx, dy, dt, a), nh)
    d, p = c // nh, kp // nh
    vp = _pad_thw(vol.float())
    gh = g.float().reshape(b, t, h, w, nh, d)
    outs = ([], [], [], [])
    for j in range(jl):
        aj = a[:, j].float()
        hats, dhats = [], []
        for u in (dx[:, j], dy[:, j], dt[:, j]):
            u = u.float()
            hats.append([hat(u - (k - 1)) for k in range(3)])
            dhats.append([hat_grad(u - (k - 1)) for k in range(3)])
        (hx, hy, ht), (dhx, dhy, dht) = hats, dhats
        da, ddx, ddy, ddt = (torch.zeros_like(aj) for _ in range(4))
        for it, ih, iw in _TAPS:
            v = _win(vp[:, j], it, ih, iw, t, h, w).reshape(b, t, h, w, nh, d)
            r = (gh * v).sum(-1)                                  # [.., nh]
            rk = r[..., None].expand(b, t, h, w, nh, p).reshape(aj.shape)
            da = da + rk * (hx[iw] * hy[ih] * ht[it])
            ddx = ddx + rk * (aj * hy[ih] * ht[it]) * dhx[iw]
            ddy = ddy + rk * (aj * hx[iw] * ht[it]) * dhy[ih]
            ddt = ddt + rk * (aj * hx[iw] * hy[ih]) * dht[it]
        for acc, x in zip(outs, (ddx, ddy, ddt, da)):
            acc.append(x)
    return tuple(torch.stack(x, dim=1).to(dx.dtype) for x in outs)


def blend3d_backward_reference(vol, dx, dy, dt, a, g, nh: int = 8):
    """(dvol, ddx, ddy, ddt, da) of ``blend3d_reference`` for the cotangent
    g: the plain versions of K8 and K9."""
    dvol = blend3d_bwd_dvol_reference(dx, dy, dt, a, g, vol.dtype, nh)
    return (dvol,) + blend3d_bwd_dcomps_reference(vol, dx, dy, dt, a, g, nh)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def blend3d_fwd(vol, dx, dy, dt, a, nh: int = 8) -> torch.Tensor:
    """K6 on CUDA tensors (at every grid: it also serves K7's regime), the
    plain version on CPU tensors: float32 [B, T, H, W, C]."""
    b, jl, t, h, w, c, kp = _shapes(vol, (dx, dy, dt, a), nh)
    if device_of(vol, dx, dy, dt, a) == "cpu":
        return blend3d_reference(vol, dx, dy, dt, a, nh)
    check_kernel_args(nh, c, jl, vol.dtype,
                      {"vol": vol, "dx": dx, "dy": dy, "dt": dt, "a": a})
    out = torch.empty((b, t, h, w, c), dtype=torch.float32, device=vol.device)
    sms = torch.cuda.get_device_properties(vol.device).multi_processor_count
    launch("blend3d", vol.device, vol.data_ptr(), dx.data_ptr(),
           dy.data_ptr(), dt.data_ptr(), a.data_ptr(), out.data_ptr(),
           int(vol.dtype == torch.bfloat16), b, jl, t, h, w, kp // nh,
           BLEND3D_TILE, k6_frames_per_block(b, t, h, w, sms))
    blend3d_fwd.launches += 1
    return out


def blend3d_bwd_dvol(dx, dy, dt, a, g, vol_dtype: torch.dtype,
                     nh: int = 8) -> torch.Tensor:
    """K8 on CUDA tensors (``vol_dtype`` must be the components' dtype
    there), the plain version on CPU tensors: dvol [B, J, T, H, W, C]."""
    b, jl, t, h, w, kp = dx.shape
    c = g.shape[-1]
    if tuple(g.shape) != (b, t, h, w, c) or any(
            x.shape != dx.shape for x in (dy, dt, a)):
        raise ValueError(f"g {tuple(g.shape)} does not match the components "
                         f"{tuple(dx.shape)}")
    if device_of(dx, dy, dt, a, g) == "cpu":
        return blend3d_bwd_dvol_reference(dx, dy, dt, a, g, vol_dtype, nh)
    if vol_dtype != dx.dtype:
        raise ValueError(f"K8 writes dvol in the components' dtype "
                         f"{dx.dtype}; got vol_dtype {vol_dtype}")
    check_kernel_args(nh, c, jl, dx.dtype,
                      {"dx": dx, "dy": dy, "dt": dt, "a": a, "g": g})
    dvol = torch.empty((b, jl, t, h, w, c), dtype=vol_dtype, device=dx.device)
    launch("blend3d_bwd_dvol", dx.device, dx.data_ptr(), dy.data_ptr(),
           dt.data_ptr(), a.data_ptr(), g.data_ptr(), dvol.data_ptr(),
           int(dx.dtype == torch.bfloat16), b, jl, t, h, w, kp // nh,
           BLEND3D_TILE)
    blend3d_bwd_dvol.launches += 1
    return dvol


def blend3d_bwd_dcomps(vol, dx, dy, dt, a, g, nh: int = 8):
    """K9 on CUDA tensors, the plain version on CPU tensors: (ddx, ddy,
    ddt, da) in the components' dtype."""
    b, jl, t, h, w, c, kp = _shapes(vol, (dx, dy, dt, a), nh)
    if tuple(g.shape) != (b, t, h, w, c):
        raise ValueError(f"g {tuple(g.shape)} does not match vol "
                         f"{tuple(vol.shape)}")
    if device_of(vol, dx, dy, dt, a, g) == "cpu":
        return blend3d_bwd_dcomps_reference(vol, dx, dy, dt, a, g, nh)
    check_kernel_args(nh, c, jl, vol.dtype,
                      {"vol": vol, "dx": dx, "dy": dy, "dt": dt, "a": a,
                       "g": g})
    ddx, ddy, ddt, da = (torch.empty_like(dx) for _ in range(4))
    sms = torch.cuda.get_device_properties(vol.device).multi_processor_count
    launch("blend3d_bwd_dcomps", vol.device, vol.data_ptr(), dx.data_ptr(),
           dy.data_ptr(), dt.data_ptr(), a.data_ptr(), g.data_ptr(),
           ddx.data_ptr(), ddy.data_ptr(), ddt.data_ptr(), da.data_ptr(),
           int(vol.dtype == torch.bfloat16), b, jl, t, h, w, kp // nh,
           BLEND3D_TILE, k9_frames_per_block(b, t, h, w, sms))
    blend3d_bwd_dcomps.launches += 1
    return ddx, ddy, ddt, da


def blend3d_backward(vol, dx, dy, dt, a, g, nh: int = 8,
                     need_vol: bool = True, need_comps: bool = True,
                     kernels: bool = True):
    """(dvol, ddx, ddy, ddt, da) for the float32 cotangent g through K8 and
    K9 (their plain versions on the CPU or when not ``kernels``); a part
    not needed is None."""
    g = g.float().contiguous()
    dvol_fn = blend3d_bwd_dvol if kernels else blend3d_bwd_dvol_reference
    dcomps_fn = blend3d_bwd_dcomps if kernels else blend3d_bwd_dcomps_reference
    dvol = dvol_fn(dx, dy, dt, a, g, vol.dtype, nh) if need_vol else None
    comps = (dcomps_fn(vol, dx, dy, dt, a, g, nh) if need_comps
             else (None,) * 4)
    return (dvol,) + tuple(comps)


class _Blend3d(torch.autograd.Function):
    """K6 forward; K8 + K9 backward (the JAX package's ``_blend``
    custom_vjp, whose residuals are the inputs)."""

    @staticmethod
    def forward(ctx, vol, dx, dy, dt, a, nh, kernels):
        ctx.save_for_backward(vol, dx, dy, dt, a)
        ctx.nh, ctx.kernels = nh, kernels
        if device_of(vol, dx, dy, dt, a) == "cpu" or not kernels:
            return blend3d_reference(vol, dx, dy, dt, a, nh)
        return blend3d_fwd(vol, dx, dy, dt, a, nh)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad
        grads = blend3d_backward(*ctx.saved_tensors, g, ctx.nh,
                                 need_vol=need[0], need_comps=any(need[1:5]),
                                 kernels=ctx.kernels)
        return (*grads, None, None)


def blend3d(vol: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
            dt: torch.Tensor, a: torch.Tensor, nh: int = 8,
            kernels: bool = True) -> torch.Tensor:
    """vol [B, J, T, H, W, C], dx/dy/dt/a [B, J, T, H, W, nh*P] -> float32
    [B, T, H, W, C], differentiable in all five inputs; the plain versions
    on any device when not ``kernels``."""
    return _Blend3d.apply(vol, dx, dy, dt, a, nh, kernels)


blend3d_fwd.launches = 0
blend3d_bwd_dvol.launches = 0
blend3d_bwd_dcomps.launches = 0
