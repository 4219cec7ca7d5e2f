"""Mamba S6 selective scan (K5): CUDA kernel wrapper and plain version.

Counterpart of ``class_query_vad_tpu/ops/selective_scan.py`` (the contract,
:36-91) and ``ops/selective_scan_pallas.py`` (TPU kernel ``_scan_kernel``,
:37).  Per batch b, channel d of group g, state n and step l:

    delta_l = softplus(delta_l + delta_bias[d])      (each part optional)
    h_l     = exp(delta_l * A[d, n]) * h_{l-1} + delta_l * u_l * B[b, g, n, l]
    y_l     = sum_n C[b, g, n, l] * h_l + D[d] * u_l

with float32 carries whatever the input dtype and y in u's dtype.  The
kernel is ``csrc/selective_scan.cu``; what it computes, what bounds it and
its design are in that file's header.

``selective_scan`` takes CPU tensors to ``selective_scan_reference`` and
CUDA tensors to the kernel; anything else raises.  There is no fallback.
The kernel is forward only: on CUDA tensors that need a gradient it raises
(training the Mamba family is ROADMAP.md Queue 1 step 19).  Each launch
counts one in ``selective_scan.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import device_of, launch

_STATES = (4, 8, 16)          # the N the kernel is built for
_CHUNK = 64                   # steps per vectorised slab of the plain loop


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _grouped(bc: torch.Tensor) -> torch.Tensor:
    """B or C [B, N, L] -> [B, 1, N, L]; [B, G, N, L] as it is."""
    return bc[:, None] if bc.dim() == 3 else bc


def selective_scan_reference(u, delta, A, B, C, D=None, delta_bias=None,
                             delta_softplus: bool = False,
                             return_last_state: bool = False):
    """Plain PyTorch version of the kernel: sequential over L in float32,
    vectorised over (B, KD, N).  u, delta [B, KD, L]; A [KD, N]; B, C
    [B, G, N, L] or [B, N, L]; D, delta_bias [KD].  Returns y [B, KD, L] in
    u's dtype, and the last state [B, KD, N] float32 when asked.  Any
    device; differentiable."""
    B, C = _grouped(B), _grouped(C)
    bsz, kd, length = u.shape
    groups, n = B.shape[1], A.shape[1]
    dk = kd // groups
    uf = u.float()
    d = delta.float()
    if delta_bias is not None:
        d = d + delta_bias.float()[None, :, None]
    if delta_softplus:
        d = _softplus(d)
    a = A.float().reshape(1, groups, dk, 1, n)
    d_g = d.reshape(bsz, groups, dk, length)
    du_g = (d * uf).reshape(bsz, groups, dk, length)
    b_t = B.float().transpose(-1, -2)[:, :, None]        # [B, G, 1, L, N]
    c_t = C.float().transpose(-1, -2)[:, :, None]
    h = torch.zeros((bsz, groups, dk, n), dtype=torch.float32, device=u.device)
    ys = []
    for l0 in range(0, length, _CHUNK):
        sl = slice(l0, min(l0 + _CHUNK, length))
        decay = torch.exp(d_g[..., sl, None] * a)          # [B, G, dk, c, N]
        drive = du_g[..., sl, None] * b_t[:, :, :, sl]
        hs = []
        for i in range(decay.shape[3]):
            h = decay[:, :, :, i] * h + drive[:, :, :, i]
            hs.append(h)
        ys.append((torch.stack(hs, dim=3) * c_t[:, :, :, sl]).sum(-1))
    y = torch.cat(ys, dim=-1).reshape(bsz, kd, length)
    if D is not None:
        y = y + D.float()[None, :, None] * uf
    y = y.to(u.dtype)
    if return_last_state:
        return y, h.reshape(bsz, kd, n)
    return y


def _check_kernel_args(u, delta, A, B, C, D, delta_bias):
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(f"u and delta must be one shape [B, KD, L]; got "
                         f"{tuple(u.shape)} and {tuple(delta.shape)}")
    bsz, kd, length = u.shape
    if B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"B and C must be one shape [B, G, N, L]; got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    groups, n = B.shape[1], B.shape[2]
    if (B.shape[0], B.shape[3]) != (bsz, length) or kd % groups:
        raise ValueError(f"B {tuple(B.shape)} does not fit u {tuple(u.shape)}")
    if tuple(A.shape) != (kd, n):
        raise ValueError(f"A must be [KD, N] = [{kd}, {n}]; got {tuple(A.shape)}")
    for name, x in (("D", D), ("delta_bias", delta_bias)):
        if x is not None and tuple(x.shape) != (kd,):
            raise ValueError(f"{name} must be [{kd}]; got {tuple(x.shape)}")
    if n not in _STATES:
        raise ValueError(f"the kernel takes N in {_STATES}; got N={n}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bf16 u; got {u.dtype}")
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise ValueError(f"B and C must have u's dtype {u.dtype}; got "
                         f"{B.dtype} and {C.dtype}")
    if max(bsz, groups) > 65535:
        raise ValueError(f"the kernel takes B, G <= 65535; got {bsz}, {groups}")


def _launch(u, delta, A, B, C, D, delta_bias, delta_softplus,
            return_last_state):
    """K5 on CUDA tensors; strided inputs are read in place."""
    _check_kernel_args(u, delta, A, B, C, D, delta_bias)
    bsz, kd, length = u.shape
    groups, n = B.shape[1], B.shape[2]
    delta = delta.float()                  # float32 already on the model path
    A = A.float().contiguous()
    D = None if D is None else D.float().contiguous()
    delta_bias = None if delta_bias is None else delta_bias.float().contiguous()
    y = torch.empty_like(u)
    last = (torch.empty((bsz, kd, n), dtype=torch.float32, device=u.device)
            if return_last_state else None)
    strides = (ctypes.c_longlong * 17)(
        *u.stride(), *delta.stride(), *B.stride(), *C.stride(), *y.stride())
    ptr = lambda x: None if x is None else x.data_ptr()
    launch("selective_scan", u.device, u.data_ptr(), delta.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(), ptr(D), ptr(delta_bias),
           y.data_ptr(), ptr(last), ctypes.addressof(strides),
           int(u.dtype == torch.bfloat16), bsz, kd, length, groups, n,
           int(delta_softplus))
    selective_scan.launches += 1
    return (y, last) if return_last_state else y


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False):
    """Selective scan with the JAX package's contract (see the module
    docstring): K5 on CUDA tensors, the plain version on CPU tensors."""
    B, C = _grouped(B), _grouped(C)
    tensors = [x for x in (u, delta, A, B, C, D, delta_bias) if x is not None]
    if device_of(*tensors) == "cpu":
        return selective_scan_reference(u, delta, A, B, C, D, delta_bias,
                                        delta_softplus, return_last_state)
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(
            "the selective-scan kernel (K5) is forward only: its backward, "
            "and training the Mamba family, are ROADMAP.md Queue 1 step 19; "
            "run the forward under torch.no_grad() or torch.inference_mode()")
    return _launch(u, delta, A, B, C, D, delta_bias, delta_softplus,
                   return_last_state)


selective_scan.launches = 0
