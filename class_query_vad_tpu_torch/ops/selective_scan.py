"""Mamba S6 selective scan (K5): CUDA kernel wrapper and plain version.

Counterpart of ``class_query_vad_tpu/ops/selective_scan.py`` (the contract,
:36-91) and ``ops/selective_scan_pallas.py`` (TPU kernel ``_scan_kernel``,
:37).  Per batch b, channel d of group g, state n and step l:

    delta_l = softplus(delta_l + delta_bias[d])      (each part optional)
    h_l     = exp(delta_l * A[d, n]) * h_{l-1} + delta_l * u_l * B[b, g, n, l]
    y_l     = sum_n C[b, g, n, l] * h_l + D[d] * u_l

with float32 carries whatever the input dtype and y in u's dtype.  The
kernel is ``csrc/selective_scan.cu``; what it computes, what bounds it and
its design are in that file's header.  It is parallel over L: chunks of
``scan_chunk`` steps, scanned, their carries folded, then rescanned (three
CUDA kernels per call); ``selective_scan_chunked`` is that order in plain
PyTorch, which the CPU tests hold to the JAX scans.

``selective_scan`` takes CPU tensors to ``selective_scan_reference`` and
CUDA tensors to the kernel; anything else raises.  There is no fallback.
The kernel is forward only: on CUDA tensors that need a gradient it raises
(training the Mamba family is ROADMAP.md Queue 1 step 19).  Each call
counts one in ``selective_scan.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import device_of, launch

_STATES = (4, 8, 16)          # the N the kernel is built for
_CHUNK = 64                   # steps per vectorised slab of the plain loop
# the kernel's blocks: 64 channels of one group x one chunk of L, which is
# a multiple of its 16-step sub-tiles; chunks are cut for ~512 blocks, one
# wave at the 4 blocks per SM that the H100's 132 SMs hold (a second,
# partial wave was slower at the backbone's shape)
_BLOCK_CHANNELS, _SUB, _TARGET_BLOCKS, _MIN_CHUNK = 64, 16, 512, 32
_LOG2E = 1.4426950408889634


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


def scan_chunk(batch: int, channels: int, length: int, groups: int) -> int:
    """The chunk length K5 cuts L into: a multiple of 16 steps, at least 32,
    short enough for ~512 blocks of 64 channels (128 at the backbone's
    B=2, KD=384, L=5121; 32 at the VSS encoder's)."""
    tiles = batch * groups * -(-(channels // groups) // _BLOCK_CHANNELS)
    per_chunk = -(-length // -(-_TARGET_BLOCKS // tiles))
    return max(_MIN_CHUNK, -(-per_chunk // _SUB) * _SUB)


def selective_scan_chunked(u, delta, A, B, C, D=None, delta_bias=None,
                           delta_softplus: bool = False,
                           return_last_state: bool = False, chunk: int = 64):
    """The plain version in K5's chunked order (``csrc/selective_scan.cu``),
    float32 throughout: L cut into chunks of ``chunk`` steps (the last one
    padded with delta = 0, which keeps the state); every chunk scanned from
    h = 0 to its end state, with its sum of delta; the summaries folded in
    chunk order into each chunk's carry-in, h_in(k+1) = exp2(A log2e *
    sum delta_k) * h_in(k) + end_k; every chunk rescanned from its carry-in
    for y.  exp(delta A) is exp2(delta * (A log2e)), as in the kernel.  The
    CPU tests hold it to the JAX scans; nothing on a model path calls it.
    Arguments and results as ``selective_scan_reference``."""
    B, C = _grouped(B), _grouped(C)
    bsz, kd, length = u.shape
    groups, n = B.shape[1], A.shape[1]
    dk = kd // groups
    nc = -(-length // chunk)
    pad = nc * chunk - length
    uf = u.float()
    d = delta.float()
    if delta_bias is not None:
        d = d + delta_bias.float()[None, :, None]
    if delta_softplus:
        d = _softplus(d)
    fold = lambda x: torch.nn.functional.pad(x, (0, pad)).reshape(
        *x.shape[:-1], nc, chunk)
    d_c = fold(d).reshape(bsz, groups, dk, nc, chunk)
    du_c = fold(d * uf).reshape(bsz, groups, dk, nc, chunk)
    b_c = fold(B.float()).permute(0, 1, 3, 4, 2)[:, :, None]  # [B,G,1,nc,c,N]
    c_c = fold(C.float()).permute(0, 1, 3, 4, 2)[:, :, None]
    a2 = (A.float() * _LOG2E).reshape(1, groups, dk, 1, n)

    def scan(h, with_y: bool):
        ys = []
        for i in range(chunk):
            h = (torch.exp2(d_c[..., i, None] * a2) * h
                 + du_c[..., i, None] * b_c[..., i, :])
            if with_y:
                ys.append((h * c_c[..., i, :]).sum(-1))
        return h, ys

    zero = torch.zeros((bsz, groups, dk, nc, n), dtype=torch.float32,
                       device=u.device)
    ends, _ = scan(zero, False)                              # [B,G,dk,nc,N]
    decay = torch.exp2(a2 * d_c.sum(-1)[..., None])          # [B,G,dk,nc,N]
    carries, h = [], zero[..., 0, :]
    for k in range(nc):
        carries.append(h)
        h = decay[..., k, :] * h + ends[..., k, :]
    h, ys = scan(torch.stack(carries, dim=3), True)
    y = torch.stack(ys, dim=-1).reshape(bsz, kd, nc * chunk)[..., :length]
    if D is not None:
        y = y + D.float()[None, :, None] * uf
    y = y.to(u.dtype)
    if return_last_state:
        return y, h[..., -1, :].reshape(bsz, kd, n)
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
    """K5 on CUDA tensors (one to three CUDA kernels, see the module
    docstring); strided inputs are read in place."""
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
    chunk = scan_chunk(bsz, kd, length, groups)
    summaries = (length - 1) // chunk             # chunks with a carry out
    scratch = (torch.empty(bsz * summaries * kd * (n + 1), dtype=torch.float32,
                           device=u.device) if summaries else None)
    strides = (ctypes.c_longlong * 17)(
        *u.stride(), *delta.stride(), *B.stride(), *C.stride(), *y.stride())
    ptr = lambda x: None if x is None else x.data_ptr()
    launch("selective_scan", u.device, u.data_ptr(), delta.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(), ptr(D), ptr(delta_bias),
           y.data_ptr(), ptr(last), ptr(scratch), ctypes.addressof(strides),
           int(u.dtype == torch.bfloat16), bsz, kd, length, groups, n,
           int(delta_softplus), chunk)
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
