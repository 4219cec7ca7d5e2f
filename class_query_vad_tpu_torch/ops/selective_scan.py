"""Mamba S6 selective scan (K5) and its backward: CUDA kernel wrappers,
plain versions and the autograd Function that joins them.

Counterpart of ``class_query_vad_tpu/ops/selective_scan.py`` (the contract,
:36-91) and ``ops/selective_scan_pallas.py`` (TPU kernel ``_scan_kernel``,
:37; its VJP ``_scan_pallas_bwd``, :200, is jax.vjp of the associative
scan).  Per batch b, channel d of group g, state n and step l:

    delta_l = softplus(delta_l + delta_bias[d])      (each part optional)
    h_l     = exp(delta_l * A[d, n]) * h_{l-1} + delta_l * u_l * B[b, g, n, l]
    y_l     = sum_n C[b, g, n, l] * h_l + D[d] * u_l

with float32 carries whatever the input dtype and y in u's dtype.  The
forward kernel is ``csrc/selective_scan.cu``, the backward
``csrc/selective_scan_bwd.cu``; what each computes, what bounds it and its
design are in its file's header.  Both are parallel over L in chunks of
``scan_chunk`` steps: the forward scans the chunks, folds their carries and
rescans them (three CUDA kernels per call); the backward keeps the
forward's chunk carry-ins and, in one CUDA kernel after a memset of its
flags, walks each chunk forward from its carry-in (its states and its
adjoint summary), takes its adjoint carry by a look-back over the chunks to
its right and walks it backward (two device operations per call).
``selective_scan_chunked`` and ``selective_scan_bwd_chunked`` are those
orders in plain PyTorch, which the CPU tests hold to the JAX scans and
their ``jax.vjp``.

``selective_scan`` takes CPU tensors to the plain versions and CUDA tensors
to the kernels; anything else raises.  There is no fallback.  With
gradients on and an input that needs one it runs ``SelectiveScanFn``: on
the card K5, keeping its carry-ins, and in the backward
``selective_scan_bwd``'s kernel; on the CPU ``selective_scan_reference``
and ``selective_scan_bwd_reference``.  Under ``torch.no_grad()`` it is K5
alone and saves nothing.  Each forward kernel call counts one in
``selective_scan.launches``, each backward one in
``selective_scan_bwd.launches``.
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
# partial wave was slower at the backbone's shape), and at most 128 steps
# long, so that the backward's checkpoints of a chunk fit in shared memory
_BLOCK_CHANNELS, _SUB, _TARGET_BLOCKS, _MIN_CHUNK, _MAX_CHUNK = 64, 16, 512, 32, 128
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
    """The chunk length K5 and its backward cut L into: a multiple of 16
    steps from 32 to 128, short enough for ~512 blocks of 64 channels (128
    at the backbone's B=2, KD=384, L=5121; 64 at its B=1; 32 at the VSS
    encoder's)."""
    tiles = batch * groups * -(-(channels // groups) // _BLOCK_CHANNELS)
    per_chunk = -(-length // -(-_TARGET_BLOCKS // tiles))
    return min(_MAX_CHUNK, max(_MIN_CHUNK, -(-per_chunk // _SUB) * _SUB))


class _Chunks:
    """The chunked orders' float32 operands: L cut into ``chunk``-step
    chunks, the last padded with delta = 0 (which keeps the state, and the
    adjoint); u, delta, delta * u [B, G, dk, nc, chunk], B and C [B, G, 1,
    nc, chunk, N], A log2 e [1, G, dk, 1, N]; ``x`` is delta + bias before
    the softplus.  ``carries`` folds the forward's chunk summaries, as K5's
    kernels 1 and 2: the carry-in of every chunk [B, G, dk, nc, N]."""

    def __init__(self, u, delta, A, B, C, delta_bias, delta_softplus, chunk):
        bsz, kd, length = u.shape
        groups, n = B.shape[1], A.shape[1]
        self.shape = (bsz, groups, kd // groups, n)
        self.length, self.chunk = length, chunk
        self.nc = -(-length // chunk)
        self.pad = self.nc * chunk - length
        self.uf = u.float()
        self.x = delta.float()
        if delta_bias is not None:
            self.x = self.x + delta_bias.float()[None, :, None]
        self.d = _softplus(self.x) if delta_softplus else self.x
        self.u_c = self.fold(self.uf)
        self.d_c = self.fold(self.d)
        self.du_c = self.fold(self.d * self.uf)
        self.b_c = self.fold_bc(B)
        self.c_c = self.fold_bc(C)
        self.a2 = (A.float() * _LOG2E).reshape(1, groups, -1, 1, n)

    def fold(self, x):
        """[B, KD, L] -> [B, G, dk, nc, chunk], zero-padded."""
        bsz, groups, dk, _ = self.shape
        return torch.nn.functional.pad(x, (0, self.pad)).reshape(
            bsz, groups, dk, self.nc, self.chunk)

    def unfold(self, x):
        """[B, G, dk, nc, chunk] -> [B, KD, L]."""
        bsz, groups, dk, _ = self.shape
        return x.reshape(bsz, groups * dk, -1)[..., :self.length]

    def fold_bc(self, x):
        x = torch.nn.functional.pad(x.float(), (0, self.pad))
        return x.reshape(*x.shape[:-1], self.nc, self.chunk).permute(
            0, 1, 3, 4, 2)[:, :, None]

    def decay(self, i):
        """exp(delta A) of every chunk's step i, as exp2(delta * A log2e)."""
        return torch.exp2(self.d_c[..., i, None] * self.a2)

    def carries(self):
        bsz, groups, dk, n = self.shape
        h = torch.zeros((bsz, groups, dk, self.nc, n), dtype=torch.float32,
                        device=self.uf.device)
        for i in range(self.chunk):                # every chunk from h = 0
            h = self.decay(i) * h + self.du_c[..., i, None] * self.b_c[..., i, :]
        total = torch.exp2(self.a2 * self.d_c.sum(-1)[..., None])
        carry, out = torch.zeros_like(h[..., 0, :]), []
        for k in range(self.nc):
            out.append(carry)
            carry = total[..., k, :] * carry + h[..., k, :]
        return torch.stack(out, dim=3)


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
    ch = _Chunks(u, delta, A, B, C, delta_bias, delta_softplus, chunk)
    bsz, groups, dk, n = ch.shape
    h, ys = ch.carries(), []
    for i in range(chunk):
        h = ch.decay(i) * h + ch.du_c[..., i, None] * ch.b_c[..., i, :]
        ys.append((h * ch.c_c[..., i, :]).sum(-1))
    y = ch.unfold(torch.stack(ys, dim=-1))
    if D is not None:
        y = y + D.float()[None, :, None] * ch.uf
    y = y.to(u.dtype)
    if return_last_state:
        return y, h[..., -1, :].reshape(bsz, groups * dk, n)
    return y


def selective_scan_bwd_reference(u, delta, A, B, C, dy, D=None,
                                 delta_bias=None, delta_softplus: bool = False,
                                 dlast=None):
    """The VJP of ``selective_scan`` in plain PyTorch, float32, sequential
    over L: the states h_l forward, then the adjoint g_l = C_l dy_l +
    a_{l+1} g_{l+1} (+ ``dlast``, the last state's gradient, at l = L - 1)
    backward, and from them

        dC = sum_{d in g} h_l dy_l            dB = sum_{d in g} g_l delta_l u_l
        du = sum_n g_l delta_l B_l + D dy_l   ddelta = sigmoid(x_l) sum_n g_l
                                                       (A a_l h_{l-1} + u_l B_l)
        dA = sum_{b,l} g_l delta_l a_l h_{l-1}
        dD = sum_{b,l} dy_l u_l               d delta_bias = sum_{b,l} ddelta_l

    (x = delta + delta_bias; sigmoid, jax.nn.softplus's derivative, only
    with the softplus).  Returns (du, ddelta, dA, dB, dC, dD, d delta_bias):
    du, dB, dC in u's, B's and C's dtypes, the rest float32; dD and d
    delta_bias None when D and delta_bias are.  Any device."""
    B, C = _grouped(B), _grouped(C)
    bsz, kd, length = u.shape
    groups, n = B.shape[1], A.shape[1]
    dk = kd // groups
    uf = u.float()
    x = delta.float()
    if delta_bias is not None:
        x = x + delta_bias.float()[None, :, None]
    d = _softplus(x) if delta_softplus else x
    a = A.float()[None, :, None]                                # [1, KD, 1, N]
    per_channel = lambda bc: bc.float().repeat_interleave(dk, 1).transpose(-1, -2)
    b_t, c_t = per_channel(B), per_channel(C)                   # [B, KD, L, N]
    decay = torch.exp(d[..., None] * a)
    drive = (d * uf)[..., None] * b_t
    dyf = dy.float()
    h = torch.zeros((bsz, kd, n), dtype=torch.float32, device=u.device)
    hs = []
    for l in range(length):
        h = decay[:, :, l] * h + drive[:, :, l]
        hs.append(h)
    hs = torch.stack(hs, dim=2)                                 # h_l
    h_prev = torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2)
    cdy = c_t * dyf[..., None]
    carry = (torch.zeros_like(h) if dlast is None else dlast.float())
    gs = [None] * length
    for l in reversed(range(length)):
        gs[l] = cdy[:, :, l] + carry
        carry = decay[:, :, l] * gs[l]
    g = torch.stack(gs, dim=2)                                  # g_l
    group_sum = lambda t: t.reshape(bsz, groups, dk, length, n).sum(2).transpose(-1, -2)
    dC = group_sum(hs * dyf[..., None])
    dB = group_sum(g * (d * uf)[..., None])
    du = (g * b_t).sum(-1) * d
    if D is not None:
        du = du + D.float()[None, :, None] * dyf
    dd = (g * (a * decay * h_prev + uf[..., None] * b_t)).sum(-1)
    if delta_softplus:
        dd = dd * torch.sigmoid(x)
    dA = (g * d[..., None] * decay * h_prev).sum((0, 2))
    dD = (dyf * uf).sum((0, 2)) if D is not None else None
    dbias = dd.sum((0, 2)) if delta_bias is not None else None
    return (du.to(u.dtype), dd, dA, dB.to(B.dtype), dC.to(C.dtype), dD, dbias)


# csrc/selective_scan_bwd.cu: a block's channels (a tile), a thread's states
_BWD_CHANNELS, _BWD_STATES = 64, 2


def _lane_tree(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum ``x`` over ``dim`` (a power of two) as the kernel's butterfly
    does over lanes: pairs by the index's lowest bit first."""
    dim %= x.dim()
    while x.shape[dim] > 1:
        x = x.unflatten(dim, (-1, 2)).sum(dim + 1)
    return x


def _in_order(parts):
    """parts[0] + parts[1] + ..., left to right, as the kernel adds them."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def selective_scan_bwd_chunked(u, delta, A, B, C, dy, D=None,
                               delta_bias=None, delta_softplus: bool = False,
                               dlast=None, chunk: int = 64):
    """``selective_scan_bwd_reference`` in the backward kernel's order
    (``csrc/selective_scan_bwd.cu``), float32: the forward's chunk
    carry-ins folded as K5 folds them; every chunk walked forward from its
    carry-in, its states and, in the same walk, its adjoint summary from
    zero, S_k = sum_l (prod_{j <= l} a_j) C_l dy_l, with the running product
    P_k of its decays; the adjoint carries folded in order from the last
    chunk, R_{k-1} = P_k R_k + S_k (R of the last chunk: ``dlast`` or 0);
    every chunk walked backward from R_k.  du's and ddelta's sums over the
    states: each thread's 2 states, then the channel's N / 2 threads
    pairwise; dB's and dC's over the channels: each warp's channels
    pairwise, the warps of a 64-channel tile in order, the tiles in order;
    dA, dD and d delta_bias per (b, chunk), then in (b, chunk) order.
    Arguments and results as the reference's; the CPU tests hold it to
    ``jax.vjp`` of the JAX scans."""
    B, C = _grouped(B), _grouped(C)
    ch = _Chunks(u, delta, A, B, C, delta_bias, delta_softplus, chunk)
    bsz, groups, dk, n = ch.shape
    parts = n // _BWD_STATES
    dy_c = ch.fold(dy.float())
    cdy = lambda i: ch.c_c[..., i, :] * dy_c[..., i, None]
    # pass 1: the states from the carry-ins, the summaries from zero
    hs, decays = [ch.carries()], []
    prod, summ = torch.ones_like(hs[0]), torch.zeros_like(hs[0])
    for i in range(chunk):
        decays.append(ch.decay(i))
        hs.append(decays[i] * hs[i] + ch.du_c[..., i, None] * ch.b_c[..., i, :])
        prod = prod * decays[i]
        summ = summ + prod * cdy(i)
    # the adjoint carries, folded from the last chunk
    r = (torch.zeros_like(hs[0][..., 0, :]) if dlast is None
         else dlast.float().reshape(bsz, groups, dk, n))
    radj = [None] * ch.nc
    for k in reversed(range(ch.nc)):
        radj[k] = r
        r = prod[..., k, :] * r + summ[..., k, :]
    # pass 2: backward from R_k
    s = torch.stack(radj, dim=3)
    a = A.float().reshape(1, groups, dk, 1, n)
    by_thread = lambda t: t.unflatten(-1, (parts, _BWD_STATES)).sum(-1)
    terms = {k: [None] * chunk for k in ("b", "c", "u", "d")}
    acc_a = torch.zeros_like(s)
    for i in reversed(range(chunk)):
        g = cdy(i) + s
        d_i = ch.d_c[..., i, None]
        t = g * (decays[i] * hs[i])
        gb = by_thread(g * ch.b_c[..., i, :])
        terms["c"][i] = hs[i + 1] * dy_c[..., i, None]
        terms["b"][i] = g * ch.du_c[..., i, None]
        terms["u"][i] = _lane_tree(d_i * gb, -1)[..., 0]
        terms["d"][i] = _lane_tree(ch.u_c[..., i, None] * gb + by_thread(a * t),
                                   -1)[..., 0]
        acc_a = acc_a + d_i * t
        s = decays[i] * g
    tiles = -(-dk // _BWD_CHANNELS)
    per_warp = 32 // parts

    def channel_sum(parts_):
        t = torch.stack(parts_, dim=4)                 # [B, G, dk, nc, c, N]
        t = torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, 0, 0, tiles * _BWD_CHANNELS - dk))
        t = t.unflatten(2, (tiles, -1, per_warp))      # [B, G, tile, warp, ch, ...]
        t = _lane_tree(t, 4)[:, :, :, :, 0]
        t = _in_order(_in_order(t.unbind(3)).unbind(2))   # the warps, the tiles
        return t.flatten(2, 3).transpose(-1, -2)[..., :ch.length]   # [B, G, N, L]

    du = ch.unfold(torch.stack(terms["u"], dim=-1))
    if D is not None:
        du = du + D.float()[None, :, None] * dy.float()
    dd = ch.unfold(torch.stack(terms["d"], dim=-1))
    if delta_softplus:
        dd = dd * torch.sigmoid(ch.x)
    in_chunks = lambda x: _in_order(
        x.permute(0, 3, 1, 2, 4).flatten(0, 1).unbind(0))
    dA = in_chunks(acc_a).reshape(groups * dk, n)      # over (b, chunk)
    dD = (in_chunks((dy_c * ch.u_c).sum(-1, keepdim=True)).reshape(-1)
          if D is not None else None)
    dbias = (in_chunks(ch.fold(dd).sum(-1, keepdim=True)).reshape(-1)
             if delta_bias is not None else None)
    return (du.to(u.dtype), dd, dA, channel_sum(terms["b"]).to(B.dtype),
            channel_sum(terms["c"]).to(C.dtype), dD, dbias)


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


_ptr = lambda x: None if x is None else x.data_ptr()


def _launch(u, delta, A, B, C, D, delta_bias, delta_softplus,
            return_last_state, keep_carries: bool = False):
    """K5 on CUDA tensors (one to three CUDA kernels, see the module
    docstring); strided inputs are read in place.  Returns (y, the last
    state or None, the chunk carry-ins [B, n_chunks - 1, KD, N] float32
    with ``keep_carries`` and more than one chunk, else None)."""
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
    launch("selective_scan", u.device, u.data_ptr(), delta.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(), _ptr(D), _ptr(delta_bias),
           y.data_ptr(), _ptr(last), _ptr(scratch), ctypes.addressof(strides),
           int(u.dtype == torch.bfloat16), bsz, kd, length, groups, n,
           int(delta_softplus), chunk)
    selective_scan.launches += 1
    carries = None
    if keep_carries and summaries:    # kernel 2 wrote them over the end states
        carries = scratch[:bsz * summaries * kd * n].view(bsz, summaries, kd, n)
    return y, last, carries


def scan_carries(u, delta, A, B, C, D=None, delta_bias=None,
                 delta_softplus: bool = False):
    """K5's chunk carry-ins for ``selective_scan_bwd`` on CUDA tensors (one
    forward kernel call, counted): None when L fits one chunk."""
    return _launch(u, delta, A, _grouped(B), _grouped(C), D, delta_bias,
                   delta_softplus, False, keep_carries=True)[2]


def _bwd_scratch(bsz, kd, length, groups, n, chunk) -> int:
    """float32s of the backward kernel's scratch (``csrc/selective_scan_bwd.cu``
    `launch_typed`): its ticket, per-block flags, per-tile and per-chunk
    counters (ints, zeroed by a memset before the kernel); every block's
    adjoint summary, product of decays and carry out (a float per chain of
    its 64-channel tile); dA's, dD's and d delta_bias's per-(b, chunk)
    partials; every block's dB / dC sums over its tile, which the chunk's
    last block adds up."""
    nc = -(-length // chunk)
    tiles = -(-(kd // groups) // _BWD_CHANNELS)
    slots = bsz * groups * tiles * nc
    ints = -(-(1 + slots + groups * tiles + bsz * groups * nc) // 4) * 4
    return (ints + 3 * slots * _BWD_CHANNELS * n + bsz * nc * kd * (n + 2)
            + slots * 2 * n * chunk)


def _launch_bwd(u, delta, A, B, C, dy, D, delta_bias, delta_softplus,
                carries, dlast):
    """The backward kernel on CUDA tensors (a memset and one CUDA kernel,
    see ``csrc/selective_scan_bwd.cu``)."""
    _check_kernel_args(u, delta, A, B, C, D, delta_bias)
    if dy.shape != u.shape or dy.dtype != u.dtype:
        raise ValueError(f"dy must be u's shape and dtype {tuple(u.shape)} "
                         f"{u.dtype}; got {tuple(dy.shape)} {dy.dtype}")
    bsz, kd, length = u.shape
    groups, n = B.shape[1], B.shape[2]
    chunk = scan_chunk(bsz, kd, length, groups)
    nc = -(-length // chunk)
    want = (bsz, nc - 1, kd, n)
    if nc > 1 and (carries is None or tuple(carries.shape) != want):
        raise ValueError(f"the backward takes the forward's chunk carry-ins "
                         f"{want} (scan_carries); got "
                         f"{None if carries is None else tuple(carries.shape)}")
    if dlast is not None and tuple(dlast.shape) != (bsz, kd, n):
        raise ValueError(f"dlast must be [{bsz}, {kd}, {n}]; got "
                         f"{tuple(dlast.shape)}")
    f32 = lambda x: None if x is None else x.float().contiguous()
    # the kernel reads a thread's states of carries and dlast as one vector
    aligned = lambda x: (None if x is None else
                         x if x.dtype == torch.float32 and x.is_contiguous()
                         and x.data_ptr() % 16 == 0 else x.float().clone())
    delta = delta.float()
    A, D, delta_bias = map(f32, (A, D, delta_bias))
    carries, dlast = map(aligned, (carries, dlast))
    du = torch.empty(u.shape, dtype=u.dtype, device=u.device)
    ddelta = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    dB = torch.empty(B.shape, dtype=u.dtype, device=u.device)
    dC = torch.empty(B.shape, dtype=u.dtype, device=u.device)
    dA = torch.empty((kd, n), dtype=torch.float32, device=u.device)
    dD = torch.empty(kd, dtype=torch.float32, device=u.device)
    dbias = torch.empty(kd, dtype=torch.float32, device=u.device)
    scratch = torch.empty(_bwd_scratch(bsz, kd, length, groups, n, chunk),
                          dtype=torch.float32, device=u.device)
    strides = (ctypes.c_longlong * 17)(
        *u.stride(), *delta.stride(), *B.stride(), *C.stride(), *dy.stride())
    launch("selective_scan_bwd", u.device, u.data_ptr(), delta.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(), _ptr(D), _ptr(delta_bias),
           dy.data_ptr(), _ptr(carries), _ptr(dlast), du.data_ptr(),
           ddelta.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
           dD.data_ptr(), dbias.data_ptr(), scratch.data_ptr(),
           ctypes.addressof(strides), int(u.dtype == torch.bfloat16), bsz, kd,
           length, groups, n, int(delta_softplus), chunk)
    selective_scan_bwd.launches += 1
    return (du, ddelta, dA, dB, dC, dD if D is not None else None,
            dbias if delta_bias is not None else None)


def selective_scan_bwd(u, delta, A, B, C, dy, D=None, delta_bias=None,
                       delta_softplus: bool = False, carries=None, dlast=None):
    """K5's backward: the gradients (du, ddelta, dA, dB, dC, dD, d
    delta_bias) of ``selective_scan`` given dy (and ``dlast``, the last
    state's gradient, or None) — the backward kernel on CUDA tensors, which
    also takes the forward's chunk ``carries`` (``scan_carries``; None
    when L fits one chunk), ``selective_scan_bwd_reference`` on CPU
    tensors.  Results as the reference's."""
    B, C = _grouped(B), _grouped(C)
    tensors = [x for x in (u, delta, A, B, C, dy, D, delta_bias, carries,
                           dlast) if x is not None]
    if device_of(*tensors) == "cpu":
        return selective_scan_bwd_reference(u, delta, A, B, C, dy, D,
                                            delta_bias, delta_softplus, dlast)
    return _launch_bwd(u, delta, A, B, C, dy, D, delta_bias, delta_softplus,
                       carries, dlast)


selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """``selective_scan`` under autograd.  Forward: K5 on the card, keeping
    its chunk carry-ins (the one tensor saved besides the inputs: [B,
    n_chunks - 1, KD, N] float32, no per-step state), or
    ``selective_scan_reference`` on the CPU.  Backward:
    ``selective_scan_bwd``, its kernel on the card, its reference on the
    CPU; the gradients in their inputs' dtypes."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus,
                return_last_state):
        if u.is_cuda:
            y, last, carries = _launch(u, delta, A, B, C, D, delta_bias,
                                       delta_softplus, return_last_state,
                                       keep_carries=True)
        else:
            y, last = selective_scan_reference(u, delta, A, B, C, D,
                                               delta_bias, delta_softplus, True)
            carries = None
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, carries)
        ctx.delta_softplus = delta_softplus
        return (y, last) if return_last_state else y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dlast=None):
        u, delta, A, B, C, D, delta_bias, carries = ctx.saved_tensors
        grads = selective_scan_bwd(u, delta, A, B, C, dy.to(u.dtype), D,
                                   delta_bias, ctx.delta_softplus, carries,
                                   dlast)
        inputs = (u, delta, A, B, C, D, delta_bias)
        return tuple(None if x is None else g.to(x.dtype)
                     for g, x in zip(grads, inputs)) + (None, None)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False):
    """Selective scan with the JAX package's contract (see the module
    docstring): K5 on CUDA tensors, the plain version on CPU tensors;
    differentiable through ``SelectiveScanFn``."""
    B, C = _grouped(B), _grouped(C)
    tensors = [x for x in (u, delta, A, B, C, D, delta_bias) if x is not None]
    cpu = device_of(*tensors) == "cpu"
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return SelectiveScanFn.apply(u, delta, A, B, C, D, delta_bias,
                                     delta_softplus, return_last_state)
    if cpu:
        return selective_scan_reference(u, delta, A, B, C, D, delta_bias,
                                        delta_softplus, return_last_state)
    y, last, _ = _launch(u, delta, A, B, C, D, delta_bias, delta_softplus,
                         return_last_state)
    return (y, last) if return_last_state else y


selective_scan.launches = 0
