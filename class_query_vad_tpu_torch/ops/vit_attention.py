"""Softmax self-attention from fused qkv for the ViT backbone: kernel K12,
its plain PyTorch version, the einsum reference and the autograd wiring.

Counterpart of ``class_query_vad_tpu/ops/vit_attention.py``: the TPU kernel
is ``_flash_kernel`` (K12, :36; ``pallas_call`` in ``_flash_fwd_impl``
:99), reached through the ``custom_vjp`` ``flash_attention_qkv`` (:131).
On the card it is ``csrc/vit_attention.cu``; what it computes, what bounds
it and its design are in that file's header.

Layout (the JAX package's): fused ``qkv`` [B, N, 3C] with q | k | v along
the last axis and head h at lanes [h*D, (h+1)*D) of each third; output [B,
N, C].  The kernel takes D = 64 (ViT-B) and any N: it streams K and V
through shared memory twice and keeps no score row (``kernel_shape``).

As in the JAX package, no model path calls it: the port's ViT keeps its
eager attention (``models/vit.py``), and the one entry point is
``scripts/bench_vit_attn.py``.  ``flash_attention_qkv`` is differentiable:
its forward takes CPU tensors to the plain version (``flash_attention_
plain``, which mirrors the kernel's arithmetic) and CUDA tensors to K12;
anything else raises, and there is no fallback.  Its backward is autograd
through ``attention_from_qkv_ref``, as the JAX package's ``_bwd`` (:140):
JAX has no backward kernel here, and neither has the port.
``vit_attention`` launches the kernel and counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from .cuda_build import device_of, launch

HEAD_DIM = 64
_GRID_LIMIT = 65535           # CUDA's grid y / z: heads and batch


def split_qkv(qkv: torch.Tensor, num_heads: int):
    """q, k, v [B, H, N, D] views of fused qkv [B, N, 3C]."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3C] with C a multiple of "
                         f"num_heads={num_heads}; got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    return qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def merge_heads(out: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]."""
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


def attention_from_qkv_ref(qkv: torch.Tensor, num_heads: int,
                           scale: float) -> torch.Tensor:
    """The einsum formulation (the JAX package's ``attention_from_qkv_ref``,
    vit_attention.py:112) in its rounding order: q * scale in the qkv
    dtype, the scores in that dtype, the row max without gradient, exp in
    float32 rounded back, the row sum in float32 rounded back, p = e / den,
    then p v in the qkv dtype."""
    q, k, v = split_qkv(qkv, num_heads)
    s = (q * scale) @ k.transpose(-2, -1)
    mx = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp((s - mx).float()).to(qkv.dtype)
    den = e.float().sum(dim=-1, keepdim=True)
    p = e / den.to(qkv.dtype)
    return merge_heads(p @ v)


def flash_attention_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                          keys_per_tile: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K12, in ``_flash_kernel``'s order (:44-56):
    the scores a float32 dot times the scale, the max and the sum in
    float32, p = e / sum rounded to the v dtype, and p v accumulated in
    float32, then cast.  ``keys_per_tile`` takes the card kernel's pass 1
    order instead of the whole row's: the max m and the sum l by the
    running recurrence over tiles of that many keys (l rescaled by
    exp(m_old - m_new) when m grows), then p = exp(s - m) / l.  Any
    device."""
    q, k, v = split_qkv(qkv, num_heads)
    s = (q.float() @ k.float().transpose(-2, -1)) * scale
    if keys_per_tile is None:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        m = torch.full_like(s[..., :1], -torch.inf)
        l = torch.zeros_like(m)
        for j0 in range(0, s.shape[-1], keys_per_tile):
            tile = s[..., j0:j0 + keys_per_tile]
            m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(tile - m_new).sum(
                dim=-1, keepdim=True)
            m = m_new
        p = torch.exp(s - m) / l
    return merge_heads((p.to(v.dtype).float() @ v.float()).to(qkv.dtype))


def kernel_shape(shape, num_heads: int):
    """(B, N, C) of a fused qkv ``shape`` [B, N, 3C] that K12 takes: head
    dim 64, any N, B and ``num_heads`` up to the grid's 65535.  Raises
    ValueError otherwise.  Pure Python: the wrapper's shape rules."""
    if len(shape) != 3 or num_heads < 1 or shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3C] with C a multiple of "
                         f"num_heads={num_heads}; got {tuple(shape)}")
    b, n, c3 = shape
    c = c3 // 3
    if c // num_heads != HEAD_DIM:
        raise ValueError(f"K12 takes head dim {HEAD_DIM}; got {c // num_heads}")
    if b > _GRID_LIMIT or num_heads > _GRID_LIMIT:
        raise ValueError(f"K12 takes batch and heads up to {_GRID_LIMIT}; got "
                         f"{b} and {num_heads}")
    return b, n, c


def vit_attention(qkv: torch.Tensor, num_heads: int,
                  scale: float) -> torch.Tensor:
    """K12 on a CUDA tensor: out [B, N, C] from fused qkv [B, N, 3C].  Takes
    the shapes ``kernel_shape`` takes, a positive scale, float32 or bf16,
    contiguous and 16-byte aligned; raises on anything else.  Not
    differentiable: ``flash_attention_qkv`` is the entry point."""
    b, n, c = kernel_shape(qkv.shape, num_heads)
    if not scale > 0:
        raise ValueError(f"K12 takes a positive scale; got {scale}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K12 takes float32 or bf16; got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K12 takes a contiguous, 16-byte aligned qkv")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    if b and n:
        launch("vit_attention", qkv.device, qkv.data_ptr(), out.data_ptr(),
               int(qkv.dtype == torch.bfloat16), b, n, num_heads, float(scale))
        vit_attention.launches += 1
    return out


vit_attention.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K12 (or the plain version on the CPU) forward; the backward of the
    JAX package's ``_bwd``: the VJP of ``attention_from_qkv_ref``,
    recomputed from the saved qkv."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv)
        if device_of(qkv) == "cpu":
            return flash_attention_plain(qkv, num_heads, scale)
        return vit_attention(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            out = attention_from_qkv_ref(x, ctx.num_heads, ctx.scale)
            (dqkv,) = torch.autograd.grad(out, x, g.to(qkv.dtype))
        return dqkv, None, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        scale: float) -> torch.Tensor:
    """out [B, N, C] from fused qkv [B, N, 3C] (q | k | v along the last
    axis): K12 on the card, its plain version on the CPU; differentiable."""
    return _FlashAttention.apply(qkv, num_heads, scale)
