"""Fused two-matmul FFN, out = act(x W1 + b1) W2 + b2: kernel K13, its
plain PyTorch version, the reference composite and the autograd wiring.

Counterpart of ``class_query_vad_tpu/ops/fused_ffn.py``: the TPU kernel is
``_ffn_kernel`` (K13, :74; ``pallas_call`` in ``fused_ffn`` :128), reached
through the ``custom_vjp`` ``fused_ffn`` (:100).  On the card it is
``csrc/fused_ffn.cu``; what it computes, what bounds it and its design are
in that file's header.

Layout (the JAX package's): x [N, C], w1 [C, F], b1 [F], w2 [F, C], b2
[C]; a port ``Linear``'s weight is the transpose ([out, in]).  The weights
are used in x's dtype, as the JAX op casts them.  Each dot accumulates in
float32 and is rounded to that dtype before its bias is added in it (a
flax ``Dense`` chain); ``F.linear(x, w, b)`` adds the bias before rounding
and so is not the same function in bf16.  The kernel takes C in (256,
768) and F a multiple of 64: the port's encoder, decoder and VSS FFNs
(256 -> 1024 or 2048) and the ViT MLP (768 -> 3072).  The activations are
``relu``, ``gelu_exact`` and ``gelu_tanh`` (the GELUs in float32, then
cast back).  The JAX op sends ``gelu_exact`` to its XLA composite only
because Mosaic has no ``erf``; the card has ``erff``, so K13 takes all
three.  The TPU-only arguments (``tile``, ``use_pallas``, ``precise``,
``interpret``) have no counterpart.

As in the JAX package, no model path calls it (its FFNs keep their
``Linear`` pair).  ``fused_ffn`` is differentiable: its forward takes CPU
tensors to the plain version and CUDA tensors to K13; anything else
raises, and there is no fallback.  Its backward is autograd through
``ffn_reference``, as the JAX package's ``_fused_ffn_bwd`` (:158), and
returns each gradient in its input's dtype.  ``fused_ffn_kernel`` launches
the kernel and counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_build import device_of, launch, plain_version

ACTIVATIONS = ("relu", "gelu_exact", "gelu_tanh")
KERNEL_WIDTHS = (256, 768)           # C the kernel takes
HIDDEN_CHUNK = 64                    # F must be a multiple of it


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return F.relu(h)
    if kind == "gelu_exact":
        return F.gelu(h.float()).to(h.dtype)
    if kind == "gelu_tanh":
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)
    raise ValueError(f"unknown activation {kind!r}")


def _check(x, w1, b1, w2, b2, activation: str):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("x, w1, w2 must be matrices")
    n, c = x.shape
    f = w1.shape[1]
    if (tuple(w1.shape) != (c, f) or tuple(w2.shape) != (f, c)
            or tuple(b1.shape) != (f,) or tuple(b2.shape) != (c,)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}: "
            f"want x [N, C], w1 [C, F], b1 [F], w2 [F, C], b2 [C]")
    return n, c, f


def ffn_reference(x, w1, b1, w2, b2, activation: str = "relu",
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """The JAX package's ``ffn_reference`` (fused_ffn.py:88): the flax
    Dense chain in ``dtype`` (x's by default), each matmul's output in that
    dtype before its bias is added."""
    dt = dtype or x.dtype
    h = x.to(dt) @ w1.to(dt) + b1.to(dt)
    h = _act(h, activation)
    return h @ w2.to(dt) + b2.to(dt)


def fused_ffn_plain(x, w1, b1, w2, b2,
                    activation: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of K13, in ``_ffn_kernel``'s order (:74-85):
    each dot accumulated in float32, rounded to x's dtype, then its bias
    added in that dtype.  Any device."""
    _check(x, w1, b1, w2, b2, activation)
    dt = x.dtype
    h = (x.float() @ w1.to(dt).float()).to(dt) + b1.to(dt)
    h = _act(h, activation)
    return (h.float() @ w2.to(dt).float()).to(dt) + b2.to(dt)


def fused_ffn_kernel(x, w1, b1, w2, b2,
                     activation: str = "relu") -> torch.Tensor:
    """K13 on CUDA tensors: [N, C] out.  Takes C in ``KERNEL_WIDTHS``, F a
    multiple of 64, float32 or bf16 x, contiguous and 16-byte aligned;
    casts the weights and biases to x's dtype (w1 and w2 then 16-byte
    aligned).  Raises on anything else.  Not differentiable: ``fused_ffn``
    is the entry point."""
    n, c, f = _check(x, w1, b1, w2, b2, activation)
    if c not in KERNEL_WIDTHS or f % HIDDEN_CHUNK or f == 0:
        raise ValueError(f"K13 takes C in {KERNEL_WIDTHS} and F a multiple "
                         f"of {HIDDEN_CHUNK}; got C={c}, F={f}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K13 takes float32 or bf16; got {dt}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K13 takes a contiguous, 16-byte aligned x")
    w1, b1, w2, b2 = (w.to(dt).contiguous() for w in (w1, b1, w2, b2))
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("K13's tensor maps take 16-byte aligned w1 and w2")
    out = torch.empty((n, c), dtype=dt, device=x.device)
    if n:
        launch("fused_ffn", x.device, x.data_ptr(), w1.data_ptr(),
               b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
               int(dt == torch.bfloat16), ACTIVATIONS.index(activation), n,
               c, f)
        fused_ffn_kernel.launches += 1
    return out


fused_ffn_kernel.launches = 0


class _FusedFFN(torch.autograd.Function):
    """K13 (or the plain version on the CPU) forward; the backward of the
    JAX package's ``_fused_ffn_bwd``: the VJP of ``ffn_reference``,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        ctx.activation = activation
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if device_of(x, w1, b1, w2, b2) == "cpu":
            return plain_version(True, fused_ffn_plain, x, w1, b1, w2, b2,
                                 activation)
        return fused_ffn_kernel(x, w1, b1, w2, b2, activation)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [s.detach().requires_grad_() for s in saved]
            out = ffn_reference(*leaves, activation=ctx.activation)
            grads = torch.autograd.grad(out, leaves, g.to(out.dtype))
        return (*grads, None)


def fused_ffn(x, w1, b1, w2, b2, activation: str = "relu") -> torch.Tensor:
    """act(x w1 + b1) w2 + b2 for x [N, C]: K13 on the card, its plain
    version on the CPU; differentiable."""
    return _FusedFFN.apply(x, w1, b1, w2, b2, activation)
