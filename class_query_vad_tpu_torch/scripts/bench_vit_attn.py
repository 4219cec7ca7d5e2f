"""Microbench and correctness of the ViT attention kernel K12 on the card.

    python -m class_query_vad_tpu_torch.scripts.bench_vit_attn

The port's counterpart of the repo-root ``scripts/bench_vit_attn.py`` (the
one caller of the JAX package's K12), and K12's entry point: no model path
of the port calls it.  At the JAX script's shapes (B=1, N=2560, 12 heads x
64, bf16) it prints K12's max relative error against the einsum reference
``attention_from_qkv_ref``, the device time of K12 chained x12 (one ViT
depth), beside two yardsticks on the split heads that no path of the port
routes through K12: the port ViT's own eager attention
(``models.vit.eager_attention``) and
``F.scaled_dot_product_attention``; then the gradient check of the
training path (autograd through ``flash_attention_qkv``, whose backward
recomputes the reference, against autograd of the reference).  Needs a
CUDA card; raises without one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vit import eager_attention
from ..ops.vit_attention import (attention_from_qkv_ref, flash_attention_qkv,
                                 merge_heads, split_qkv)

B, N, H, D = 1, 2560, 12, 64
DEPTH = 12                       # one ViT-B's attention blocks


def vit_eager_attention(qkv: torch.Tensor, scale: float,
                        heads: int = H) -> torch.Tensor:
    """The port ViT's own attention (``models.vit.eager_attention``) on
    fused qkv."""
    return eager_attention(*(x.transpose(1, 2) for x in split_qkv(qkv, heads)),
                           scale)


def sdpa_attention(qkv: torch.Tensor, scale: float,
                   heads: int = H) -> torch.Tensor:
    """``F.scaled_dot_product_attention`` on the split heads: a yardstick
    only, which no path of the port calls."""
    return merge_heads(F.scaled_dot_product_attention(*split_qkv(qkv, heads),
                                                      scale=scale))


def chained_ms(fn, qkv: torch.Tensor, iters: int = 10) -> float:
    """Mean device ms of ``DEPTH`` calls back to back (CUDA events)."""
    for _ in range(2):
        fn(qkv)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        for _ in range(DEPTH):
            fn(qkv)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (want.abs().max() + 1e-9)).item()


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_vit_attn needs a CUDA card")
    dev = torch.device("cuda", 0)
    scale = D ** -0.5
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((B, N, 3 * H * D), generator=g).to(dev, torch.bfloat16)

    res = {"rel_err": _rel(flash_attention_qkv(qkv, H, scale),
                           attention_from_qkv_ref(qkv, H, scale))}
    print(f"max rel err vs einsum ref (bf16): {res['rel_err']:.2e}")

    with torch.inference_mode():
        for name, fn in (("K12", lambda x: flash_attention_qkv(x, H, scale)),
                         ("vit_eager", lambda x: vit_eager_attention(x, scale)),
                         ("sdpa", lambda x: sdpa_attention(x, scale))):
            ms = chained_ms(fn, qkv)
            res[f"{name}_ms"] = ms
            print(f"{name:10s} x{DEPTH} blocks: {ms:7.3f} ms  "
                  f"({ms / DEPTH:6.3f} ms/block)")

    x32 = torch.randn((B, N, 3 * H * D), generator=g).to(dev)
    grads = []
    for fn in (flash_attention_qkv, attention_from_qkv_ref):
        x = x32.clone().requires_grad_()
        (fn(x.bfloat16(), H, scale).float() ** 2).sum().backward()
        grads.append(x.grad)
    res["grad_rel_err"] = _rel(*grads)
    print(f"grad max rel err: {res['grad_rel_err']:.2e}")
    return res


if __name__ == "__main__":
    main()
