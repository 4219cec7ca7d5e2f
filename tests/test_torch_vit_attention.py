"""K12's plain version, the einsum reference and the attention's gradient
in the PyTorch port against the JAX package, on the CPU.

* ``flash_attention_plain`` (the mirror of the TPU kernel's arithmetic)
  against ``_flash_kernel`` in interpret mode: ``_flash_fwd_impl`` has no
  ``interpret`` argument, so its module's ``pl`` is pointed at a shim whose
  ``pallas_call`` runs in interpret mode; nothing in the JAX package
  changes.  qkv [2, 192, 768], 4 heads x 64: three query blocks of 64.
  In bf16 the mirror must hold a tolerance that the einsum reference's
  rounding order fails, so the test tells the two orders apart.
* ``attention_from_qkv_ref`` against JAX's, in float32 and bf16.
* ``flash_attention_qkv``'s gradient against ``jax.grad`` through JAX's
  ``flash_attention_qkv`` (its VJP is the reference's), float32.
* The bench entry point refuses to run without a card.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import class_query_vad_tpu.ops.vit_attention as jva
from class_query_vad_tpu_torch.ops.vit_attention import (
    attention_from_qkv_ref,
    flash_attention_plain,
    flash_attention_qkv,
    vit_attention,
)

from torch_parity import n, t

B, N, H, D = 2, 192, 4, 64
SCALE = D ** -0.5
# float32: the same arithmetic, summed in other orders (3.7e-7 x max|ref|
# at seed 0)
F32_TOL = 1e-6
# bf16: the mirror's p and output roundings agree with the kernel's up to
# scores summed in another order (1.1e-3 x max|ref| at the test's seed);
# the einsum reference rounds the scaled q, the scores, e and p in bf16
# (6.5e-3 away)
BF16_TOL = 4e-3


@pytest.fixture
def interpret(monkeypatch):
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(jva, "pl", shim)


def _qkv(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3 * H * D)).astype(np.float32)
    return x, jnp.asarray(x, dtype)


def _rel(got, want):
    return np.abs(n(got) - n(want)).max() / np.abs(n(want)).max()


def test_k12_runs_three_query_blocks():
    assert jva._pick_bq(N) == 64 and N // jva._pick_bq(N) == 3


def test_flash_plain_matches_the_kernel_float32(interpret):
    x, xj = _qkv(0)
    want = jva._flash_fwd_impl(xj, H, SCALE)
    got = flash_attention_plain(t(x), H, SCALE)
    assert got.dtype == torch.float32 and got.shape == (B, N, H * D)
    assert _rel(got, want) <= F32_TOL


def test_flash_plain_matches_the_kernel_bf16_and_the_reference_does_not(
        interpret):
    x, xj = _qkv(1, jnp.bfloat16)
    want = jva._flash_fwd_impl(xj, H, SCALE)
    xt = t(np.asarray(xj.astype(jnp.float32))).bfloat16()
    got = flash_attention_plain(xt, H, SCALE)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= BF16_TOL
    # the einsum order is another function in bf16: it fails the tolerance
    assert _rel(attention_from_qkv_ref(xt, H, SCALE), want) > BF16_TOL


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (jnp.bfloat16, 1e-2)])
def test_reference_matches_jax(dtype, tol):
    """float32: summation order; bf16: XLA's CPU einsum and torch's may
    round the bf16 scores and outputs a ulp apart."""
    x, xj = _qkv(2, dtype)
    want = jva.attention_from_qkv_ref(xj, H, SCALE)
    xt = t(np.asarray(xj.astype(jnp.float32)))
    if dtype is jnp.bfloat16:
        xt = xt.bfloat16()
    assert _rel(attention_from_qkv_ref(xt, H, SCALE), want) <= tol


def test_gradient_matches_jax_grad(interpret):
    x, xj = _qkv(3)
    cot = np.random.default_rng(4).standard_normal((B, N, H * D)).astype(
        np.float32)
    gj = jax.grad(lambda q: (jva.flash_attention_qkv(q, H, SCALE)
                             * jnp.asarray(cot)).sum())(xj)
    xt = t(x).requires_grad_()
    before = vit_attention.launches
    flash_attention_qkv(xt, H, SCALE).backward(t(cot))
    assert vit_attention.launches == before           # CPU: the plain version
    assert _rel(xt.grad, gj) <= 1e-5


def test_bench_entry_point_needs_a_card(monkeypatch):
    from class_query_vad_tpu_torch.scripts import bench_vit_attn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        bench_vit_attn.main()
