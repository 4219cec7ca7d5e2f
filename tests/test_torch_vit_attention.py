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
* ``flash_attention_plain`` in the card kernel's pass-1 order
  (``keys_per_tile``: the running max and sum over tiles of 64 or 128
  keys) against the same interpret-mode kernel, also at a ragged N = 200
  (one query block of 200 rows, ``_pick_bq`` patched: the JAX kernel itself
  takes only multiples of 64).
* ``flash_attention_qkv``'s gradient against ``jax.grad`` through JAX's
  ``flash_attention_qkv`` (its VJP is the reference's), float32.
* The port's K12 takes every N that JAX's kernel takes (``kernel_shape``,
  the wrapper's shape rules, in pure Python).
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
    kernel_shape,
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


def _qkv(seed, dtype=np.float32, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, 3 * H * D)).astype(np.float32)
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


@functools.lru_cache(maxsize=None)
def _kernel_out(dtype, n):
    """qkv (float32 numpy, seed 5) and the interpret-mode kernel's output
    at (dtype, n); one query block of n rows when n is not a multiple of
    64."""
    x, xj = _qkv(5, dtype, n)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jva, "pl", types.SimpleNamespace(
            pallas_call=functools.partial(pl.pallas_call, interpret=True),
            BlockSpec=pl.BlockSpec))
        if n % 64:
            mp.setattr(jva, "_pick_bq", lambda m: m)
        want = np.asarray(jva._flash_fwd_impl(xj, H, SCALE).astype(jnp.float32))
    return np.asarray(xj.astype(jnp.float32)), want


@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (jnp.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("keys_per_tile", [64, 128])
@pytest.mark.parametrize("n", [N, 200])
def test_flash_plain_in_tiles_matches_the_kernel(dtype, tol, keys_per_tile, n):
    """The card kernel's order: (m, l) by the running recurrence over key
    tiles (l rescaled when m grows) differs from the whole row's in the
    sum's order only."""
    x, want = _kernel_out(dtype, n)
    xt = t(x) if dtype is np.float32 else t(x).bfloat16()
    got = flash_attention_plain(xt, H, SCALE, keys_per_tile=keys_per_tile)
    assert got.dtype == xt.dtype and got.shape == (B, n, H * D)
    assert _rel(got, want) <= tol


def test_kernel_takes_every_token_count_jax_takes():
    """Every N at which JAX's flash kernel runs at ViT-B's 12 x 64 (the
    multiples of 64 up to its VMEM limit, 57,344), e.g. 4096 (a 16-frame
    256x512 clip), and N that it does not (1001); its head dim only."""
    heads, c = 12, 768
    ns = [n for n in range(64, 65536, 64) if jva.flash_supported(n, c, heads)]
    assert {2560, 4096, 10240, 57344} <= set(ns) and max(ns) == 57344
    for n in ns + [1, 1001, 70000]:
        assert kernel_shape((2, n, 3 * c), heads) == (2, n, c)
    with pytest.raises(ValueError):
        kernel_shape((2, 64, 3 * c), 24)                  # head dim 32
    with pytest.raises(ValueError):
        kernel_shape((2, 64, 3 * c + 3), heads)


def test_bench_entry_point_needs_a_card(monkeypatch):
    from class_query_vad_tpu_torch.scripts import bench_vit_attn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        bench_vit_attn.main()
