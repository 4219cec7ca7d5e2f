"""K13's plain version, the reference composite and the FFN's gradients in
the PyTorch port against the JAX package, on the CPU.

* ``fused_ffn_plain`` (the mirror of the TPU kernel's arithmetic) against
  ``fused_ffn(..., interpret=True)``: the Pallas kernel ``_ffn_kernel`` in
  interpret mode for relu and gelu_tanh, JAX's XLA composite for
  gelu_exact (Mosaic has no erf, so the JAX op never sends it to the
  kernel); n = 300 tokens over tiles of 128, so the last tile is ragged.
* ``ffn_reference`` against JAX's.
* ``fused_ffn``'s gradients against ``jax.grad`` through JAX's
  ``fused_ffn`` (its VJP is the reference's), float32, and with bf16 x and
  float32 weights each gradient in its input's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from class_query_vad_tpu.ops import fused_ffn as jff
from class_query_vad_tpu_torch.ops.fused_ffn import (
    ACTIVATIONS,
    ffn_reference,
    fused_ffn,
    fused_ffn_kernel,
    fused_ffn_plain,
)

from torch_parity import n, t

N_TOK, C, F = 300, 128, 256
TILE = 128
# float32: the same arithmetic summed in other orders (these inputs: 0
# relu, 2.6e-7 gelu_exact, 2.2e-7 gelu_tanh, x max|ref|)
F32_TOL = 1e-5
# bf16: XLA's CPU bf16 dot rounds in places the card will not, so this
# case only bounds the dtype flow; the float32 case pins the algorithm
# (these inputs: 3.0e-4 relu, 3.5e-4 gelu_exact, 5.8e-3 gelu_tanh)
BF16_TOL = 1e-2


def _args(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N_TOK, C)).astype(np.float32),
            (rng.standard_normal((C, F)) / np.sqrt(C)).astype(np.float32),
            (0.1 * rng.standard_normal(F)).astype(np.float32),
            (rng.standard_normal((F, C)) / np.sqrt(F)).astype(np.float32),
            (0.1 * rng.standard_normal(C)).astype(np.float32)]


def _rel(got, want):
    return np.abs(n(got) - n(want)).max() / np.abs(n(want)).max()


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (jnp.bfloat16, BF16_TOL)])
def test_plain_matches_the_kernel(activation, dtype, tol):
    args = _args(ACTIVATIONS.index(activation))
    x = jnp.asarray(args[0], dtype)
    want = jff.fused_ffn(x, *map(jnp.asarray, args[1:]), activation, TILE,
                         True, False, True)
    xt = t(np.asarray(x.astype(jnp.float32)))
    if dtype is jnp.bfloat16:
        xt = xt.bfloat16()
    got = fused_ffn_plain(xt, *map(t, args[1:]), activation)
    assert got.dtype == xt.dtype and got.shape == (N_TOK, C)
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_reference_matches_jax(activation):
    args = _args(10)
    want = jff.ffn_reference(*map(jnp.asarray, args), activation)
    got = ffn_reference(*map(t, args), activation)
    assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_gradients_match_jax_grad(activation):
    args = _args(20)
    cot = np.random.default_rng(21).standard_normal((N_TOK, C)).astype(
        np.float32)
    want = jax.grad(
        lambda *a: (jff.fused_ffn(*a, activation, TILE, True, False, True)
                    * jnp.asarray(cot)).sum(),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    xs = [t(a).requires_grad_() for a in args]
    before = fused_ffn_kernel.launches
    fused_ffn(*xs, activation).backward(t(cot))
    assert fused_ffn_kernel.launches == before        # CPU: the plain version
    for x, w in zip(xs, want):
        assert _rel(x.grad, w) <= F32_TOL


def test_gradient_dtypes_follow_the_inputs():
    """bf16 x with float32 weights: the weights are used in bf16, and each
    gradient comes back in its input's dtype, as JAX's VJP gives it."""
    args = _args(30)
    jargs = [jnp.asarray(args[0], jnp.bfloat16), *map(jnp.asarray, args[1:])]
    want = jax.grad(lambda *a: jff.fused_ffn(*a).astype(jnp.float32).sum(),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
    xs = [t(np.asarray(jargs[0].astype(jnp.float32))).bfloat16(),
          *map(t, args[1:])]
    xs = [x.requires_grad_() for x in xs]
    fused_ffn(*xs).float().sum().backward()
    for x, w in zip(xs, want):
        assert x.grad.dtype == x.dtype
        assert str(w.dtype) == str(x.dtype).removeprefix("torch.")
