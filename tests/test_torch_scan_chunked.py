"""K5's chunked order on the CPU: ``selective_scan_chunked`` (the plain
mirror of ``csrc/selective_scan.cu``: chunks scanned from zero, their
carries folded, then rescanned) against the JAX package's scans, the
associative ``selective_scan``, the sequential ``selective_scan_sequential``
and the Pallas ``selective_scan_pallas`` (interpret mode, where its kernel
tiles: L a multiple of 32, KD a multiple of 128).  Lengths cover one chunk
(L <= chunk, L = 1), exact multiples, one step past one, and several chunks
plus a remainder; N in {4, 8, 16}, G in {1, 4}; D, delta_bias and the
softplus each on and off; the last state.  Inputs come from numpy with a
seed.  The kernel itself is held to the plain version on a card in
tests/test_torch_cuda.py.

Tolerance: float32 on both sides, summed in other orders (the mirror folds
exp(A * sum delta) where the others multiply the steps' decays): 1e-5 x
max|y| and max|last state|, the plain version's standard
(tests/test_torch_selective_scan.py), where a wrong carry is O(1e-1).
bf16 outputs add one bf16 rounding (2^-8 relative) on either side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.selective_scan import selective_scan as j_scan
from class_query_vad_tpu.ops.selective_scan import (
    selective_scan_sequential as j_scan_sequential,
)
from class_query_vad_tpu.ops.selective_scan_pallas import (
    selective_scan_pallas as j_scan_pallas,
)
from class_query_vad_tpu_torch.ops.selective_scan import (
    scan_chunk,
    selective_scan_chunked,
    selective_scan_reference,
)

from torch_parity import jit_opt0, n, t

TOL = 1e-5
BF16_TOL = 2 ** -7
CHUNK = 32

FLAGS = {                                  # (D, delta_bias, softplus)
    "all": (True, True, True),
    "none": (False, False, False),
    "softplus": (False, False, True),
    "skip_bias": (True, True, False),
}

# (L, N, G, flags): L = 1, under a chunk, a chunk, a chunk + 1, three
# chunks + 5; every N and G, every flag set
CASES = [
    (1, 4, 1, "all"), (1, 16, 4, "none"),
    (37, 8, 1, "softplus"), (37, 16, 4, "skip_bias"), (37, 4, 4, "all"),
    (CHUNK, 16, 1, "all"), (CHUNK, 4, 4, "none"),
    (CHUNK + 1, 8, 4, "all"), (CHUNK + 1, 16, 1, "softplus"),
    (3 * CHUNK + 5, 4, 1, "skip_bias"), (3 * CHUNK + 5, 8, 4, "all"),
    (3 * CHUNK + 5, 16, 4, "none"),
]


def _inputs(b, kd, length, ns, g, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    # delta and its bias >= 0: without the softplus a negative step size
    # would make the recurrence grow
    return dict(u=f(b, kd, length), delta=np.abs(0.5 * f(b, kd, length)),
                A=-np.exp(f(kd, ns)), B=f(b, g, ns, length),
                C=f(b, g, ns, length), D=f(kd),
                delta_bias=np.abs(0.3 * f(kd)))


def _call(fn, x, flags, wrap, **kw):
    """``fn`` on ``x`` with ``flags``; a JAX function (``wrap``
    ``jnp.asarray``) jitted (``jit_opt0``)."""
    d, bias, softplus = FLAGS[flags]

    def call(u, delta, A, B, C, D, delta_bias):
        return fn(u, delta, A, B, C, D, delta_bias=delta_bias,
                  delta_softplus=softplus, **kw)

    args = (wrap(x["u"]), wrap(x["delta"]), wrap(x["A"]), wrap(x["B"]),
            wrap(x["C"]), wrap(x["D"]) if d else None,
            wrap(x["delta_bias"]) if bias else None)
    return jit_opt0(call, *args) if wrap is jnp.asarray else call(*args)


def _close(got, want, tol=TOL):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|err| = {err:.2e} x max|y| > {tol:.0e}"


def _chunked(x, flags, chunk=CHUNK, **kw):
    return _call(selective_scan_chunked, x, flags, t, chunk=chunk, **kw)


@pytest.mark.parametrize("length,ns,g,flags", CASES,
                         ids=lambda v: str(v))
def test_chunked_matches_jax_associative(length, ns, g, flags):
    x = _inputs(2, 16, length, ns, g, seed=length + ns + g)
    y_t, last_t = _chunked(x, flags, return_last_state=True)
    y_j, last_j = _call(j_scan, x, flags, jnp.asarray, return_last_state=True)
    _close(y_t, y_j)
    _close(last_t, last_j)


@pytest.mark.parametrize("length,ns,g,flags", CASES[::2],
                         ids=lambda v: str(v))
def test_chunked_matches_jax_sequential(length, ns, g, flags):
    x = _inputs(1, 8 * g, length, ns, g, seed=7 * length + ns)
    y_t, last_t = _chunked(x, flags, return_last_state=True)
    y_j, last_j = _call(j_scan_sequential, x, flags, jnp.asarray,
                        return_last_state=True)
    _close(y_t, y_j)
    _close(last_t, last_j)


@pytest.mark.parametrize("length,ns,g,flags", [
    (64, 4, 1, "all"), (96, 8, 4, "none"), (96, 16, 1, "skip_bias"),
    (64, 4, 4, "softplus")], ids=lambda v: str(v))
def test_chunked_matches_pallas(length, ns, g, flags):
    """KD = 128 and L a multiple of 32 take the Pallas kernel (interpret
    mode on the CPU), its own chunks 32 steps; the mirror's are 48, so
    that the two cut L differently."""
    x = _inputs(1, 128, length, ns, g, seed=length * ns)
    _close(_chunked(x, flags, chunk=48),
           _call(j_scan_pallas, x, flags, jnp.asarray, chunk=32))


def test_chunked_bf16_inputs_at_the_kernels_chunk():
    """bf16 u, B, C and y with a float32 delta (the bf16 backbone's dtypes)
    at the chunk the wrapper picks for this shape: both sides carry
    float32 and round y to bf16 once."""
    b, kd, length, ns, g = 2, 64, 1281, 16, 1
    chunk = scan_chunk(b, kd, length, g)
    assert length > 2 * chunk             # several chunks and a remainder
    x = _inputs(b, kd, length, ns, g, seed=11)
    bf = lambda a: t(a, torch.bfloat16)
    y_t = selective_scan_chunked(
        bf(x["u"]), t(x["delta"]), t(x["A"]), bf(x["B"]), bf(x["C"]),
        t(x["D"]), t(x["delta_bias"]), True, chunk=chunk)
    y_j = jit_opt0(
        lambda u, delta, A, B, C, D, bias: j_scan(
            u, delta, A, B, C, D, delta_bias=bias, delta_softplus=True),
        jnp.asarray(x["u"], jnp.bfloat16), jnp.asarray(x["delta"]),
        jnp.asarray(x["A"]), jnp.asarray(x["B"], jnp.bfloat16),
        jnp.asarray(x["C"], jnp.bfloat16), jnp.asarray(x["D"]),
        jnp.asarray(x["delta_bias"]))
    assert y_t.dtype == torch.bfloat16
    _close(y_t, y_j, BF16_TOL)


@pytest.mark.parametrize("shape,chunk", [
    ((2, 384, 5121, 1), 128),             # the VSS backbone's scans
    ((2, 1024, 320, 4), 32),              # the VSS encoder's
    ((1, 96, 37, 2), 32),                 # two chunks, the last of 5 steps
    ((1, 8, 1, 1), 32),                   # one step
])
def test_scan_chunk_is_a_multiple_of_the_sub_tile(shape, chunk):
    """The wrapper's chunk: a multiple of the kernel's 16-step sub-tiles,
    at least 32, and at the backbone's shape enough chunks for ~500
    blocks of 64 channels; the mirror at that chunk equals the plain scan
    on a short slice of the shape."""
    got = scan_chunk(*shape)
    assert got == chunk and got % 16 == 0
    b, kd, length, g = shape
    x = _inputs(1, 8 * g, min(length, 2 * got + 3), 4, g, seed=got)
    _close(_chunked(x, "all", chunk=got), _call(selective_scan_reference, x, "all", t))
