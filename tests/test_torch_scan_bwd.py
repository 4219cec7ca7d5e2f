"""K5's backward on the CPU: the plain versions ``selective_scan_bwd_reference``
(sequential over L) and ``selective_scan_bwd_chunked`` (the backward
kernel's chunked order: chunk adjoints from zero, their carries folded from
the last chunk, every chunk's states recomputed from the forward's carry-ins
and walked backward, dB / dC summed per block of 256 / N channels) against
``jax.vjp`` of the JAX package's scans: the associative ``selective_scan``,
the sequential ``selective_scan_sequential`` and the Pallas
``selective_scan_pallas`` (interpret mode on the CPU, where its kernel
tiles: KD a multiple of 128, L of 32; its VJP is the associative scan's).
Lengths under a chunk, exact multiples and one step past them; G in {1, 2,
4}, N in {4, 8, 16}; D, delta_bias and the softplus each on and off; the
last state's gradient; bf16 u, B and C.  Also ``SelectiveScanFn`` (what
``selective_scan`` runs under autograd) against autograd through
``selective_scan_reference``.  The kernel itself is held to the plain
version on a card in tests/test_torch_cuda.py.

Tolerances, x max|grad| of each gradient: float32 1e-5 for the per-step
gradients (du, ddelta, dB, dC; measured ~2e-7), 1e-4 for dA, dD and d
delta_bias, sums over B x L steps; bf16 1e-2 (du, dB and dC are rounded to
bf16 on both sides, 2^-8 of the largest).  A wrong adjoint, a missed carry
or a term dropped is O(1e-1).
"""

import functools

import jax
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
    selective_scan,
    selective_scan_bwd,
    selective_scan_bwd_chunked,
    selective_scan_bwd_reference,
    selective_scan_reference,
)

from torch_parity import n, t

TOL, SUM_TOL, BF16_TOL = 1e-5, 1e-4, 1e-2
CHUNK = 32
NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")
SUMS = ("A", "D", "delta_bias")

FLAGS = {                                  # (D, delta_bias, softplus)
    "all": (True, True, True),
    "none": (False, False, False),
    "softplus": (False, False, True),
    "skip_bias": (True, True, False),
}

# (L, N, G, flags): under a chunk, one and two chunks exactly, one step past
# them; every N, G and flag set
CASES = [
    (20, 4, 1, "all"), (20, 16, 2, "none"), (20, 8, 4, "softplus"),
    (CHUNK, 8, 1, "skip_bias"), (CHUNK + 1, 16, 4, "all"),
    (2 * CHUNK, 4, 2, "softplus"), (2 * CHUNK, 16, 1, "all"),
    (2 * CHUNK + 1, 8, 2, "all"), (2 * CHUNK + 1, 4, 4, "skip_bias"),
    (2 * CHUNK + 1, 16, 1, "none"),
]


def _inputs(b, kd, length, ns, g, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    # delta and its bias >= 0: without the softplus a negative step size
    # would make the recurrence grow
    return dict(u=f(b, kd, length), delta=np.abs(0.5 * f(b, kd, length)),
                A=-np.exp(f(kd, ns)), B=f(b, g, ns, length),
                C=f(b, g, ns, length), D=f(kd),
                delta_bias=np.abs(0.3 * f(kd)), dy=f(b, kd, length),
                dlast=f(b, kd, ns))


def _present(flags):
    d, bias, _ = FLAGS[flags]
    return [k for k in NAMES if (k != "D" or d) and (k != "delta_bias" or bias)]


@functools.lru_cache(maxsize=None)
def _jax_grads(fn, shape, flags, last: bool = True, bf16: bool = False, **kw):
    """{name: gradient} of ``fn``'s y (and last state) against dy (and
    dlast), through ``jax.vjp`` (jitted: eager, the associative scan's VJP
    takes ~10 s a case), on ``_inputs(*shape)``."""
    x = _inputs(*shape)
    softplus = FLAGS[flags][2]
    names = _present(flags)
    low = lambda k: jnp.bfloat16 if bf16 and k in ("u", "B", "C") else jnp.float32
    args = [jnp.asarray(x[k], low(k)) for k in names]

    def f(*a):
        v = dict(zip(names, a))
        return fn(v["u"], v["delta"], v["A"], v["B"], v["C"], v.get("D"),
                  delta_bias=v.get("delta_bias"), delta_softplus=softplus,
                  **({"return_last_state": True} if last else {}), **kw)

    dy = jnp.asarray(x["dy"], low("u"))
    cot = (dy, jnp.asarray(x["dlast"])) if last else dy
    grads = jax.jit(lambda a, c: jax.vjp(f, *a)[1](c))(args, cot)
    return dict(zip(names, grads))


def _torch_grads(fn, x, flags, last: bool = True, bf16: bool = False, **kw):
    d, bias, softplus = FLAGS[flags]
    low = lambda k: t(x[k], torch.bfloat16 if bf16 else None)
    got = fn(low("u"), t(x["delta"]), t(x["A"]), low("B"), low("C"), low("dy"),
             D=t(x["D"]) if d else None,
             delta_bias=t(x["delta_bias"]) if bias else None,
             delta_softplus=softplus, dlast=t(x["dlast"]) if last else None,
             **kw)
    return dict(zip(NAMES, got))


def _close(got, want, bf16: bool = False):
    assert sorted(k for k, v in got.items() if v is not None) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if bf16 and k in ("u", "B", "C"):
            assert g.dtype == torch.bfloat16, k
        tol = BF16_TOL if bf16 else (SUM_TOL if k in SUMS else TOL)
        err = np.abs(n(g) - n(w)).max() / np.abs(n(w)).max()
        assert err <= tol, f"d{k}: max|err| = {err:.2e} x max|grad| > {tol:.0e}"


@pytest.mark.parametrize("fn", ["reference", "chunked"])
@pytest.mark.parametrize("length,ns,g,flags", CASES, ids=lambda v: str(v))
def test_bwd_matches_jax_associative_vjp(fn, length, ns, g, flags):
    shape = (2, 32, length, ns, g, 3 * length + ns + g)
    bwd = (selective_scan_bwd_reference if fn == "reference" else
           selective_scan_bwd_chunked)
    kw = {} if fn == "reference" else {"chunk": CHUNK}
    _close(_torch_grads(bwd, _inputs(*shape), flags, **kw),
           _jax_grads(j_scan, shape, flags))


@pytest.mark.parametrize("length,ns,g,flags", CASES[::3], ids=lambda v: str(v))
def test_bwd_chunked_matches_jax_sequential_vjp(length, ns, g, flags):
    shape = (1, 16 * g, length, ns, g, 5 * length + ns)
    got = _torch_grads(selective_scan_bwd_chunked, _inputs(*shape), flags,
                       chunk=CHUNK)
    _close(got, _jax_grads(j_scan_sequential, shape, flags))


@pytest.mark.parametrize("length,ns,g,flags", [
    (64, 4, 1, "all"), (96, 16, 4, "none"), (64, 8, 2, "skip_bias")],
    ids=lambda v: str(v))
def test_bwd_matches_pallas_vjp(length, ns, g, flags):
    """KD = 128 and L a multiple of 32 take the Pallas forward (interpret
    mode); the mirror's chunks are 48 steps, the Pallas kernel's 32."""
    shape = (1, 128, length, ns, g, length * ns)
    x = _inputs(*shape)
    want = _jax_grads(j_scan_pallas, shape, flags, last=False, chunk=32)
    _close(_torch_grads(selective_scan_bwd_reference, x, flags, last=False), want)
    _close(_torch_grads(selective_scan_bwd_chunked, x, flags, last=False,
                        chunk=48), want)


@pytest.mark.parametrize("fn", ["reference", "chunked"])
def test_bwd_bf16_inputs(fn):
    """bf16 u, B, C (and so y and dy) with a float32 delta, the bf16
    backbone's dtypes, at three chunks and a remainder: du, dB and dC come
    back in bf16, as JAX's VJP returns them."""
    shape = (2, 32, 3 * CHUNK + 7, 16, 1, 11)
    bwd = (selective_scan_bwd_reference if fn == "reference" else
           selective_scan_bwd_chunked)
    kw = {} if fn == "reference" else {"chunk": CHUNK}
    _close(_torch_grads(bwd, _inputs(*shape), "all", bf16=True, **kw),
           _jax_grads(j_scan, shape, "all", bf16=True), bf16=True)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("grouped", [True, False])
def test_selective_scan_fn_matches_autograd_through_the_reference(flags, grouped):
    """``selective_scan`` with gradients on (``SelectiveScanFn``: the
    reference forward, the explicit backward) against autograd through
    ``selective_scan_reference``: y, the last state and every input's
    gradient, including [B, N, L] B / C without a group axis and the
    optional D / delta_bias."""
    x = _inputs(2, 24, 45, 8, 1, seed=17)
    if not grouped:
        x["B"], x["C"] = x["B"][:, 0], x["C"][:, 0]
    d, bias, softplus = FLAGS[flags]
    names = _present(flags)
    outs, grads = [], []
    for fn in (selective_scan, selective_scan_reference):
        leaves = {k: t(x[k]).requires_grad_(True) for k in names}
        y, last = fn(leaves["u"], leaves["delta"], leaves["A"], leaves["B"],
                     leaves["C"], leaves.get("D"), leaves.get("delta_bias"),
                     softplus, True)
        ((y * t(x["dy"])).sum() + (last * t(x["dlast"])).sum()).backward()
        outs.append((y, last))
        grads.append({k: v.grad for k, v in leaves.items()})
    assert outs[0][0].grad_fn.name() == "SelectiveScanFnBackward"
    for a, b in zip(*outs):
        np.testing.assert_array_equal(n(a), n(b))
    for k in names:
        assert grads[0][k].shape == grads[1][k].shape, k
    _close(grads[0], grads[1])


def test_selective_scan_fn_keeps_input_dtypes():
    """bf16 u / B / C and a float32 delta, A, D, bias: each gradient in its
    input's dtype; under no_grad the plain forward alone, no graph."""
    x = _inputs(1, 16, 40, 4, 1, seed=23)
    low = {"u", "B", "C"}
    leaves = {k: t(x[k], torch.bfloat16 if k in low else None).requires_grad_(True)
              for k in NAMES}
    args = [leaves[k] for k in NAMES]
    y = selective_scan(*args, delta_softplus=True)
    assert y.dtype == torch.bfloat16
    (y.float() * t(x["dy"])).sum().backward()
    for k, v in leaves.items():
        assert v.grad.dtype == v.dtype, k
    with torch.no_grad():
        y0 = selective_scan(*args, delta_softplus=True)
    assert y0.grad_fn is None
    np.testing.assert_array_equal(n(y0), n(y))


def test_bwd_wrapper_takes_cpu_tensors_to_the_reference():
    """``selective_scan_bwd`` on CPU tensors is the reference (no kernel
    launch counted); a mix of devices raises."""
    x = _inputs(1, 16, 33, 4, 2, seed=29)
    before = selective_scan_bwd.launches
    got = _torch_grads(selective_scan_bwd, x, "all")
    want = _torch_grads(selective_scan_bwd_reference, x, "all")
    assert selective_scan_bwd.launches == before
    for k in NAMES:
        np.testing.assert_array_equal(n(got[k]), n(want[k]))
    meta = torch.empty(x["dy"].shape, device="meta")
    with pytest.raises(ValueError, match="CPU tensors or CUDA tensors"):
        selective_scan_bwd(t(x["u"]), t(x["delta"]), t(x["A"]), t(x["B"]),
                           t(x["C"]), meta)
