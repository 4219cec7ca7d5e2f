"""K5's plain version (``ops/selective_scan.py``) against the JAX package's
selective scans, on the CPU: the associative ``selective_scan`` and the
Pallas ``selective_scan_pallas`` (interpret mode at the shapes its kernel
tiles, KD=128 and L=64; its associative fallback at an odd L), with the
flags on and off, bf16 u/B/C against a float32 delta, and the last state.
Inputs come from numpy with a seed.  The kernel against the plain version
on a card is in tests/test_torch_cuda.py.

Tolerance: float32 on both sides; the recurrence runs sequentially here
and as a tree (associative) or per chunk (Pallas) there, so y differs by
rounding only: 1e-5 x max|y| (measured ~2e-7), where a slip (a missing
bias, softplus or skip term, a wrong group) is O(1e-1).  bf16 outputs add
one bf16 rounding (2^-8 relative) on either side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.selective_scan import selective_scan as j_scan
from class_query_vad_tpu.ops.selective_scan_pallas import (
    selective_scan_pallas as j_scan_pallas,
)
from class_query_vad_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_reference,
)

from torch_parity import n, t

TOL = 1e-5
BF16_TOL = 2 ** -7


def _inputs(b, kd, length, ns, g, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    # delta and its bias >= 0: without the softplus a negative step size
    # would make the recurrence grow
    return dict(u=f(b, kd, length), delta=np.abs(0.5 * f(b, kd, length)),
                A=-np.exp(f(kd, ns)), B=f(b, g, ns, length),
                C=f(b, g, ns, length), D=f(kd),
                delta_bias=np.abs(0.3 * f(kd)))


FLAGS = {                                  # (D, delta_bias, softplus)
    "all": (True, True, True),
    "none": (False, False, False),
    "softplus": (False, False, True),
    "skip_bias": (True, True, False),
}


def _call(fn, x, flags, wrap, **kw):
    d, bias, softplus = FLAGS[flags]
    return fn(wrap(x["u"]), wrap(x["delta"]), wrap(x["A"]), wrap(x["B"]),
              wrap(x["C"]), wrap(x["D"]) if d else None,
              delta_bias=wrap(x["delta_bias"]) if bias else None,
              delta_softplus=softplus, **kw)


def _close(got, want, tol=TOL):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max|err| = {err:.2e} x max|y| > {tol:.0e}"


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("shape", [(2, 128, 64, 4, 1), (2, 128, 64, 4, 4),
                                   (1, 96, 37, 8, 2), (2, 24, 130, 16, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_scan_matches_jax_associative(shape, flags):
    x = _inputs(*shape)
    y_t, last_t = _call(selective_scan_reference, x, flags, t,
                        return_last_state=True)
    y_j, last_j = _call(j_scan, x, flags, jnp.asarray, return_last_state=True)
    _close(y_t, y_j)
    _close(last_t, last_j)


@pytest.mark.parametrize("flags", ["all", "none"])
@pytest.mark.parametrize("shape", [(2, 128, 64, 4, 1), (2, 128, 64, 4, 4),
                                   (1, 96, 37, 8, 2)],
                         ids=["pallas_g1", "pallas_g4", "odd_L_fallback"])
def test_plain_scan_matches_pallas(shape, flags):
    """KD=128, L=64 take the Pallas kernel (interpret mode on the CPU);
    L=37 falls back to the associative scan inside the same entry point."""
    x = _inputs(*shape, seed=1)
    _close(_call(selective_scan_reference, x, flags, t),
           _call(j_scan_pallas, x, flags, jnp.asarray))


@pytest.mark.parametrize("shape", [(2, 128, 64, 4, 4), (1, 48, 41, 16, 1)],
                         ids=["g4", "odd_L"])
def test_plain_scan_bf16_inputs(shape):
    """bf16 u, B, C and y with a float32 delta (the bf16 backbone's dtypes):
    both sides carry float32 and round y to bf16 once."""
    x = _inputs(*shape, seed=2)
    bf = lambda a: t(a, torch.bfloat16)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    args_t = [bf(x["u"]), t(x["delta"]), t(x["A"]), bf(x["B"]), bf(x["C"]),
              t(x["D"])]
    args_j = [jb(x["u"]), jnp.asarray(x["delta"]), jnp.asarray(x["A"]),
              jb(x["B"]), jb(x["C"]), jnp.asarray(x["D"])]
    y_t = selective_scan_reference(*args_t, delta_bias=t(x["delta_bias"]),
                                   delta_softplus=True)
    y_j = j_scan_pallas(*args_j, delta_bias=jnp.asarray(x["delta_bias"]),
                        delta_softplus=True)
    assert y_t.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    _close(y_t, y_j, BF16_TOL)


def test_ungrouped_bc_equal_one_group():
    """B, C given as [B, N, L] are one group, as in the JAX contract."""
    x = _inputs(2, 16, 20, 4, 1, seed=3)
    y4 = _call(selective_scan_reference, x, "all", t)
    x3 = dict(x, B=x["B"][:, 0], C=x["C"][:, 0])
    torch.testing.assert_close(_call(selective_scan_reference, x3, "all", t),
                               y4, rtol=0, atol=0)


def test_wrapper_takes_cpu_tensors_to_the_plain_version():
    """On CPU tensors the wrapper is the plain version (no launch), strided
    views included, and autograd runs through it."""
    x = _inputs(2, 16, 20, 4, 1, seed=4)
    before = selective_scan.launches
    want = _call(selective_scan_reference, x, "all", t)
    # u and delta as time-major views, as the backbone hands them over
    ut = t(x["u"]).transpose(1, 2).contiguous().transpose(1, 2)
    dt = t(x["delta"]).transpose(1, 2).contiguous().transpose(1, 2)
    ut.requires_grad_()
    got = selective_scan(ut, dt, t(x["A"]), t(x["B"]), t(x["C"]), t(x["D"]),
                         delta_bias=t(x["delta_bias"]), delta_softplus=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()
    assert ut.grad is not None and torch.isfinite(ut.grad).all()
    assert selective_scan.launches == before


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    meta = lambda *s: torch.empty(s, device="meta")
    before = selective_scan.launches
    with pytest.raises(ValueError):
        selective_scan(meta(1, 8, 5), meta(1, 8, 5), meta(8, 4),
                       meta(1, 1, 4, 5), meta(1, 1, 4, 5))
    with pytest.raises(ValueError):          # one CPU, one meta tensor
        selective_scan(torch.zeros(1, 8, 5), meta(1, 8, 5), meta(8, 4),
                       meta(1, 1, 4, 5), meta(1, 1, 4, 5))
    assert selective_scan.launches == before
