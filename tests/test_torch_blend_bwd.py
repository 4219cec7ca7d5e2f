"""The blend kernels' plain versions against the JAX package's Pallas
kernels in interpret mode, on the CPU:

* ``blend2d_reference`` against ``_blend2d`` (K2, ``_blend_kernel_v2_2d``);
* ``blend2d_backward_reference`` against ``jax.vjp`` of that call (K3
  ``_bwd2d_dvol_kernel`` and K4 ``_bwd2d_dcomps_kernel``), with offsets lying
  exactly on 0 and +-1, where XLA's subgradients and torch's differ;
* the port's ``fused_blend2d`` autograd against ``jax.grad`` through
  ``windowed_blend_fused_head`` (K1's custom_vjp: the recompute + K3/K4).

nh=8, C=256, kp=64, small grids; the JAX side pads H and W to multiples
of 8 as ``windowed_blend_comps`` does (zero components give zero output),
the port does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.fast_deform_pallas import (
    _blend2d,
    windowed_blend_fused_head,
)
from class_query_vad_tpu_torch.ops.blend2d import (
    blend2d,
    blend2d_backward_reference,
    blend2d_bwd_dcomps,
    blend2d_bwd_dvol,
    blend2d_reference,
    hat_grad,
)
from class_query_vad_tpu_torch.ops.fast_deform_cuda import (
    fused_blend2d,
    fused_blend2d_reference,
    fused_components,
)

from torch_parity import jit_opt0, n, t

NH, C, KP = 8, 256, 64
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# float32: the same arithmetic summed in other orders.  bf16: inputs are
# the same bf16 values on both sides and both sum in float32, but the
# outputs are rounded to bf16 (one ulp = 2^-8 relative) after different
# summation orders.
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _comps(jl, thw, dtype, seed, ties=False):
    tt, h, w = thw
    rng = np.random.default_rng(seed)
    shape = (1, jl, tt, h, w, KP)
    vol = rng.standard_normal((1, jl, tt, h, w, C)).astype(np.float32)
    dx = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    dy = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    if ties:            # a third of the offsets exactly on -1, 0 or 1
        for x in (dx, dy):
            pick = rng.random(shape) < 1 / 3
            x[pick] = rng.integers(-1, 2, shape)[pick]
    a = rng.uniform(0.0, 0.3, shape).astype(np.float32)
    g = rng.standard_normal((1, tt, h, w, C)).astype(np.float32)
    jx = [jnp.asarray(x, JDT[dtype]) for x in (vol, dx, dy, a)]
    tx = [t(np.asarray(x.astype(jnp.float32))).to(TDT[dtype]) for x in jx]
    return jx, tx, g


def _pad8(x):
    h, w = x.shape[3], x.shape[4]
    return jnp.pad(x, [(0, 0)] * 3 + [(0, (-h) % 8), (0, (-w) % 8), (0, 0)])


def _blend2d_jax(vol, dx, dy, a):
    """K2 in interpret mode on grids padded to multiples of 8."""
    h, w = vol.shape[3], vol.shape[4]
    out = _blend2d(*(_pad8(x) for x in (vol, dx, dy, a)), False, True)
    return out[:, :, :h, :w]


CASES = [(2, (1, 5, 6), "float32"), (3, (2, 8, 3), "float32"),
         (2, (1, 4, 7), "bfloat16"), (4, (1, 3, 9), "bfloat16")]


@pytest.mark.parametrize("jl,thw,dtype", CASES)
def test_blend2d_reference_matches_pallas_interpret(jl, thw, dtype):
    jx, tx, _ = _comps(jl, thw, dtype, seed=jl)
    out_j = _blend2d_jax(*jx)
    out_t = blend2d_reference(*tx, NH)
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(n(out_t), n(out_j), **TOL[dtype])


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("jl,thw,dtype", CASES)
def test_blend2d_backward_matches_pallas_vjp(jl, thw, dtype, ties):
    jx, tx, g = _comps(jl, thw, dtype, seed=10 + jl, ties=ties)
    want = jit_opt0(lambda gg, *x: jax.vjp(_blend2d_jax, *x)[1](gg),
                    jnp.asarray(g), *jx)
    got = blend2d_backward_reference(*tx, t(g), NH)
    for name, gt, gj in zip(("dvol", "ddx", "ddy", "da"), got, want):
        assert gt.dtype == TDT[dtype], name
        np.testing.assert_allclose(n(gt), n(gj), err_msg=name, **TOL[dtype])
    # the wrappers take CPU tensors to these plain versions, as the
    # autograd Function does
    before = (blend2d_bwd_dvol.launches, blend2d_bwd_dcomps.launches)
    xs = [x.clone().requires_grad_() for x in tx]
    torch.autograd.backward(blend2d(*xs, NH), t(g))
    for x, gt in zip(xs, got):
        torch.testing.assert_close(x.grad, gt, rtol=0, atol=0)
    assert (blend2d_bwd_dvol.launches, blend2d_bwd_dcomps.launches) == before


def test_ties_follow_xla_not_torch_autograd():
    """At offsets exactly on 0 and +-1 the JAX package's gradients take
    abs'(0) = +1 and half weight at |u| = 1; torch's autograd of the same
    expression would not."""
    u = torch.tensor([-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5])
    want = [0.0, 0.5, 1.0, -1.0, -1.0, -0.5, 0.0]
    assert hat_grad(u).tolist() == want
    uj = jnp.asarray(u.numpy())
    xla = jax.vmap(jax.grad(lambda x: jnp.maximum(0.0, 1.0 - jnp.abs(x))))(uj)
    assert np.asarray(xla).tolist() == want
    ut = u.clone().requires_grad_()
    (1.0 - ut.abs()).clamp(min=0.0).sum().backward()
    assert ut.grad.tolist() != want


# the last case zeroes a quarter of the offset lanes: tanh(0) = 0 puts the
# offsets on the ties of hat', where torch autograd would differ
FUSED_CASES = [(3, (1, 5, 6), "float32", False),
               (2, (2, 4, 3), "float32", False),
               (4, (1, 3, 7), "bfloat16", False),
               (2, (1, 4, 5), "float32", True)]


@pytest.mark.parametrize("jl,thw,dtype,ties", FUSED_CASES)
def test_fused_blend2d_grad_matches_jax(jl, thw, dtype, ties):
    tt, h, w = thw
    rng = np.random.default_rng(20 + jl)
    vol = rng.standard_normal((1, jl, tt, h, w, C)).astype(np.float32)
    fused = (2.0 * rng.standard_normal((1, tt, h, w, 3 * jl * KP))
             ).astype(np.float32)
    if ties:
        offsets = fused[..., :2 * jl * KP]
        offsets[rng.random(offsets.shape) < 0.25] = 0.0
    g = rng.standard_normal((1, tt, h, w, C)).astype(np.float32)
    vol_j, fused_j = jnp.asarray(vol, JDT[dtype]), jnp.asarray(fused, JDT[dtype])

    def f(v, fu):
        return windowed_blend_fused_head([v[:, i] for i in range(jl)], fu,
                                         nh=NH, radius=1.0, use_pallas=True,
                                         interpret=True)

    def f_and_vjp(v, fu, gg):
        out, vjp = jax.vjp(f, v, fu)
        return out, vjp(gg)

    out_j, (dvol_j, dfused_j) = jit_opt0(f_and_vjp, vol_j, fused_j,
                                         jnp.asarray(g))

    vol_t = t(np.asarray(vol_j.astype(jnp.float32))).to(TDT[dtype])
    fused_t = t(np.asarray(fused_j.astype(jnp.float32))).to(TDT[dtype])
    vol_t.requires_grad_()
    fused_t.requires_grad_()
    out_t = fused_blend2d(vol_t, fused_t, NH, 1.0)
    out_t.backward(t(g))
    np.testing.assert_allclose(n(out_t), n(out_j), **TOL[dtype])
    assert vol_t.grad.dtype == fused_t.grad.dtype == TDT[dtype]
    np.testing.assert_allclose(n(vol_t.grad), n(dvol_j), **TOL[dtype])
    # d fused passes through tanh' and the softmax Jacobian: scale the
    # tolerance by the gradient's size
    scale = float(np.abs(n(dfused_j)).max())
    np.testing.assert_allclose(n(fused_t.grad), n(dfused_j),
                               atol=TOL[dtype]["atol"] * scale,
                               rtol=TOL[dtype]["rtol"])


def test_fused_blend2d_grad_is_autograd_of_the_plain_composite():
    """Away from ties, K1's backward (recompute + K3/K4 plain versions) is
    torch autograd through ``fused_components`` + ``blend2d_reference``."""
    rng = np.random.default_rng(5)
    vol = t(rng.standard_normal((2, 2, 1, 4, 5, C)).astype(np.float32))
    fused = t((2.0 * rng.standard_normal((2, 1, 4, 5, 3 * 2 * KP))
               ).astype(np.float32))
    g = t(rng.standard_normal((2, 1, 4, 5, C)).astype(np.float32))
    a = [vol.clone().requires_grad_(), fused.clone().requires_grad_()]
    fused_blend2d(*a, NH, 1.0).backward(g)
    b = [vol.clone().requires_grad_(), fused.clone().requires_grad_()]
    blend2d_reference(b[0], *fused_components(b[1], 2, NH, 1.0), NH).backward(g)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(
        fused_blend2d(vol, fused, NH, 1.0),
        fused_blend2d_reference(vol, fused, NH, 1.0), atol=0, rtol=0)
