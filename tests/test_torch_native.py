"""The native cross-level blend of the PyTorch port against the JAX
package, on the CPU in float32 (``FAST_CROSS_LEVEL: native``, 2d and 3d
windows).

* ``native_phase`` and the plain ``native_blend_level`` against JAX's
  (``ops/fast_deform.py:229-304``), value levels coarser, equal and finer;
* the port's ``native_blend`` (plain version of K10 / K11, autograd
  Function) against ``windowed_blend_native`` with the TPU kernels in
  interpret mode, forward and the gradients of every input, ties included;
* ``fused_components`` with nc = 2 and 3 against the JAX encoder's lanes
  (``models/fast_encoder.py:196-250``), the ``l3hp`` offset init.

The tiny whole native models are in ``test_torch_native_model.py``, so
that the two files' JAX compiles run on separate test workers.  Inputs
are drawn by numpy from a seed; one JAX jit per interpret-mode world,
shared (``functools.lru_cache``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops import deform_attn as j_da
from class_query_vad_tpu.ops import fast_deform as j_fd
from class_query_vad_tpu.ops.fast_deform_pallas import windowed_blend_native
from class_query_vad_tpu_torch.ops import deform_attn as da
from class_query_vad_tpu_torch.ops.fast_deform import (
    native_blend_level,
    native_phase,
    native_tables_on,
)
from class_query_vad_tpu_torch.ops.fast_deform_cuda import fused_components
from class_query_vad_tpu_torch.ops.native_blend import (
    native_blend,
    native_blend2d,
    native_blend3d,
    native_blend_reference,
)

from torch_parity import jit_opt0, n, t

NH, D = 8, 32
C = NH * D

# float32 on both sides, the same taps summed in other orders
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_q,n_v", [(12, 6), (12, 3), (20, 5), (12, 12),
                                     (10, 20), (5, 40), (7, 3), (3, 7)])
def test_native_phase_matches_jax(n_q, n_v):
    base, phi = native_phase(n_q, n_v)
    j_base, j_phi = j_fd.native_phase(n_q, n_v)
    np.testing.assert_array_equal(base, j_base)
    np.testing.assert_array_equal(phi, j_phi)
    assert phi.dtype == np.float32 and (phi >= 0).all() and (phi < 1).all()


def test_native_tables_hold_the_phases():
    base, phi = native_tables_on(12, 20, ((6, 10), (24, 40)),
                                 torch.device("cpu"))
    assert base.dtype == torch.int32 and phi.dtype == torch.float32
    for j, (hv, wv) in enumerate(((6, 10), (24, 40))):
        by, py = native_phase(12, hv)
        bx, px = native_phase(20, wv)
        np.testing.assert_array_equal(base[j].numpy(),
                                      np.concatenate([[hv, wv], by, bx]))
        np.testing.assert_array_equal(phi[j].numpy(), np.concatenate([py, px]))


def _comps(rng, shape, nc: int, ties: bool = False):
    """dx, dy, (dt,) a of ``shape``; with ``ties`` a third of the offsets
    sit exactly on -1, -0.5, 0, 0.5 or 1, where hat' has its ties once a
    phase of 0 or 0.5 is added."""
    offs = []
    for _ in range(nc):
        x = rng.uniform(-0.97, 0.97, shape).astype(np.float32)
        if ties:
            pick = rng.random(shape) < 1 / 3
            x[pick] = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0],
                                 shape).astype(np.float32)[pick]
        offs.append(x)
    a = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    return offs, a


@pytest.mark.parametrize("use_dt", [False, True])
@pytest.mark.parametrize("vshape", [(6, 10), (12, 20), (24, 40)],
                         ids=["coarser", "same", "finer"])
def test_native_blend_level_matches_jax(vshape, use_dt):
    rng = np.random.default_rng(sum(vshape) + use_dt)
    b, tt, p = 2, 3, 4
    vol = rng.normal(size=(b, tt) + vshape + (C,)).astype(np.float32)
    offs, a = _comps(rng, (b, tt, 12, 20, NH * p), 3 if use_dt else 2)
    dt = offs[2] if use_dt else None
    want = j_fd.native_blend_level(
        jnp.asarray(vol), jnp.asarray(offs[0]), jnp.asarray(offs[1]),
        jnp.asarray(a), NH, dt=None if dt is None else jnp.asarray(dt))
    got = native_blend_level(t(vol), t(offs[0]), t(offs[1]), t(a), NH,
                             dt=None if dt is None else t(dt))
    assert got.dtype == torch.float32 and got.shape == (b, tt, 12, 20, C)
    np.testing.assert_allclose(n(got), n(want), **FWD_TOL)


# tests/test_fast_encoder.py's shapes: for the 2d window (:522-575) a 12x20
# query grid (not a multiple of 8: the TPU kernel's pad path), levels at
# ratios 1, 2, 4 and a finer 24x40 level (the JAX oracle's route); for the
# 3d window (:612-665) an 8x16 grid over ratios 1, 2, 4 at T=3 (a finer
# level with dt is held to JAX's oracle by test_native_blend_level_matches_jax)
BLEND_CASES = {
    "2d": dict(b=2, tt=2, p=4, hw=(12, 20),
               vshapes=[(12, 20), (6, 10), (3, 5), (24, 40)]),
    "3d": dict(b=2, tt=3, p=2, hw=(8, 16), vshapes=[(8, 16), (4, 8), (2, 4)]),
}


@functools.lru_cache(maxsize=None)
def _blend_world(window: str):
    """Inputs (a third of the offsets on hat's ties), a float32 cotangent G,
    and the JAX side's output and gradients of <out, G> through
    ``windowed_blend_native`` with the TPU kernels in interpret mode (its
    custom VJP is the oracle's)."""
    cs = BLEND_CASES[window]
    rng = np.random.default_rng(31 + (window == "3d"))
    b, tt, (h, w) = cs["b"], cs["tt"], cs["hw"]
    values = [rng.normal(size=(b, tt, hv, wv, C)).astype(np.float32)
              for hv, wv in cs["vshapes"]]
    offs, a = _comps(rng, (b, len(values), tt, h, w, NH * cs["p"]),
                     3 if window == "3d" else 2, ties=True)
    g = rng.normal(size=(b, tt, h, w, C)).astype(np.float32)

    def kernels(vals, dx, dy, a_, *dt):
        return windowed_blend_native(vals, dx, dy, a_, nh=NH, use_pallas=True,
                                     interpret=True, dt=dt[0] if dt else None)

    def forward_and_vjp(args, cotangent):
        out, vjp = jax.vjp(kernels, *args)
        return out, vjp(cotangent)

    args = ([jnp.asarray(v) for v in values],
            *(jnp.asarray(x) for x in (offs[0], offs[1], a, *offs[2:])))
    out, grads = jit_opt0(forward_and_vjp, args, jnp.asarray(g))
    return values, offs, a, g, np.asarray(out), grads


@pytest.mark.parametrize("window", ["2d", "3d"])
def test_native_blend_matches_jax_kernels_in_interpret_mode(window):
    values, offs, a, _, want, _ = _blend_world(window)
    dt = t(offs[2]) if window == "3d" else None
    before = (native_blend2d.launches, native_blend3d.launches)
    got = native_blend([t(v) for v in values], t(offs[0]), t(offs[1]), t(a),
                       NH, dt=dt)
    assert (native_blend2d.launches, native_blend3d.launches) == before
    np.testing.assert_allclose(n(got), want, **FWD_TOL)


@pytest.mark.parametrize("window", ["2d", "3d"])
def test_native_blend_gradients_match_jax(window):
    """Every input's gradient through the autograd Function against the
    VJP of the TPU kernels' entry; with offsets on hat's tie points, XLA's
    subgradients (abs'(0) = +1, half at |u| = 1)."""
    values, offs, a, g, _, want = _blend_world(window)
    use_dt = window == "3d"
    vs = [t(v).requires_grad_() for v in values]
    comps = [t(x).requires_grad_() for x in (offs[0], offs[1], a)]
    dt = t(offs[2]).requires_grad_() if use_dt else None
    out = native_blend(vs, *comps, NH, dt=dt)
    out.backward(t(g))
    got = [[v.grad for v in vs]] + [x.grad for x in comps]
    if use_dt:
        got.append(dt.grad)
    for i, (x, y) in enumerate(zip(got, want)):
        for xx, yy in zip(x if isinstance(x, list) else [x],
                          y if isinstance(y, list) else [y]):
            np.testing.assert_allclose(n(xx), np.asarray(yy), **GRAD_TOL,
                                       err_msg=f"input {i}")


def test_native_blend_function_gradient_equals_plain_autograd():
    """The Function's backward (the plain version recomputed per level)
    equals autograd through the plain sum."""
    rng = np.random.default_rng(3)
    values = [rng.normal(size=(1, 2) + s + (C,)).astype(np.float32)
              for s in ((4, 6), (2, 3), (8, 12))]
    offs, a = _comps(rng, (1, 3, 2, 4, 6, NH * 2), 3)
    g = t(rng.normal(size=(1, 2, 4, 6, C)).astype(np.float32))
    grads = []
    for fn in (native_blend, native_blend_reference):
        xs = [t(x).requires_grad_() for x in (*values, *offs, a)]
        vs, (dx, dy, dt, aa) = xs[:3], xs[3:]
        fn(vs, dx, dy, aa, NH, dt=dt).backward(g)
        grads.append([x.grad for x in xs])
    for x, y in zip(*grads):
        np.testing.assert_allclose(n(x), n(y), rtol=1e-6, atol=1e-6)


def test_native_blend_rejects_non_cpu_non_cuda_tensors():
    values = [torch.empty((1, 1, 4, 6, 256), device="meta")]
    comps = [torch.empty((1, 1, 1, 4, 6, 64), device="meta") for _ in range(3)]
    before = (native_blend2d.launches, native_blend3d.launches)
    with pytest.raises(ValueError):
        native_blend(values, *comps, 8)
    with pytest.raises(ValueError):       # one CPU, one meta tensor
        native_blend([torch.zeros(values[0].shape)], *comps, 8)
    with pytest.raises(ValueError):       # a level of another T
        native_blend([torch.zeros((1, 2, 4, 6, 256))],
                     *(torch.zeros(x.shape) for x in comps), 8)
    assert (native_blend2d.launches, native_blend3d.launches) == before


def _jax_components(fused, nl: int, nc: int, nh: int = NH):
    """fast_encoder.py:196-250 as the JAX encoder computes them from its
    head lanes (radius 1): dx, dy, (dt,) a per level, stacked."""
    kp = fused.shape[-1] // ((nc + 1) * nl)
    raw = jnp.tanh(fused[..., : nl * nc * kp])
    logits = fused[..., nl * nc * kp:].astype(jnp.float32)
    head_ind = jnp.asarray(
        (jnp.arange(nl * kp)[:, None] // (kp // nh) % nh)
        == (jnp.arange(nl * kp)[None, :] // (kp // nh) % nh), jnp.float32)
    e = jnp.exp(logits - jax.lax.stop_gradient(
        jnp.max(logits, axis=-1, keepdims=True)))
    a = (e / jnp.einsum("...k,kc->...c", e, head_ind)).astype(fused.dtype)
    offs = [jnp.stack([raw[..., (nc * j + k) * kp:(nc * j + k + 1) * kp]
                       for j in range(nl)], axis=1) for k in range(nc)]
    return offs + [jnp.stack([a[..., j * kp:(j + 1) * kp]
                              for j in range(nl)], axis=1)]


def _ulps(x, y) -> int:
    """The largest distance in float32 units of the last place."""
    bits = [np.asarray(n(z) if isinstance(z, torch.Tensor) else z,
                       np.float32).view(np.int32).astype(np.int64)
            for z in (x, y)]
    return int(np.abs(bits[0] - bits[1]).max())


@pytest.mark.parametrize("nc", [2, 3])
def test_fused_components_match_the_jax_lanes(nc):
    """Within a few float32 ulps, not bit for bit, and the gaps are shown to
    come from the elementwise functions: each side's offsets are exactly its
    own tanh of the lanes (XLA's and torch's tanh differ by up to 4 ulps),
    and the weights differ by exp (1 ulp) and the per-head denominator's
    summation order (JAX sums it by a matmul)."""
    rng = np.random.default_rng(40 + nc)
    nl, kp = 4, 64
    fused = (2.0 * rng.standard_normal((2, 1, 3, 5, (nc + 1) * nl * kp))
             ).astype(np.float32)
    want = _jax_components(jnp.asarray(fused), nl, nc)
    got = fused_components(t(fused), nl, NH, 1.0, nc)
    assert len(got) == nc + 1
    for x, y in zip(got, want):
        assert x.shape == (2, nl, 1, 3, 5, kp)
        np.testing.assert_allclose(n(x), np.asarray(y), rtol=1e-6, atol=1e-7)
    n_off = nc * nl * kp
    tanh_t = torch.tanh(t(fused[..., :n_off]))
    tanh_j = np.asarray(jnp.tanh(jnp.asarray(fused[..., :n_off])))
    for k in range(nc):
        for j in range(nl):
            lanes = slice((nc * j + k) * kp, (nc * j + k + 1) * kp)
            assert torch.equal(got[k][:, j], tanh_t[..., lanes])
            np.testing.assert_array_equal(np.asarray(want[k][:, j]),
                                          tanh_j[..., lanes])
    assert _ulps(tanh_t, tanh_j) <= 4
    assert max(_ulps(x, y) for x, y in zip(got[:nc], want[:nc])) <= 4
    logits = fused[..., n_off:]
    shifted = logits - logits.max(axis=-1, keepdims=True)
    assert _ulps(torch.exp(t(shifted)), jnp.exp(jnp.asarray(shifted))) <= 1
    assert _ulps(got[-1], want[-1]) <= 4


def test_directional_offset_init_l3hp():
    np.testing.assert_array_equal(
        n(da.directional_offset_init_l3hp(8, 4, 8)),
        np.asarray(j_da.directional_offset_init_l3hp(8, 4, 8)))
