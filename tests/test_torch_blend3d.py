"""The (x, y, t) window blend's plain versions against the JAX package, on
the CPU:

* ``blend3d_reference`` against the oracle ``_blend_xla_vol`` and against
  ``_blend`` (K6, ``_blend_kernel_v2``, in interpret mode), and against
  K7 (``_blend_kernel``, the h-blocked variant, on ``_halo_stack``'s
  copies) called directly;
* ``blend3d_backward_reference`` against ``jax.vjp`` of the oracle and of
  ``_blend`` in interpret mode (K8 ``_bwd_dvol_kernel``, K9
  ``_bwd_dcomps_kernel``), with a third of the offsets exactly on 0 and
  +-1, where XLA's subgradients and torch's differ;
* the port's ``blend3d`` autograd against those plain versions, and bf16
  inputs through the plain version against the oracle on the same bf16
  values;
* the fast encoder with the 3d resample window (two layers over three
  levels, a padded clip), forward and every input's and parameter's
  gradient, against the JAX encoder (which takes the oracle on the CPU).

nh=8, C=256, kp=64.  The interpret-mode kernels tile by 8, so their grids
are multiples of 8 (``windowed_blend_comps`` pads other grids with
zero-weight queries; the port masks borders instead).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.models.fast_encoder import (
    FastDeformableEncoder as JEncoder,
)
from class_query_vad_tpu.ops.fast_deform_pallas import (
    _blend,
    _blend_pallas_b1,
    _blend_xla_vol,
    _halo_stack,
    _pick_ht,
)
from class_query_vad_tpu_torch.models.fast_encoder import FastDeformableEncoder
from class_query_vad_tpu_torch.ops import blend3d as b3
from class_query_vad_tpu_torch.ops.blend3d import (
    blend3d,
    blend3d_backward_reference,
    blend3d_bwd_dcomps,
    blend3d_bwd_dvol,
    blend3d_fwd,
    blend3d_reference,
)
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import load_from_flax, n, random_params, t

NH, C, KP = 8, 256, 64
NAMES = ("dvol", "ddx", "ddy", "ddt", "da")
# float32 on both sides: the same arithmetic summed in other orders
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
# as tests/test_fast_encoder.py:340 holds K8/K9 to the oracle's VJP
BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 outputs (dvol, the component gradients) are rounded to bf16 after
# sums in other orders: one bf16 ulp is 2^-8 relative
BF16_BWD_TOL = dict(atol=2e-2, rtol=2e-2)

# tests/test_fast_encoder.py:323's shapes (B, J, T, H, W), and smaller ones
SHAPES = {"fast_encoder": (2, 2, 3, 8, 16), "small": (1, 3, 2, 8, 8),
          "odd": (1, 2, 3, 5, 7)}


def _inputs(shape, seed, ties=False):
    """vol, dx, dy, dt, a, g as numpy; offsets uniform in (-1, 1) and, with
    ``ties``, a third of them exactly on -1, 0 or 1; weights in [0, 0.3)."""
    b, jl, tt, h, w = shape
    rng = np.random.default_rng(seed)
    cs = (b, jl, tt, h, w, KP)
    vol = rng.standard_normal((b, jl, tt, h, w, C)).astype(np.float32)
    offs = []
    for _ in range(3):
        x = rng.uniform(-1.0, 1.0, cs).astype(np.float32)
        if ties:
            pick = rng.random(cs) < 1 / 3
            x[pick] = rng.integers(-1, 2, cs)[pick]
        offs.append(x)
    a = rng.uniform(0.0, 0.3, cs).astype(np.float32)
    g = rng.standard_normal((b, tt, h, w, C)).astype(np.float32)
    return [vol, *offs, a], g


def _kernel_blend(*xs):
    return _blend(*xs, False, True)


@functools.lru_cache(maxsize=None)
def _jax_world(shape_key: str, seed: int, ties: bool, kernel: bool):
    """Forward and VJP of the oracle (``kernel`` False) or of ``_blend`` in
    interpret mode (K6 + K8/K9), jitted together."""
    xs, g = _inputs(SHAPES[shape_key], seed, ties)
    fn = _kernel_blend if kernel else _blend_xla_vol

    @jax.jit
    def run(*args):
        out, vjp = jax.vjp(fn, *args[:-1])
        return out, vjp(args[-1])

    out, grads = run(*(jnp.asarray(x) for x in xs), jnp.asarray(g))
    return xs, g, np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "k6_interpret"])
@pytest.mark.parametrize("shape_key", ["fast_encoder", "small"])
def test_blend3d_reference_matches_jax(shape_key, kernel):
    xs, _, out_j, _ = _jax_world(shape_key, 0, False, kernel)
    out_t = blend3d_reference(*(t(x) for x in xs), NH)
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(n(out_t), out_j, **FWD_TOL)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_blend3d_reference_matches_k7_interpret(ties):
    """K7 (the h-blocked TPU kernel ``_blend`` takes past K6's VMEM
    estimate), called as ``_blend`` calls it, per batch element on the
    three h-copies of the padded volume.  At 64x48 its h-block
    (``_pick_ht``) is 32 rows, so the halo between two blocks is read."""
    shape = (1, 2, 2, 64, 48)
    assert _pick_ht(2, 64, 48, C) == 32
    xs, _ = _inputs(shape, 3, ties)
    vol, dx, dy, dt, a = (jnp.asarray(x) for x in xs)
    want = np.stack([np.asarray(_blend_pallas_b1(
        _halo_stack(vol[i], 1, 2), dx[i], dy[i], dt[i], a[i],
        interpret=True)) for i in range(shape[0])])
    got = blend3d_reference(*(t(x) for x in xs), NH)
    np.testing.assert_allclose(n(got), want, **FWD_TOL)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("kernel", [False, True],
                         ids=["xla_vjp", "k8_k9_interpret"])
def test_blend3d_backward_matches_jax_vjp(kernel, ties):
    xs, g, _, want = _jax_world("fast_encoder", 1, ties, kernel)
    got = blend3d_backward_reference(*(t(x) for x in xs), t(g), NH)
    for name, gt, gj in zip(NAMES, got, want):
        assert gt.dtype == torch.float32, name
        np.testing.assert_allclose(n(gt), gj, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("shape_key", ["small", "odd"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_blend3d_autograd_is_the_plain_backward(shape_key, ties):
    """``blend3d``'s gradient on CPU tensors is the plain backward, ties
    included, and no wrapper counts a launch there."""
    xs, g = _inputs(SHAPES[shape_key], 2, ties)
    ts = [t(x) for x in xs]
    counters = (blend3d_fwd, blend3d_bwd_dvol, blend3d_bwd_dcomps)
    before = [c.launches for c in counters]
    req = [x.clone().requires_grad_() for x in ts]
    out = blend3d(*req, NH)
    torch.testing.assert_close(out, blend3d_reference(*ts, NH), rtol=0,
                               atol=0)
    out.backward(t(g))
    want = blend3d_backward_reference(*ts, t(g), NH)
    for name, x, w in zip(NAMES, req, want):
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0, msg=name)
    assert [c.launches for c in counters] == before


def test_blend3d_honours_needs_input_grad(monkeypatch):
    """Only the parts a caller needs are computed: vol alone skips K9's
    plain version, the components alone skip K8's."""
    xs, g = _inputs(SHAPES["small"], 4)
    calls = []
    for name in ("blend3d_bwd_dvol", "blend3d_bwd_dcomps"):
        fn = getattr(b3, name)
        monkeypatch.setattr(b3, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    vol = t(xs[0]).requires_grad_()
    blend3d(vol, *(t(x) for x in xs[1:]), NH).backward(t(g))
    comps = [t(x).requires_grad_() for x in xs[1:]]
    blend3d(t(xs[0]), *comps, NH).backward(t(g))
    assert calls == ["blend3d_bwd_dvol", "blend3d_bwd_dcomps"]
    assert vol.grad is not None and all(c.grad is not None for c in comps)


@functools.lru_cache(maxsize=None)
def _bf16_world(ties: bool):
    """The oracle and its VJP on bf16 inputs (float32 cotangent)."""
    xs, g = _inputs(SHAPES["small"], 5, ties)
    xb = [jnp.asarray(x, jnp.bfloat16) for x in xs]

    @jax.jit
    def run(*args):
        out, vjp = jax.vjp(_blend_xla_vol, *args[:-1])
        return out, vjp(args[-1])

    out, grads = run(*xb, jnp.asarray(g))
    same = [t(np.asarray(x.astype(jnp.float32))).bfloat16() for x in xb]
    return same, g, np.asarray(out), [np.asarray(x.astype(jnp.float32))
                                      for x in grads]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_blend3d_bf16_matches_the_oracle(ties):
    """bf16 inputs: both sides read the same bf16 values and sum in float32,
    so the float32 forward differs only in summation order (1e-5); the
    gradients come back in bf16 on both sides."""
    xs, g, out_j, grads_j = _bf16_world(ties)
    out_t = blend3d_reference(*xs, NH)
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(n(out_t), out_j, **FWD_TOL)
    got = blend3d_backward_reference(*xs, t(g), NH)
    for name, gt, gj in zip(NAMES, got, grads_j):
        assert gt.dtype == torch.bfloat16, name
        np.testing.assert_allclose(n(gt), gj, err_msg=name, **BF16_BWD_TOL)


def test_blend3d_wrappers_reject_mixed_devices_and_shapes():
    xs, g = _inputs(SHAPES["small"], 6)
    ts = [t(x) for x in xs]
    with pytest.raises(ValueError, match="one shape"):
        blend3d_fwd(ts[0], ts[1][..., :32], *ts[2:], NH)
    with pytest.raises(ValueError, match="match"):
        blend3d_bwd_dvol(*ts[1:], t(g)[:, :1], torch.float32, NH)
    with pytest.raises(ValueError, match="match vol"):
        blend3d_bwd_dcomps(*ts, t(g)[..., :128], NH)
    meta = ts[0].to("meta")
    with pytest.raises(ValueError, match="CPU tensors or CUDA"):
        blend3d_fwd(meta, *ts[1:], NH)


@functools.lru_cache(maxsize=None)
def _encoder_world():
    """The JAX encoder (window 3d, resample) on seeded inputs and params:
    its outputs and the gradients of <outputs, cotangents> with respect to
    the params and the level inputs."""
    rng = np.random.default_rng(9)
    grids = [(2, 8, 12), (2, 4, 6), (2, 2, 3)]
    srcs = [rng.standard_normal((2, *g, C)).astype(np.float32) for g in grids]
    poses = [rng.standard_normal((2, *g, C)).astype(np.float32) for g in grids]
    masks = [np.zeros((2, *g), bool) for g in grids]
    for m in masks:
        m[-1, ..., m.shape[-1] - 1:] = True        # last clip padded right
    cots = [rng.standard_normal((2, *g, C)).astype(np.float32) for g in grids]
    jm = JEncoder(2, C, 64, 3, NH, 8, 1, "3d", "resample")
    args = [[jnp.asarray(a) for a in x] for x in (srcs, poses, masks)]
    params = random_params(lambda k, *a: jm.init(k, *a, True), *args, seed=9)

    @jax.jit
    def run(p, s, q, m):
        def f(p, s):
            outs = jm.apply(p, s, q, m, True)
            return sum((o * jnp.asarray(c)).sum() for o, c in zip(outs, cots)), outs
        (_, outs), grads = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(p, s)
        return outs, grads

    outs, (dparams, dsrcs) = run(params, *args)
    return srcs, poses, masks, cots, params, outs, dparams, dsrcs


# float32 on both sides through two encoder layers (LayerNorms, FFNs):
# the module tests' tolerance (tests/test_torch_modules.py)
ENC_TOL = dict(atol=1e-4, rtol=1e-4)


def test_fast_encoder_3d_resample_matches_jax():
    srcs, poses, masks, cots, params, outs, dparams, dsrcs = _encoder_world()
    tm = FastDeformableEncoder(2, C, 64, 3, NH, 8, 1, "3d", "resample").eval()
    load_from_flax(tm, params, ("transformer", "encoder"),
                   "transformer.encoder.")
    xs = [t(a).requires_grad_() for a in srcs]
    got = tm(xs, [t(a) for a in poses], [t(a) for a in masks])
    for g, w in zip(got, outs):
        np.testing.assert_allclose(n(g), n(w), **ENC_TOL)
    sum((g * t(c)).sum() for g, c in zip(got, cots)).backward()
    for x, w in zip(xs, dsrcs):
        np.testing.assert_allclose(n(x.grad), n(w), **ENC_TOL)
    want = params_from_jax({"transformer": {"encoder": dparams["params"]}})
    for name, p in tm.named_parameters():
        w = want["transformer.encoder." + name]
        # gradients sum over every token: scale the tolerance by their size
        np.testing.assert_allclose(n(p.grad), n(w), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(n(w)).max()),
                                   err_msg=name)
