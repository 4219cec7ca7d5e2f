"""K1's plain PyTorch version (``fused_blend2d_reference``) against the JAX
package's fused-head blend: the Pallas kernel ``_fused_kernel_2d`` in
interpret mode (as tests/test_fused_head_blend.py runs it) and the XLA
composite ``_fused2d_composite``.  Small grids with H and W not multiples
of 8, nh=8, C=256, kp=64, J=2..4, float32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.fast_deform_pallas import (
    _fused2d_composite,
    windowed_blend_fused_head,
)
from class_query_vad_tpu_torch.ops.fast_deform_cuda import (
    fused_blend2d,
    fused_blend2d_reference,
)

from torch_parity import jit_opt0, n, t

NH, C, KP = 8, 256, 64

# float32: the same arithmetic, summed in other orders.  bf16: offsets and
# weights are rounded to bf16 on both sides, but XLA's and torch's
# tanh/exp may land on either side of a rounding boundary (one bf16 ulp of
# a tap weight), as tests/test_fused_head_blend.py allows for.
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(jl, thw, dtype, seed):
    tt, h, w = thw
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((1, jl, tt, h, w, C)).astype(np.float32)
    fused = (2.0 * rng.standard_normal((1, tt, h, w, 3 * jl * KP))
             ).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    vol_j, fused_j = jnp.asarray(vol, jdt), jnp.asarray(fused, jdt)
    # identical rounded values on both sides
    vol_t = t(np.asarray(vol_j.astype(jnp.float32))).to(tdt)
    fused_t = t(np.asarray(fused_j.astype(jnp.float32))).to(tdt)
    return vol_j, fused_j, vol_t, fused_t


CASES = [
    (4, (2, 5, 7), "float32"),
    (4, (1, 6, 10), "bfloat16"),
    (3, (2, 3, 9), "float32"),
    (3, (1, 4, 5), "bfloat16"),
    (2, (1, 7, 3), "float32"),
    (2, (2, 2, 6), "bfloat16"),
]


@pytest.mark.parametrize("jl,thw,dtype", CASES)
def test_reference_matches_pallas_interpret(jl, thw, dtype):
    vol_j, fused_j, vol_t, fused_t = _inputs(jl, thw, dtype, seed=jl)
    out_j = jit_opt0(lambda v, f: windowed_blend_fused_head(
        [v[:, i] for i in range(jl)], f, nh=NH, radius=1.0,
        use_pallas=True, interpret=True), vol_j, fused_j)
    out_t = fused_blend2d_reference(vol_t, fused_t, NH, 1.0)
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(n(out_t), n(out_j), **TOL[dtype])


@pytest.mark.parametrize("jl,thw,dtype", CASES)
def test_reference_matches_xla_composite(jl, thw, dtype):
    vol_j, fused_j, vol_t, fused_t = _inputs(jl, thw, dtype, seed=10 + jl)
    out_j = _fused2d_composite(vol_j, fused_j, NH, 1.0, False, True)
    out_t = fused_blend2d_reference(vol_t, fused_t, NH, 1.0)
    np.testing.assert_allclose(n(out_t), n(out_j), **TOL[dtype])


def test_reference_radius_scales_offsets():
    """radius multiplies the tanh offsets (the general-radius form of the
    same op); at radius 0 every tap mass sits on the centre, so the output
    is the per-head softmax-weighted sum of the centre values."""
    _, _, vol_t, fused_t = _inputs(2, (1, 3, 4), "float32", seed=3)
    out = fused_blend2d_reference(vol_t, fused_t, NH, 0.0)
    nw0 = 2 * 2 * KP
    lg = fused_t[..., nw0:].reshape(1, 1, 3, 4, 2, NH, 8)
    a = torch.softmax(lg.transpose(-3, -2).reshape(1, 1, 3, 4, NH, 16), -1)
    a = a.reshape(1, 1, 3, 4, NH, 2, 8).sum(-1)           # [.., nh, J]
    v = vol_t.reshape(1, 2, 1, 3, 4, NH, C // NH)
    want = torch.einsum("btyxhj,bjtyxhd->btyxhd", a, v).reshape(out.shape)
    np.testing.assert_allclose(n(out), n(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("level,comp,head,point", [
    (0, 0, 0, 0), (1, 1, 5, 3), (2, 0, 7, 7), (2, 1, 2, 6)])
def test_fused_head_lane_layout(level, comp, head, point):
    """Lanes of the fused head (fast_encoder.py:112-119): offsets in
    (level, component x/y, head, point) order, then weight logits in
    (level, head, point) order.  One lane of one head carries all of that
    head's weight and a +1 pixel offset along one axis: that head's
    channels read the level's values one pixel over (zero past the border);
    the other heads, with zero lanes, average the levels' centre values."""
    jl, h, w, p, d = 3, 5, 6, KP // NH, C // NH
    vol = torch.from_numpy(np.random.default_rng(level).standard_normal(
        (1, jl, 1, h, w, C)).astype(np.float32))
    fused = torch.zeros((1, 1, h, w, 3 * jl * KP))
    fused[..., (2 * level + comp) * KP + head * p + point] = 20.0  # tanh = 1
    fused[..., 2 * jl * KP + level * KP + head * p + point] = 40.0
    out = fused_blend2d_reference(vol, fused, NH, 1.0).reshape(h, w, NH, d)

    want = vol[0, :, 0].reshape(jl, h, w, NH, d).mean(0)
    src = torch.nn.functional.pad(vol[0, level, 0], (0, 0, 0, 1, 0, 1))
    shifted = src[1:, :w] if comp else src[:h, 1:]        # y+1 or x+1
    want[..., head, :] = shifted.reshape(h, w, NH, d)[..., head, :]
    np.testing.assert_allclose(n(out), n(want), atol=1e-5, rtol=1e-5)


def test_wrapper_takes_cpu_tensors_to_the_plain_version():
    _, _, vol_t, fused_t = _inputs(4, (1, 5, 7), "float32", seed=5)
    before = fused_blend2d.launches
    out = fused_blend2d(vol_t, fused_t, NH, 1.0)
    assert fused_blend2d.launches == before        # no kernel launched
    np.testing.assert_array_equal(
        n(out), n(fused_blend2d_reference(vol_t, fused_t, NH, 1.0)))


def test_wrapper_rejects_bad_shapes():
    _, _, vol_t, fused_t = _inputs(2, (1, 3, 4), "float32", seed=6)
    with pytest.raises(ValueError):
        fused_blend2d(vol_t, fused_t[..., :-1], NH, 1.0)      # lanes
    with pytest.raises(ValueError):
        fused_blend2d(vol_t, fused_t, 7, 1.0)                 # C % nh
    with pytest.raises(ValueError):
        fused_blend2d(vol_t[:, :, :, :2], fused_t, NH, 1.0)   # grid
