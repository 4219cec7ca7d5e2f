"""The exact encoder's sampler, ``ops.deform_attn.ms_deform_attn_3d``,
against the JAX package's ``ms_deform_attn_3d_xla`` (its oracle) and
``ms_deform_attn_3d_packed`` (what its dispatcher runs), on the CPU in
float32; its gradients with respect to value, locations and weights
against ``jax.grad`` of ``_xla``.

Locations are drawn around and past each level's volume, and also put on
its borders (the drop guard's -1 and size, the last pixel centre) and on
exact pixel centres (the floors' kinks).  Those levels have power-of-two
sides, so that ``loc * size - 0.5`` is exact in float32 whichever way a
compiler rounds it, and both sides floor it alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.deform_attn import (
    ms_deform_attn_3d_packed,
    ms_deform_attn_3d_xla,
)
from class_query_vad_tpu_torch.ops.deform_attn import ms_deform_attn_3d

from torch_parity import n, t

# float32 on both sides, the same corner weights; the sums over levels,
# points and corners run in other orders
FWD_TOL = 1e-5
GRAD_TOL = 1e-4

SHAPES = {
    1: ((3, 5, 7),),
    2: ((2, 6, 5), (1, 3, 3)),
    3: ((4, 8, 8), (2, 4, 4), (1, 2, 2)),        # power-of-two sides
    4: ((2, 8, 10), (2, 4, 5), (2, 2, 3), (2, 1, 2)),
}


def _inputs(seed, levels, b=2, q=20, nh=4, p=3, d=8, special=False):
    rng = np.random.default_rng(seed)
    shapes = SHAPES[levels]
    s = sum(a * b_ * c for a, b_, c in shapes)
    value = rng.normal(size=(b, s, nh, d)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, q, nh, levels, p, 3)).astype(np.float32)
    w = rng.uniform(size=(b, q, nh, levels, p)).astype(np.float32)
    if special:
        # on each component, per level: the guard's -1 and size, the first
        # and last pixel centres, and whole pixel centres inside
        for lvl, (tt, hh, ww) in enumerate(shapes):
            for c, size in enumerate((ww, hh, tt)):
                marks = np.array([-1.0, size, 0.0, size - 1.0]
                                 + list(range(size)), np.float32)
                pick = rng.integers(0, marks.size, loc[..., lvl, :, c].shape)
                on = rng.random(pick.shape) < 0.6
                loc[..., lvl, :, c] = np.where(
                    on, (marks[pick] + 0.5) / size, loc[..., lvl, :, c])
    return shapes, value, loc, w


def _jax(fn, shapes, value, loc, w, **kw):
    return np.asarray(fn(jnp.asarray(value), shapes, jnp.asarray(loc),
                         jnp.asarray(w), **kw))


@pytest.mark.parametrize("levels,d,chunk,special", [
    (1, 4, 64, False),
    (2, 8, 7, False),         # query chunks smaller than Q (20)
    (3, 8, 64, True),         # borders and whole pixel centres
    (3, 16, 6, True),
    (4, 32, 64, False),
    (4, 8, 5, False),
])
def test_forward_matches_jax(levels, d, chunk, special):
    shapes, value, loc, w = _inputs(levels * 10 + d, levels, d=d,
                                    special=special)
    got = n(ms_deform_attn_3d(t(value), shapes, t(loc), t(w),
                              query_chunk=chunk))
    assert got.shape == (2, 20, 4 * d)
    want = _jax(ms_deform_attn_3d_xla, shapes, value, loc, w)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    packed = _jax(ms_deform_attn_3d_packed, shapes, value, loc, w,
                  query_chunk=16)
    np.testing.assert_allclose(got, packed, atol=FWD_TOL, rtol=0)


def test_points_entirely_outside_are_dropped():
    """A point past the guard adds nothing, whatever its weight; a point on
    the last pixel centre reads that pixel alone."""
    shapes = ((2, 4, 4),)
    value = np.arange(32, dtype=np.float32).reshape(1, 32, 1, 1) + 1.0
    loc = np.array([[-0.125, 0.5, 0.5],      # x = -1: dropped
                     [1.125, 0.5, 0.5],      # x = 4 = w: dropped
                     [0.875, 0.875, 0.75]],  # the last pixel centre
                    np.float32).reshape(1, 3, 1, 1, 1, 3)
    w = np.full((1, 3, 1, 1, 1), 3.0, np.float32)
    got = n(ms_deform_attn_3d(t(value), shapes, t(loc), t(w)))[0, :, 0]
    np.testing.assert_array_equal(got, [0.0, 0.0, 3.0 * 32.0])


@pytest.mark.parametrize("levels,special,chunk", [
    (2, False, 64), (3, True, 64), (3, True, 7), (4, False, 9)])
def test_gradients_match_jax(levels, special, chunk):
    shapes, value, loc, w = _inputs(100 + levels, levels, q=12, d=8,
                                    special=special)
    g = np.random.default_rng(7).normal(
        size=(2, 12, 4 * 8)).astype(np.float32)

    def f(v, l, a):
        return (ms_deform_attn_3d_xla(v, shapes, l, a) * g).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    xs = [t(x).requires_grad_() for x in (value, loc, w)]
    (ms_deform_attn_3d(*xs[:1], shapes, *xs[1:], query_chunk=chunk)
     * t(g)).sum().backward()
    for name, x, wj in zip(("value", "locations", "weights"), xs, want):
        np.testing.assert_allclose(n(x.grad), np.asarray(wj), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)


def test_rejects_mismatched_level_shapes():
    shapes, value, loc, w = _inputs(0, 2)
    with pytest.raises(ValueError, match="level shapes"):
        ms_deform_attn_3d(t(value), shapes[:1], t(loc), t(w))
