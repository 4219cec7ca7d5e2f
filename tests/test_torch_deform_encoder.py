"""The exact deformable encoder's modules in the PyTorch port against the
flax modules of ``class_query_vad_tpu/models/deform_encoder.py``, on the
CPU in float32: ``MSDeformAttn3D`` with 3- and 6-wide reference points and
a padding mask, the encoder layer with and without ``q_chunks``,
``encoder_reference_points``, ``get_valid_ratio`` on padded masks, and a
2-layer ``DeformableEncoder`` with its gradients.  Params cross over by
``params_from_jax`` (the reference's names, ``transformer.encoder.layers.
{i}.self_attn.{value_proj,sampling_offsets,attention_weights,output_proj}``,
``norm1``, ``norm2``, ``linear1``, ``linear2``).  Also
``utils.offset_stats``: the offsets and attention logits a 2-layer encoder's
heads emit, captured by forward hooks, against the JAX package's captured
intermediates, and the window statistics computed from them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.models import deform_encoder as jde
from class_query_vad_tpu_torch.models import deform_encoder as tde

from torch_parity import jit_opt0, load_from_flax, n, random_params, t

# float32 on both sides; projections, softmax, sampling and LayerNorms sum
# in other orders
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

D, NL, NH, NP, FFN = 32, 2, 4, 3, 64
SHAPES = ((2, 6, 8), (2, 3, 4))
S = sum(a * b * c for a, b, c in SHAPES)
PREFIX = ("transformer", "encoder")


def _masks(b=2):
    """Per level [B, T, H, W] pad masks: clip 1 padded on the right (2 of
    8 columns at level 0, 1 of 4 at level 1) and at the bottom."""
    ms = []
    for lvl, (tt, hh, ww) in enumerate(SHAPES):
        m = np.zeros((b, tt, hh, ww), bool)
        m[1, :, :, ww - (2 if lvl == 0 else 1):] = True
        m[1, :, hh - 1:] = True
        ms.append(m)
    return ms


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, S, D)).astype(np.float32)
    pos = rng.normal(size=(b, S, D)).astype(np.float32)
    mask = np.concatenate([m.reshape(b, -1) for m in _masks(b)], 1)
    vr = np.stack([np.asarray(jde.get_valid_ratio(jnp.asarray(m)))
                   for m in _masks(b)], 1)
    return src, pos, mask, vr


def test_get_valid_ratio_and_reference_points_match_jax():
    for m in _masks():
        np.testing.assert_array_equal(
            n(tde.get_valid_ratio(t(m))), np.asarray(jde.get_valid_ratio(m)))
    vr = _inputs(0)[3]
    assert vr.shape == (2, NL, 3) and (vr[1, :, :2] < 1).all() and (vr[0] == 1).all()
    got = tde.encoder_reference_points(SHAPES, t(vr))
    want = jde.encoder_reference_points(SHAPES, jnp.asarray(vr))
    assert got.shape == (2, S, NL, 3)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ref_width,masked", [(3, True), (3, False),
                                              (6, True)])
def test_ms_deform_attn_matches_flax(ref_width, masked):
    src, pos, mask, vr = _inputs(1 + ref_width)
    rng = np.random.default_rng(2)
    q = 7
    query = rng.normal(size=(2, q, D)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, (2, q, NL, ref_width)).astype(np.float32)
    if ref_width == 6:
        ref[..., 3:] = rng.uniform(0.1, 0.6, (2, q, NL, 3))
    pm = jnp.asarray(mask) if masked else None
    jm = jde.MSDeformAttn3D(D, NL, NH, NP)
    args = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src))
    params = random_params(lambda k, *a: jm.init(k, *a, SHAPES, pm), *args,
                           seed=3)
    want = jm.apply(params, *args, SHAPES, pm)
    tm = tde.MSDeformAttn3D(D, NL, NH, NP)
    load_from_flax(tm, params, PREFIX + ("layers_0", "self_attn"),
                   "transformer.encoder.layers.0.self_attn.")
    with torch.no_grad():
        got = tm(t(query), t(ref), t(src), SHAPES,
                 t(mask) if masked else None)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_offset_normaliser_is_the_reference_quirk():
    """(T, W, H) against (x, y, t) offsets: with zero offset kernels and an
    offset bias of 1 in x only, the x location moves by 1 / T."""
    tm = tde.MSDeformAttn3D(D, NL, NH, NP)
    seen = []
    tm.sampling_locations.register_forward_hook(
        lambda _m, _i, out: seen.append(out))
    with torch.no_grad():
        tm.sampling_offsets.weight.zero_()
        bias = torch.zeros(NH, NL, NP, 3)
        bias[..., 0] = 1.0
        tm.sampling_offsets.bias.copy_(bias.reshape(-1))
        ref = torch.full((1, 1, NL, 3), 0.5)
        tm(torch.zeros(1, 1, D), ref, torch.zeros(1, S, D), SHAPES)
    moved = seen[0][0, 0, 0, :, 0] - 0.5                     # [L, 3]
    want = torch.tensor([[1.0 / tt, 0.0, 0.0] for tt, _, _ in SHAPES])
    torch.testing.assert_close(moved, want)


@functools.lru_cache(maxsize=None)
def _layer_world(chunks):
    src, pos, mask, vr = _inputs(5)
    ref = jde.encoder_reference_points(SHAPES, jnp.asarray(vr))
    jm = jde.DeformableEncoderLayer(D, FFN, NL, NH, NP, 0.0)
    args = (jnp.asarray(src), jnp.asarray(pos), ref)
    m = jnp.asarray(mask)
    params = random_params(
        lambda k, *a: jm.init(k, *a, SHAPES, m, True, chunks), *args, seed=6)
    want = jit_opt0(lambda p, *a: jm.apply(p, *a, SHAPES, m, True, chunks),
                    params, *args)
    return (src, pos, mask, np.asarray(ref)), params, want


@pytest.mark.parametrize("chunks", [None, ((16, 48), (96, 108)),
                                    ((0, 12),)])
def test_encoder_layer_with_query_rows_matches_flax(chunks):
    (src, pos, mask, ref), params, want = _layer_world(chunks)
    tm = tde.DeformableEncoderLayer(D, FFN, NL, NH, NP, 0.0).eval()
    load_from_flax(tm, params, PREFIX + ("layers_0",),
                   "transformer.encoder.layers.0.")
    with torch.no_grad():
        got = tm(t(src), t(pos), t(ref), SHAPES, t(mask), chunks)
    rows = S if chunks is None else sum(b - a for a, b in chunks)
    assert got.shape == (2, rows, D)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _encoder_world():
    src, pos, mask, vr = _inputs(9)
    jm = jde.DeformableEncoder(2, D, FFN, NL, NH, NP, 0.0)
    g = np.random.default_rng(10).normal(size=(2, S, D)).astype(np.float32)
    rest = (jnp.asarray(vr), jnp.asarray(pos), jnp.asarray(mask))
    params = random_params(
        lambda k, x: jm.init(k, x, SHAPES, *rest, True), jnp.asarray(src),
        seed=11)

    def f(p, x):
        return (jm.apply(p, x, SHAPES, *rest, True) * g).sum()

    out, grads = jit_opt0(
        lambda p, x: (jm.apply(p, x, SHAPES, *rest, True),
                      jax.grad(f, argnums=(0, 1))(p, x)),
        params, jnp.asarray(src))
    return (src, pos, mask, vr, g), params, out, grads


def test_encoder_and_its_gradients_match_flax():
    (src, pos, mask, vr, g), params, want, (gp, gx) = _encoder_world()
    tm = tde.DeformableEncoder(2, D, FFN, NL, NH, NP, 0.0).eval()
    load_from_flax(tm, params, PREFIX, "transformer.encoder.")
    x = t(src).requires_grad_()
    got = tm(x, SHAPES, t(vr), t(pos), t(mask))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(n(x.grad), np.asarray(gx), **GRAD_TOL)
    wanted = {}
    load_from_flax(_Grabber(wanted), gp, PREFIX, "transformer.encoder.")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(n(p.grad), n(wanted[name]), err_msg=name,
                                   **GRAD_TOL)


class _Grabber(torch.nn.Module):
    """Takes any state_dict (here, a gradient tree mapped onto the port's
    parameter names) into ``store``."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def load_state_dict(self, sd, strict=True):
        self.store.update(sd)


def test_offset_stats_match_jax():
    """``collect_offsets_and_weights`` (forward hooks) against the JAX
    package's (flax's captured intermediates) on a 2-layer encoder: the
    offsets and logits within ``TOL``, in layer order; the native-pixel
    offsets (the permuted-normalizer quirk), softmax weights and the
    per-level window fractions from them equal to JAX's functions' within
    the same tolerance (a fraction may differ where an offset lies within
    1e-5 of a threshold: the check asserts none does)."""
    from class_query_vad_tpu.utils import offset_stats as jstats
    from class_query_vad_tpu_torch.utils import offset_stats as tstats

    src, pos, mask, vr = _inputs(13)
    jm = jde.DeformableEncoder(2, D, FFN, NL, NH, NP, 0.0)
    rest = (jnp.asarray(vr), jnp.asarray(pos), jnp.asarray(mask))
    params = random_params(
        lambda k, x: jm.init(k, x, SHAPES, *rest, True), jnp.asarray(src),
        seed=14)
    _, pairs_j = jstats.collect_offsets_and_weights(
        _Jitted(jm), params, jnp.asarray(src), SHAPES, *rest, True)
    tm = tde.DeformableEncoder(2, D, FFN, NL, NH, NP, 0.0).eval()
    load_from_flax(tm, params, PREFIX, "transformer.encoder.")
    out, pairs_t = tstats.collect_offsets_and_weights(
        tm, t(src), SHAPES, t(vr), t(pos), t(mask))
    assert out.shape == (2, S, D) and len(pairs_t) == len(pairs_j) == 2
    shapes = [tuple(s) for s in SHAPES]
    for (o_t, w_t), (o_j, w_j) in zip(pairs_t, pairs_j):
        np.testing.assert_allclose(o_t, o_j, **TOL)
        np.testing.assert_allclose(w_t, w_j, **TOL)
        px_t = tstats.native_pixel_offsets(o_t, shapes, NH, NP)
        px_j = jstats.native_pixel_offsets(o_j, shapes, NH, NP)
        np.testing.assert_allclose(px_t, px_j, **TOL)
        sw_t = tstats.softmax_weights(w_t, NH, NL, NP)
        sw_j = jstats.softmax_weights(w_j, NH, NL, NP)
        np.testing.assert_allclose(sw_t, sw_j, **TOL)
        sp = np.abs(px_j[..., :2])
        for th in (1.0, 2.0):
            assert np.abs(np.abs(sp.max(-1)) - th).min() > 1e-5
            assert np.abs(sp - th).min() > 1e-5
        rows_t = tstats.window_fractions(px_t, shapes, weights=sw_t)
        rows_j = jstats.window_fractions(px_j, shapes, weights=sw_j)
        for r_t, r_j in zip(rows_t, rows_j):
            assert sorted(r_t) == sorted(r_j)
            for k, v in r_j.items():
                np.testing.assert_allclose(r_t[k], v, err_msg=k, **TOL)


class _Jitted:
    """A flax module whose ``apply`` runs jitted (``jit_opt0``), for the
    JAX package's functions that call ``module.apply``."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, **kwargs):
        return jit_opt0(lambda v: self.module.apply(v, *args, **kwargs),
                        variables)
