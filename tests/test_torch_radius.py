"""``FAST_RADIUS`` > 1 in the PyTorch port against the JAX package, on the
CPU in float32.

* ``windowed_blend_fused`` at R = 2 against JAX's: the 2d window (JAX's dt
  = 0; the port's (x, y) offsets, and its (x, y, t) form with dt = 0) and
  a 3d dt, forward and ``jax.vjp``, with a third of the offsets exactly on
  the integer ties, where XLA's subgradients and torch's differ.
* A tiny whole model with ``FAST_RADIUS: 2`` and the 2d window
  (``radius2_world``): the heads against the JAX model, and the route: the
  general blend, never K1, K2 or K6.  The 3d window's model is in
  ``tests/test_torch_radius_3d.py``: each takes one JAX compile of ~50 s
  (the JAX blend unrolls 125 shifts x 4 levels x 4 query grids), so the two
  files run on separate xdist workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu.ops.fast_deform import (
    windowed_blend_fused as jax_windowed_blend_fused,
)
from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.ops.fast_deform import windowed_blend_fused
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import n, random_params, t, tiny_cfg

R = 2
B, T, H, W, NH, D, L, P = 1, 3, 6, 7, 2, 4, 2, 3
# float32 on both sides: the same arithmetic summed in other orders
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, window):
    """aligned levels, offsets [..., 3] in (-R, R) with a third on the
    integer ties -2..2 (dt = 0 for the 2d window), weights, cotangent."""
    rng = np.random.default_rng(seed)
    aligned = [rng.standard_normal((B, T, H, W, NH, D)).astype(np.float32)
               for _ in range(L)]
    shape = (B, T, H, W, NH, L, P, 3)
    offs = rng.uniform(-R, R, shape).astype(np.float32)
    tie = rng.random(shape) < 1 / 3
    offs[tie] = rng.integers(-R, R + 1, shape)[tie]
    if window == "2d":
        offs[..., 2] = 0.0
    weights = rng.uniform(0.0, 0.3, shape[:-1]).astype(np.float32)
    cot = rng.standard_normal((B, T, H, W, NH, D)).astype(np.float32)
    return aligned, offs, weights, cot


@pytest.mark.parametrize("window,nc", [("2d", 2), ("2d", 3), ("3d", 3)])
def test_windowed_blend_fused_matches_jax(window, nc):
    aligned, offs, weights, cot = _inputs(1 if window == "2d" else 2, window)
    out_j, vjp = jax.vjp(
        lambda a, o, w: jax_windowed_blend_fused(a, o, w, R),
        [jnp.asarray(a) for a in aligned], jnp.asarray(offs),
        jnp.asarray(weights))
    g_a, g_o, g_w = vjp(jnp.asarray(cot))

    a_t = [t(a).requires_grad_() for a in aligned]
    o_t = t(offs[..., :nc]).requires_grad_()
    w_t = t(weights).requires_grad_()
    out = windowed_blend_fused(a_t, o_t, w_t, R)
    np.testing.assert_allclose(n(out), n(out_j), **FWD_TOL)
    out.backward(t(cot))
    for x, want in zip(a_t, g_a):
        np.testing.assert_allclose(n(x.grad), n(want), **BWD_TOL)
    np.testing.assert_allclose(n(o_t.grad), n(g_o)[..., :nc], **BWD_TOL)
    np.testing.assert_allclose(n(w_t.grad), n(g_w), **BWD_TOL)


def _radius2(cfg, window, radius=R):
    c = cfg.CONFIG.MODEL
    c.FAST_RADIUS = radius
    c.FAST_WINDOW = window
    c.FAST_CROSS_LEVEL = "resample"
    c.ENC_LAYERS = 1
    return cfg


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def radius2_world(window):
    """A tiny ``FAST_RADIUS: 2`` model of ``window`` (``tiny_cfg``, one
    encoder layer) in both packages with the same seeded params, a padded
    pair of clips and the JAX model's heads.  The params are traced from
    the radius-1 model (the same tree; a far cheaper trace)."""
    rng = np.random.default_rng(80)
    pixels = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True                       # second clip padded right
    j1 = jax_build_model(_radius2(tiny_cfg(jax_cfg_defaults(), True), window,
                                  radius=1))
    params = random_params(lambda k, x, m: j1.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask), seed=81)
    jm = jax_build_model(_radius2(tiny_cfg(jax_cfg_defaults(), True), window))
    out_j = _compiled(lambda p, x, m: jm.apply(p, x, m, True), params,
                      jnp.asarray(pixels), jnp.asarray(mask))
    model = build_model(_radius2(tiny_cfg(get_cfg_defaults(), True), window),
                        device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return pixels, mask, out_j, model


# as tests/test_torch_model.py: float32 on both sides, other summation
# orders through the ViT block, the encoder and decoder layers
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)


def check_radius2_model(window, monkeypatch):
    pixels, mask, out_j, model = radius2_world(window)
    attn = model.transformer.encoder.layers[0].self_attn
    assert attn.radius == R and not attn.fused_route and not attn.native
    from class_query_vad_tpu_torch.models import fast_encoder

    calls = []
    monkeypatch.setattr(fast_encoder, "windowed_blend_fused",
                        lambda *a: (calls.append(a[1].shape[-1]),
                                    windowed_blend_fused(*a))[1])
    for name in ("fused_blend2d", "blend2d", "blend3d"):
        monkeypatch.setattr(fast_encoder, name, None)
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    # one call per query grid (4 levels), (x, y) or (x, y, t) offsets
    assert calls == [2 if window == "2d" else 3] * 4
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        assert out_t[k].shape == out_j[k].shape, k
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), **MODEL_TOL,
                                   err_msg=k)


def test_tiny_radius2_model_2d_matches_jax_on_the_general_route(monkeypatch):
    check_radius2_model("2d", monkeypatch)
