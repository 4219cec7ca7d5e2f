"""Tiny whole models with ``FAST_WINDOW: 3d`` and ``FAST_CROSS_LEVEL:
resample`` (the config default, and the documented variant of
``AVA22_ViT-B_fast.yaml``) in the PyTorch port against the JAX package, on
the CPU in float32: the forward heads, and one train step against
``jax.value_and_grad`` (losses, the matcher's assignment, every gradient).
The encoder's blend is then ``blend3d`` (the plain versions of K6, K8 and
K9 here) on the JAX side's ``_blend_xla_vol``.

The tiny configurations are ``tests/torch_parity.py``'s (``tiny_cfg``,
``train_cfg`` at ViT depth 1) with the 3d window; the same params through
``params_from_jax``.  One JAX jit each, compiled without LLVM's
optimisation passes (the same graph in about half the compile time).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.losses import (
    build_criterion_and_postprocessor as jax_build_criterion,
    build_matcher as jax_build_matcher,
)
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.models.transformer import center_slice_plan
from class_query_vad_tpu_torch.ops.blend3d import blend3d
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import n, random_params, t, tiny_cfg, train_batch, train_cfg


def _window3d(cfg):
    cfg.CONFIG.MODEL.FAST_WINDOW = "3d"
    cfg.CONFIG.MODEL.FAST_CROSS_LEVEL = "resample"
    return cfg


def _train_cfg3d(get_defaults):
    """``train_cfg`` with the 3d window and ViT depth 1 (one aux decoder
    layer stays)."""
    cfg = _window3d(train_cfg(get_defaults))
    cfg.CONFIG.ViT.DEPTH = 1
    return cfg


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _model_world():
    rng = np.random.default_rng(70)
    pixels = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True                       # second clip padded right
    jm = jax_build_model(_window3d(tiny_cfg(jax_cfg_defaults(), True)))
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask), seed=71)
    out_j = _compiled(lambda p, x, m: jm.apply(p, x, m, True), params,
                      jnp.asarray(pixels), jnp.asarray(mask))
    model = build_model(_window3d(tiny_cfg(get_cfg_defaults(), True)),
                        device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    return params, out_j, out_t, model


# as tests/test_torch_model.py: float32 on both sides, other summation
# orders through the ViT block, the encoder and decoder layers
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)


def test_tiny_resample3d_model_matches_jax():
    _, out_j, out_t, _ = _model_world()
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        assert out_t[k].shape == out_j[k].shape, k
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), **MODEL_TOL,
                                   err_msg=k)


def test_resample3d_model_takes_the_3d_route(monkeypatch):
    """No centre-frame slice (the plan decides by window alone), so the
    encoder runs over every backbone frame and the decoder takes the common-grid
    decode; each encoder layer's offset head carries (D, nl*3*kp) lanes
    from the JAX params; its blend is ``blend3d``, one call per query grid
    over every backbone frame."""
    params, _, _, model = _model_world()
    # 8 frames, tubelet 2: 4 backbone frames
    assert center_slice_plan(True, True, "3d", 4, 8, 4) is None
    assert center_slice_plan(True, True, "2d", 4, 8, 4) is not None
    attn = model.transformer.encoder.layers[0].self_attn
    assert attn.nc == 3 and not attn.native and not attn.fused_route
    jax_offsets = params["params"]["transformer"]["encoder"]["layers_0"][
        "self_attn"]["sampling_offsets_kernel"]
    assert jax_offsets.shape == (256, 4 * 3 * 64)
    np.testing.assert_array_equal(n(attn.window_offsets.weight),
                                  np.asarray(jax_offsets).T)
    from class_query_vad_tpu_torch.models import fast_encoder

    seen = []
    monkeypatch.setattr(fast_encoder, "blend3d",
                        lambda vol, *c: (seen.append(tuple(vol.shape)),
                                         blend3d(vol, *c))[1])
    monkeypatch.setattr(fast_encoder, "blend2d", None)
    rng = np.random.default_rng(72)
    with torch.inference_mode():
        model(t(rng.normal(size=(1, 8, 64, 64, 3)).astype(np.float32)),
              torch.zeros((1, 64, 64), dtype=torch.bool))
    # 2 layers x 4 query grids, each over 4 aligned levels and all 4
    # backbone frames
    assert len(seen) == 2 * 4
    assert {s[:3] for s in seen} == {(1, 4, 4)}


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX package's train-step loss (engine/train.py:194-202), its
    value_and_grad and the matcher's assignment on its outputs, on seeded
    params, with the 3d window."""
    cfg = _train_cfg3d(jax_cfg_defaults)
    jm = jax_build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in train_batch(3).items()}
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           batch["pixels"], batch["mask"], seed=73)
    matcher = jax_build_matcher(cfg)
    crit, _, wd = jax_build_criterion(cfg, matcher)

    def loss_fn(p):
        # the class head's fixed 0.5 dropout is off in the port's step
        # (tests/test_torch_train_step.py)
        out = jm.apply(p, batch["pixels"], batch["mask"], True)
        losses = crit(out, batch)
        total = sum(losses[k] * w for k, w in wd.items())
        match = [matcher(o, batch) for o in list(out["aux_outputs"]) + [out]]
        return total, (losses, match)

    (total, (losses, match)), grads = _compiled(
        jax.value_and_grad(loss_fn, has_aux=True), params)
    return params, float(total), losses, match, grads


def test_tiny_resample3d_train_step_matches_jax():
    params, total_j, losses_j, match_j, grads_j = _jax_step()
    cfg = _train_cfg3d(get_cfg_defaults)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    model.head_dropout.p = 0.0
    trainer = Trainer(model, cfg, device="cpu")
    total, losses, match = trainer.loss(
        {k: t(v) for k, v in train_batch(3).items()})

    # as tests/test_torch_train_step.py: fp32 on both sides, other orders
    np.testing.assert_allclose(float(total.detach()), total_j, rtol=1e-4)
    assert sorted(losses) == sorted(losses_j)
    for k in losses_j:
        np.testing.assert_allclose(n(losses[k]), n(losses_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for layer, mj in enumerate(match_j):
        ok = np.asarray(mj.match_ok)
        np.testing.assert_array_equal(match.match_ok[layer].numpy(), ok)
        np.testing.assert_array_equal(match.gt_idx[layer].numpy()[ok],
                                      np.asarray(mj.gt_idx)[ok])
    total.backward()
    want = params_from_jax(grads_j)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p.grad), n(want[name]), rtol=1e-3,
                                   atol=5e-4, err_msg=name)
    # the 3d encoder's own projections received gradients through K8/K9's
    # plain versions
    for layer in model.transformer.encoder.layers:
        for mod in (layer.self_attn.value_proj, layer.self_attn.window_offsets,
                    layer.self_attn.window_weights):
            assert mod.weight.grad.abs().max() > 0
