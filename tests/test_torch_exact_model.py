"""Tiny whole models with the exact deformable encoder (``ENCODER_TYPE:
attention``) in the PyTorch port against the JAX package, on the CPU in
float32: ``AVA22_ViT-B.yaml`` with the last-layer query slice on and off,
with ``FAST_WINDOW: 2d`` (the backbone's centre-frame slice must stay off:
it belongs to the fast encoder), one train step against
``jax.value_and_grad``, and ``AVA22_ViT-B-train-mamba.yaml`` (VideoMamba +
the exact encoder, eval) with ``VIDEOMAMBA_SPECS`` patched in both
packages as ``tests/test_torch_mamba.py`` does.

Cut with ``torch_parity.cut_cfg`` (ViT depth 1, 2 + 2 layers, d_ffn 64, 3
queries, 8 frames of 64x64); the same seeded params through
``params_from_jax``.  One JAX jit per world, shared.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_custom as jax_cfg_custom
from class_query_vad_tpu.engine.train import make_optimizer as jax_make_optimizer
from class_query_vad_tpu.losses import (
    build_criterion_and_postprocessor as jax_build_criterion,
    build_matcher as jax_build_matcher,
)
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu.models import videomamba as j_vm
from class_query_vad_tpu_torch.config import get_cfg_custom
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.losses import postprocess_ava
from class_query_vad_tpu_torch.models import build_model, videomamba
from class_query_vad_tpu_torch.models.deform_encoder import MSDeformAttn3D
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import (
    CONFIG_DIR,
    TINY_VIDEOMAMBA,
    TRAIN_M,
    cut_cfg,
    n,
    random_params,
    t,
    train_batch,
)

AVA = "AVA22_ViT-B.yaml"
MAMBA = "AVA22_ViT-B-train-mamba.yaml"
# float32 on both sides, other summation orders (as tests/test_torch_model.py)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
HEADS = ("pred_logits", "pred_boxes", "pred_logits_b")


def _cfg(get_cfg, yaml=AVA, opts=()):
    cfg = cut_cfg(get_cfg(str(CONFIG_DIR / yaml), list(opts)))
    cfg.CONFIG.DATA.NUM_CLASSES = 12
    return cfg


def _request(seed, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    pixels = rng.normal(size=(2, 8) + hw + (3,)).astype(np.float32)
    mask = np.zeros((2,) + hw, bool)
    mask[1, :, hw[1] * 3 // 4:] = True               # second clip padded right
    return pixels, mask


def _jit(jm, params, pixels, mask):
    args = (params, jnp.asarray(pixels), jnp.asarray(mask))
    return jax.jit(lambda p, x, m: jm.apply(p, x, m, True)).lower(
        *args).compile({"xla_backend_optimization_level": 0})(*args)


VARIANTS = {
    "slice": (),
    "no_slice": ("CONFIG.MODEL.FAST_EFF_SLICE", False),
    "window_2d": ("CONFIG.MODEL.FAST_WINDOW", "2d"),
}


@functools.lru_cache(maxsize=None)
def _world(variant: str):
    seed = sorted(VARIANTS).index(variant)
    pixels, mask = _request(70 + seed)
    opts = VARIANTS[variant]
    jm = jax_build_model(_cfg(jax_cfg_custom, opts=opts))
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask),
                           seed=80 + seed)
    out_j = _jit(jm, params, pixels, mask)
    model = build_model(_cfg(get_cfg_custom, opts=opts), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return out_j, model, pixels, mask


def _check_heads(out_t, out_j):
    for k in HEADS:
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), err_msg=k,
                                   **MODEL_TOL)
    assert len(out_t["aux_outputs"]) == len(out_j["aux_outputs"])
    for a_t, a_j in zip(out_t["aux_outputs"], out_j["aux_outputs"]):
        for k in HEADS:
            np.testing.assert_allclose(n(a_t[k]), n(a_j[k]),
                                       err_msg="aux " + k, **MODEL_TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tiny_exact_model_matches_jax(variant):
    out_j, model, pixels, mask = _world(variant)
    assert isinstance(model.transformer.encoder.layers[0].self_attn,
                      MSDeformAttn3D)
    rows = []
    model.transformer.encoder.layers[-1].register_forward_hook(
        lambda _m, _i, out: rows.append(out.shape[1]))
    first = []
    model.transformer.encoder.layers[0].register_forward_pre_hook(
        lambda _m, args: first.append(args[0].shape[1]))
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    _check_heads(out_t, out_j)
    # 4 token frames x the FPN's 16x16, 8x8, 4x4 and 2x2 grids at 64x64;
    # the backbone never slices for the exact encoder, and the slice cuts
    # the last layer to the 2 frames of the centre lerp
    full = 4 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2)
    assert first == [full]
    sliced = variant != "no_slice"
    assert rows == [full // 2 if sliced else full]
    scores, boxes, actor = postprocess_ava(out_t, torch.tensor([[64, 64],
                                                                [64, 48]]))
    assert scores.shape == (2, 3, 12) and boxes.shape == (2, 3, 4)


def test_exact_model_slice_changes_nothing():
    """The last-layer query slice is exact: the same weights and input with
    and without it give the same heads (to float32 order)."""
    out_j, model, pixels, mask = _world("slice")
    off = build_model(_cfg(get_cfg_custom, opts=VARIANTS["no_slice"]),
                      device="cpu")
    off.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        a, b = model(t(pixels), t(mask)), off(t(pixels), t(mask))
    for k in HEADS:
        np.testing.assert_allclose(n(a[k]), n(b[k]), atol=2e-5, rtol=2e-5)


def _train_cfg(get_cfg):
    cfg = _cfg(get_cfg)
    c = cfg.CONFIG
    c.MODEL.DROPOUT = 0.0
    c.ViT.DROP_PATH_RATE = 0.0
    c.DATA.MAX_BOXES = TRAIN_M
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX package's train-step loss (engine/train.py:194-202), its
    value_and_grad, the matcher's assignment and one optimizer update."""
    cfg = _train_cfg(jax_cfg_custom)
    jm = jax_build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in train_batch(3).items()}
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           batch["pixels"], batch["mask"], seed=90)
    matcher = jax_build_matcher(cfg)
    crit, _, wd = jax_build_criterion(cfg, matcher)

    def loss_fn(p):
        out = jm.apply(p, batch["pixels"], batch["mask"], True)
        losses = crit(out, batch)
        total = sum(losses[k] * w for k, w in wd.items())
        match = [matcher(o, batch) for o in list(out["aux_outputs"]) + [out]]
        return total, (losses, match)

    (total, (losses, match)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile(
        {"xla_backend_optimization_level": 0})(params)
    tx = jax_make_optimizer(float(cfg.CONFIG.TRAIN.LR))
    updates, _ = tx.update(grads, tx.init(params), params)
    return params, float(total), losses, match, grads, optax.apply_updates(
        params, updates)


def test_tiny_exact_train_step_matches_jax():
    params, total_j, losses_j, match_j, grads_j, new_j = _jax_step()
    cfg = _train_cfg(get_cfg_custom)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    model.head_dropout.p = 0.0       # the class head's fixed 0.5 (see JAX's)
    trainer = Trainer(model, cfg, device="cpu")
    total, losses, match = trainer.loss({k: t(v) for k, v in
                                         train_batch(3).items()})
    # as tests/test_torch_train_step.py
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
    for i, layer in enumerate(model.transformer.encoder.layers):
        for part in ("value_proj", "sampling_offsets", "attention_weights"):
            g = getattr(layer.self_attn, part).weight.grad
            assert g.abs().max() > 0, f"layer {i} {part}"
    grads = {name: n(p.grad) for name, p in model.named_parameters()}
    assert trainer.optimizer.update() is not None
    after = params_from_jax(new_j)
    lr = float(cfg.CONFIG.TRAIN.LR)
    for name, p in model.named_parameters():
        got, exp = n(p), n(after[name])
        # as tests/test_torch_train_step.py: AdamW's first step is lr x the
        # gradient's sign where the gradient is well above its tolerance
        sure = np.abs(grads[name]) > 5e-3
        np.testing.assert_allclose(got[sure], exp[sure], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got, exp, atol=2 * lr + 1e-6, err_msg=name)


def _mamba_cfg(get_cfg):
    """AVA22_ViT-B-train-mamba.yaml cut as tests/test_torch_mamba.py cuts
    the VSS one: D_MODEL 32, 2 + 2 layers, d_ffn 64, 3 queries, 8 frames,
    mamba_proj width 48; VideoMamba patched to embed 32, depth 2."""
    cfg = _cfg(get_cfg, MAMBA)
    cfg.CONFIG.MODEL.D_MODEL = 32
    cfg.CONFIG.MAMBA.OUT_CHANNELS.videomamba_tiny = 48
    return cfg


@functools.lru_cache(maxsize=None)
def _mamba_world():
    pixels, mask = _request(95, (64, 128))
    with (mock.patch.dict(j_vm.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA),
          mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA)):
        jm = jax_build_model(_mamba_cfg(jax_cfg_custom))
        params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                               jnp.asarray(pixels), jnp.asarray(mask),
                               seed=96)
        out_j = _jit(jm, params, pixels, mask)
        model = build_model(_mamba_cfg(get_cfg_custom), device="cpu",
                            input_hw=(64, 128))
    model.load_state_dict(params_from_jax(params), strict=True)
    return out_j, model, pixels, mask


def test_tiny_videomamba_exact_model_matches_jax():
    out_j, model, pixels, mask = _mamba_world()
    assert model.spec.is_mamba and model.spec.encoder_type == "attention"
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    _check_heads(out_t, out_j)
    with pytest.raises(NotImplementedError, match="step 19"):
        model.train()(t(pixels), t(mask))
