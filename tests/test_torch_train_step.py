"""One whole tiny train step of the port against the JAX package's, on the
CPU in float32: every loss key (aux included), every parameter's gradient
(the JAX gradient tree mapped onto the port's names by ``params_from_jax``),
the parameters after one AdamW update and the matcher's assignment of every
decoder layer; with ViT checkpointing off and on.  Also the tune-point
freezing labels.

The tiny model is tests/test_torch_model.py's with two decoder layers (one
aux layer), dropout and drop path at 0; inputs and params come from numpy
with a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.engine.train import (
    backbone_freeze_labels as jax_freeze_labels,
    make_optimizer as jax_make_optimizer,
)
from class_query_vad_tpu.losses import (
    build_criterion_and_postprocessor as jax_build_criterion,
    build_matcher as jax_build_matcher,
)
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.engine import Trainer, backbone_freeze_labels
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import n, random_params, t, train_batch, train_cfg


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX package's train-step loss (engine/train.py:194-202), its
    value_and_grad, the matcher's assignment on its outputs and one
    update of its optimizer, on seeded params (remat off: it changes no
    value)."""
    cfg = train_cfg(jax_cfg_defaults)
    jm = jax_build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           batch["pixels"], batch["mask"], seed=0)
    matcher = jax_build_matcher(cfg)
    crit, _, wd = jax_build_criterion(cfg, matcher)

    def loss_fn(p):
        # deterministic: at MODEL.DROPOUT = DROP_PATH_RATE = 0 the one
        # dropout left is the class head's fixed 0.5 (detr.py:126), whose
        # bits the two frameworks cannot share; the port's test turns it
        # off instead
        out = jm.apply(p, batch["pixels"], batch["mask"], True)
        losses = crit(out, batch)
        total = sum(losses[k] * w for k, w in wd.items())
        layers = list(out["aux_outputs"]) + [out]
        match = [matcher(o, batch) for o in layers]
        return total, (losses, match)

    (total, (losses, match)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jax_make_optimizer(float(cfg.CONFIG.TRAIN.LR))
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    return params, float(total), losses, match, grads, new


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_tiny_train_step_matches_jax(use_checkpoint):
    params, total_j, losses_j, match_j, grads_j, new_j = _jax_step()
    cfg = train_cfg(get_cfg_defaults)
    cfg.CONFIG.ViT.USE_CHECKPOINT = use_checkpoint
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    model.head_dropout.p = 0.0          # see _jax_step
    trainer = Trainer(model, cfg, device="cpu")
    batch = {k: t(v) for k, v in train_batch().items()}
    total, losses, match = trainer.loss(batch)

    # fp32 on both sides through the ViT, two encoder and two decoder
    # layers; the frameworks sum in other orders (measured ~1e-6)
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
        # fp32 noise through the backward measured ~4e-6
        # (tests/test_remat.py:64-70); 5e-4 / 1e-3 leave margin
        np.testing.assert_allclose(n(p.grad), n(want[name]), rtol=1e-3,
                                   atol=5e-4, err_msg=name)

    grads = {name: n(p.grad) for name, p in model.named_parameters()}
    assert trainer.optimizer.update() is not None
    after = params_from_jax(new_j)
    lr = float(cfg.CONFIG.TRAIN.LR)
    for name, p in model.named_parameters():
        got, exp = n(p), n(after[name])
        # AdamW's first update is lr * g / (|g| + eps) per element: where
        # a gradient is within the grad tolerance of 0 its sign (so +-lr)
        # is not determined; well above it the update agrees to float32
        # rounding
        sure = np.abs(grads[name]) > 5e-3
        np.testing.assert_allclose(got[sure], exp[sure], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got, exp, atol=2 * lr + 1e-6, err_msg=name)



def test_backbone_freeze_labels_match_jax():
    params = _jax_step()[0]
    for pretrained, tune in ((True, 1), (True, 0), (False, 1)):
        cfgs = []
        for get in (get_cfg_defaults, jax_cfg_defaults):
            cfg = train_cfg(get)
            cfg.CONFIG.MODEL.PRETRAINED, cfg.CONFIG.MODEL.TUNE_POINT = pretrained, tune
            cfgs.append(cfg)
        labels = jax_freeze_labels(params, cfgs[1])
        want = params_from_jax(jax.tree_util.tree_map(
            lambda lab, p: np.full(p.shape, lab == "frozen", np.float32),
            labels, params))
        got = backbone_freeze_labels(build_model(cfgs[0], device="cpu"), cfgs[0])
        assert {k: v == "frozen" for k, v in got.items()} == {
            k: bool(want[k].any()) for k in got}
        assert any(v == "frozen" for v in got.values()) == (pretrained and tune > 0)
