"""The CSN backbone and a tiny ``AVA22_CSN50`` model in the PyTorch port
against the JAX package, on the CPU in float32, the same params through
``params_from_jax``.

* ``CSN`` at block counts (1, 1, 1, 1) and CSN-50's (3, 4, 6, 3), both
  ``last_stride`` values, on a [2, 8, 32, 32] clip: the float32 eval
  pyramid (running statistics) within 1e-5 x max|ref| of each level; the
  train pyramid (batch statistics) and every gradient of a fixed linear
  loss against ``jax.grad`` within 1e-4, both sides in float64 (see
  ``_csn_world``); the running statistics unchanged by the train forward
  and its backward;
* ``use_affine=True`` (``Affine``, the frozen-BN replacement): the same;
* a tiny ``AVA22_CSN50`` model (1 encoder layer, 1 decoder layer pair, 8
  frames of 64x64) against JAX's ``build_model``: heads within 2e-4, with
  the levels' unequal T taking the exact encoder's full (unsliced) last
  layer and the common-grid decode through ``grid_resize_3d_at_frame``;
* ``AVA22_CSN152.yaml`` (50 bottlenecks) takes a train step: its running
  statistics stay, the stages its TUNE_POINT freezes get no gradient.

One JAX jit per CSN world (``functools.lru_cache``).
"""

import functools
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_custom as jax_cfg_custom
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu.models import csn as jcsn
from class_query_vad_tpu.models.csn import CSN as JCSN
from class_query_vad_tpu_torch.config import get_cfg_custom
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.models import transformer as tr
from class_query_vad_tpu_torch.models.csn import CSN, Affine, CSNBatchNorm
from class_query_vad_tpu_torch.models.deform_encoder import DeformableEncoder
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import load_from_flax, n, random_params, t

CONFIGS = Path(__file__).resolve().parents[1] / "configuration"
CLIP = (2, 8, 32, 32, 3)
EVAL_TOL = 1e-5
TRAIN_TOL = 1e-4
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
OPT0 = {"xla_backend_optimization_level": 0}


def _cotangents(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: JAX's CSN takes
    its batch statistics in a hard-coded float32; with this in place of its
    module's ``jnp`` (and ``jax.enable_x64``) its whole train forward runs
    in float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@functools.lru_cache(maxsize=None)
def _csn_world(blocks, last_stride: bool, use_affine: bool):
    """The clip, float32 params and cotangents, and JAX's CSN in float64
    (the params promoted): the eval pyramid, the train pyramid and the
    gradients (params, clip) of sum_l <pyramid_l, ct_l> in train mode.
    Train-mode batch norms over a few positions amplify rounding
    exponentially with depth (at CSN-50's depth float32 rounding moves
    layer4 by up to 30 % on this clip, in either package), so JAX's side
    runs in float64 and the port's train side too.  One optimised jit (at
    LLVM's level 0 its float64 convolutions run 18x slower)."""
    x = np.random.default_rng(sum(blocks) + 2 * last_stride).standard_normal(
        CLIP).astype(np.float32)
    jm = JCSN(block_nums=blocks, last_stride=last_stride,
              use_affine=use_affine)
    params = random_params(lambda k, c: jm.init(k, c, False), jnp.asarray(x),
                           seed=3 + sum(blocks))
    shapes = [f.shape for f in jax.eval_shape(
        lambda p, c: jm.apply(p, c, False), params, jnp.asarray(x))]
    cts = _cotangents(shapes, 9)
    with jax.enable_x64(True), mock.patch.object(jcsn, "jnp",
                                                  _Float64Numpy()):
        j64 = JCSN(block_nums=blocks, last_stride=last_stride,
                   use_affine=use_affine, dtype=jnp.float64)

        def loss(p, c):
            out = j64.apply(p, c, True)
            return sum((f * ct).sum() for f, ct in zip(out, cts)), out

        def world(p, c):
            (_, train), grads = jax.value_and_grad(loss, (0, 1),
                                                   has_aux=True)(p, c)
            return j64.apply(p, c, False), train, grads

        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)
        out = jax.jit(world)(p64, jnp.asarray(x.astype(np.float64)))
        out = jax.tree_util.tree_map(np.asarray, out)
    return (x, params, cts, *out)


def _port_csn(blocks, last_stride, use_affine, params):
    tm = CSN(blocks, last_stride, use_affine)
    load_from_flax(tm, params, ("backbone",), "backbone.0.body.")
    return tm


def _level_close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = np.abs(n(g) - w).max()
        assert err <= tol * np.abs(w).max(), (what, i, err, np.abs(w).max())


CASES = [((1, 1, 1, 1), True), ((1, 1, 1, 1), False), ((3, 4, 6, 3), True),
         ((3, 4, 6, 3), False)]


@pytest.mark.parametrize("blocks,last_stride", CASES)
def test_csn_matches_jax_eval_and_train(blocks, last_stride):
    _check_csn(blocks, last_stride, use_affine=False)


def test_affine_norm_matches_jax():
    _check_csn((1, 1, 1, 1), True, use_affine=True)


def _check_csn(blocks, last_stride, use_affine):
    x, params, cts, want_eval, want_train, (g_params, g_x) = _csn_world(
        blocks, last_stride, use_affine)
    tm = _port_csn(blocks, last_stride, use_affine, params)
    norms = [m for m in tm.modules()
             if isinstance(m, (CSNBatchNorm, Affine))]
    assert len(norms) == 1 + 3 * sum(blocks) + 4
    with torch.no_grad():
        _level_close(tm.eval()(t(x)), want_eval, EVAL_TOL, "eval")
    stats = {k: v.clone() for k, v in tm.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert bool(stats) != use_affine
    tm.double()
    xt = t(x, torch.float64).requires_grad_()
    feats = tm.train()(xt)
    assert all(f.dtype == torch.float64 for f in feats)
    _level_close(feats, want_train, TRAIN_TOL, "train")
    sum((f * t(ct, torch.float64)).sum()
        for f, ct in zip(feats, cts)).backward()
    for k, v in stats.items():
        assert torch.equal(tm.state_dict()[k], v), k
    want = params_from_jax({"backbone": g_params["params"]})
    got = {f"backbone.0.body.{k}": p.grad for k, p in tm.named_parameters()}
    assert set(got) <= set(want)
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert not w.any(), k            # batch statistics in train
            continue
        err = (got[k] - w).abs().max().item()
        assert err <= TRAIN_TOL * w.abs().max().item() + 1e-7, (k, err)
    err = np.abs(n(xt.grad) - g_x).max()
    assert err <= TRAIN_TOL * np.abs(g_x).max()


def _csn50_cfg(get_cfg):
    """AVA22_CSN50.yaml cut to size: 1 encoder layer, 1 decoder layer pair,
    d_ffn 64, 3 queries, 8 frames; CSN-50 whole."""
    cfg = get_cfg(str(CONFIGS / "AVA22_CSN50.yaml"))
    c = cfg.CONFIG
    c.DATA.TEMP_LEN = c.MODEL.TEMP_LEN = 8
    c.MODEL.ENC_LAYERS = c.MODEL.DEC_LAYERS = 1
    c.MODEL.DIM_FEEDFORWARD = 64
    c.MODEL.QUERY_NUM = 3
    return cfg


def test_tiny_csn50_model_matches_jax():
    rng = np.random.default_rng(40)
    pixels = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True                      # second clip padded right
    jm = jax_build_model(_csn50_cfg(jax_cfg_custom))
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask), seed=41)
    args = (params, jnp.asarray(pixels), jnp.asarray(mask))
    out_j = jax.jit(lambda p, x, m: jm.apply(p, x, m, True)).lower(
        *args).compile(OPT0)(*args)
    model = build_model(_csn50_cfg(get_cfg_custom), device="cpu")
    sd = params_from_jax(params)
    model.load_state_dict(sd, strict=True)
    # the norms' parameters and statistics stay float32 in a bf16 model
    bf16 = build_model(_csn50_cfg(get_cfg_custom), torch.bfloat16, "cpu")
    dt = {k: v.dtype for k, v in bf16.state_dict().items()}
    assert dt["backbone.0.body.layer1.0.conv3.weight"] == torch.bfloat16
    for k in ("backbone.0.body.bn1.weight", "backbone.0.body.bn1.running_var",
              "backbone.0.body.layer3.0.down_sample.1.running_mean",
              "input_proj.3.0.weight", "input_proj.3.1.weight"):
        assert dt[k] == torch.float32, k
    enc_rows = []
    real_forward = DeformableEncoder.forward

    def spy_forward(self, *a, last_layer_rows=None, **kw):
        enc_rows.append(last_layer_rows)
        return real_forward(self, *a, last_layer_rows=last_layer_rows, **kw)

    with torch.inference_mode(), \
            mock.patch.object(DeformableEncoder, "forward", spy_forward), \
            mock.patch.object(tr, "grid_resize_3d_at_frame",
                              wraps=tr.grid_resize_3d_at_frame) as at_frame:
        out_t = model(t(pixels), t(mask))
    # CSN's levels (T 4, 2, 1, 1 at 8 frames): no slice plan, every level
    # resampled at the decode frame
    assert enc_rows == [None] and at_frame.call_count == 4
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]),
                                   err_msg=k, **MODEL_TOL)
    for a, b in zip(out_t["aux_outputs"], out_j["aux_outputs"]):
        for k in a:
            np.testing.assert_allclose(n(a[k]), np.asarray(b[k]), **MODEL_TOL)


def test_csn152_yaml_trains_with_frozen_stats_and_stages():
    cfg = get_cfg_custom(str(CONFIGS / "AVA22_CSN152.yaml"))
    c = cfg.CONFIG
    c.DATA.TEMP_LEN = c.MODEL.TEMP_LEN = 8
    c.MODEL.ENC_LAYERS = c.MODEL.DEC_LAYERS = 1
    c.MODEL.DIM_FEEDFORWARD = 64
    c.MODEL.QUERY_NUM = 3
    model = build_model(cfg, device="cpu")
    assert [len(getattr(model.backbone[0].body, f"layer{s}"))
            for s in range(1, 5)] == [3, 8, 36, 3]
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    trainer = Trainer(model, cfg, device="cpu")
    rng = np.random.default_rng(42)
    batch = {"pixels": rng.normal(size=(1, 8, 64, 64, 3)).astype(np.float32),
             "mask": np.zeros((1, 64, 64), bool),
             "boxes": rng.uniform(0.2, 0.7, (1, 3, 4)).astype(np.float32),
             "labels": (rng.random((1, 3, 80)) < 0.1).astype(np.float32),
             "n_boxes": np.array([2], np.int32)}
    metrics = trainer.step(batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert metrics["grad_norm"] > 0
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k
    # TUNE_POINT 4 (the default) with PRETRAINED: the stem, layer1 and
    # layer2 are frozen, layer3 and layer4 train
    body = model.backbone[0].body
    assert not any(p.requires_grad for m in (body.conv1, body.bn1,
                                             body.layer1, body.layer2)
                   for p in m.parameters())
    assert all(p.requires_grad for m in (body.layer3, body.layer4)
               for p in m.parameters())
    assert trainer.optimizer.last_grad(body.layer3[0].conv3.weight).abs().max() > 0
