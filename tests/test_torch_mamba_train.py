"""The Mamba family trains: one tiny train step of ``AVA22_train-mamba_VSS``
(VideoMamba + the VSS encoder) and of ``AVA22_ViT-B-train-mamba``
(VideoMamba + the exact deformable encoder) against the JAX package's, on
the CPU in float32: every loss key, the matcher's assignment of every
decoder layer, every parameter's gradient (the JAX gradient tree mapped
onto the port's names by ``params_from_jax``) and the parameters after one
AdamW update, with JAX's freeze labels (FrozenBatchNorm's running
statistics frozen; its weight and bias decayed like every other
parameter).  Then, on the port alone: ``GRADIENT_CHECKPOINTING`` on against
off (each VideoMamba block and encoder layer recomputed, dropout on), the
SSM encoder's dropout live in ``train()``, FrozenBatchNorm's statistics
unmoved by a step, and the reference ``.pth`` round trip of both tiny
models through JAX's ``convert_detr_checkpoint``.

The tiny models are ``torch_parity.tiny_vss_cfg`` (D_MODEL 32, 2 encoder
and 2 decoder layers, 12 classes, 4 queries, 8 frames; VideoMamba patched to
embed 32, depth 2) on 64x64 clips: a 129-step backbone scan per direction
and 16-step encoder scans.  Dropout and drop path at 0 for the parity step;
the class head's fixed 0.5 dropout off on the port's side (JAX runs
deterministic).  The scans run through K5's plain versions: the forward
``selective_scan_reference`` and the explicit backward
``selective_scan_bwd_reference`` (``SelectiveScanFn``).

Tolerances as tests/test_torch_train_step.py: losses 1e-4, gradients rtol
1e-3 / atol 5e-4 (float32 noise through the backward ~1e-6), AdamW's first
update (lr x the gradient's sign) where a gradient is well above that.
Remat: 1e-5 x max.
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
from class_query_vad_tpu.engine.train import (
    backbone_freeze_labels as jax_freeze_labels,
    make_optimizer as jax_make_optimizer,
)
from class_query_vad_tpu.losses import (
    build_criterion_and_postprocessor as jax_build_criterion,
    build_matcher as jax_build_matcher,
)
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu.models import videomamba as j_vm
from class_query_vad_tpu.utils.checkpoint_convert import convert_detr_checkpoint
from class_query_vad_tpu_torch.config import get_cfg_custom
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.models import build_model, videomamba
from class_query_vad_tpu_torch.models.detr import randomize_constants
from class_query_vad_tpu_torch.models.vss import FrozenBatchNorm
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import (
    CONFIG_DIR,
    TINY_VIDEOMAMBA,
    TRAIN_M,
    VSS_YAML,
    n,
    random_params,
    t,
    tiny_vss_cfg,
    train_batch,
)

HW = (64, 64)
YAMLS = {"vss": VSS_YAML,
         "videomamba_exact": str(CONFIG_DIR / "AVA22_ViT-B-train-mamba.yaml")}
REMAT_TOL = 1e-5


def _cfg(get_cfg, name: str, dropout: float = 0.0):
    cfg = tiny_vss_cfg(get_cfg(YAMLS[name]))
    c = cfg.CONFIG
    c.MODEL.DROPOUT = dropout
    c.MODEL.DECODER_DTYPE = "float32"
    c.DATA.MAX_BOXES = TRAIN_M
    c.DATA.IMG_SIZE = HW[0]          # the converter's VideoMamba patch grid
    c.TRAIN.GRAD_ACCUM = 1
    return cfg


def _tiny():
    return (mock.patch.dict(j_vm.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA),
            mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA))


def _model(cfg, seed: int = 0):
    with _tiny()[1]:
        return build_model(cfg, device="cpu", input_hw=HW,
                           generator=torch.Generator().manual_seed(seed))


@functools.lru_cache(maxsize=None)
def _jax_step(name: str):
    """The JAX package's train-step loss (engine/train.py:194-202), its
    value_and_grad (compiled at XLA's opt level 0), the matcher's
    assignment and one update of its optimizer with its freeze labels."""
    batch = {k: jnp.asarray(v) for k, v in train_batch(7).items()}
    jpatch, _ = _tiny()
    with jpatch:
        cfg = _cfg(jax_cfg_custom, name)
        jm = jax_build_model(cfg)
        params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                               batch["pixels"], batch["mask"], seed=41)
        matcher = jax_build_matcher(cfg)
        crit, _, wd = jax_build_criterion(cfg, matcher)

        def loss_fn(p):
            out = jm.apply(p, batch["pixels"], batch["mask"], True)
            losses = crit(out, batch)
            total = sum(losses[k] * w for k, w in wd.items())
            match = [matcher(o, batch)
                     for o in list(out["aux_outputs"]) + [out]]
            return total, (losses, match)

        (total, (losses, match)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile(
            {"xla_backend_optimization_level": 0})(params)
    tx = jax_make_optimizer(float(cfg.CONFIG.TRAIN.LR),
                            freeze_labels=jax_freeze_labels(params, cfg))
    updates, _ = tx.update(grads, tx.init(params), params)
    return params, float(total), losses, match, grads, optax.apply_updates(
        params, updates)


@pytest.mark.parametrize("name", list(YAMLS))
def test_tiny_mamba_train_step_matches_jax(name):
    params, total_j, losses_j, match_j, grads_j, new_j = _jax_step(name)
    cfg = _cfg(get_cfg_custom, name)
    model = _model(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    model.head_dropout.p = 0.0
    trainer = Trainer(model, cfg, device="cpu")
    total, losses, match = trainer.loss(
        {k: t(v) for k, v in train_batch(7).items()})
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
    for pname, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype, pname
        np.testing.assert_allclose(n(p.grad), n(want[pname]), rtol=1e-3,
                                   atol=5e-4, err_msg=pname)
    body = model.backbone[0].body
    for i, blk in enumerate(body.layers):       # both scan directions train
        for p in ("A_log", "A_b_log", "D", "D_b"):
            assert getattr(blk.mixer, p).grad.abs().max() > 0, (i, p)
    grads = {k: n(p.grad) for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    assert (len(stats) > 0) == (name == "vss")
    assert trainer.optimizer.update() is not None
    after = params_from_jax(new_j)
    lr = float(cfg.CONFIG.TRAIN.LR)
    for pname, p in model.named_parameters():
        got, exp = n(p), n(after[pname])
        sure = np.abs(grads[pname]) > 5e-3
        np.testing.assert_allclose(got[sure], exp[sure], rtol=1e-6,
                                   atol=1e-6, err_msg=pname)
        np.testing.assert_allclose(got, exp, atol=2 * lr + 1e-6, err_msg=pname)
    for k, v in stats.items():                   # frozen in both packages
        np.testing.assert_array_equal(n(model.get_buffer(k)), n(after[k]))
        np.testing.assert_array_equal(n(v), n(after[k]))


def _remat_step(name: str, remat: bool):
    """One train step's loss and gradients with dropout on, and how many
    times VideoMamba's first block and encoder layer 0 ran forward."""
    cfg = _cfg(get_cfg_custom, name, dropout=0.1)
    cfg.CONFIG.GRADIENT_CHECKPOINTING = remat
    model = _model(cfg, seed=5)
    randomize_constants(model, torch.Generator().manual_seed(6))
    calls = {"block": 0, "layer": 0}
    for key, mod in (("block", model.backbone[0].body.layers[0]),
                     ("layer", model.transformer.encoder.layers[0])):
        # a pre-hook: the recompute stops once it has what the backward
        # needs, before a forward hook would run
        mod.register_forward_pre_hook(
            lambda *_, key=key: calls.__setitem__(key, calls[key] + 1))
    trainer = Trainer(model, cfg, device="cpu", seed=3)
    total, _, _ = trainer.loss({k: t(v) for k, v in train_batch(8).items()})
    total.backward()
    return total.item(), {k: p.grad.clone() for k, p in model.named_parameters()}, calls


@pytest.mark.parametrize("name", list(YAMLS))
def test_remat_changes_nothing(name):
    """GRADIENT_CHECKPOINTING on: every VideoMamba block and encoder layer
    recomputed in the backward (the RNG replayed, so dropout draws the
    same masks); the same loss and gradients within 1e-5 x max."""
    (l0, g0, c0), (l1, g1, c1) = (_remat_step(name, r) for r in (False, True))
    assert c0 == {"block": 1, "layer": 1} and c1 == {"block": 2, "layer": 2}
    assert abs(l1 - l0) <= REMAT_TOL * abs(l0)
    assert sorted(g0) == sorted(g1)
    for k, g in g0.items():
        err = (g1[k] - g).abs().max().item()
        assert err <= REMAT_TOL * g.abs().max().item() + 1e-12, (k, err)


def test_ssm_encoder_dropout_is_live_in_train():
    """The VSS encoder layer's two dropouts draw in ``train()`` and are
    off in ``eval()``."""
    cfg = _cfg(get_cfg_custom, "vss", dropout=0.1)
    layer = _model(cfg).transformer.encoder.layers[0]
    rng = np.random.default_rng(0)
    src = t(rng.standard_normal((1, 2 * 4 * 4, 32)).astype(np.float32))
    pos = t(rng.standard_normal((1, 2 * 4 * 4, 32)).astype(np.float32))
    with torch.no_grad():
        a, b = (layer.train()(src, pos, (2, 4, 4)) for _ in range(2))
        c, d = (layer.eval()(src, pos, (2, 4, 4)) for _ in range(2))
    assert not torch.equal(a, b) and torch.equal(c, d)
    assert not torch.allclose(a, c, atol=1e-3)


def test_frozen_batchnorm_statistics_stay_after_a_step():
    """A VSS ``Trainer.step`` in ``train()``: FrozenBatchNorm keeps its
    inference form, so its running statistics (buffers) do not move while
    its weight and bias do."""
    cfg = _cfg(get_cfg_custom, "vss")
    model = _model(cfg, seed=9)
    randomize_constants(model, torch.Generator().manual_seed(10))
    bns = {k: m for k, m in model.named_modules() if isinstance(m, FrozenBatchNorm)}
    assert len(bns) == 2 * 2                      # proj_conv and LSBlock per layer
    before = {k: [x.clone() for x in (m.running_mean, m.running_var,
                                      m.weight, m.bias)]
              for k, m in bns.items()}
    trainer = Trainer(model, cfg, device="cpu")
    assert "grad_norm" in trainer.step(train_batch(9))
    for k, m in bns.items():
        mean, var, w, b = before[k]
        assert torch.equal(m.running_mean, mean) and torch.equal(m.running_var, var), k
        assert not torch.equal(m.weight, w) and not torch.equal(m.bias, b), k


@pytest.mark.parametrize("name", list(YAMLS))
def test_reference_pth_round_trip(name):
    """A tiny model's state_dict, as the reference saves one, through JAX's
    ``convert_detr_checkpoint`` (``convert_videomamba``,
    ``convert_mamba_proj``, ``convert_ssm_encoder`` / ``convert_vss_block``
    or ``convert_encoder``) and ``params_from_jax``: every tensor back as
    it was, FrozenBatchNorm's statistics included.  The decoder's ConvBlock
    aliases (``conv_blocks.{0,1,2}``, one module registered three times)
    come back equal because the three names hold one tensor; JAX reads
    ``conv_blocks.0``."""
    jpatch, tpatch = _tiny()
    model = _model(_cfg(get_cfg_custom, name), seed=11)
    randomize_constants(model, torch.Generator().manual_seed(12))
    sd = model.state_dict()
    with jpatch:
        tree = convert_detr_checkpoint({k: v.numpy() for k, v in sd.items()},
                                       _cfg(jax_cfg_custom, name))
    back = params_from_jax(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(torch.as_tensor(np.asarray(back[k])), v), k
    aliases = [k for k in sd if ".conv_blocks.1." in k]
    assert aliases and all(
        sd[k].data_ptr() == sd[k.replace(".conv_blocks.1.", ".conv_blocks.0.")].data_ptr()
        for k in aliases)


@pytest.mark.parametrize("name", list(YAMLS))
def test_reference_pth_loads_like_jax(name, tmp_path):
    """The same tiny model saved as the reference saves a DETR (under
    ``model``, every key prefixed ``module.``): the port's
    ``load_pretrained_params`` loads every tensor, exactly what
    ``params_from_jax`` of the JAX package's ``load_pretrained_params``
    gives, and exactly the saved model."""
    from class_query_vad_tpu.engine.checkpoint import (
        load_pretrained_params as jax_load,
    )
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_pretrained_params,
    )

    src = _model(_cfg(get_cfg_custom, name), seed=13)
    randomize_constants(src, torch.Generator().manual_seed(14))
    sd = src.state_dict()
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": v.clone() for k, v in sd.items()}}, path)
    dst = _model(_cfg(get_cfg_custom, name), seed=15)
    jpatch, tpatch = _tiny()
    with jpatch, tpatch:
        assert load_pretrained_params(_cfg(get_cfg_custom, name), path, dst) == []
        want = params_from_jax(jax_load(_cfg(jax_cfg_custom, name), path))
    got = dst.state_dict()
    assert set(got) == set(want) == set(sd)
    for k, v in got.items():
        assert torch.equal(v, torch.as_tensor(np.asarray(want[k])).to(v.dtype)), k
        assert torch.equal(v, sd[k]), k


def test_temporal_max_pool_gradient_at_ties_matches_jax():
    """VideoMamba's 4x max-pool over T (``TemporalMaxPool``) on bf16 token
    maps full of ties (values on a coarse grid): its value and its
    gradient, all of it to the first maximum of each window, equal to
    ``jax.grad`` of flax's ``nn.max_pool`` (4, 1, 1), bit for bit."""
    import flax.linen as fnn

    from class_query_vad_tpu_torch.models.videomamba import TemporalMaxPool

    rng = np.random.default_rng(3)
    x = (rng.integers(0, 3, (2, 9, 2, 3, 4)) / 2).astype(np.float32)
    g = rng.standard_normal((2, 2, 2, 3, 4)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    pool = lambda v: fnn.max_pool(v, (4, 1, 1), strides=(4, 1, 1))
    want = pool(xj)
    want_grad = jax.grad(lambda v: (pool(v).astype(jnp.float32)
                                    * jnp.asarray(g)).sum())(xj)
    xt = t(x, torch.bfloat16).requires_grad_(True)
    got = TemporalMaxPool()(xt)
    (got.float() * t(g)).sum().backward()
    np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(xt.grad), n(want_grad))
    assert (n(xt.grad) != 0).sum() == g.size          # one element per window


def test_reference_pth_of_another_clip_size_loads_like_jax(tmp_path):
    """A reference ``.pth`` of VideoMamba + exact whose position tables
    were trained at another clip size (6x6 patches, 4 frames): the port's
    ``load_pretrained_params`` resamples them (bicubic, linear) to
    ``IMG_SIZE`` (4x4 patches) and ``TEMP_LEN`` (8 frames) as the JAX
    package's ``convert_detr_checkpoint`` does; the loaded model equals
    ``params_from_jax`` of JAX's load, bit for bit."""
    from class_query_vad_tpu.engine.checkpoint import (
        load_pretrained_params as jax_load,
    )
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_pretrained_params,
    )

    name, body = "videomamba_exact", "backbone.0.body."
    sd = _model(_cfg(get_cfg_custom, name), seed=16).state_dict()
    g = torch.Generator().manual_seed(17)
    c = sd[body + "pos_embed"].shape[-1]
    sd[body + "pos_embed"] = torch.randn((1, 1 + 36, c), generator=g)
    sd[body + "temporal_pos_embedding"] = torch.randn((1, 4, c), generator=g)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": sd}, path)
    dst = _model(_cfg(get_cfg_custom, name), seed=18)
    jpatch, tpatch = _tiny()
    with jpatch, tpatch:
        assert load_pretrained_params(_cfg(get_cfg_custom, name), path,
                                      dst) == []
        want = params_from_jax(jax_load(_cfg(jax_cfg_custom, name), path))
    got = dst.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, torch.as_tensor(np.asarray(want[k])).to(v.dtype)), k
    assert got[body + "pos_embed"].shape[1] == 1 + 16
    assert got[body + "temporal_pos_embedding"].shape[1] == 8
