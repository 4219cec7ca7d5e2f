"""One whole tiny train step of the port against the JAX package's, on the
CPU in float32: every loss key (aux included), every parameter's gradient
(the JAX gradient tree mapped onto the port's names by ``params_from_jax``),
the parameters after one AdamW update and the matcher's assignment of every
decoder layer; with ViT checkpointing off and on.  Also the tune-point
freezing labels.  The same step on two gloo ranks (``engine.Trainer`` in
DDP, one clip each, spawned as processes that import no JAX) against the
JAX step on the concatenated batch, and, on the same ranks (one spawn:
torch's import in each rank is most of its cost), gradient accumulation
under DDP, CSN's sync-BN against JAX's ``CSNBatchNorm`` on the whole
batch, and ``GRADIENT_CHECKPOINTING`` under DDP (a narrow ViT and a CSN-50,
two steps) against the remat-off DDP step and one process.

The tiny model is tests/test_torch_model.py's with two decoder layers (one
aux layer), dropout and drop path at 0; inputs and params come from numpy
with a seed.
"""

import functools
import shutil
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from class_query_vad_tpu.models import csn as jcsn
from class_query_vad_tpu_torch.config import get_cfg_custom, get_cfg_defaults
from class_query_vad_tpu_torch.engine import Trainer, backbone_freeze_labels
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.parallel.jobs import cpu_trainer
from class_query_vad_tpu_torch.parallel.launch import start_ranks
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from test_torch_csn import _Float64Numpy
from torch_parity import (
    CONFIG_DIR,
    TRAIN_M,
    cut_cfg,
    n,
    random_params,
    t,
    train_batch,
    train_cfg,
)


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


def _sync_bn_inputs():
    """Four NCDHW clips (mean 0.5, spread 2), a cotangent, the affine."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 6, 3, 5, 5)) * 2.0 + 0.5
    g = rng.standard_normal(x.shape)
    return x, g, 1 + 0.1 * rng.standard_normal(6), 0.1 * rng.standard_normal(6)


REMAT_MODELS = ("vit", "csn50")


def _remat_cfg(name: str, remat: bool):
    """``GRADIENT_CHECKPOINTING`` ``remat`` on ``train_cfg``'s model with a
    ViT of width 64 (2 heads), or on AVA22_CSN50.yaml cut to one encoder
    and two decoder layers (CSN's blocks and widths kept, its first stages
    frozen by the YAML's TUNE_POINT), ``train_batch``'s 12 classes and 6
    gt slots; dropout and drop path off, one micro-batch per update."""
    if name == "vit":
        cfg = train_cfg(get_cfg_defaults)
        cfg.CONFIG.ViT.EMBED_DIM, cfg.CONFIG.ViT.NUM_HEADS = 64, 2
    else:
        cfg = cut_cfg(get_cfg_custom(str(CONFIG_DIR / "AVA22_CSN50.yaml")),
                      enc_layers=1, dec_layers=2)
        c = cfg.CONFIG
        c.DATA.NUM_CLASSES, c.DATA.MAX_BOXES = 12, TRAIN_M
        c.MODEL.DROPOUT, c.ViT.DROP_PATH_RATE = 0.0, 0.0
    cfg.CONFIG.TRAIN.GRAD_ACCUM = 1
    cfg.CONFIG.GRADIENT_CHECKPOINTING = remat
    return cfg


def _one_process_steps(cfg, batches):
    """``remat_steps``'s result for one process on the whole batches."""
    trainer = cpu_trainer(cfg)
    metrics, grads = [], None
    for b in batches:
        metrics.append(trainer.step({k: t(v) for k, v in b.items()}))
        if grads is None:
            grads = {k: trainer.optimizer.last_grad(p).clone()
                     for k, p in trainer.model.named_parameters()
                     if p.requires_grad}
    return {"metrics": metrics, "grads": grads}


RESUME_STEPS = 3
RESUME_JOB = 3 + 2 * len(REMAT_MODELS)     # its index in ``_two_ranks``


def _dropout_cfg():
    """``train_cfg``'s model with dropout and drop path on, one
    micro-batch per update."""
    cfg = train_cfg(get_cfg_defaults)
    cfg.CONFIG.MODEL.DROPOUT = 0.1
    cfg.CONFIG.ViT.DROP_PATH_RATE = 0.2
    cfg.CONFIG.TRAIN.GRAD_ACCUM = 1
    return cfg


@functools.lru_cache(maxsize=None)
def _two_ranks():
    """The two gloo ranks' results for the tests below: the train step on
    ``train_batch()`` from JAX's params, ``GRAD_ACCUM`` 2 over two
    micro-batches, CSN's sync-BN, two steps of each ``REMAT_MODELS`` model
    with remat on and off, ``RESUME_STEPS`` steps with dropout on against
    a run saved and resumed before the last; and meanwhile, in this process, the same
    accumulation on both clips of each micro-batch and the remat models'
    two steps (remat off) on both clips."""
    x, g, w, b = _sync_bn_inputs()
    base_path = tempfile.mkdtemp(prefix="cqvad_resume_")
    acc = train_cfg(get_cfg_defaults)
    acc.CONFIG.TRAIN.GRAD_ACCUM = 2
    windows = [train_batch(0), train_batch(1)]
    ranks = start_ranks(2, [
        ("class_query_vad_tpu_torch.parallel.jobs:train_step",
         {"cfg": train_cfg(get_cfg_defaults).dump(), "batch": train_batch(),
          "state": params_from_jax(_jax_step()[0])}),
        ("class_query_vad_tpu_torch.parallel.jobs:accumulated_steps",
         {"cfg": acc.dump(), "batches": windows}),
        ("class_query_vad_tpu_torch.parallel.jobs:csn_batch_norm",
         {"x": x, "g": g, "weight": w, "bias": b})] + [
        ("class_query_vad_tpu_torch.parallel.jobs:remat_steps",
         {"cfg": _remat_cfg(name, remat).dump(), "batches": windows})
        for name in REMAT_MODELS for remat in (True, False)] + [
        ("class_query_vad_tpu_torch.parallel.jobs:resumed_steps",
         {"cfg": _dropout_cfg().dump(),
          "batches": [train_batch(s) for s in range(RESUME_STEPS)],
          "base_path": base_path})])
    model = build_model(acc, device="cpu")
    model.head_dropout.p = 0.0
    single = Trainer(model, acc, device="cpu")
    metrics = [single.step({k: t(v) for k, v in b.items()}) for b in windows]
    remat_one = {name: _one_process_steps(_remat_cfg(name, False), windows)
                 for name in REMAT_MODELS}
    try:
        return ranks.join(), model, metrics, remat_one
    finally:
        shutil.rmtree(base_path, ignore_errors=True)


def test_two_rank_ddp_step_matches_jax():
    """Two gloo ranks, clip r on rank r (3 and 2 live gt boxes): the summed
    losses, every gradient after DDP's summing hook and the parameters
    after AdamW are JAX's single step on both clips, with
    ``test_tiny_train_step_matches_jax``'s tolerances; both ranks'
    gradients and parameters are bit-equal."""
    cfg = train_cfg(get_cfg_defaults)
    params, total_j, losses_j, match_j, grads_j, new_j = _jax_step()
    want, after = params_from_jax(grads_j), params_from_jax(new_j)
    ranks, model, metrics, _ = _two_ranks()
    got = [r[0] for r in ranks]
    np.testing.assert_allclose(float(got[0]["losses"]["total"]), total_j,
                               rtol=1e-4)
    for k in losses_j:
        np.testing.assert_allclose(n(got[0]["losses"][k]), n(losses_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for r, res in enumerate(got):
        gt_idx, match_ok = res["match"]
        for layer, mj in enumerate(match_j):
            ok = np.asarray(mj.match_ok)[r]
            np.testing.assert_array_equal(match_ok[layer, 0].numpy(), ok)
            np.testing.assert_array_equal(gt_idx[layer, 0].numpy()[ok],
                                          np.asarray(mj.gt_idx)[r][ok])
    lr = float(cfg.CONFIG.TRAIN.LR)
    assert sorted(got[0]["grads"]) == sorted(got[0]["params"])
    for name, g in got[0]["grads"].items():
        assert torch.equal(g, got[1]["grads"][name]), name
        assert torch.equal(got[0]["params"][name], got[1]["params"][name])
        np.testing.assert_allclose(n(g), n(want[name]), rtol=1e-3,
                                   atol=5e-4, err_msg=name)
        p, exp = n(got[0]["params"][name]), n(after[name])
        sure = np.abs(n(g)) > 5e-3          # as the single-process test
        np.testing.assert_allclose(p[sure], exp[sure], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(p, exp, atol=2 * lr + 1e-6, err_msg=name)
    # GRAD_ACCUM 2: the first micro-batch under DDP's no_sync, its float32
    # sums reduced at the update with the second's; the same metrics and
    # AdamW step as one process on both clips (float32 sums in another
    # order: the first step's size where a gradient is near 0, as above)
    two = [r[1] for r in ranks]
    assert "grad_norm" not in two[0]["metrics"][0]
    for m_got, m_want in zip(two[0]["metrics"], metrics):
        assert sorted(m_got) == sorted(m_want)
        for k in m_want:
            np.testing.assert_allclose(n(m_got[k]), n(m_want[k]), rtol=1e-4,
                                       err_msg=k)
    for name, p in model.named_parameters():
        assert torch.equal(two[0]["params"][name], two[1]["params"][name])
        np.testing.assert_allclose(n(two[0]["params"][name]), n(p),
                                   atol=2 * lr + 1e-6, err_msg=name)


def test_sync_batch_norm_on_two_ranks_matches_jax_global_batch():
    """``CSNBatchNorm`` in train mode, four clips, rank r holding clips r
    and r + 2: each rank's output and its clips' gradient equal JAX's
    ``CSNBatchNorm`` on all four, and the ranks' summed weight / bias
    gradients equal JAX's (``jax.vjp``), both sides in float64 (JAX's
    float32 statistics read as float64, ``test_torch_csn._Float64Numpy``)
    to 1e-10 x max|ref|: the same statistics summed in another order."""
    x, g, w, b = _sync_bn_inputs()
    last = lambda a: np.moveaxis(a, 1, -1)      # noqa: E731  NCDHW -> NDHWC
    with jax.enable_x64(True), mock.patch.object(jcsn, "jnp",
                                                  _Float64Numpy()):
        bn = jcsn.CSNBatchNorm(6, dtype=jnp.float64)
        params = {"params": {"weight": w, "bias": b,
                             "running_mean": np.zeros(6),
                             "running_var": np.ones(6)}}
        y, vjp = jax.vjp(lambda p, v: bn.apply(p, v, True), params, last(x))
        dp, dx = (jax.tree_util.tree_map(np.asarray, a)
                  for a in vjp(jnp.asarray(last(g))))
    y, dx = np.moveaxis(np.asarray(y), -1, 1), np.moveaxis(dx, -1, 1)

    def close(got, want, what):
        assert got.dtype == torch.float64, what
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-10 * np.abs(want).max(), (what, err)

    for r, res in enumerate(_two_ranks()[0]):
        res = res[2]
        close(res["y"], y[r::2], f"rank {r} y")
        close(res["dx"], dx[r::2], f"rank {r} dx")
        close(res["dweight"], dp["params"]["weight"], f"rank {r} dweight")
        close(res["dbias"], dp["params"]["bias"], f"rank {r} dbias")


@pytest.mark.parametrize("name", REMAT_MODELS)
def test_gradient_checkpointing_under_ddp_on_two_ranks(name):
    """``GRADIENT_CHECKPOINTING`` under DDP, two gloo ranks with one clip
    each, two steps: the backward recomputes the first decoder layer (and
    CSN's sync-BN issues its all-reduces again, among DDP's bucket
    all-reduces); the first step's losses equal the remat-off DDP step's
    and its reduced gradients are within ``test_torch_remat``'s 1e-6 of a
    tensor's largest gradient of them; both runs are one process's two
    steps on both clips (losses to rtol 1e-4 as the accumulation check
    above; the first gradients to rtol 1e-4 and 1e-5 of the model's
    largest gradient, since float32 sums of two clips and sync-BN's
    statistics run in another order, and a gradient that is ~0 is all
    rounding); the
    second step's forward ran, so DDP found no trainable parameter without
    a gradient; both ranks' parameters are bit-equal after."""
    jobs = {(nm, remat): 3 + 2 * i + (0 if remat else 1)
            for i, nm in enumerate(REMAT_MODELS) for remat in (True, False)}
    ranks, _, _, one = _two_ranks()
    on = [r[jobs[name, True]] for r in ranks]
    off = [r[jobs[name, False]] for r in ranks]
    one = one[name]
    assert on[0]["forwards"] == 4 and off[0]["forwards"] == 2
    for res in (on, off):
        assert res[0]["digest"] == res[1]["digest"]
        assert len(res[0]["metrics"]) == 2
    for k, v in off[0]["metrics"][0].items():
        assert torch.equal(on[0]["metrics"][0][k], v), k
    for step in range(2):
        for k, v in one["metrics"][step].items():
            for res in (on, off):
                np.testing.assert_allclose(n(res[0]["metrics"][step][k]),
                                           n(v), rtol=1e-4, err_msg=k)
    g_on, g_off, g_one = on[0]["grads"], off[0]["grads"], one["grads"]
    assert sorted(g_on) == sorted(g_off) == sorted(g_one)
    top = max(g.abs().max().item() for g in g_one.values())
    for k, g in g_one.items():
        scale = g.abs().max().item()
        assert (g_on[k] - g_off[k]).abs().max().item() <= 1e-6 * scale, k
        np.testing.assert_allclose(n(g_on[k]), n(g), rtol=1e-4,
                                   atol=1e-5 * top, err_msg=k)


def test_two_rank_resume_gives_each_rank_its_own_dropout_stream():
    """Two gloo ranks, dropout and drop path on: ``RESUME_STEPS`` steps
    against the same steps with ``save_checkpoint`` (every rank's torch
    generator gathered to rank 0's file) and ``load_checkpoint`` into a
    fresh trainer before the last.  On each rank the last step's losses,
    its dropout mask and every parameter after it are the uninterrupted
    run's, bit for bit; the two ranks' masks differ (each rank restored
    its own stream, ``Trainer``'s ``seed + rank``)."""
    res = [r[RESUME_JOB] for r in _two_ranks()[0]]
    for rank, runs in enumerate(res):
        want, got = runs["uninterrupted"], runs["resumed"]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, v in want["metrics"].items():
            assert torch.equal(got["metrics"][k], v), (rank, k)
        assert torch.equal(got["mask"], want["mask"]), rank
        assert got["digest"] == want["digest"], rank
    assert res[0]["resumed"]["digest"] == res[1]["resumed"]["digest"]
    masks = [runs["resumed"]["mask"] for runs in res]
    assert masks[0].shape == masks[1].shape
    assert not torch.equal(masks[0], masks[1])
