"""The port's eval loop (``class_query_vad_tpu_torch/engine/evaluate.py``)
against the JAX package's ``run_validation``.

* synthetic_eval's AVA world through one deterministic fake forward (numpy,
  so both frameworks see the same float32 bits) and a postprocess that
  only slices: the same txt files byte for byte, the same mAP, metrics and
  eval losses (``assert_equal``);
* the same world through synthetic_eval's ``fake_forward`` in JAX and its
  torch mirror, each with its own package's ``postprocess_ava``: txt
  numbers within 1e-6 + 1e-6 relative (a float32 ulp or two of XLA's and
  torch's sigmoid), the same mAP within 1e-9;
* a two-rank run (rank 1 writes, then rank 0 merges) equals one rank;
* NaN logits with a criterion raise ``FloatingPointError``;
* bf16 pixels cast on the host give the bf16 model's outputs bit for bit;
* ``run_validation`` then ``Trainer.step`` in one process: the
  process-wide tables first cached under inference mode take gradients.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.testing import assert_equal

import synthetic_eval as se
from class_query_vad_tpu_torch.engine.evaluate import run_validation
from torch_parity import tiny_cfg, train_batch


def _fake_np(px):
    """synthetic_eval's fake head, in numpy: scores (sigmoid), absolute
    xyxy boxes and actorness per query, from the pixels' mean."""
    logits, boxes, binary = [], [], []
    for b in range(px.shape[0]):
        cx, cy, wh, lg = se._fake_boxes_scores(px[b])
        logits.append(se._sigmoid(lg))
        boxes.append(np.stack([(cx - wh / 2) * se.W, (cy - wh / 2) * se.H,
                               (cx + wh / 2) * se.W, (cy + wh / 2) * se.H], -1))
        binary.append(se._sigmoid(np.sin(cx))[:, None])
    return {"pred_logits": np.float32(logits), "pred_boxes": np.float32(boxes),
            "pred_logits_b": np.float32(binary)}


def _criterion(xp):
    """Losses that are single elements (exact in both frameworks); aux keys
    end in a digit and stay out of the total."""
    def criterion(out, targets, evaluation=False):
        assert evaluation
        return {"loss_ce": out["pred_logits"][0, 0, 0],
                "loss_bbox": out["pred_boxes"][1, 2, 3] * xp(0.01),
                "loss_ce_0": out["pred_logits"][1, 1, 1]}
    return criterion


def _jax_run(cfg, batches, post=None, forward=None, **kw):
    import jax.numpy as jnp

    from class_query_vad_tpu.engine import run_validation as jax_run

    if forward is None:
        def forward(params, px, mk):
            return {k: jnp.asarray(v) for k, v in _fake_np(np.asarray(px)).items()}
    if post is None:
        def post(out, sizes):
            return (out["pred_logits"], out["pred_boxes"],
                    out["pred_logits_b"][..., :1])
    return jax_run(cfg, None, {}, post, batches, forward_fn=forward, **kw)


def _port_run(cfg, batches, post=None, forward=None, **kw):
    if forward is None:
        def forward(px, mk):
            return {k: torch.from_numpy(v)
                    for k, v in _fake_np(px.numpy()).items()}
    if post is None:
        def post(out, sizes):
            return (out["pred_logits"], out["pred_boxes"],
                    out["pred_logits_b"][..., :1])
    # the fake forward holds no weights: the model's one parameter says
    # where the batches go
    return run_validation(cfg, torch.nn.Linear(1, 1), post, batches,
                          forward_fn=forward, **kw)


def _files(path):
    return [(path / f).read_bytes() for f in ("0.txt", "GT_0.txt")]


def test_same_lines_and_result_as_jax(tmp_path):
    import jax.numpy as jnp

    batches = se.make_batches()
    jcfg = se.make_eval_cfg(tmp_path / "jax", "res")
    tcfg = se.make_eval_cfg(tmp_path / "port", "res")
    want = _jax_run(jcfg, batches, criterion=_criterion(jnp.float32))
    got = _port_run(tcfg, batches, criterion=_criterion(torch.tensor))
    assert want["mAP"] > 0.0
    assert _files(tmp_path / "port" / "res") == _files(tmp_path / "jax" / "res")
    assert_equal(got, want)
    assert set(got["eval_losses"]) == {"loss_ce", "loss_bbox", "loss_ce_0",
                                       "total_loss"}


def _torch_fake_forward(px, mk):
    """synthetic_eval.fake_forward in torch."""
    sig = px.float().mean(dim=(1, 2, 3, 4))
    q = torch.arange(se.NQ, dtype=torch.float32)
    c = torch.arange(se.NC, dtype=torch.float32)
    logits = 2.0 * torch.sin(sig[:, None, None] * 5.0 + q[None, :, None] * 0.7
                             + c[None, None, :] * 1.3)
    cx = torch.sigmoid(torch.sin(sig[:, None] * 3.0 + q[None, :] * 1.1))
    cy = torch.sigmoid(torch.cos(sig[:, None] * 2.0 + q[None, :] * 0.9))
    wh = (0.1 + 0.2 * torch.sigmoid(torch.sin(q)))[None, :].expand_as(cx)
    boxes = torch.stack([cx, cy, wh, wh], dim=-1)
    logits_b = torch.stack([torch.cos(sig[:, None] + q[None, :]),
                            torch.sin(sig[:, None] * 2.0 + q[None, :]),
                            torch.zeros_like(cx)], dim=-1)
    return {"pred_logits": logits, "pred_boxes": boxes,
            "pred_logits_b": logits_b}


def _rows(path):
    out = []
    for line in open(path):
        key, vals = line.split(" [")
        out.append((key, [float(v) for v in vals.rstrip("]\n").split(",")]))
    return out


def test_real_postprocess_against_jax(tmp_path):
    import jax

    from class_query_vad_tpu.losses.criterion import postprocess_ava as jpost
    from class_query_vad_tpu_torch.losses import postprocess_ava as tpost

    batches = se.make_batches()
    jcfg = se.make_eval_cfg(tmp_path / "jax", "res")
    tcfg = se.make_eval_cfg(tmp_path / "port", "res")
    want = _jax_run(jcfg, batches, jpost, jax.jit(se.fake_forward))
    got = _port_run(tcfg, batches, tpost, _torch_fake_forward)
    for f in ("0.txt", "GT_0.txt"):
        a = _rows(tmp_path / "port" / "res" / f)
        b = _rows(tmp_path / "jax" / "res" / f)
        assert [k for k, _ in a] == [k for k, _ in b]
        np.testing.assert_allclose(np.array([v for _, v in a]),
                                   np.array([v for _, v in b]), rtol=1e-6,
                                   atol=1e-6)
    assert want["mAP"] > 0.0
    assert abs(got["mAP"] - want["mAP"]) <= 1e-9


def test_two_ranks_merge_to_one(tmp_path):
    batches = se.make_batches()
    one = _port_run(se.make_eval_cfg(tmp_path / "one", "res"), batches)
    cfg = se.make_eval_cfg(tmp_path / "two", "res")
    assert _port_run(cfg, batches[1::2], rank=1, world_size=2) is None
    calls = []
    two = _port_run(cfg, batches[0::2], rank=0, world_size=2,
                    barrier=lambda: calls.append(1))
    assert calls == [1]
    assert one["mAP"] > 0.0
    assert_equal(two, one)


def test_non_finite_eval_loss_raises(tmp_path):
    def nan_forward(px, mk):
        out = {k: torch.from_numpy(v) for k, v in _fake_np(px.numpy()).items()}
        out["pred_logits"][0, 0, 0] = float("nan")
        return out

    with pytest.raises(FloatingPointError):
        _port_run(se.make_eval_cfg(tmp_path, "res"), se.make_batches(),
                  forward=nan_forward, criterion=_criterion(torch.tensor))


def _tiny_ava(bf16: bool = False):
    from class_query_vad_tpu_torch.config import get_cfg_defaults
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    cfg = tiny_cfg(get_cfg_defaults(), eff_slice=True)
    cfg.CONFIG.MODEL.DROPOUT = 0.0
    cfg.CONFIG.ViT.DROP_PATH_RATE = 0.0
    cfg.CONFIG.DATA.MAX_BOXES = 6
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = build_model(cfg, dtype, "cpu", torch.Generator().manual_seed(3))
    randomize_constants(model, torch.Generator().manual_seed(4))
    return cfg, model


def _tiny_loader(n_batches: int = 2):
    out = []
    for i in range(n_batches):
        batch = train_batch(seed=i)
        meta = []
        for b in range(2):
            n = int(batch["n_boxes"][b])
            cxcywh = batch["boxes"][b, :n] * 64
            xyxy = np.concatenate([cxcywh[:, :2] - cxcywh[:, 2:] / 2,
                                   cxcywh[:, :2] + cxcywh[:, 2:] / 2], 1)
            meta.append({"image_id": [f"v{i}_{b:04d}"],
                         "size": np.array([64, 48 if b else 64]),
                         "raw_boxes": np.concatenate(
                             [np.zeros((n, 2), np.float32), xyxy], 1),
                         "labels": batch["labels"][b, :n]})
        out.append((batch, meta))
    return out


def test_bf16_pixel_shipping_is_exact(tmp_path):
    """The bf16 model's first op casts the pixels to bf16, so casting them
    on the host before the copy changes nothing, in the ViT and through
    the whole loop."""
    from class_query_vad_tpu_torch.losses import postprocess_ava

    cfg, model = _tiny_ava(bf16=True)
    vit = model.backbone[0].body
    px = torch.from_numpy(
        (np.random.default_rng(0).normal(size=(1, 8, 64, 64, 3)) * 3)
        .astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(vit(px), vit(px.to(torch.bfloat16)))
    loader = _tiny_loader(1)
    files = []
    for name, tdt in (("f32", None), ("bf16", torch.bfloat16)):
        cfg.CONFIG.LOG.BASE_PATH = str(tmp_path)
        cfg.CONFIG.LOG.RES_DIR = name
        run_validation(cfg, model, postprocess_ava, loader,
                       transfer_dtype=tdt)
        files.append(_files(tmp_path / name))
    assert files[0] == files[1]


def test_validation_then_train_step(tmp_path):
    """The alignment matrices are first cached inside run_validation's
    inference mode; a train step after it must still take gradients."""
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.losses import (
        build_criterion_and_postprocessor,
        build_matcher,
    )
    from class_query_vad_tpu_torch.ops import fast_deform

    cfg, model = _tiny_ava()
    cfg.CONFIG.LOG.BASE_PATH = str(tmp_path)
    cfg.CONFIG.TRAIN.GRAD_ACCUM = 1
    fast_deform._resize_matrix_on.cache_clear()
    criterion, post, _ = build_criterion_and_postprocessor(
        cfg, build_matcher(cfg))
    loader = _tiny_loader()
    res = run_validation(cfg, model, post, loader, criterion=criterion)
    assert fast_deform._resize_matrix_on.cache_info().currsize > 0
    assert 0.0 <= res["mAP"] <= 1.0
    assert np.isfinite(res["eval_losses"]["total_loss"])
    trainer = Trainer(model, cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = trainer.step(loader[0][0])
    assert torch.isfinite(metrics["total_loss"]) and metrics["grad_norm"] > 0
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])]
    assert any(".self_attn.value_proj." in n for n in moved)
