"""The port's checkpoints (``class_query_vad_tpu_torch/engine/checkpoint.py``)
on tiny models (ViT depth 1 and width 64 over 2 heads, D_MODEL 64, one
encoder and two decoder layers; the YAMLs' heads, levels, points and
classes otherwise).

* A reference-layout ``.pth`` (``{"model": sd}``, ``module.`` prefixes,
  the reference's unused ConvBlock ``q_proj``) of a seeded exact-encoder
  model (``AVA22_ViT-B.yaml`` cut): the port's ``load_pretrained_params``
  must give exactly ``params_from_jax`` of the JAX package's.
* A reference CSN DETR ``.pth`` (``AVA22_CSN50.yaml`` cut) with its
  ``num_batches_tracked`` buffers: the same tensors as JAX's converter
  gives; the counters are dropped and reported, any other unexpected key
  raises.
* ``load_detr_weights`` tube -> single-frame and back (``UCF_ViT-B`` <->
  ``AVA22_ViT-B``, the ``refpoint_embed`` reshape; ``class_queries`` 24 vs
  80 classes is the shape mismatch): the same tensors as JAX's, the same
  transplanted and skipped counts.
* The fast encoder (``AVA22_ViT-B_fast``), which the JAX package's loaders
  send to its SSM converter: every reference-named key loads, the window
  heads stay at their init and are reported, anything else missing or
  unexpected raises, as does a shape that differs; a bare state_dict
  with the window heads loads whole.
* ``save_checkpoint`` -> ``load_pretrained_params`` reads a port
  checkpoint as it is; ``load_checkpoint`` restores a ``Trainer`` (its
  epoch and accuracy too), and the resumed one (dropout on) takes the steps
  of an uninterrupted one bit for bit, also halfway through a
  ``GRAD_ACCUM`` 2 window.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from class_query_vad_tpu_torch.engine.checkpoint import (
    load_checkpoint,
    load_detr_weights,
    load_pretrained_params,
    save_checkpoint,
)
from class_query_vad_tpu_torch.utils.weights import params_from_jax
from torch_parity import CONFIG_DIR, cut_cfg, train_batch, train_cfg


def _cfgs(yaml: str):
    from class_query_vad_tpu.config import get_cfg_custom as jax_cfg
    from class_query_vad_tpu_torch.config import get_cfg_custom as port_cfg

    path = str(CONFIG_DIR / f"{yaml}.yaml")
    out = []
    for get in (jax_cfg, port_cfg):
        # two decoder layers: with one, neither package has a query_scale
        cfg = cut_cfg(get(path), enc_layers=1, dec_layers=2)
        _narrow(cfg)
        out.append(cfg)
    return tuple(out)


def _narrow(cfg):
    cfg.CONFIG.ViT.EMBED_DIM = 64
    cfg.CONFIG.ViT.NUM_HEADS = 2
    cfg.CONFIG.MODEL.D_MODEL = 64
    return cfg


def _model(cfg, seed: int):
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    m = build_model(cfg, torch.float32, "cpu", torch.Generator().manual_seed(seed))
    randomize_constants(m, torch.Generator().manual_seed(seed + 1))
    return m


def _reference_file(path, sd, extra=None):
    """``sd`` as the reference saves it: under ``model``, every key
    prefixed ``module.``, with the class layers' unused ConvBlock q_proj."""
    d = int(sd["transformer.level_embed"].shape[1])     # D_MODEL
    ref = {f"module.{k}": v.clone() for k, v in sd.items()}
    for k in list(sd):
        if ".conv_blocks." in k and k.endswith(".conv1.weight"):
            ref[f"module.{k.replace('conv1.weight', 'q_proj.weight')}"] = (
                torch.randn(d, d))
    ref.update({f"module.{k}": v for k, v in (extra or {}).items()})
    torch.save({"epoch": 3, "model": ref}, path)
    return str(path)


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k


def test_reference_pth_matches_jax(tmp_path):
    from class_query_vad_tpu.engine.checkpoint import (
        load_pretrained_params as jax_load,
    )

    jcfg, tcfg = _cfgs("AVA22_ViT-B")
    src = _model(tcfg, 10)
    path = _reference_file(tmp_path / "ref.pth", src.state_dict())
    dst = _model(tcfg, 20)
    assert load_pretrained_params(tcfg, path, dst) == []
    want = params_from_jax(jax_load(jcfg, path))
    _assert_sd_equal(dst.state_dict(), want)
    _assert_sd_equal(dst.state_dict(), src.state_dict())


def test_reference_csn_pth_matches_jax(tmp_path):
    """A reference CSN DETR (``AVA22_CSN50.yaml`` cut) ``.pth`` with the
    ``*.num_batches_tracked`` buffers of its BatchNorm3d's: through JAX's
    ``convert_detr_checkpoint`` and ``params_from_jax`` the same tensors as
    the port's ``load_pretrained_params``, which drops the counters by
    name; ``load_detr_weights`` transplants its encoder and decoder."""
    from class_query_vad_tpu.engine.checkpoint import (
        load_pretrained_params as jax_load,
    )

    jcfg, tcfg = _cfgs("AVA22_CSN50")
    src = _model(tcfg, 50)
    sd = src.state_dict()
    counters = {k.replace("running_mean", "num_batches_tracked"):
                torch.tensor(7) for k in sd if k.endswith("running_mean")}
    assert len(counters) == 1 + 3 * 16 + 4
    path = _reference_file(tmp_path / "csn.pth", sd, counters)
    dst = _model(tcfg, 60)
    assert sorted(load_pretrained_params(tcfg, path, dst)) == sorted(counters)
    want = params_from_jax(jax_load(jcfg, path))
    _assert_sd_equal(dst.state_dict(), want)
    _assert_sd_equal(dst.state_dict(), sd)
    bad = _reference_file(tmp_path / "bad.pth", sd,
                          {"backbone.0.body.bn1.momentum": torch.ones(1)})
    with pytest.raises(KeyError, match="momentum"):
        load_pretrained_params(tcfg, bad, dst)
    used, skipped = load_detr_weights(_model(tcfg, 70), path, tcfg)
    assert used > 20 and skipped == 0


def _jax_params(jcfg, model):
    from class_query_vad_tpu.utils.checkpoint_convert import (
        convert_detr_checkpoint,
    )

    return convert_detr_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)


@pytest.mark.parametrize("donor,target", [("UCF_ViT-B", "AVA22_ViT-B"),
                                          ("AVA22_ViT-B", "UCF_ViT-B")])
def test_load_detr_weights_matches_jax(tmp_path, capsys, donor, target):
    from class_query_vad_tpu.engine.checkpoint import (
        load_detr_weights as jax_transplant,
    )

    _, dcfg = _cfgs(donor)
    path = _reference_file(tmp_path / "stage1.pth", _model(dcfg, 30).state_dict())
    jcfg, tcfg = _cfgs(target)
    model = _model(tcfg, 40)
    params = _jax_params(jcfg, model)
    _assert_sd_equal(model.state_dict(), params_from_jax(params))

    capsys.readouterr()
    new = jax_transplant(params, path, jcfg)
    jax_out = capsys.readouterr().out
    used, skipped = load_detr_weights(model, path, tcfg)
    port_out = capsys.readouterr().out
    _assert_sd_equal(model.state_dict(), params_from_jax(new))
    assert f"{used} tensors transplanted, {skipped} skipped" in jax_out
    assert skipped == 1 and "class_queries" in port_out   # 24 vs 80 classes
    assert used > 40


def _fast_files(tmp_path):
    """A fast-encoder model and its reference-layout file: no window heads,
    the exact encoder's sampling_offsets / attention_weights instead."""
    _, fcfg = _cfgs("AVA22_ViT-B_fast")
    _, ecfg = _cfgs("AVA22_ViT-B")
    src = _model(fcfg, 50)
    sd = {k: v for k, v in src.state_dict().items() if ".window_" not in k}
    exact = {k: v for k, v in _model(ecfg, 60).state_dict().items()
             if ".sampling_offsets." in k or ".attention_weights." in k}
    assert sd.keys().isdisjoint(exact) and len(exact) == 4
    return fcfg, src, sd, exact


def test_fast_encoder_branch(tmp_path, capsys):
    fcfg, src, sd, exact = _fast_files(tmp_path)
    path = _reference_file(tmp_path / "ref.pth", sd, exact)
    dst = _model(fcfg, 70)
    init = {k: v.clone() for k, v in dst.state_dict().items()}
    reported = load_pretrained_params(fcfg, path, dst)
    heads = sorted(k for k in init if ".window_" in k)
    assert len(heads) == 4 and sorted(reported) == sorted(heads + list(exact))
    assert "window_offsets" in capsys.readouterr().out
    got = dst.state_dict()
    for k in got:
        assert torch.equal(got[k], (init if k in heads else src.state_dict())[k]), k

    # anything else missing or unexpected raises
    for name, bad, extra in (
            ("missing", {k: v for k, v in sd.items()
                         if k != "transformer.encoder.layers.0.linear1.weight"},
             exact),
            ("unexpected", sd, {**exact, "transformer.encoder.extra": torch.ones(2)})):
        with pytest.raises(KeyError):      # raised before anything loads
            load_pretrained_params(fcfg, _reference_file(
                tmp_path / f"{name}.pth", bad, extra), dst)

    # a bare state_dict with the window heads loads whole; a shape that
    # differs raises
    bare = tmp_path / "bare.pth"
    torch.save(src.state_dict(), bare)
    assert load_pretrained_params(fcfg, str(bare), dst) == []
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    wrong = dict(src.state_dict())
    wrong["class_embed_b.weight"] = torch.zeros(3, 5)
    torch.save(wrong, bare)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_pretrained_params(fcfg, str(bare), dst)

    # the two-stage init: every encoder key but the window heads
    dst = _model(fcfg, 80)
    init = {k: v.clone() for k, v in dst.state_dict().items()}
    used, skipped = load_detr_weights(dst, path, fcfg)
    assert skipped == 0
    got = dst.state_dict()
    for k in got:
        donor = k.startswith(("transformer.encoder.", "transformer.decoder.",
                              "transformer.level_embed", "refpoint_embed"))
        want = src.state_dict() if donor and k not in heads else init
        assert torch.equal(got[k], want[k]), k


def test_port_checkpoint_loads_as_is(tmp_path):
    _, tcfg = _cfgs("AVA22_ViT-B_fast")
    tcfg.CONFIG.LOG.BASE_PATH = str(tmp_path)
    tcfg.CONFIG.LOG.EXP_NAME = "exp"
    src = _model(tcfg, 90)
    path = save_checkpoint(tcfg, src, 4, accuracy=0.25)
    assert path.endswith("exp/checkpoints/ckpt_epoch_04.pt")
    dst = _model(tcfg, 91)
    assert load_pretrained_params(tcfg, path, dst) == []
    _assert_sd_equal(dst.state_dict(), src.state_dict())
    # a model's checkpoint holds no optimizer: it cannot resume a run
    with pytest.raises(ValueError, match="no optimizer state"):
        load_checkpoint(path, None)


def _resume_cfg(tmp_path, accum: int):
    from class_query_vad_tpu_torch.config import get_cfg_defaults

    cfg = train_cfg(get_cfg_defaults)
    cfg.CONFIG.MODEL.DROPOUT = 0.1            # dropout on: the RNG matters
    cfg.CONFIG.ViT.DROP_PATH_RATE = 0.2
    cfg.CONFIG.TRAIN.GRAD_ACCUM = accum
    cfg.CONFIG.ViT.DEPTH = 1
    _narrow(cfg)
    cfg.CONFIG.LOG.BASE_PATH = str(tmp_path)
    cfg.CONFIG.LOG.EXP_NAME = "resume"
    return cfg


def _trainer(cfg, seed: int):
    from class_query_vad_tpu_torch.engine import Trainer

    return Trainer(_model(cfg, seed).train(), cfg, device="cpu")


@pytest.mark.parametrize("accum,steps,save_after", [(1, 2, 1), (2, 3, 1)])
def test_resume_is_bit_exact(tmp_path, accum, steps, save_after):
    cfg = _resume_cfg(tmp_path, accum)
    batches = [train_batch(seed=s) for s in range(steps)]

    def run(trainer, chunk):
        return [trainer.step(b)["total_loss"] for b in chunk]

    ref = _trainer(cfg, 100)
    want = run(ref, batches)
    np.random.seed(5)
    random.seed(5)

    first = _trainer(cfg, 100)
    got = run(first, batches[:save_after])
    path = save_checkpoint(cfg, first, 3, accuracy=0.25)
    if accum > 1:
        assert first.optimizer.micro == save_after and first.optimizer.steps == 0
    np_state, py_state = np.random.rand(), random.random()
    resumed = _trainer(cfg, 200)           # another init, another RNG state
    meta = load_checkpoint(path, resumed)
    assert meta["epoch"] == 3 and meta["accuracy"] == 0.25
    assert (np.random.rand(), random.random()) == (np_state, py_state)
    got += run(resumed, batches[save_after:])

    assert [float(x) for x in got] == [float(x) for x in want]
    _assert_sd_equal(resumed.model.state_dict(), ref.model.state_dict())
    for a, b in zip(resumed.optimizer.masters, ref.optimizer.masters):
        assert torch.equal(a, b)
    sa, sb = resumed.optimizer.opt.state_dict(), ref.optimizer.opt.state_dict()
    for i, st in sb["state"].items():
        for k, v in st.items():
            assert torch.equal(sa["state"][i][k], v), (i, k)
    assert resumed.optimizer.steps == ref.optimizer.steps == steps // accum
    assert resumed.optimizer.micro == steps
    for a, b in zip(resumed.optimizer.acc, ref.optimizer.acc):
        assert (a is None and b is None) or torch.equal(a, b)
