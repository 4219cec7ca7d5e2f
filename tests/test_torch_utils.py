"""The port's utilities against the JAX package's, on the CPU:

* ``utils.checkpoint_convert``: ``convert_csn_mat`` (Caffe2 ``.mat`` names,
  with and without running statistics) and ``convert_videomamba_pretrain``
  (prefix strip, head drop, bicubic / linear resampling of the position
  tables) equal to ``params_from_jax`` of the JAX converters' trees, bit
  for bit, and naming exactly the port's modules' tensors;
* ``utils.transplant``: the exact -> fast encoder transplant of a tiny
  encoder (2d resample, 3d native with level scales) equal to
  ``params_from_jax(transplant_exact_to_fast(...))``, bit for bit, and
  loadable into the fast encoder;
* ``utils.plot_utils``: ``load_log`` equal to JAX's, the plots (matplotlib
  when present), a clear ``ImportError`` without it, the plot CLI;
* ``utils.profiling``: ``trace`` writes a Chrome trace, ``timed_call``.

(The offset statistics are in ``test_torch_deform_encoder.py``, the FLOP
count in ``test_torch_model.py``.)
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.utils import checkpoint_convert as jconv
from class_query_vad_tpu.utils import plot_utils as jplot
from class_query_vad_tpu.utils import transplant as jtrans
from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.models.csn import CSN
from class_query_vad_tpu_torch.utils import checkpoint_convert as tconv
from class_query_vad_tpu_torch.utils import plot_utils as tplot
from class_query_vad_tpu_torch.utils import transplant as ttrans
from class_query_vad_tpu_torch.utils.profiling import timed_call, trace
from class_query_vad_tpu_torch.utils.weights import params_from_jax


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k


def _csn_mat(block_nums, stats: bool, seed: int = 0):
    """Caffe2-named CSN weights of CSN's shapes at small widths' stand-in:
    random arrays with the right ranks (the converters only rename)."""
    rng = np.random.default_rng(seed)
    mat = {}

    def conv(name):
        mat[name] = rng.standard_normal((4, 3, 1, 2, 2)).astype(np.float32)

    def bn(name):
        mat[name + "_s"] = rng.standard_normal((4, 1)).astype(np.float32)
        mat[name + "_b"] = rng.standard_normal((1, 4)).astype(np.float32)
        if stats:
            mat[name + "_rm"] = rng.standard_normal(4).astype(np.float32)
            mat[name + "_riv"] = rng.random(4).astype(np.float32)

    conv("conv1_w")
    bn("conv1_spatbn_relu")
    for count in range(sum(block_nums)):
        for i in (1, 3, 4):
            conv(f"comp_{count}_conv_{i}_w")
            bn(f"comp_{count}_spatbn_{i}")
        conv(f"shortcut_projection_{count}_w")
        bn(f"shortcut_projection_{count}_spatbn")
    return mat


@pytest.mark.parametrize("stats", [True, False])
def test_convert_csn_mat_matches_jax(stats):
    blocks = (3, 4, 6, 3)
    mat = _csn_mat(blocks, stats)
    got = tconv.convert_csn_mat(mat, blocks)
    _equal(got, params_from_jax({"backbone": jconv.convert_csn_mat(mat, blocks)}))
    own = {f"backbone.0.body.{k}" for k in CSN(blocks).state_dict()}
    if stats:
        assert set(got) == own
    else:
        assert set(got) == {k for k in own if "running" not in k}


def _videomamba_pretrain(depth: int, c: int = 8, patches: int = 36,
                         frames: int = 4, seed: int = 1):
    """A raw VideoMamba pretrain state_dict (bimamba-v2 names, a
    ``backbone.`` prefix, a classifier head, one layer more than used)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    d, n, r, k = 2 * c, 4, 2, 4
    sd = {"patch_embed.proj.weight": f(c, 3, 1, 16, 16),
          "patch_embed.proj.bias": f(c), "cls_token": f(1, 1, c),
          "pos_embed": f(1, 1 + patches, c),
          "temporal_pos_embedding": f(1, frames, c),
          "norm_f.weight": f(c), "norm_f.bias": f(c),
          "head.weight": f(10, c), "head.bias": f(10)}
    for i in range(depth + 1):
        s, mx = f"layers.{i}", f"layers.{i}.mixer"
        sd.update({f"{s}.norm.weight": f(c), f"{s}.norm.bias": f(c),
                   f"{mx}.in_proj.weight": f(2 * d, c),
                   f"{mx}.out_proj.weight": f(c, d)})
        for suf in ("", "_b"):
            sd.update({f"{mx}.conv1d{suf}.weight": f(d, 1, k),
                       f"{mx}.conv1d{suf}.bias": f(d),
                       f"{mx}.x_proj{suf}.weight": f(r + 2 * n, d),
                       f"{mx}.dt_proj{suf}.weight": f(d, r),
                       f"{mx}.dt_proj{suf}.bias": f(d),
                       f"{mx}.A{suf}_log": f(d, n), f"{mx}.D{suf}": f(d)})
    return {f"backbone.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("patches,frames", [(16, 8), (36, 4)],
                         ids=["resampled", "same_size"])
def test_convert_videomamba_pretrain_matches_jax(patches, frames):
    sd = _videomamba_pretrain(depth=2)
    got = tconv.convert_videomamba_pretrain(sd, depth=2, num_frames=frames,
                                            num_patches=patches)
    want = params_from_jax(jconv.convert_videomamba_pretrain(
        {k: v.numpy() for k, v in sd.items()}, depth=2, num_frames=frames,
        num_patches=patches))
    _equal(got, want)
    body = "backbone.0.body."
    assert got[body + "pos_embed"].shape == (1, 1 + patches, 8)
    assert got[body + "temporal_pos_embedding"].shape == (1, frames, 8)
    assert not any(".layers.2." in k or "head" in k for k in got)


def _exact_encoder_params(seed: int, d=16, nh=2, nl=2, np_=2, ffn=8,
                          layers=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dense = lambda i, o: {"kernel": f(i, o), "bias": 0.1 * f(o)}  # noqa
    norm = lambda: {"scale": 1 + 0.1 * f(d), "bias": 0.1 * f(d)}  # noqa
    enc = {f"layers_{i}": {
        "self_attn": {"value_proj": dense(d, d), "output_proj": dense(d, d),
                      "sampling_offsets": dense(d, nh * nl * np_ * 3),
                      "attention_weights": dense(d, nh * nl * np_)},
        "norm1": norm(), "linear1": dense(d, ffn), "linear2": dense(ffn, d),
        "norm2": norm()} for i in range(layers)}
    return {"params": {"transformer": {"encoder": enc}}}


def _fast_cfg(get_cfg, window, native):
    cfg = get_cfg()
    m = cfg.CONFIG.MODEL
    m.NHEAD, m.NUM_FEATURE_LEVELS, m.NUM_ENC_N_POINTS = 2, 2, 2
    m.FAST_RADIUS, m.FAST_WINDOW = (1 if native else 2), window
    m.FAST_CROSS_LEVEL = "native" if native else "resample"
    return cfg


@pytest.mark.parametrize("window,native", [("2d", False), ("3d", True)])
def test_transplant_matches_jax(window, native):
    params = _exact_encoder_params(3)
    shapes = ((4, 8, 10), (4, 4, 5)) if native else None
    want = params_from_jax(jtrans.transplant_exact_to_fast(
        params, _fast_cfg(jax_cfg_defaults, window, native), shapes))
    got = ttrans.transplant_exact_to_fast(
        params_from_jax(params), _fast_cfg(get_cfg_defaults, window, native),
        shapes)
    _equal(got, want)
    assert not any("sampling_offsets" in k for k in got)
    from class_query_vad_tpu_torch.models.fast_encoder import (
        FastDeformableEncoder,
    )

    enc = FastDeformableEncoder(2, 16, 8, 2, 2, 2, 1 if native else 2,
                                window, "native" if native else "resample")
    pre = "transformer.encoder."
    enc.load_state_dict({k[len(pre):]: v for k, v in got.items()},
                        strict=True)


def test_transplant_native_needs_the_spatial_shapes():
    with pytest.raises(ValueError, match="spatial_shapes"):
        ttrans.transplant_exact_to_fast(
            params_from_jax(_exact_encoder_params(4)),
            _fast_cfg(get_cfg_defaults, "2d", True))


@pytest.fixture
def log_dir(tmp_path):
    from class_query_vad_tpu_torch.utils.logging import MetricsLogger

    cfg = get_cfg_defaults()
    cfg.CONFIG.LOG.BASE_PATH, cfg.CONFIG.LOG.EXP_NAME = str(tmp_path), "run"
    logger = MetricsLogger(cfg)
    for step in range(4):
        logger.log({"step": step, "train/total_loss": 4.0 - step,
                    "loss_bbox": 0.5 / (step + 1)})
    logger.log({"epoch": 0, "mAP": 0.25})
    return tmp_path / "run"


def test_load_log_matches_jax(log_dir):
    got = tplot.load_log(str(log_dir))
    assert got == jplot.load_log(str(log_dir)) and len(got) == 5


def test_plots(log_dir, tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    fig, axs = tplot.plot_logs([str(log_dir)], fields=("train/total_loss",
                                                       "mAP"), ewm_alpha=0.5)
    assert [a.get_title() for a in axs] == ["train/total_loss", "mAP"]
    ys = axs[0].get_lines()[0].get_ydata()
    np.testing.assert_allclose(ys, [4.0, 3.5, 2.75, 1.875])
    npz = tmp_path / "pr.npz"
    np.savez(npz, precision=np.linspace(1, 0.5, 5), recall=np.linspace(0, 1, 5),
             ap=0.7)
    fig, axs = tplot.plot_precision_recall([str(npz)])
    assert axs[0].get_title() == "Precision / Recall"
    from class_query_vad_tpu_torch.scripts.plot_logs import main

    out = tmp_path / "curves.png"
    main([str(log_dir), "--fields", "train/total_loss", "--out", str(out)])
    assert out.stat().st_size > 0


def test_plots_without_matplotlib_raise_a_clear_import_error(log_dir,
                                                             monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        tplot.plot_logs([str(log_dir)])


def test_offset_window_stats_cli(tmp_path, monkeypatch, capsys):
    """``scripts/offset_window_stats``: without a card and without
    ``--device cpu`` it raises before building anything; with ``--device
    cpu`` it reports every level of the reference init and of a tiny
    exact-encoder model (AVA22_ViT-B.yaml at ViT depth 1, one encoder and
    one decoder layer)."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.scripts.offset_window_stats import main

    from torch_parity import CONFIG_DIR, cut_cfg

    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(cut_cfg(get_cfg_custom(str(CONFIG_DIR / "AVA22_ViT-B.yaml")),
                            enc_layers=1, dec_layers=1).dump())
    args = ["--config-file", str(yaml), "--size", "64", "64"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    out = main(args + ["--device", "cpu"])
    assert sorted(out["init"]) == [0, 1, 2, 3]
    assert sorted(out["model"]) == [0, 1, 2, 3]
    for row in out["model"].values():
        assert 0.0 <= row["wfrac_within_1"] <= row["wfrac_within_2"] <= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_trace_writes_a_chrome_trace_and_timed_call(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        (x @ x).sum()
    files = list((tmp_path / "prof").glob("trace_*_rank0.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(r.key == "aten::mm" for r in prof.key_averages())
    assert timed_call(torch.mm, x, x, iters=3, warmup=1) > 0
