"""The port's kernel and forward timers on the CPU, tiny: ``probe_gather``,
``bench_selective_scan``, ``bench_config_forward``, ``bench_model_stages``
and ``bench_backbone_decomp`` under ``class_query_vad_tpu_torch.scripts``,
each called through its ``main`` with ``--device cpu`` and small shapes
passed as flags (the forward timers on a YAML cut by
``torch_parity.cut_cfg`` with a narrow ViT): each runs, prints its JSON
lines and returns them; without ``--device cpu`` each raises when no
card is present.  Timings on the CPU mean nothing: only the records'
shapes are checked, and ``probe_gather``'s K14 row (its plain version
here) is exact against ``index_select``.
"""

import importlib
import json

import pytest
import torch

from class_query_vad_tpu_torch.config import get_cfg_custom

from torch_parity import CONFIG_DIR, cut_cfg

SCRIPTS = ("probe_gather", "bench_selective_scan", "bench_config_forward",
           "bench_model_stages", "bench_backbone_decomp")


def _main(name):
    return importlib.import_module(
        f"class_query_vad_tpu_torch.scripts.{name}").main


def _json_lines(out: str):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    """AVA22_ViT-B_fast.yaml cut to one encoder and one decoder layer, its
    ViT 64 wide with 2 heads, 8 frames."""
    cfg = cut_cfg(get_cfg_custom(str(CONFIG_DIR / "AVA22_ViT-B_fast.yaml")),
                  enc_layers=1, dec_layers=1)
    cfg.CONFIG.ViT.EMBED_DIM, cfg.CONFIG.ViT.NUM_HEADS = 64, 2
    path = tmp_path_factory.mktemp("timers") / "tiny.yaml"
    path.write_text(cfg.dump())
    return str(path)


def test_probe_gather_on_the_cpu(capsys):
    rec = _main("probe_gather")(["--rows", "64", "--indices", "300",
                                 "--iters", "1", "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == rec
    probes = [r["probe"] for r in rec]
    assert probes == (["index_select"] * 6
                      + ["blocked (2,2,2,32) as embedding_bag"]
                      + ["gather"] * 2 + ["K14 row_gather"])
    assert {(r["D"], r["dtype"]) for r in rec[:6]} == {
        (d, dt) for d in (32, 128, 256) for dt in ("float32", "bfloat16")}
    k14 = rec[-1]
    assert k14["exact"] is True and k14["card"] == "cpu"
    assert k14["bytes"] == 64 * 32 * 2 + 300 * 4 + 300 * 32 * 2
    assert "bound_ms" not in k14          # a bound is the card's
    assert all(r["ms"] > 0 for r in rec)


def test_bench_selective_scan_on_the_cpu(capsys):
    rows = _main("bench_selective_scan")(["quick", "--lengths", "16",
                                          "--iters", "1", "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == rows
    assert [(r["shape"], r["B"], r["KD"], r["N"], r["L"], r["dtype"])
            for r in rows] == [("vss", 4, 1024, 4, 16, "bfloat16"),
                               ("mamba", 1, 128, 16, 16, "bfloat16")]
    for r in rows:
        for impl in ("K5", "chunked", "ref"):
            assert r[f"{impl}_fwd_ms"] > 0 and r[f"{impl}_fb_ms"] > 0


def test_bench_config_forward_on_the_cpu(capsys, tiny_yaml):
    rec = _main("bench_config_forward")(["--config", tiny_yaml, "--hw",
                                         "64x64", "--iters", "1",
                                         "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == [rec]
    assert {"config", "batch", "temp_len", "hw", "first_call_s",
            "ms_per_batch", "ms_per_clip", "clips_per_s",
            "windows_ms"} <= set(rec)
    assert rec["temp_len"] == 8 and len(rec["windows_ms"]) == 3
    assert rec["windows_ms"][1] == rec["ms_per_batch"]


@pytest.mark.parametrize("name,stages", [
    ("bench_model_stages", ("full", "backbone", "encoder", "rest")),
    ("bench_backbone_decomp", ("full", "vit", "bb", "fpn")),
])
def test_stage_timers_on_the_cpu(capsys, tiny_yaml, name, stages):
    rec = _main(name)(["--config", tiny_yaml, "--hw", "64x64", "--batch",
                       "1", "--iters", "1", "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == [rec]
    assert rec["script"] == name and rec["card"] == "cpu"
    assert {f"{k}_ms" for k in stages} <= set(rec)
    parts = ("backbone", "encoder") if name == "bench_model_stages" else (
        "vit",)
    whole = "full" if name == "bench_model_stages" else "bb"
    rest = "rest" if name == "bench_model_stages" else "fpn"
    assert rec[f"{rest}_ms"] == pytest.approx(
        rec[f"{whole}_ms"] - sum(rec[f"{p}_ms"] for p in parts))


@pytest.mark.parametrize("name", SCRIPTS)
def test_timers_raise_without_a_card_unless_told_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config", "AVA22_ViT-B_fast.yaml"] if name == (
        "bench_config_forward") else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(name)(argv)
