"""The port's CLIs, ``python -m class_query_vad_tpu_torch.evaluate`` and
``... .train``, on a synthetic JHMDB51-21 world (``tests/test_e2e_cli.py``'s,
at narrow widths: ``torch_parity.jhmdb_world``).

* evaluate and train as subprocesses with ``--device cpu``: the JSON
  metrics line parses, evaluate's ``--flops`` prints the model's GFLOPs
  and ``--profile DIR`` writes a Chrome trace there, the train run writes ``ckpt_epoch_00.pt`` and
  ``--resume`` from it (``main`` in this process) starts at epoch 1;
  without ``--device cpu`` and with no card both raise, not run on the
  CPU;
* evaluate on two gloo ranks (two processes with torchrun's environment):
  rank 0 prints the 1-process run's mAP and video mAP, rank 1 prints no
  metrics line.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import JHMDB_YAML, jhmdb_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return jhmdb_world(tmp_path_factory.mktemp("jhmdb"))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return dict(env, **extra)


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)


@functools.lru_cache(maxsize=None)
def _evaluate_once(world):
    """The 1-process evaluate run on ``world`` (shared by the tests)."""
    return _run("class_query_vad_tpu_torch.evaluate", "--config-file",
                str(world / "config1.yaml"), "--num_workers", "2",
                "--device", "cpu", "--flops", "--profile",
                str(world / "profile"))


def _json(stdout):
    return json.loads([l for l in stdout.splitlines() if l.startswith("{")][-1])


def test_evaluate_cli(world):
    proc = _evaluate_once(world)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = _json(proc.stdout)
    assert 0.0 <= line["mAP"] <= 1.0 and 0.0 <= line["v_mAP"] <= 1.0
    assert np.isfinite(line["eval_loss"])
    assert (world / "res" / "0.txt").exists()
    assert (world / "res" / "GT_0.txt").exists()
    gflops = [l for l in proc.stdout.splitlines()
              if l.startswith("Model cost analysis:")]
    assert len(gflops) == 1 and "bytes accessed not counted" in gflops[0]
    assert float(gflops[0].split()[3]) > 0
    assert len(list((world / "profile").glob("trace_*_rank0.json"))) == 1


def test_train_cli_and_resume(world, capsys):
    ckpt = world / "e2e" / "checkpoints" / "ckpt_epoch_00.pt"
    proc = _run("class_query_vad_tpu_torch.train", "--config-file",
                str(world / "config1.yaml"), "--num_workers", "2",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Epoch 0: mean loss" in proc.stdout and ckpt.exists()
    assert _json(proc.stdout)["epoch"] == 0
    # the resumed run in this process: its main() takes the same flags
    from class_query_vad_tpu_torch.train import main

    capsys.readouterr()
    main(["--config-file", str(world / "config2.yaml"), "--num_workers", "2",
          "--device", "cpu", "--resume", str(ckpt)])
    out = capsys.readouterr().out
    assert "Resumed from" in out and "epoch 1" in out
    assert "Epoch [0]" not in out and "Epoch 1: mean loss" in out
    line = _json(out)
    assert line["epoch"] == 1 and "mAP" in line
    assert (world / "e2e" / "checkpoints" / "ckpt_epoch_01.pt").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("cli", ["evaluate", "train"])
def test_cli_without_a_card_raises(world, cli):
    import importlib

    main = importlib.import_module(f"class_query_vad_tpu_torch.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        main(["--config-file", str(world / "config1.yaml")])


def test_evaluate_cli_on_two_ranks(world):
    """``torchrun --nproc_per_node 2 -m class_query_vad_tpu_torch.evaluate
    --device cpu``, as two processes with its environment: each rank
    evaluates its share of the val clips, rank 0 merges both ranks' txt
    files (in ``res2``) and prints the 1-process run's mAP and v_mAP."""
    from class_query_vad_tpu_torch.parallel import free_port

    (world / "config_2ranks.yaml").write_text(
        JHMDB_YAML.format(root=world, epochs=1, res="res2"))
    env = _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "class_query_vad_tpu_torch.evaluate",
         "--config-file", str(world / "config_2ranks.yaml"), "--num_workers",
         "1", "--device", "cpu"], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    one = _json(_evaluate_once(world).stdout)
    two = _json(outs[0][0])
    assert (two["mAP"], two["v_mAP"]) == (one["mAP"], one["v_mAP"])
    assert not any(l.startswith("{") for l in outs[1][0].splitlines())
    for r in range(2):
        assert (world / "res2" / f"{r}.txt").exists()
