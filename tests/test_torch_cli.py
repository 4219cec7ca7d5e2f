"""The port's CLIs, ``python -m class_query_vad_tpu_torch.evaluate`` and
``... .train``, on a synthetic JHMDB51-21 world (``tests/test_e2e_cli.py``'s,
at narrow widths: ``torch_parity.jhmdb_world``).

* evaluate and train as subprocesses with ``--device cpu``: the JSON
  metrics line parses, the train run writes ``ckpt_epoch_00.pt`` and
  ``--resume`` from it (``main`` in this process) starts at epoch 1;
  without ``--device cpu`` and with no card both raise, not run on the
  CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import jhmdb_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return jhmdb_world(tmp_path_factory.mktemp("jhmdb"))


def _run(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _json(stdout):
    return json.loads([l for l in stdout.splitlines() if l.startswith("{")][-1])


def test_evaluate_cli(world):
    proc = _run("class_query_vad_tpu_torch.evaluate", "--config-file",
                str(world / "config1.yaml"), "--num_workers", "2",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = _json(proc.stdout)
    assert 0.0 <= line["mAP"] <= 1.0 and 0.0 <= line["v_mAP"] <= 1.0
    assert np.isfinite(line["eval_loss"])
    assert (world / "res" / "0.txt").exists()
    assert (world / "res" / "GT_0.txt").exists()


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
