"""What the port's timing scripts share (``probe_gather``,
``bench_selective_scan``, ``bench_config_forward``, ``bench_model_stages``,
``bench_backbone_decomp``): the ``--device`` flag (the card unless
``--device cpu``; a card that is not there raises), the card's name and
power limit, the median of timed windows (``utils.profiling.timed_call``,
which synchronizes), and a config's bf16 model on seeded clips whose
submodules are timed as the forward calls them.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils.profiling import timed_call

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")


def device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device with no card raises."""
    from ..evaluate import resolve_device

    return resolve_device(name)


def card(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def emit(record: dict) -> dict:
    """Print ``record`` as one JSON line and return it."""
    print(json.dumps(record), flush=True)
    return record


def median_ms(fn: Callable[[], object], iters: int,
              windows: int = 3) -> Tuple[float, List[float]]:
    """The median of ``windows`` timed windows of ``iters`` calls each, in
    ms per call, after one window of warm-up; and every window's ms."""
    timed_call(fn, iters=iters, warmup=1)
    ms = sorted(1e3 * timed_call(fn, iters=iters, warmup=0)
                for _ in range(windows))
    return ms[windows // 2], ms


def clip_model(config: str, batch: int, hw: str, dev: torch.device):
    """(cfg, the config's model in bf16 with its seeded init, seeded clips
    [batch, DATA.TEMP_LEN, H, W, 3] float32, an all-valid mask) for
    ``config`` (a YAML of the repo's ``configuration/`` by name, or a
    path) and ``hw`` = "HxW"."""
    from ..config import get_cfg_custom
    from ..models import build_model

    cfg = get_cfg_custom(os.path.join(REPO, "configuration", config))
    h, w = (int(x) for x in hw.split("x"))
    model = build_model(cfg, dtype=torch.bfloat16, device=dev,
                        input_hw=(h, w))
    t = cfg.CONFIG.DATA.TEMP_LEN
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.standard_normal(
        (batch, t, h, w, 3)).astype(np.float32)).to(dev)
    mask = torch.zeros((batch, h, w), dtype=torch.bool, device=dev)
    return cfg, model, pixels, mask


def stage_calls(model: nn.Module, pixels: torch.Tensor, mask: torch.Tensor,
                stages: Dict[str, nn.Module]
                ) -> Dict[str, Callable[[], object]]:
    """For each named submodule, a call of it on the arguments that one
    forward of ``model`` gave it (captured by forward pre-hooks), so that
    a stage is timed on the main path's own inputs (for the fast encoder:
    the centre-frame slice the backbone computes).  Raises if the forward
    did not call a stage."""
    seen: Dict[str, tuple] = {}

    def hook(name):
        def capture(_module, args, kwargs):
            seen.setdefault(name, (args, kwargs))
        return capture

    handles = [m.register_forward_pre_hook(hook(k), with_kwargs=True)
               for k, m in stages.items()]
    try:
        with torch.inference_mode():
            model(pixels, mask)
    finally:
        for h in handles:
            h.remove()
    missing = [k for k in stages if k not in seen]
    if missing:
        raise RuntimeError(f"the forward did not call {missing}")
    return {k: (lambda m=m, a=seen[k]: m(*a[0], **a[1]))
            for k, m in stages.items()}


def add_forward_args(ap, batch: int, iters: int,
                     config: str | None = None) -> None:
    """The forward timers' flags (the JAX scripts' defaults, ``--hw`` the
    clip size, ``--device``)."""
    if config is None:
        ap.add_argument("--config", required=True)
    else:
        ap.add_argument("--config", default=config)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--hw", default="256x320")
    add_device_arg(ap)


def stage_times(args, stages: Callable[[nn.Module], Dict[str, nn.Module]]
                ) -> Tuple[Dict[str, float], str]:
    """The stage timers' run: the model of ``args.config`` on seeded clips,
    ``full`` (the whole forward) and each of ``stages(model)`` timed as its
    own call (median of 3 windows of ``args.iters``), under inference
    mode.  Returns ({"full": ms, <stage>: ms, ...} per batch, ``card``)."""
    dev = device(args.device)
    _, model, pixels, mask = clip_model(args.config, args.batch, args.hw, dev)
    calls = stage_calls(model, pixels, mask, stages(model))
    calls = {"full": lambda: model(pixels, mask), **calls}
    with torch.inference_mode():
        ms = {k: median_ms(fn, args.iters)[0] for k, fn in calls.items()}
    return ms, card(dev)


def print_stages(rows: Dict[str, float], batch: int, where: str) -> None:
    """The JAX scripts' table: ms/batch | ms/clip per row."""
    print(f"B={batch}  (ms/batch | ms/clip) on {where}")
    for k, ms in rows.items():
        print(f"{k:9s} {ms:7.2f} | {ms / batch:6.2f}")
