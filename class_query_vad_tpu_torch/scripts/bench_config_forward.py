"""Eval-forward time of any configuration YAML (the repo root's
``scripts/bench_config_forward.py`` on the port).

    python -m class_query_vad_tpu_torch.scripts.bench_config_forward \\
        --config AVA22_CSN50.yaml [--batch 1] [--iters 20] [--windows 3] \\
        [--hw 256x320] [--device cuda|cpu]

Builds the config's whole model (CSN / ViT / VideoMamba backbone, any
encoder) in bf16 with its seeded init and times the all-heads forward on
seeded clips [B, DATA.TEMP_LEN, H, W, 3] under inference mode: the first
call alone (on the card it builds the config's kernels), then the median
of ``--windows`` windows of ``--iters`` calls
(``utils.profiling.timed_call``, synchronized).  Prints one JSON line, the
JAX script's keys and the card's name and power limit.  Runs on the card
(raises without one) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..utils.profiling import timed_call
from .timing import add_forward_args, card, clip_model, device, emit, median_ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_forward_args(ap, batch=1, iters=20)
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device(args.device)
    t0 = time.perf_counter()
    cfg, model, pixels, mask = clip_model(args.config, args.batch, args.hw,
                                          dev)
    print(f"build_model {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    with torch.inference_mode():
        first_s = timed_call(model, pixels, mask, iters=1, warmup=0)
        print(f"first call {first_s:.1f}s", file=sys.stderr)
        ms, windows = median_ms(lambda: model(pixels, mask), args.iters,
                                args.windows)
    b = args.batch
    return emit({
        "config": args.config, "batch": b,
        "temp_len": cfg.CONFIG.DATA.TEMP_LEN, "hw": args.hw,
        "first_call_s": first_s, "ms_per_batch": ms, "ms_per_clip": ms / b,
        "clips_per_s": 1e3 * b / ms, "windows_ms": windows,
        "card": card(dev)})


if __name__ == "__main__":
    main()
