"""Stage decomposition of a model's eval forward (the repo root's
``scripts/bench_model_stages.py`` on the port).

    python -m class_query_vad_tpu_torch.scripts.bench_model_stages \\
        [--config AVA22_ViT-B_fast.yaml] [--batch 2] [--iters 30] \\
        [--hw 256x320] [--device cuda|cpu]

The config's model in bf16 with its seeded init on seeded clips
[B, DATA.TEMP_LEN, H, W, 3]; each stage timed as its own call under
inference mode, the median of 3 windows of ``--iters`` calls
(``utils.profiling.timed_call``, synchronized):

  full      the whole forward (all heads)
  backbone  ``DETR.backbone[0]``: ViT body + FPN + masks / poses
  encoder   the encoder on the levels the forward gives it
  rest      full - backbone - encoder (handoff, decoder, heads)

The backbone and the encoder run on the arguments one forward gave them
(``timing.stage_calls``): on the main path the backbone's centre-frame
slice and the encoder's sliced levels, where the JAX script times them on
every frame.  Prints the JAX script's table, then one JSON line with the
card's name and power limit.  Runs on the card (raises without one)
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from .timing import add_forward_args, emit, print_stages, stage_times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_forward_args(ap, batch=2, iters=30, config="AVA22_ViT-B_fast.yaml")
    args = ap.parse_args(argv)
    ms, where = stage_times(args, lambda m: {
        "backbone": m.backbone[0], "encoder": m.transformer.encoder})
    ms["rest"] = ms["full"] - ms["backbone"] - ms["encoder"]
    print_stages(ms, args.batch, where)
    return emit({"script": "bench_model_stages", "config": args.config,
                 "batch": args.batch, "hw": args.hw, "card": where,
                 **{f"{k}_ms": v for k, v in ms.items()}})


if __name__ == "__main__":
    main()
