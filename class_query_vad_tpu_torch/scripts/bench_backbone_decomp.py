"""Decomposition of a model's backbone stage: ViT body vs FPN (the repo
root's ``scripts/bench_backbone_decomp.py`` on the port).

    python -m class_query_vad_tpu_torch.scripts.bench_backbone_decomp \\
        [--config AVA22_ViT-B_fast.yaml] [--batch 2] [--iters 30] \\
        [--hw 256x320] [--device cuda|cpu]

The config's model in bf16 with its seeded init on seeded clips; each
row timed as its own call under inference mode, the median of 3 windows
of ``--iters`` calls (``utils.profiling.timed_call``, synchronized):

  vit   the backbone's body alone (``DETR.backbone[0].body``)
  bb    the whole backbone (ViT + 4-level FPN + masks / poses)
  fpn   bb - vit
  full  the whole forward

The body and the backbone run on the arguments one forward gave them
(``timing.stage_calls``; on the main path the ViT's last block and the
FPN compute the centre-frame slice only).  Prints the JAX script's table,
then one JSON line with the card's name and power limit.  Runs on the
card (raises without one) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from .timing import add_forward_args, emit, print_stages, stage_times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_forward_args(ap, batch=2, iters=30, config="AVA22_ViT-B_fast.yaml")
    args = ap.parse_args(argv)
    ms, where = stage_times(args, lambda m: {
        "vit": m.backbone[0].body, "bb": m.backbone[0]})
    ms["fpn"] = ms["bb"] - ms["vit"]
    print_stages({k: ms[k] for k in ("vit", "bb", "fpn", "full")},
                 args.batch, where)
    return emit({"script": "bench_backbone_decomp", "config": args.config,
                 "batch": args.batch, "hw": args.hw, "card": where,
                 **{f"{k}_ms": v for k, v in ms.items()}})


if __name__ == "__main__":
    main()
