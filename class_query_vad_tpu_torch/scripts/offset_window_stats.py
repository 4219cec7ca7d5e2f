"""How often do an exact encoder's sampling offsets leave the fast
encoder's window?  (The repo root's ``scripts/offset_window_stats.py`` on
the port.)  Two measurements, no data needed:

1. ``init``: the AVA-shaped exact encoder at the reference's
   initialization: the offset head's weight is zero, so the offsets are
   its directional ring bias for every query (point magnitudes 1..P), the
   distribution every training run starts from;
2. ``model``: the offsets and attention weights of a whole exact-encoder
   model (``--config-file``, ``--pretrained_path``; a seeded init without
   one) over seeded clips, captured by forward hooks, the out-of-window
   fraction also weighted by the softmax attention.  The model runs on
   the card (``--device``, ``cuda`` by default, which raises without
   one); ``--device cpu`` runs it on the CPU.

Prints per level the mean / max |spatial offset| in native pixels, the
fraction within +-1 / +-2 (the radius-1 window and a 2x slack) and |pt|,
the temporal component the 2d window drops; then one JSON line.

    python -m class_query_vad_tpu_torch.scripts.offset_window_stats \\
        [--config-file Y] [--pretrained_path P] [--clips N] [--frames T] \\
        [--size H W] [--device cuda|cpu]

(The JAX script's second measurement trains its synthetic probe,
``scripts/encoder_train_probe.py``, which the port has not taken over.)
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from class_query_vad_tpu_torch.utils.offset_stats import (
    collect_offsets_and_weights,
    native_pixel_offsets,
    softmax_weights,
    window_fractions,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def report(tag, raw_list, shapes, nh, np_, weight_list=None):
    pixels = np.concatenate(
        [native_pixel_offsets(r, shapes, nh, np_).reshape(
            -1, nh, len(shapes), np_, 3) for r in raw_list], axis=0)
    weights = None
    if weight_list is not None:
        weights = np.concatenate(
            [softmax_weights(w, nh, len(shapes), np_).reshape(
                -1, nh, len(shapes), np_) for w in weight_list], axis=0)
    rows = window_fractions(pixels, shapes, weights=weights)
    print(f"\n== {tag} ==")
    for r in rows:
        extra = ""
        if "wfrac_within_1" in r:
            extra = (f"  ATTN-WEIGHTED +-1: {100 * r['wfrac_within_1']:.1f}%"
                     f"  +-2: {100 * r['wfrac_within_2']:.1f}%")
        print(f"  level {r['level']} {r['shape']}: "
              f"mean|p| {r['mean_px']:.2f}px  max {r['max_px']:.1f}px  "
              f"within +-1: {100 * r['frac_within_1']:.1f}%  "
              f"+-2: {100 * r['frac_within_2']:.1f}%  "
              f"mean|pt| {r['mean_pt']:.2f}{extra}")
    return {r["level"]: r for r in rows}


def ava_init_stats():
    """The AVA-shaped exact encoder at the reference's init."""
    from class_query_vad_tpu_torch.ops.deform_attn import (
        directional_offset_init,
    )

    shapes = ((8, 64, 80), (8, 32, 40), (8, 16, 20), (8, 8, 10))
    nh, np_ = 8, 8
    bias = np.asarray(directional_offset_init(nh, len(shapes), np_))
    return report("AVA exact encoder @ reference init", [bias[None]],
                  shapes, nh, np_)


def model_stats(config: str, pretrained: str, clips: int, frames: int,
                size, device="cpu"):
    """A whole exact-encoder model's offsets over seeded clips, on
    ``device``."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_pretrained_params,
    )
    from class_query_vad_tpu_torch.models import build_model

    cfg = get_cfg_custom(config)
    cfg.CONFIG.DATA.TEMP_LEN = cfg.CONFIG.MODEL.TEMP_LEN = frames
    model = build_model(cfg, device=device, input_hw=tuple(size))
    if pretrained:
        load_pretrained_params(cfg, pretrained, model)
    rng = np.random.default_rng(0)
    shapes, raws, wts = None, [], []
    for _ in range(clips):
        px = torch.from_numpy(rng.normal(
            size=(1, frames, *size, 3)).astype(np.float32)).to(device)
        mask = torch.zeros((1, *size), dtype=torch.bool, device=device)
        srcs = []
        hook = model.transformer.register_forward_pre_hook(
            lambda _m, args: srcs.append(args[0]))
        _, pairs = collect_offsets_and_weights(model, px, mask)
        hook.remove()
        # the levels as [B, T, H, W, C]: (T, H, W) per level
        shapes = tuple(tuple(int(d) for d in s.shape[1:4]) for s in srcs[0])
        for o, w in pairs:
            raws.append(o)
            wts.append(w)
    m = cfg.CONFIG.MODEL
    return report(f"{os.path.basename(config)} ({clips} clips)", raws,
                  shapes, m.NHEAD, m.NUM_ENC_N_POINTS, weight_list=wts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-file", default=os.path.join(
        REPO, "configuration", "AVA22_ViT-B.yaml"))
    ap.add_argument("--pretrained_path", default="")
    ap.add_argument("--clips", type=int, default=1)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(128, 160))
    ap.add_argument("--device", default="cuda",
                    help="the model's device; cuda raises without a card")
    args = ap.parse_args(argv)
    from class_query_vad_tpu_torch.evaluate import resolve_device

    dev = resolve_device(args.device)
    out = {"init": ava_init_stats(),
           "model": model_stats(args.config_file, args.pretrained_path,
                                args.clips, args.frames, args.size, dev)}
    print("\n" + json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
