"""Entry points of the port (counterpart of the repo root's
``__graft_entry__.py``):

* ``entry()``: the main path's bf16 forward (``AVA22_ViT-B_fast``, one
  16x256x320 clip) and its example arguments, on the card;
* ``dryrun_multichip(n)``: ``n`` gloo ranks on the CPU (NCCL takes one
  rank per GPU, and a card machine may hold one) run the JAX dry run's
  three passes at its tiny shapes: a train step of the exact encoder, a
  train step of the ``fast_attention`` / 2d encoder, each held to a
  single-process step on the whole batch, and the sharded eval with
  ground truth canned from the model's own top detections, whose mAP must
  be materially above 0 and equal to the 1-rank run's.

    python -m class_query_vad_tpu_torch.entry [dryrun [N]]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from .parallel import jobs
from .parallel.launch import start_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_PATH = os.path.join(REPO, "configuration", "AVA22_ViT-B_fast.yaml")
EXACT = os.path.join(REPO, "configuration", "AVA22_ViT-B.yaml")
# the dry run's shapes (__graft_entry__.py's): clips of 4 frames at 32x64,
# 4 gt slots with 3 live boxes, 16 classes
T, H, W, M, NC = 4, 32, 64, 4, 16


def entry(device=None):
    """(fn, example_args): ``fn(pixels, mask)`` is the main path's bf16
    eval forward, returning (pred_logits, pred_boxes, pred_logits_b).  On
    the card unless ``device`` says otherwise; with no card it raises."""
    from .config import get_cfg_custom
    from .models import build_model

    cfg = get_cfg_custom(MAIN_PATH)
    model = build_model(cfg, dtype=torch.bfloat16, device=device)
    device = next(model.parameters()).device
    t = int(cfg.CONFIG.DATA.TEMP_LEN)
    pixels = torch.zeros((1, t, 256, 320, 3), device=device)
    mask = torch.zeros((1, 256, 320), dtype=torch.bool, device=device)

    @torch.inference_mode()
    def fn(pixels, mask):
        out = model(pixels, mask)
        return out["pred_logits"], out["pred_boxes"], out["pred_logits_b"]

    return fn, (pixels, mask)


def dryrun_cfg(fast: bool):
    """``AVA22_ViT-B.yaml`` at the dry run's size (ViT depth 1, one encoder
    and one decoder layer, 16 classes, 4 frames), dropout and drop path
    off; with ``fast`` the ``fast_attention`` encoder, 2d window, radius 1."""
    from .config import get_cfg_custom

    cfg = get_cfg_custom(EXACT)
    c = cfg.CONFIG
    c.DATA.TEMP_LEN = c.MODEL.TEMP_LEN = T
    c.DATA.NUM_CLASSES = NC
    c.DATA.LABEL_PATH = ""
    c.ViT.DEPTH = 1
    c.MODEL.ENC_LAYERS = c.MODEL.DEC_LAYERS = 1
    c.TRAIN.GRAD_ACCUM = 1
    c.MODEL.DROPOUT = 0.0
    c.ViT.DROP_PATH_RATE = 0.0
    if fast:
        c.MODEL.ENCODER_TYPE = "fast_attention"
        c.MODEL.FAST_RADIUS = 1
        c.MODEL.FAST_WINDOW = "2d"
    return cfg


def dryrun_batch(n: int) -> dict:
    rng = np.random.default_rng(0)
    return {
        "pixels": rng.normal(size=(n, T, H, W, 3)).astype(np.float32),
        "mask": np.zeros((n, H, W), bool),
        "boxes": np.clip(rng.uniform(0.2, 0.7, (n, M, 4)), 0.05,
                         0.95).astype(np.float32),
        "labels": (rng.uniform(size=(n, M, NC)) < 0.05).astype(np.float32),
        "n_boxes": np.full((n,), 3, np.int32),
    }


def canned_eval(model, postprocess, n: int):
    """Two eval batches of ``n`` clips and their metadata, the ground truth
    of each clip canned from its own top detection (its highest-actorness
    query's box, labelled with that query's argmax class)."""
    r = np.random.default_rng(2)
    mask = np.zeros((n, H, W), bool)
    sizes = torch.tensor([[H, W]] * n, dtype=torch.float32)
    batches = []
    for i in range(2):
        px = r.normal(size=(n, T, H, W, 3)).astype(np.float32)
        with torch.inference_mode():
            scores, boxes, binary = (x.numpy() for x in postprocess(
                model(torch.from_numpy(px), torch.from_numpy(mask)), sizes))
        meta = []
        for b in range(n):
            q = int(binary[b, :, 0].argmax())
            raw = np.zeros((1, 6), np.float32)
            raw[0, 2:6] = boxes[b, q]
            labels = np.zeros((1, NC), np.float32)
            labels[0, int(scores[b, q].argmax())] = 1.0
            meta.append({"image_id": [f"v{i:03d},{b:02d}"],
                         "size": np.asarray([H, W], np.float32),
                         "raw_boxes": raw, "labels": labels})
        batches.append(({"pixels": px, "mask": mask}, meta))
    return batches


def _dryrun_rank(n: int, base: str) -> dict:
    """One rank of the dry run (``launch.start_ranks``)."""
    from .engine import run_validation
    from .parallel import rank, sync_hosts

    out = {}
    for fast in (False, True):
        trainer, res = jobs.trained(dryrun_cfg(fast), dryrun_batch(n))
        out["fast" if fast else "exact"] = {k: res[k] for k in
                                            ("losses", "params")}
    cfg = dryrun_cfg(True)
    cfg.CONFIG.LOG.BASE_PATH = base
    model = trainer.model.eval()
    batches = canned_eval(model, trainer.postprocess, n)
    r = rank()
    clips = lambda b, m, s: ({k: v[s] for k, v in b.items()}, m[s])  # noqa
    if r == 0:
        # the clips one by one, as the ranks forward them, in the order
        # rank 0 merges the ranks' files: a fresh init's class logits are
        # float32 noise around 0 (the mean of a LayerNorm's output over its
        # features), so its scores tie at 0.5 and another batch shape
        # moves them; the evaluators (both packages') break score ties by
        # line order
        cfg.CONFIG.LOG.RES_DIR = "res_single"
        out["mAP_single"] = run_validation(
            cfg, model, trainer.postprocess,
            [clips(b, m, slice(i, i + 1)) for i in range(n)
             for b, m in batches])["mAP"]
    sync_hosts()
    cfg.CONFIG.LOG.RES_DIR = "res"
    res = run_validation(
        cfg, model, trainer.postprocess,
        [clips(b, m, slice(r, None, n)) for b, m in batches],
        rank=r, world_size=n, barrier=sync_hosts)
    if r == 0:
        out["mAP"] = res["mAP"]
    out["backend"] = torch.distributed.get_backend()
    return out


def dryrun_multichip(n_devices: int = 2) -> None:
    """The dry run on ``n_devices`` CPU ranks; raises if a check fails."""
    with tempfile.TemporaryDirectory(prefix="dryrun_eval_") as base:
        spawned = start_ranks(n_devices, [(
            "class_query_vad_tpu_torch.entry:_dryrun_rank",
            {"n": n_devices, "base": base})], threads=2)
        batch = dryrun_batch(n_devices)
        single = {}
        for tag in ("exact", "fast"):
            trainer = jobs.cpu_trainer(dryrun_cfg(tag == "fast"))
            single[tag] = trainer.model, trainer.step(batch)
        ranks = [r[0] for r in spawned.join()]
    lr = float(dryrun_cfg(False).CONFIG.TRAIN.LR)
    for tag in ("exact", "fast"):
        model, metrics = single[tag]
        for r, got in enumerate(ranks):
            for k, v in got[tag]["params"].items():
                if not torch.equal(v, ranks[0][tag]["params"][k]):
                    raise AssertionError(f"{tag}: rank {r}'s {k} differs "
                                         f"from rank 0's")
        want = dict(model.named_parameters())
        for k, v in ranks[0][tag]["params"].items():
            # AdamW's first step moves each element by ~lr whatever its
            # gradient's size: where a gradient is near 0 (float32 noise
            # between the split and the whole batch) its sign may differ
            if not torch.allclose(v, want[k].detach(), rtol=0,
                                  atol=2 * lr + 1e-6):
                raise AssertionError(f"{tag}: {k} after the step differs "
                                     f"from the single-process step's")
        total = float(ranks[0][tag]["losses"]["total"])
        if not np.isclose(total, float(metrics["total_loss"]), rtol=1e-4):
            raise AssertionError(f"{tag}: loss {total} on {n_devices} ranks, "
                                 f"{float(metrics['total_loss'])} in one")
        name = "fast_attention/2d" if tag == "fast" else "exact"
        print(f"dryrun_multichip ({name}) OK: loss {total:.6f} "
              f"({n_devices} ranks' parameters equal, within AdamW's "
              f"first step of one process's)")
    m1, mn = ranks[0]["mAP_single"], ranks[0]["mAP"]
    if not mn > 0.005:
        raise AssertionError(f"sharded eval mAP {mn:.4f}: canned-GT eval "
                             f"must score materially above zero")
    if mn != m1:
        raise AssertionError(f"sharded mAP {mn!r} != single-rank {m1!r}")
    print(f"dryrun_multichip eval OK: mAP={mn:.4f} (sharded == single-rank, "
          f"{n_devices} ranks)")
    print(f"dryrun_multichip ran on {n_devices} CPU ranks, backend "
          f"{ranks[0]['backend']}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 2)
    else:
        fn, args = entry()
        print("entry OK:", [tuple(o.shape) for o in fn(*args)])
