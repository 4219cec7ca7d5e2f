"""Validation loop: forward + postprocess + per-rank txt protocol + mAP
(counterpart of the JAX package's ``engine/evaluate.py``).

Reference semantics (utils/video_action_recognition.py):

* per batch: forward, postprocess to absolute boxes / scores, buffer the
  rank's predictions and ground truths;
* write ``{rank}.txt`` / ``GT_{rank}.txt`` in the shared line formats
  (:231-240): detection row = [x1, y1, x2, y2, s_1..s_NC, p_b]; GT row =
  raw_boxes row + label vector;
* rank 0 loads every rank's files into the dataset's evaluator and
  computes the frame mAP (+ the video mAP for the tube datasets)
  (:249-261);
* AVA keyframe rows (:140-155); UCF / JHMDB flatten (B, T) and strip the
  front / end pads, frame keys = f"{video}_{frame_idx:03d}" (:623-660).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

_TARGET_KEYS = ("boxes", "labels", "n_boxes", "frame_valid", "n_actors")


def _fmt_line(key: str, vals) -> str:
    return "{} {}\n".format(key, [float(v) for v in vals])


class EvalBuffers:
    def __init__(self):
        self.det_lines: List[str] = []
        self.gt_lines: List[str] = []

    def write(self, res_dir: str, rank: int):
        os.makedirs(res_dir, exist_ok=True)
        with open(os.path.join(res_dir, f"{rank}.txt"), "w") as f:
            f.writelines(self.det_lines)
        with open(os.path.join(res_dir, f"GT_{rank}.txt"), "w") as f:
            f.writelines(self.gt_lines)


def buffer_ava(buffers: EvalBuffers, scores, boxes, binary, meta):
    """scores [B, NQ, NC], boxes [B, NQ, 4] abs xyxy, binary [B, NQ, 1]."""
    for b, m in enumerate(meta):
        if m.get("_fill"):
            continue      # batch-fill duplicate (fixed shapes), not data
        frame_id = m["image_id"][0]
        for q in range(scores.shape[1]):
            buffers.det_lines.append(
                _fmt_line(
                    frame_id,
                    list(boxes[b, q]) + list(scores[b, q]) + list(binary[b, q]),
                )
            )
        for row, label in zip(m["raw_boxes"], m["labels"]):
            buffers.gt_lines.append(_fmt_line(frame_id, list(row) + list(label)))


def buffer_frames(buffers: EvalBuffers, scores, boxes, binary, meta,
                  num_classes: int):
    """scores [B, T, NQ, NC]; tube datasets (video_action_recognition.py
    :560-660): strip pads, one-hot GT labels, frame keys from raw_boxes."""
    B, T, NQ = scores.shape[:3]
    for b, m in enumerate(meta):
        if m.get("_fill") or len(m["raw_boxes"]) == 0:
            continue
        frame_id = m["image_id"][0]
        fp = int(m.get("front_pad", 0))
        ep = int(m.get("end_pad", 0))
        raw = np.asarray(m["raw_boxes"]).reshape(-1, T, 6)[:, fp : T - ep]
        labels = np.asarray(m["labels"]).reshape(-1, T)[:, fp : T - ep]
        n_actors = raw.shape[0]
        for trel in range(T - fp - ep):
            t = trel + fp
            frame_idx = int(raw[0, trel, 1])
            key = f"{frame_id}_{frame_idx:03d}"
            for q in range(NQ):
                buffers.det_lines.append(
                    _fmt_line(
                        key,
                        list(boxes[b, t, q]) + list(scores[b, t, q])
                        + list(binary[b, t, q]),
                    )
                )
            for a in range(n_actors):
                onehot = np.zeros(num_classes + 1, np.float32)
                onehot[int(labels[a, trel])] = 1.0
                buffers.gt_lines.append(
                    _fmt_line(key, list(raw[a, trel]) + list(onehot))
                )


def _to_device(x: np.ndarray, dev: torch.device, dtype=None) -> torch.Tensor:
    """Host array -> ``dev``: cast on the host (``dtype``), then, for a
    card, one copy from pinned memory that does not block the host."""
    t = torch.from_numpy(np.asarray(x))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def run_validation(
    cfg,
    model,
    postprocess: Callable,
    loader,
    rank: int = 0,
    world_size: int = 1,
    barrier: Callable = lambda: None,
    forward_fn: Optional[Callable] = None,
    criterion: Optional[Callable] = None,
    transfer_dtype: Optional[torch.dtype] = None,
):
    """Evaluate ``model`` (``forward_fn(pixels, mask)``, ``model`` by
    default) over ``loader`` (``(batch, meta)`` pairs of host arrays, as
    ``datasets.DataLoader`` yields them).  Returns ``{"mAP", "metrics"[,
    "v_mAP", "v_metrics"][, "eval_losses"]}`` on rank 0, None elsewhere.

    Every rank writes its txt files, then calls ``barrier()``; rank 0 then
    reads all ``world_size`` ranks' files.  With ``criterion`` the eval
    losses (``evaluation=True``) are averaged over the batches and a
    non-finite total raises ``FloatingPointError`` (reference
    video_action_recognition.py:210-213).

    ``transfer_dtype``: the dtype the pixels are cast to on the host before
    the copy (the model's compute dtype, e.g. bf16: the backbone casts the
    pixels to it as its first op, so the outputs are unchanged and the copy
    halves).  The batches go to the device of ``model``'s parameters.

    The loop is pipelined one batch deep: batch k+1 is copied (from pinned
    memory, not blocking the host) and its forward and postprocessing are
    queued before batch k's outputs are read back and buffered, so the
    host's buffering overlaps the card's work.  Batch k's outputs (and
    losses) start their copies to the host as soon as they are queued, so
    reading them waits for batch k alone, not for batch k+1's forward
    queued behind them on the stream.  The criterion's matcher reads its
    costs on the host, so with ``criterion`` each batch waits for its own
    forward.  Everything runs under ``torch.inference_mode``;
    the model's process-wide caches are built outside it (``ops.
    fast_deform``), so a train step may follow in the same process.
    """
    name = cfg.CONFIG.DATA.DATASET_NAME
    nc = cfg.CONFIG.DATA.NUM_CLASSES
    res_dir = os.path.join(cfg.CONFIG.LOG.BASE_PATH, cfg.CONFIG.LOG.RES_DIR)
    buffers = EvalBuffers()
    if forward_fn is None:
        forward_fn = model
    dev = next(model.parameters()).device

    n_batches = 0
    loss_sums: Dict[str, float] = {}

    def _to_host(tensors):
        # copies queued now: behind the work that made the tensors, ahead
        # of the next batch's forward
        return [t.detach().float().to("cpu", non_blocking=True)
                for t in tensors]

    def _drain(pending):
        post, losses, landed, meta = pending
        if landed is not None:
            landed.synchronize()
        if losses is not None:
            keys, vals = losses
            losses = dict(zip(keys, vals.numpy()))
            # summed in float32 as the JAX package sums its device scalars
            total = float(sum(v for k, v in losses.items()
                              if not k[-1].isdigit()))
            if not math.isfinite(total):
                raise FloatingPointError(
                    f"Loss is {total}, stopping eval: {losses}"
                )
            for k, v in losses.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            loss_sums["total_loss"] = loss_sums.get("total_loss", 0.0) + total
        scores, boxes, binary = (x.numpy() for x in post)
        if name == "ava":
            buffer_ava(buffers, scores, boxes, binary, meta)
        else:
            buffer_frames(buffers, scores, boxes, binary, meta, nc)

    pending = None
    with torch.inference_mode():
        for batch, meta in loader:
            px = _to_device(batch["pixels"], dev, transfer_dtype)
            mk = _to_device(batch["mask"], dev)
            out = forward_fn(px, mk)
            sizes = _to_device(
                np.stack([np.asarray(m["size"], np.float32) for m in meta]),
                dev)
            post = _to_host(postprocess(out, sizes))
            n_batches += 1
            if pending is not None:
                _drain(pending)
            losses = None
            if criterion is not None:
                targets = {k: _to_device(batch[k], dev)
                           for k in _TARGET_KEYS if k in batch}
                d = criterion(out, targets, evaluation=True)
                losses = (list(d), _to_host([torch.stack(
                    [v.float().reshape(()) for v in d.values()])])[0])
            landed = None                 # when this batch's copies are in
            if dev.type == "cuda":
                landed = torch.cuda.Event()
                landed.record()
            pending = (post, losses, landed, meta)
        if pending is not None:
            _drain(pending)

    buffers.write(res_dir, rank)
    barrier()

    if rank != 0:
        return None

    eval_losses = (
        {k: v / max(n_batches, 1) for k, v in loss_sums.items()}
        if loss_sums else None
    )

    def _with_losses(result):
        if eval_losses is not None:
            result["eval_losses"] = eval_losses
        return result

    det_files = [os.path.join(res_dir, f"{r}.txt") for r in range(world_size)]
    gt_files = [os.path.join(res_dir, f"GT_{r}.txt") for r in range(world_size)]

    if name == "ava":
        from ..evaluates import STDetectionEvaluaterAVA

        ev = STDetectionEvaluaterAVA(
            cfg.CONFIG.DATA.LABEL_PATH, tiou_thresholds=[0.5], class_num=nc
        )
        ev.load_GT_from_path(gt_files)
        ev.load_detection_from_path(det_files)
        mAP, metrics = ev.evaluate()
        return _with_losses({"mAP": mAP[0], "metrics": metrics})
    elif name == "ucf":
        from ..evaluates import STDetectionEvaluaterUCF

        ev = STDetectionEvaluaterUCF(
            tiou_thresholds=[0.5], class_num=nc,
            query_num=cfg.CONFIG.MODEL.QUERY_NUM,
        )
    else:
        from ..evaluates import STDetectionEvaluaterJHMDB

        ev = STDetectionEvaluaterJHMDB(
            tiou_thresholds=[0.5], class_num=nc,
            query_num=cfg.CONFIG.MODEL.QUERY_NUM,
        )
    ev.load_GT_from_path(gt_files)
    ev.load_detection_from_path(det_files)
    mAP, metrics, v_mAP, v_metrics = ev.evaluate()
    return _with_losses({"mAP": mAP[0], "v_mAP": v_mAP[0], "metrics": metrics,
                         "v_metrics": v_metrics})
