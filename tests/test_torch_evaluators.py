"""The port's evaluators (``class_query_vad_tpu_torch/evaluates/``, a copy
of the JAX package's numpy-only ``evaluates/``) against the JAX package's
on the same per-rank txt files: AVA (synthetic_eval's world, the pbtxt
label map with the 80-class whitelist and fewer classes), UCF101-24 and
JHMDB51-21 (several actors, front / end pads, background frames), and the
size-bucketed single-person AVA evaluator.  Every mAP, video mAP and
metrics dict must be equal (``assert_equal``: NaN equals NaN)."""

from __future__ import annotations

import numpy as np
import pytest
from numpy.testing import assert_equal

import class_query_vad_tpu.evaluates as jev
import class_query_vad_tpu_torch.evaluates as tev
from class_query_vad_tpu.engine.evaluate import (
    EvalBuffers,
    buffer_ava,
    buffer_frames,
)

import synthetic_eval as se


def _write(buffers_by_rank, tmp_path):
    for rank, buf in enumerate(buffers_by_rank):
        buf.write(str(tmp_path), rank)
    n = len(buffers_by_rank)
    return ([str(tmp_path / f"{r}.txt") for r in range(n)],
            [str(tmp_path / f"GT_{r}.txt") for r in range(n)])


def _ava_files(tmp_path, nc: int, n_frames: int = 6, seed: int = 0):
    """Two ranks' AVA files: per keyframe 3 GT actors with multi-hot labels
    and 5 detections, the first 3 near the GT boxes."""
    rng = np.random.default_rng(seed)
    bufs = [EvalBuffers(), EvalBuffers()]
    for i in range(n_frames):
        gt = rng.uniform(10, 60, (3, 2))
        gt = np.concatenate([gt, gt + rng.uniform(20, 40, (3, 2))], 1)
        labels = (rng.random((3, nc)) < 0.15).astype(np.float32)
        labels[np.arange(3), rng.integers(0, nc, 3)] = 1.0
        raw = np.concatenate([np.full((3, 1), i), np.full((3, 1), 2), gt], 1)
        boxes = np.concatenate(
            [gt + rng.normal(0, 3, gt.shape), rng.uniform(0, 80, (2, 4))])
        scores = rng.random((5, nc)).astype(np.float32)
        scores[:3] += 0.5 * labels
        meta = [{"image_id": [f"vid{i % 3}_{900 + i:04d}"], "raw_boxes": raw,
                 "labels": labels}]
        buffer_ava(bufs[i % 2], scores[None], boxes[None],
                   rng.random((1, 5, 1)), meta)
    return _write(bufs, tmp_path)


def _labelmap(tmp_path, ids, excluded=()):
    path = tmp_path / "labelmap.pbtxt"
    path.write_text("".join(
        f'item {{\n  name: "action {i}"\n  id: {i}\n}}\n' for i in ids))
    (tmp_path / "ava_val_excluded_timestamps_v2.2.csv").write_text(
        "".join(f"{k}\n" for k in excluded))
    return str(path)


def _assert_same(a, b):
    assert_equal(a, b)
    assert type(a[0][0]) is type(b[0][0])


def test_ava_evaluator_synthetic_eval_world(tmp_path):
    """synthetic_eval's batches through its fake forward (sigmoid scores,
    abs boxes), unlabelled classes: the default categories."""
    import jax.numpy as jnp

    buf = EvalBuffers()
    for batch, meta in se.make_batches():
        out = se.fake_forward(None, jnp.asarray(batch["pixels"]), None)
        scores = 1.0 / (1.0 + np.exp(-np.asarray(out["pred_logits"])))
        cx, cy, w, h = np.moveaxis(np.asarray(out["pred_boxes"]), -1, 0)
        boxes = np.stack([(cx - w / 2) * se.W, (cy - h / 2) * se.H,
                          (cx + w / 2) * se.W, (cy + h / 2) * se.H], -1)
        buffer_ava(buf, scores, boxes, np.asarray(out["pred_logits_b"])[..., :1],
                   meta)
    det, gt = _write([buf], tmp_path)
    res = []
    for mod in (jev, tev):
        ev = mod.STDetectionEvaluaterAVA("", tiou_thresholds=[0.5],
                                         class_num=se.NC)
        ev.load_GT_from_path(gt)
        ev.load_detection_from_path(det)
        res.append(ev.evaluate())
    assert res[0][0][0] > 0.0
    _assert_same(res[0], res[1])


@pytest.mark.parametrize("nc,ids", [
    (80, [i for i in range(1, 81) if i % 4]),    # whitelist: 60 of 80
    (12, list(range(1, 13))),                     # fewer classes: no whitelist
])
def test_ava_evaluator_label_map(tmp_path, nc, ids):
    det, gt = _ava_files(tmp_path, nc)
    label_path = _labelmap(tmp_path, ids, excluded=["vid1_0904"])
    res = []
    for mod in (jev, tev):
        ev = mod.STDetectionEvaluaterAVA(label_path, tiou_thresholds=[0.5, 0.75],
                                         class_num=nc)
        assert (len(ev.exclude_keys) == 1) == (nc == 80)
        ev.load_GT_from_path(gt)
        ev.load_detection_from_path(det)
        res.append(ev.evaluate())
    assert res[0][0][0] > 0.0
    _assert_same(res[0], res[1])
    assert_equal(jev.read_labelmap(label_path), tev.read_labelmap(label_path))


def _tube_files(tmp_path, name: str, nq: int = 4, t: int = 8, seed: int = 1):
    """Per-rank tube files as ``buffer_frames`` writes them: 4 clips of 2
    videos (two clips each, frames 1-8 and 9-16), front / end pads, UCF
    with 2 actors (the second background with -1 boxes over the first
    half of a video's first clip), JHMDB with one tube per video."""
    nc = 24 if name == "ucf" else 21
    rng = np.random.default_rng(seed)
    bufs = [EvalBuffers(), EvalBuffers()]
    pads = [(2, 0), (0, 1), (1, 0), (0, 2)]
    video_labels = rng.choice(nc, 2, replace=False)
    for i, (fp, ep) in enumerate(pads):
        vid, clip = divmod(i, 2)
        a = 2 if name == "ucf" else 1
        label = int(video_labels[vid])
        frames = clip * t + np.arange(1, t + 1)
        base = rng.uniform(10, 40, (a, 1, 2))
        xy = base + np.cumsum(rng.normal(0, 1.5, (a, t, 2)), 1)
        wh = rng.uniform(20, 30, (a, 1, 2))
        raw = np.zeros((a, t, 6), np.float32)
        raw[..., 0] = i
        raw[..., 1] = frames
        raw[..., 2:4] = xy
        raw[..., 4:6] = xy + wh
        labels = np.full((a, t), label, np.int64)
        labels[:, :fp] = nc
        labels[:, t - ep:] = nc
        if a == 2 and clip == 0:      # its tube starts inside the video
            labels[1, : t // 2] = nc
            raw[1, : t // 2, 2:] = -1.0
        boxes = np.repeat(raw[:, :, 2:][:, :, None], nq // a, 2)
        boxes = boxes.transpose(1, 0, 2, 3).reshape(t, nq, 4)
        boxes = boxes + rng.normal(0, 2.0, boxes.shape)
        scores = rng.random((t, nq, nc)).astype(np.float32) * 0.5
        scores[..., label] += 0.5
        binary = rng.uniform(0.5, 1.0, (t, nq, 1))
        meta = [{"image_id": [f"Cls_v_{vid:04d}"], "front_pad": fp,
                 "end_pad": ep, "raw_boxes": raw.reshape(-1, 6),
                 "labels": labels.reshape(-1)}]
        buffer_frames(bufs[i % 2], scores[None], boxes[None], binary[None],
                      meta, nc)
    det, gt = _write(bufs, tmp_path)
    return det, gt, nc


@pytest.mark.parametrize("name", ["ucf", "jhmdb"])
def test_tube_evaluators(tmp_path, name):
    det, gt, nc = _tube_files(tmp_path, name)
    cls = {"ucf": "STDetectionEvaluaterUCF",
           "jhmdb": "STDetectionEvaluaterJHMDB"}[name]
    res = []
    for mod in (jev, tev):
        ev = getattr(mod, cls)(tiou_thresholds=[0.5, 0.2], class_num=nc,
                               query_num=4)
        ev.load_GT_from_path(gt)
        ev.load_detection_from_path(det)
        res.append(ev.evaluate())
    assert res[0][0][0] > 0.0 and res[0][2][0] > 0.0     # mAP, v-mAP
    _assert_same(res[0], res[1])


@pytest.mark.parametrize("bucket", [(0.0, 555.0 ** 2), (0.0, 900.0),
                                    (900.0, 555.0 ** 2)])
def test_single_person_evaluator(tmp_path, bucket):
    det, gt = _ava_files(tmp_path, 12, n_frames=8, seed=3)
    res = []
    for mod in (jev.evaluators, tev.evaluators):
        ev = mod.STDetectionEvaluaterSinglePerson(
            class_num=12, threshold_size_min=bucket[0],
            threshold_size_max=bucket[1])
        ev.load_GT_from_path(gt)
        ev.load_detection_from_path(det)
        res.append(ev.evaluate())
    _assert_same(res[0], res[1])
