"""Frame-level PASCAL mAP (TF-Object-Detection-API semantics).

Clean numpy reimplementation of the reference's vendored evaluator
(reference evaluates/utils/object_detection_evaluation.py,
per_image_evaluation.py:330-393, metrics.py:22-124) with the exact
decision rules:

* per image and class, detections are processed IN THE ORDER GIVEN (the
  callers pre-sort by descending score, evaluate_ava.py:152-166); each
  detection matches its argmax-IoU ground truth; a gt can be detected once;
  a match needs IoU >= threshold; difficult-gt matches drop the detection
  from scoring entirely;
* per class: P/R curve over globally score-sorted detections, precision
  denominator clamped by eps; AP = area under the monotone precision
  envelope with (0,1)/(1,0) sentinels (VOC "all points");
* classes without ground truth are excluded from the mean (NaN-mean).

Box format here is [x1, y1, x2, y2] absolute (plain area, no +1) — the
reference's np_box_list_ops.iou uses [ymin, xmin, ymax, xmax] but IoU is
coordinate-order invariant.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [N, 4] x [M, 4] xyxy boxes (no +1 convention)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC all-points AP (metrics.py:74-124)."""
    if precision is None:
        return float("nan")
    if not precision.size:
        return 0.0
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def compute_precision_recall(scores, tp_labels, num_gt):
    """metrics.py:22-71 — global sort by score desc, cumulative P/R."""
    if num_gt == 0:
        return None, None
    order = np.argsort(scores)[::-1]
    tp = tp_labels[order].astype(int)
    fp = 1 - tp
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(fp)
    precision = cum_tp.astype(float) / np.maximum(
        cum_tp + cum_fp, np.finfo(np.float64).eps
    )
    recall = cum_tp.astype(float) / num_gt
    return precision, recall


def tp_fp_single_class(
    det_boxes: np.ndarray,       # [N, 4] in caller's order (score-sorted)
    det_scores: np.ndarray,      # [N]
    gt_boxes: np.ndarray,        # [M, 4]
    gt_difficult: np.ndarray,    # [M] bool
    iou_threshold: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """per_image_evaluation.py:330-393 exactly: sequential argmax matching."""
    n = det_boxes.shape[0]
    if n == 0:
        return np.array([], float), np.array([], bool)
    if gt_boxes.size == 0:
        return det_scores.astype(float), np.zeros(n, bool)

    iou = box_iou_matrix(det_boxes, gt_boxes)
    tp = np.zeros(n, bool)
    dropped = np.zeros(n, bool)
    gt_detected = np.zeros(gt_boxes.shape[0], bool)
    best = np.argmax(iou, axis=1)
    for i in range(n):
        g = best[i]
        if iou[i, g] >= iou_threshold:
            if gt_difficult[g]:
                dropped[i] = True
            elif not gt_detected[g]:
                tp[i] = True
                gt_detected[g] = True
    keep = ~dropped
    return det_scores[keep].astype(float), tp[keep]


class PascalMAPEvaluator:
    """Accumulates per-image GT/detections, computes per-class AP + mAP.

    Class ids are 0-based here (the reference's 1-based ids minus its
    label_id_offset).
    """

    def __init__(self, num_classes: int, iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou_threshold = iou_threshold
        self.clear()

    def clear(self):
        self._gt: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._scores = [[] for _ in range(self.num_classes)]
        self._tp = [[] for _ in range(self.num_classes)]
        self._num_gt = np.zeros(self.num_classes, np.int64)

    def add_ground_truth(self, image_key: str, boxes, classes, difficult=None):
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        classes = np.asarray(classes, int)
        if difficult is None:
            difficult = np.zeros(len(classes), bool)
        if image_key in self._gt:
            raise ValueError(f"duplicate ground truth for {image_key}")
        self._gt[image_key] = (boxes, classes, np.asarray(difficult, bool))
        for c in range(self.num_classes):
            self._num_gt[c] += int(np.sum(classes[~difficult] == c))

    def add_detections(self, image_key: str, boxes, classes, scores):
        """Detections for one image; sorted by descending score internally
        (matching evaluate_ava.py:152-155)."""
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        classes = np.asarray(classes, int)
        scores = np.asarray(scores, float)
        order = np.argsort(-scores)
        boxes, classes, scores = boxes[order], classes[order], scores[order]

        gt_boxes, gt_classes, gt_difficult = self._gt.get(
            image_key, (np.zeros((0, 4)), np.zeros(0, int), np.zeros(0, bool))
        )
        for c in np.unique(classes):
            sel = classes == c
            gsel = gt_classes == c
            s, t = tp_fp_single_class(
                boxes[sel], scores[sel], gt_boxes[gsel], gt_difficult[gsel],
                self.iou_threshold,
            )
            self._scores[c].append(s)
            self._tp[c].append(t)

    def evaluate(self) -> Tuple[np.ndarray, float]:
        """Returns (per_class_ap [NC] with NaN where no gt, mAP)."""
        ap = np.full(self.num_classes, np.nan)
        for c in range(self.num_classes):
            if self._num_gt[c] == 0:
                continue
            scores = (
                np.concatenate(self._scores[c]) if self._scores[c] else
                np.array([], float)
            )
            tps = (
                np.concatenate(self._tp[c]) if self._tp[c] else
                np.array([], bool)
            )
            precision, recall = compute_precision_recall(
                scores, tps, self._num_gt[c]
            )
            ap[c] = compute_average_precision(precision, recall)
        with np.errstate(invalid="ignore"):
            mean_ap = float(np.nanmean(ap)) if np.any(~np.isnan(ap)) else 0.0
        return ap, mean_ap
