"""Video-mAP: tube linking + spatio-temporal AP.

Clean numpy reimplementation of the reference's tube machinery
(reference evaluates/utils/video_map.py:95-341 and
video_map_utils.py:85-260) with the exact decision rules:

* per (class, video): missing frames are filled with the nearest frame's
  detections; Viterbi (backward max-sum) over edge scores
  iou + s_i + s_j + 0.5*s_i*s_j links one box per frame; linked boxes are
  removed and the pass repeats until some frame empties, max 3 tubes
  (video_map.py:112-174);
* 3D NMS at 0.3 on tube-mean scores, then each kept tube is trimmed to
  [start : start+len] where start/len come from the video's first/last
  frames with any detection (video_map.py:177-226);
* AP: tubes sorted by mean score; a tube is positive if its best
  spatio-temporal IoU (iou3dt, +1-pixel area convention, temporal overlap
  weighting) against the video's remaining gt tubes clears the threshold;
  matched gt is consumed; PR uses fn + 1e-5 in the recall denominator;
  VOC all-points AP (video_map.py:211-277, video_map_utils.py:207-260);
* mAP = plain mean over classes (no gt-presence filtering).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# geometry (reference +1-pixel conventions, video_map_utils.py:85-180)
# ---------------------------------------------------------------------------

def _area2d(b: np.ndarray) -> np.ndarray:
    return (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)


def _overlap2d(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    xmin = np.maximum(b1[:, 0], b2[:, 0])
    xmax = np.minimum(b1[:, 2] + 1, b2[:, 2] + 1)
    ymin = np.maximum(b1[:, 1], b2[:, 1])
    ymax = np.minimum(b1[:, 3] + 1, b2[:, 3] + 1)
    return np.maximum(0, xmax - xmin) * np.maximum(0, ymax - ymin)


def iou2d(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    if b1.ndim == 1:
        b1 = b1[None, :]
    if b2.ndim == 1:
        b2 = b2[None, :]
    o = _overlap2d(b1, b2)
    return o / (_area2d(b1) + _area2d(b2) - o)


def iou3d(b1: np.ndarray, b2: np.ndarray) -> float:
    """Mean per-frame IoU of two aligned tubes [T, >=5] (col 0 = frame)."""
    o = _overlap2d(b1[:, 1:5], b2[:, 1:5])
    return float(np.mean(o / (_area2d(b1[:, 1:5]) + _area2d(b2[:, 1:5]) - o)))


def iou3dt(b1: np.ndarray, b2: np.ndarray) -> float:
    """Spatio-temporal tube IoU (video_map_utils.py:207-216)."""
    if len(b1) == 0 or len(b2) == 0:
        return 0.0
    tmin = max(b1[0, 0], b2[0, 0])
    tmax = min(b1[-1, 0], b2[-1, 0])
    if tmax <= tmin:
        return 0.0
    temporal_inter = tmax - tmin + 1
    temporal_union = max(b1[-1, 0], b2[-1, 0]) - min(b1[0, 0], b2[0, 0]) + 1
    t1 = b1[np.where(b1[:, 0] == tmin)[0][0] : np.where(b1[:, 0] == tmax)[0][0] + 1]
    t2 = b2[np.where(b2[:, 0] == tmin)[0][0] : np.where(b2[:, 0] == tmax)[0][0] + 1]
    return iou3d(t1, t2) * temporal_inter / temporal_union


def nms_3d(detections: Sequence[Tuple[np.ndarray, float]], overlap=0.5):
    """Greedy tube NMS by score (video_map_utils.py:218-231)."""
    if len(detections) == 0:
        return np.array([], np.int32)
    order = np.argsort([d[1] for d in detections])
    keep = []
    while order.size > 0:
        i = order[-1]
        keep.append(i)
        ious = np.array(
            [iou3dt(detections[j][0], detections[i][0]) for j in order[:-1]]
        )
        order = order[np.where(ious <= overlap)[0]]
    return np.array(keep, np.int32)


def voc_ap(pr: np.ndarray) -> float:
    """All-points VOC AP over a [N, 2] (precision, recall) curve."""
    rec, prec = pr[:, 1], pr[:, 0]
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


# ---------------------------------------------------------------------------
# tube linking (video_map.py:95-208)
# ---------------------------------------------------------------------------

def _edge_scores(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """Pairwise link score between consecutive-frame boxes [N,5]x[M,5].

    The link IoU is the PLAIN (no +1) convention — the reference's
    compute_score_one_class calls video_map_utils.bbox_iou (:62-95), not the
    +1-pixel area2d/overlap2d pair used by the tube-matching IoUs.
    """
    a = b1[:, :4]
    b = b2[:, :4]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    # bbox_iou computes the intersection as w1+w2-union_w (equivalent to the
    # standard min/max form when boxes overlap; clamped at 0 otherwise)
    cw = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0])
    ch = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1])
    inter = np.where((cw > 0) & (ch > 0), cw * ch, 0.0)
    union = area_a[:, None] + area_b[None, :] - inter
    iou = np.where(inter > 0, inter / union, 0.0)
    s_sum = b1[:, 4:5] + b2[None, :, 4]
    s_mul = b1[:, 4:5] * b2[None, :, 4]
    return (iou + s_sum + 0.5 * s_mul).astype(np.float32)


def link_boxes(bbox_list: List[np.ndarray], max_tubes: int = 3) -> List[np.ndarray]:
    """Iterative Viterbi linking: one box per frame per pass, boxes removed
    after use, stop when any frame empties or max_tubes reached.

    bbox_list: per-frame [N_f, 5] arrays (x1 y1 x2 y2 score).
    Returns tubes as [nframes, 6] arrays (frame(1-based), box, score).
    """
    nfr = len(bbox_list)
    bbox_list = [np.asarray(b, np.float32).reshape(-1, 5) for b in bbox_list]
    not_empty = [i for i in range(nfr) if bbox_list[i].size]
    if not not_empty:
        return []
    if len(not_empty) != nfr:
        for i in range(nfr):
            if not bbox_list[i].size:
                nn = not_empty[int(np.argmin(np.abs(np.array(not_empty) - i)))]
                bbox_list[i] = bbox_list[nn]

    detect = [b.copy() for b in bbox_list]
    edges = [
        _edge_scores(detect[i], detect[i + 1]) for i in range(nfr - 1)
    ]
    res = []
    while all(d.size for d in detect):
        scores = [np.zeros(d.shape[0], np.float32) for d in detect]
        index = [None] * nfr
        for i in range(nfr - 2, -1, -1):
            es = edges[i] + scores[i + 1]
            scores[i] = es.max(axis=1)
            index[i] = es.argmax(axis=1)
        idx = np.zeros(nfr, np.int32)
        idx[0] = int(np.argmax(scores[0]))
        for i in range(nfr - 1):
            idx[i + 1] = index[i][idx[i]]

        tube = np.empty((nfr, 6), np.float32)
        tube[:, 0] = 1 + np.arange(nfr)
        for i in range(nfr):
            j = idx[i]
            if i < nfr - 1:
                edges[i] = np.delete(edges[i], j, 0)
            if i > 0:
                edges[i - 1] = np.delete(edges[i - 1], j, 1)
            tube[i, 1:5] = detect[i][j, :4]
            tube[i, 5] = detect[i][j, 4]
            detect[i] = np.delete(detect[i], j, 0)
        res.append(tube)
        if len(res) == max_tubes:
            break
    return res


def _get_max_subset(x_org: np.ndarray, gt_len: int):
    """Kadane max-subarray with target-length extension
    (video_map.py:279-312)."""
    x = x_org - np.mean(x_org)
    best_so_far = best_now = 0.0
    best_start = best_stop = start_now = -1
    for i in range(x.shape[0]):
        value = best_now + x[i]
        if value > 0:
            if best_now == 0:
                start_now = i
            best_now = value
        else:
            best_now = 0.0
        if best_now > best_so_far:
            best_so_far = best_now
            best_stop = i
            best_start = start_now
    if gt_len > (best_stop - best_start):
        ext = (gt_len - (best_stop - best_start)) // 2
        best_start -= ext
        best_stop += ext
    elif gt_len < (best_stop - best_start):
        ext = ((best_stop - best_start) - gt_len) // 2
        best_start += ext
        best_stop -= ext
    best_start = max(best_start, 0)
    best_stop = min(best_stop, x.shape[0])
    return best_start, best_stop


def temporal_check(tubes, gt_len: int):
    """Score-based tube trimming (video_map.py:314-328): low-overlap frames
    get negated scores, then max-subarray around gt_len."""
    out = []
    for tube in tubes:
        nframes = tube.shape[0]
        edge = np.array(
            [iou2d(tube[i, 1:5], tube[i + 1, 1:5])[0, 0]
             for i in range(nframes - 1)]
        )
        score = tube[:, 5].copy()
        ind = np.where(edge < 0.3)[0] + 1
        score[ind] = -score[ind]
        tube = tube.copy()
        tube[:, 5] = score
        start, stop = _get_max_subset(score, gt_len)
        out.append(tube[int(start) : int(stop)])
    return out


def link_video_one_class(vid_det, nms3d=True, trim_len=None, trim_start=None):
    """video_map.py:177-208: link, 3D-NMS (0.3), then trim — slice
    [start : start+len] when a nonzero start exists, else the score-based
    temporal_check (reference branches on the truthiness of start)."""
    vdets = [vid_det[i][1] for i in range(len(vid_det))]
    tubes = link_boxes(vdets)
    if tubes and nms3d:
        scored = [(t[:, :5], float(np.mean(t[:, 5]))) for t in tubes]
        keep = nms_3d(scored, 0.3)
        if np.array(keep).size:
            kept = [tubes[k] for k in keep]
            if trim_len and trim_start:
                tubes = [t[trim_start : trim_start + trim_len] for t in kept]
            elif trim_len and not trim_start:
                tubes = temporal_check(kept, trim_len)
            else:
                tubes = kept
    return tubes


def video_ap_one_class(gt, pred_videos, iou_thresh=0.2, temporal=True) -> float:
    """video_map.py:211-277.  gt: list of [video_index, tube[T, 5]];
    pred_videos: list of [video_index, [[frame_idx, boxes[N,5]], ...]]."""
    gt = [list(g) for g in gt]
    pred = []
    for video_index, frames in pred_videos:
        valid = [k for k in frames if len(k[1]) != 0]
        trim_len = len(valid)
        trim_start = valid[0][0] if trim_len > 0 else None
        for tube in link_video_one_class(frames, True, trim_len, trim_start):
            pred.append((video_index, tube))

    order = np.argsort(-np.array([np.mean(t[:, 5]) for _, t in pred])) if pred else []
    pr = np.empty((len(pred) + 1, 2), np.float32)
    pr[0] = (1.0, 0.0)
    fn, fp, tp = len(gt), 0, 0
    for i, k in enumerate(order):
        video_index, tube = pred[k]
        positive = False
        this = [(j, g[1]) for j, g in enumerate(gt) if g[0] == video_index]
        if this:
            if temporal:
                ious = np.array([iou3dt(np.asarray(g), tube[:, :5]) for _, g in this])
            else:
                # align lengths by frame index (video_map.py:254-261)
                def _iou_aligned(g):
                    g = np.asarray(g)
                    b = tube[:, :5]
                    if b.shape[0] > g.shape[0]:
                        return iou3d(g, b[int(g[0, 0] - 1) : int(g[-1, 0])])
                    if b.shape[0] < g.shape[0]:
                        return iou3d(g[int(b[0, 0] - 1) : int(b[-1, 0])], b)
                    return iou3d(g, b)

                ious = np.array([_iou_aligned(g) for _, g in this])
            if ious.size:
                am = int(np.argmax(ious))
                if ious[am] >= iou_thresh:
                    positive = True
                    del gt[this[am][0]]
        if positive:
            tp += 1
            fn -= 1
        else:
            fp += 1
        pr[i + 1, 0] = tp / (tp + fp)
        pr[i + 1, 1] = tp / (tp + fn + 1e-5)
    return voc_ap(pr)


class VideoMAPEvaluator:
    """gt_videos: {vname: {tubes: [tube[T,5]], gt_classes: 1-based label}};
    all_boxes: {image_key: {1-based class: [x1,y1,x2,y2,score] rows}}."""

    def __init__(self, num_classes: int, iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.iou = iou_threshold
        self.gt_videos = {}
        self.all_boxes = {}

    def add_gt(self, gt_videos):
        self.gt_videos = gt_videos

    def add_pred(self, all_boxes):
        self.all_boxes = all_boxes

    # NOTE: class-level evaluation lives in
    # evaluators._TubeEvaluaterBase._video_eval (handles both the temporal
    # and non-temporal AP variants); this class only carries state.


# ---------------------------------------------------------------------------
# error analysis (compute_video_map.py:250-352 — videoAP_error)
# ---------------------------------------------------------------------------


def _iou3dt_voc(b1, b2, spatialonly=False, temporalonly=False) -> float:
    """VOC-variant spatio-temporal tube IoU (compute_video_map.py:48-64):
    temporal terms use open lengths (no +1) unlike :func:`iou3dt`."""
    tmin = max(b1[0, 0], b2[0, 0])
    tmax = min(b1[-1, 0], b2[-1, 0])
    if tmax < tmin:
        return 0.0
    temporal_inter = tmax - tmin
    temporal_union = max(b1[-1, 0], b2[-1, 0]) - min(b1[0, 0], b2[0, 0])
    t1 = b1[np.where(b1[:, 0] == tmin)[0][0] : np.where(b1[:, 0] == tmax)[0][0] + 1]
    t2 = b2[np.where(b2[:, 0] == tmin)[0][0] : np.where(b2[:, 0] == tmax)[0][0] + 1]
    if temporalonly:
        return temporal_inter / temporal_union if temporal_union > 0 else 0.0
    ratio = 1.0 if spatialonly else (
        temporal_inter / temporal_union if temporal_union > 0 else 0.0
    )
    return iou3d(t1, t2) * ratio


ERROR_COLUMNS = ("AP", "repeat", "extra", "loc", "cls", "time",
                 "cls+time", "cls+loc", "time+loc", "cls+time+loc", "missed")


def video_ap_error(gttubes, labels, test_videos, alldets, thr=0.5):
    """Per-class video-AP error decomposition (compute_video_map.py:250-352).

    Each false positive is attributed to exactly one bucket: repeat
    (duplicate hit on an already-matched GT), extra (no GT overlap at all),
    localization / classification / timing and their combinations, judged
    with sqrt(thr) thresholds on the spatial-only and temporal-only IoUs.

    Args (in-memory, not pickles):
      gttubes: {video: {label: [tube ndarray [T, 5]]}}
      labels: class-name list
      test_videos: videos to score
      alldets: {label_idx: [(video, score, tube ndarray [T, 6])]}
    Returns {label: {column: percentage}} with a "mean" row, columns
    ``ERROR_COLUMNS``.
    """
    import math

    th_s = th_t = math.sqrt(thr)
    dupgt = {v: gttubes.get(v, {}) for v in test_videos}
    res = {}
    for ilabel in range(len(labels)):
        detections = alldets.get(ilabel, [])
        pr = np.zeros((len(detections), 11), np.float32)
        gt_num = sum(
            len(dupgt[v][ilabel]) for v in dupgt if ilabel in dupgt[v]
        )
        tp = fp = 0
        counts = dict(ER=0, EN=0, EL=0, EC=0, ET=0, ECT=0, ECL=0, ETL=0,
                      ECTL=0)
        detected = {}
        order = np.argsort(-np.array([d[1] for d in detections])) if detections else []
        for i, j in enumerate(order):
            v, score, tube = detections[j]
            ispositive = end = False
            if ilabel in dupgt[v]:
                if v not in detected:
                    detected[v] = np.zeros(len(dupgt[v][ilabel]), bool)
                ious = [_iou3dt_voc(g, tube) for g in dupgt[v][ilabel]]
                amax = int(np.argmax(ious))
                if ious[amax] >= thr:
                    if not detected[v][amax]:
                        ispositive = True
                        detected[v][amax] = True
                    else:
                        counts["ER"] += 1
                    end = True
            if not end:
                ious = [
                    _iou3dt_voc(g, tube)
                    for ll in dupgt[v] if ll != ilabel
                    for g in dupgt[v][ll]
                ]
                if ious and max(ious) >= thr:
                    counts["EC"] += 1
                    end = True
                    ious = None
            if not end:
                all_gt = [(ll, g) for ll in dupgt[v] for g in dupgt[v][ll]]
                ious = [_iou3dt_voc(g, tube) for _, g in all_gt]
                amax = int(np.argmax(ious)) if ious else -1
                if amax >= 0 and ious[amax] > 0:
                    gl, g = all_gt[amax]
                    t_iou = _iou3dt_voc(g, tube, temporalonly=True)
                    s_iou = _iou3dt_voc(g, tube, spatialonly=True)
                    same = gl == ilabel
                    if t_iou >= th_t:
                        counts["EL" if same else "ECL"] += 1
                    elif s_iou >= th_s:
                        counts["ET" if same else "ECT"] += 1
                    else:
                        counts["ETL" if same else "ECTL"] += 1
                else:
                    counts["EN"] += 1
            if ispositive:
                tp += 1
            else:
                fp += 1
            denom = float(tp + fp)
            pr[i, 0] = tp / denom
            pr[i, 1] = tp / gt_num if gt_num else 0.0
            for c, key in enumerate(
                ("ER", "EN", "EL", "EC", "ET", "ECT", "ECL", "ETL", "ECTL")
            ):
                pr[i, 2 + c] = counts[key] / denom
        res[labels[ilabel]] = pr

    out = {}
    for label, pr in res.items():
        row = {"AP": 100.0 * voc_ap(pr[:, [0, 1]]) if len(pr) else 0.0}
        for c, col in enumerate(ERROR_COLUMNS[1:-1]):
            row[col] = 100.0 * voc_ap(pr[:, [2 + c, 1]]) if len(pr) else 0.0
        row["missed"] = 100.0 - 100.0 * pr[-1, 1] if len(pr) else 100.0
        out[label] = row
    out["mean"] = {
        col: float(np.mean([out[l][col] for l in res])) for col in ERROR_COLUMNS
    }
    return out
