"""Dataset-level ST-detection evaluators (AVA / UCF101-24 / JHMDB51-21).

Bit-compatible with the reference's per-rank txt protocol so either stack's
files can be scored by either evaluator:

* detection line: ``"<image_key> [x1, y1, x2, y2, s_1..s_NC, p_b]"``
  (utils/video_action_recognition.py:231-236);
* GT line: ``"<image_key> [a, b, x1, y1, x2, y2, labels...]"`` — box at
  data[2:6], label vector at data[6:] (evaluate_ava.py:68-91).

Reference semantics reproduced:
* AVA (evaluate_ava.py:22-176): excluded-timestamp filtering, class
  whitelist from the pbtxt labelmap when class_num == 80, every class score
  becomes a detection (no threshold), per-image detections sorted by score.
* UCF (evaluate_ucf.py:29-294): frame mAP over all per-class scores; for
  video mAP only the argmax class of each query survives, gated by
  actorness >= 0.7; GT tubes are reconstructed from the interleaved GT
  lines; per-video label = first nonzero label index + 1 (clamped to 25).
* JHMDB (evaluate_jhmdb.py:27-231): every query contributes to every class
  for video mAP (no gating); one GT tube per video; video AP without
  temporal weighting (evaluate_videoAP(False)).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .pascal_map import PascalMAPEvaluator
from .video_map import VideoMAPEvaluator, video_ap_one_class


def read_labelmap(labelmap_file: str):
    """pbtxt labelmap parser (reference utils/utils.py:11-26)."""
    labelmap, class_ids = [], set()
    name = ""
    with open(labelmap_file) as f:
        for line in f:
            if line.startswith("  name:"):
                name = line.split('"')[1]
            elif line.startswith("  id:") or line.startswith("  label_id:"):
                class_id = int(line.strip().split(" ")[-1])
                labelmap.append({"id": class_id, "name": name})
                class_ids.add(class_id)
    return labelmap, class_ids


def _parse_line(line: str):
    image_key = line.split(" [")[0]
    data = [float(x) for x in line.split(" [")[1].split("]")[0].split(",")]
    return image_key, data


def _dedup_gt_lines(paths: Sequence[str]):
    """Yield GT lines, keeping only each image's first contiguous block
    (the same GT may be duplicated across ranks —
    evaluate_ucf.py:80-89)."""
    for path in paths:
        lines = open(path).readlines()
        counter: Dict[str, int] = {}
        for i, line in enumerate(lines):
            key = line.split(" [")[0]
            if counter.setdefault(key, 0) == 1:
                continue
            if i < len(lines) - 1:
                if key != lines[i + 1].split(" [")[0]:
                    counter[key] = 1
            else:
                counter[key] = 1
            yield line


class STDetectionEvaluaterAVA:
    """Frame mAP for AVA (reference evaluate_ava.py:22-176)."""

    def __init__(self, label_path: str, tiou_thresholds=(0.5,), class_num=80):
        self.class_num = class_num
        self.tiou_thresholds = list(tiou_thresholds)
        if label_path:
            categories, class_whitelist = read_labelmap(label_path)
        else:
            categories = [{"id": i + 1, "name": str(i + 1)} for i in range(class_num)]
            class_whitelist = set(range(1, class_num + 1))
        self.class_whitelist = class_whitelist
        self.exclude_keys: List[str] = []
        if class_num == 80 and label_path:
            excl = os.path.join(
                os.path.dirname(label_path), "ava_val_excluded_timestamps_v2.2.csv"
            )
            if os.path.exists(excl):
                with open(excl) as f:
                    self.exclude_keys = [
                        l.strip().replace(",", "_") for l in f if l.strip()
                    ]
        self.max_class_id = max(c["id"] for c in categories)
        self.evaluators = [
            PascalMAPEvaluator(self.max_class_id, iou) for iou in self.tiou_thresholds
        ]
        self.categories = categories

    def _keep(self, class_idx0: int) -> bool:
        return self.class_num != 80 or (class_idx0 + 1) in self.class_whitelist

    def load_GT_from_path(self, file_lst: Sequence[str]):
        per_image = defaultdict(lambda: ([], []))
        for path in file_lst:
            for line in open(path):
                key, data = _parse_line(line)
                if key in self.exclude_keys:
                    continue
                scores = np.array(data[6:])
                box = np.array(data[2:6])
                for x in range(len(scores)):
                    if scores[x] <= 1e-2:
                        continue
                    if self._keep(x):
                        per_image[key][0].append(box)
                        per_image[key][1].append(x)  # 0-based class
        for key, (boxes, classes) in per_image.items():
            if not boxes:
                continue
            for ev in self.evaluators:
                ev.add_ground_truth(key, np.stack(boxes), np.array(classes))

    def load_detection_from_path(self, file_lst: Sequence[str]):
        per_image = defaultdict(lambda: ([], [], []))
        for path in file_lst:
            for line in open(path):
                key, data = _parse_line(line)
                if key in self.exclude_keys:
                    continue
                scores = np.array(data[4 : self.class_num + 4])
                box = np.array(data[0:4])
                for x in range(len(scores)):
                    if self._keep(x):
                        per_image[key][0].append(box)
                        per_image[key][1].append(x)
                        per_image[key][2].append(scores[x])
        for key, (boxes, classes, scores) in per_image.items():
            if not boxes:
                continue
            for ev in self.evaluators:
                ev.add_detections(
                    key, np.stack(boxes), np.array(classes), np.array(scores)
                )

    def evaluate(self):
        mAP, result = [], {}
        for iou, ev in zip(self.tiou_thresholds, self.evaluators):
            ap, mean_ap = ev.evaluate()
            result[f"PascalBoxes_Precision/mAP@{iou}IOU"] = mean_ap
            for c in self.categories:
                result[
                    f"PascalBoxes_PerformanceByCategory/AP@{iou}IOU/{c['name']}"
                ] = ap[c["id"] - 1]
            mAP.append(mean_ap)
        return mAP, result


class _TubeEvaluaterBase:
    """Shared frame-mAP + video-mAP plumbing for UCF / JHMDB."""

    def __init__(self, tiou_thresholds, class_num, query_num):
        self.class_num = class_num
        self.query_num = query_num
        self.tiou_thresholds = list(tiou_thresholds)
        self.frame_evaluators = [
            PascalMAPEvaluator(class_num, iou) for iou in self.tiou_thresholds
        ]
        self.video_evaluators = [
            VideoMAPEvaluator(class_num, iou) for iou in self.tiou_thresholds
        ]

    def _add_frame_gt(self, per_image):
        for key, (boxes, classes) in per_image.items():
            if not boxes:
                continue
            for ev in self.frame_evaluators:
                ev.add_ground_truth(key, np.stack(boxes), np.array(classes))

    def _add_frame_det(self, per_image):
        for key, (boxes, classes, scores) in per_image.items():
            if not boxes:
                continue
            for ev in self.frame_evaluators:
                ev.add_detections(
                    key, np.stack(boxes), np.array(classes), np.array(scores)
                )

    def evaluate(self, temporal: bool):
        mAP, v_mAP, result, v_result = [], [], {}, {}
        for iou, fev, vev in zip(
            self.tiou_thresholds, self.frame_evaluators, self.video_evaluators
        ):
            ap, mean_ap = fev.evaluate()
            result[f"PascalBoxes_Precision/mAP@{iou}IOU"] = mean_ap
            mAP.append(mean_ap)
            vev_aps, video_mean = self._video_eval(vev, temporal)
            v_result[f"video-mAP@{iou}IOU"] = video_mean
            v_mAP.append(video_mean)
        return mAP, result, v_mAP, v_result

    def _video_eval(self, vev: VideoMAPEvaluator, temporal: bool):
        if not vev.all_boxes:
            return np.zeros(self.class_num), 0.0
        keys = sorted(vev.gt_videos.keys())
        gt_fmt = []
        for i, k in enumerate(keys):
            for tube in vev.gt_videos[k]["tubes"]:
                gt_fmt.append([vev.gt_videos[k]["gt_classes"], i + 1, tube])
        img_keys = sorted(vev.all_boxes.keys())
        video_of = lambda k: "_".join(k.split("_")[:-1])
        aps = []
        for cls_ind in range(1, self.class_num + 1):
            pred_videos = []
            v_cnt, v_dets = 1, []
            prev = video_of(img_keys[0])
            for k in img_keys:
                cur = video_of(k)
                frame_index = int(k.split("_")[-1])
                dets = vev.all_boxes[k].get(cls_ind, np.zeros((0, 5)))
                if cur != prev:
                    prev = cur
                    pred_videos.append([v_cnt, v_dets])
                    v_cnt += 1
                    v_dets = []
                v_dets.append([frame_index, np.asarray(dets, np.float32)])
            pred_videos.append([v_cnt, v_dets])
            gt = [[g[1], np.asarray(g[2], np.float32)] for g in gt_fmt if g[0] == cls_ind]
            aps.append(
                video_ap_one_class(gt, pred_videos, vev.iou, temporal=temporal)
            )
        return np.array(aps), float(np.mean(aps))


class STDetectionEvaluaterUCF(_TubeEvaluaterBase):
    def __init__(self, tiou_thresholds=(0.5,), class_num=24, query_num=15):
        super().__init__(tiou_thresholds, class_num, query_num)

    def load_GT_from_path(self, file_lst):
        per_image = defaultdict(lambda: ([], []))
        all_lines = list(_dedup_gt_lines(file_lst))
        for line in all_lines:
            key, data = _parse_line(line)
            if all(c == 0 for c in data[2:6]):
                continue
            scores = np.array(data[6:])
            box = np.array(data[2:6])
            for x in range(len(scores)):
                if scores[x] <= 1e-2:
                    continue
                per_image[key][0].append(box)
                per_image[key][1].append(x)
        self._add_frame_gt(per_image)

        # GT tube reconstruction (evaluate_ucf.py:110-141): lines per video
        # interleave tubes (ntubes rows per frame); rows with the trailing
        # pad flag 1 are dropped; a tube with no un-padded rows is dropped.
        gt_videos = {}
        all_lines.sort(key=lambda x: x.split(" [")[0])
        mem = []
        vname_of = lambda l: "_".join(l.split(" [")[0].split("_")[:-1])
        for i, line in enumerate(all_lines):
            key, data = _parse_line(line)
            vname = vname_of(line)
            scores = np.array(data[6:])
            if vname not in gt_videos:
                gt_videos[vname] = {"tubes": [], "gt_classes": 25}
            if gt_videos[vname]["gt_classes"] == 25:
                nz = scores.nonzero()[0]
                gt_videos[vname]["gt_classes"] = min(int(nz[0]) + 1, 25)
            mem.append(data)
            is_last = i == len(all_lines) - 1
            if is_last or vname_of(all_lines[i + 1]) != vname:
                nframes = len(set(d[1] for d in mem))
                ntubes = len(mem) // nframes
                tubes = []
                for n in range(ntubes):
                    rows = np.array(mem[n::ntubes])
                    if (1 - rows[:, -1]).any():
                        tubes.append(rows[rows[:, -1] != 1][:, 1:6])
                gt_videos[vname]["tubes"] = tubes
                mem = []
        for vev in self.video_evaluators:
            vev.add_gt(gt_videos)

    def load_detection_from_path(self, file_lst):
        per_image = defaultdict(lambda: ([], [], []))
        all_boxes: Dict[str, Dict[int, list]] = {}
        key_count: Dict[str, int] = {}
        for path in file_lst:
            for line in open(path):
                key, data = _parse_line(line)
                key_count[key] = key_count.get(key, 0) + 1
                if key_count[key] > self.query_num:
                    continue
                scores = np.array(data[4:-1])
                x = int(np.argmax(scores))
                box = data[0:4]
                ab = all_boxes.setdefault(key, {})
                for s in range(self.class_num):
                    ab.setdefault(s + 1, [])
                    if data[-1] < 0.7:
                        continue
                    if s == x:
                        ab[s + 1].append(box + [scores[s]])
                for s in range(len(scores)):
                    per_image[key][0].append(np.array(box))
                    per_image[key][1].append(s)
                    per_image[key][2].append(scores[s])
        for k in all_boxes:
            for s in range(self.class_num):
                all_boxes[k][s + 1] = np.asarray(all_boxes[k][s + 1], float).reshape(-1, 5)
        for vev in self.video_evaluators:
            vev.add_pred(all_boxes)
        self._add_frame_det(per_image)

    def evaluate(self):
        return super().evaluate(temporal=True)


class STDetectionEvaluaterJHMDB(_TubeEvaluaterBase):
    def __init__(self, tiou_thresholds=(0.5,), class_num=21, query_num=15):
        super().__init__(tiou_thresholds, class_num, query_num)

    def load_GT_from_path(self, file_lst):
        per_image = defaultdict(lambda: ([], []))
        gt_videos = {}
        for line in _dedup_gt_lines(file_lst):
            key, data = _parse_line(line)
            vname = "_".join(key.split("_")[:-1])
            scores = np.array(data[6:])
            if vname not in gt_videos:
                gt_videos[vname] = {"tubes": [], "gt_classes": 0}
            gt_videos[vname]["tubes"].append(data[1:6])
            if gt_videos[vname]["gt_classes"] == 0:
                gt_videos[vname]["gt_classes"] = int(scores.nonzero()[0][0]) + 1
            box = np.array(data[2:6])
            for x in range(len(scores)):
                if scores[x] <= 1e-2:
                    continue
                per_image[key][0].append(box)
                per_image[key][1].append(x)
        for k in gt_videos:
            gt_videos[k]["tubes"] = [np.asarray(gt_videos[k]["tubes"], np.float32)]
        self._add_frame_gt(per_image)
        for vev in self.video_evaluators:
            vev.add_gt(gt_videos)

    def load_detection_from_path(self, file_lst):
        per_image = defaultdict(lambda: ([], [], []))
        all_boxes: Dict[str, Dict[int, list]] = {}
        key_count: Dict[str, int] = {}
        for path in file_lst:
            for line in open(path):
                key, data = _parse_line(line)
                key_count[key] = key_count.get(key, 0) + 1
                if key_count[key] > self.query_num:
                    continue
                scores = np.array(data[4 : 4 + self.class_num])
                box = data[0:4]
                ab = all_boxes.setdefault(key, {})
                for s in range(self.class_num):
                    ab.setdefault(s + 1, []).append(box + [scores[s]])
                for s in range(len(scores)):
                    per_image[key][0].append(np.array(box))
                    per_image[key][1].append(s)
                    per_image[key][2].append(scores[s])
        for k in all_boxes:
            for s in range(self.class_num):
                all_boxes[k][s + 1] = np.asarray(all_boxes[k][s + 1], float).reshape(-1, 5)
        for vev in self.video_evaluators:
            vev.add_pred(all_boxes)
        self._add_frame_det(per_image)

    def evaluate(self):
        return super().evaluate(temporal=False)


class STDetectionEvaluaterSinglePerson(STDetectionEvaluaterAVA):
    """Size-bucketed single-class (actorness) AVA evaluator — the
    reference's diagnostic variant (evaluate_ava.py:178-331): scores only
    the person class, keeping boxes whose pixel area falls inside
    [threshold_size_min, threshold_size_max).  Useful for mAP-by-box-size
    breakdowns.  Consumes the same per-rank txt protocol; the detection
    score is the trailing actorness probability column."""

    def __init__(self, label_path: str = "", tiou_thresholds=(0.5,),
                 class_num: int = 80,
                 threshold_size_min: float = 0.0,
                 threshold_size_max: float = 555.0 * 555.0):
        super().__init__("", tiou_thresholds, class_num=1)
        self.det_class_num = class_num
        self.threshold_size_min = threshold_size_min
        self.threshold_size_max = threshold_size_max

    def _in_bucket(self, box) -> bool:
        area = max(0.0, box[2] - box[0]) * max(0.0, box[3] - box[1])
        return self.threshold_size_min <= area < self.threshold_size_max

    def load_GT_from_path(self, file_lst: Sequence[str]):
        per_image = defaultdict(lambda: ([], []))
        for path in file_lst:
            for line in open(path):
                key, data = _parse_line(line)
                box = np.array(data[2:6])
                if self._in_bucket(box):
                    per_image[key][0].append(box)
                    per_image[key][1].append(0)
        for key, (boxes, classes) in per_image.items():
            if boxes:
                for ev in self.evaluators:
                    ev.add_ground_truth(key, np.stack(boxes), np.array(classes))

    def load_detection_from_path(self, file_lst: Sequence[str]):
        per_image = defaultdict(lambda: ([], [], []))
        for path in file_lst:
            for line in open(path):
                key, data = _parse_line(line)
                box = np.array(data[0:4])
                if self._in_bucket(box):
                    per_image[key][0].append(box)
                    per_image[key][1].append(0)
                    # actorness prob is the trailing column
                    per_image[key][2].append(data[4 + self.det_class_num])
        for key, (boxes, classes, scores) in per_image.items():
            if boxes:
                for ev in self.evaluators:
                    ev.add_detections(
                        key, np.stack(boxes), np.array(classes),
                        np.array(scores),
                    )


def get_prior_length(dataset: dict) -> dict:
    """Mean train-tube length per class from a UCF/JHMDB-GT pickle dict
    (reference evaluate_ucf.py:249-276; computed but unused there — kept
    for diagnostics).  Returns {1-based class id: mean frames}."""
    res = {}
    for v in dataset["train_videos"][0]:
        ilabel, tubes = list(dataset["gttubes"][v].items())[0]
        res.setdefault(ilabel + 1, []).extend(t.shape[0] for t in tubes)
    return {cls: float(sum(ls)) / max(len(ls), 1)
            for cls, ls in sorted(res.items())}
