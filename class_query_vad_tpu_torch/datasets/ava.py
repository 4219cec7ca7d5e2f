"""AVA v2.2 frame dataset.

Port of reference datasets/ava_frame.py with the exact sampling math:

* annotations: ``ava_{mode}_v2.2.csv`` rows (vid, sec, x1, y1, x2, y2,
  action) grouped to {vid/sec: {box: [labels]}} (:43-67);
* a clip of ``clip_len`` frames at ``frame_sample_rate`` is CENTERED on the
  annotated keyframe: start = (sec-900)*30 - clip_len//2*rate, indices
  clipped to the video's frame list (:69-103, :188-190);
* frames are decoded and resized so the SHORT side is ``resize_size``
  (aspect preserved, PIL bicubic — :111-120, :194);
* boxes are scaled to the resized resolution and clamped (:141-158);
  labels are multi-hot over ``class_num`` (:150-152);
* empty-target samples resample a random index (train; :83-98).
"""

from __future__ import annotations

import csv
import os
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .transforms import Compose, make_transforms


def read_ava_csv(path: str) -> Dict[str, Dict[str, List[int]]]:
    data: Dict[str, Dict[str, List[int]]] = {}
    with open(path) as f:
        for row in csv.reader(f):
            key = "/".join([row[0], row[1]])
            subkey = "/".join(row[2:6])
            data.setdefault(key, {}).setdefault(subkey, []).append(int(row[6]))
    return data


class AVADataset:
    def __init__(
        self,
        root_path: str,
        clip_len: int,
        frame_sample_rate: int,
        transforms: Optional[Compose],
        resize_size: int = 256,
        mode: str = "train",
        class_num: int = 80,
        use_native_decode: bool = True,
    ):
        self.frame_path = os.path.join(root_path, "frames")
        self.annot_path = os.path.join(
            root_path, "annotations", f"ava_{mode}_v2.2.csv"
        )
        self.clip_len = clip_len
        self.frame_sample_rate = frame_sample_rate
        self.resize_size = resize_size
        self.class_num = class_num
        self.mode = mode
        self._transforms = transforms
        self.index_cnt = 0
        self.use_native_decode = use_native_decode
        self.data_dict = read_ava_csv(self.annot_path)
        self.data_list = list(self.data_dict.keys())

    def __len__(self):
        return len(self.data_list)

    def _resized_dims(self, ow: int, oh: int) -> Tuple[float, float]:
        if oh <= ow:
            nh = self.resize_size
            nw = self.resize_size * (ow / oh)
        else:
            nw = self.resize_size
            nh = self.resize_size * (oh / ow)
        return nw, nh

    def _load_annotation(self, sample_id: str, first_frame: str) -> Dict:
        with Image.open(first_frame) as img:
            ow, oh = img.size
        nw, nh = self._resized_dims(ow, oh)
        p_t = self.clip_len // 2

        boxes, classes = [], []
        for raw in self.data_dict[sample_id]:
            b = [float(x) for x in raw.split("/")]
            b = [b[0] * nw, b[1] * nh, b[2] * nw, b[3] * nh]
            label = np.zeros(self.class_num, np.float32)
            for x in self.data_dict[sample_id][raw]:
                label[x - 1] = 1
            boxes.append([p_t] + b)
            classes.append(label)

        boxes = np.asarray(boxes, np.float32).reshape(-1, 5)
        boxes[:, 1::3] = boxes[:, 1::3].clip(0, int(nw))
        boxes[:, 2::3] = boxes[:, 2::3].clip(0, nh)
        if boxes.shape[0]:
            raw_boxes = np.concatenate(
                [np.full((len(boxes), 1), self.index_cnt, np.float32), boxes],
                axis=1,
            )
        else:
            raw_boxes = boxes

        target = {
            "image_id": [sample_id.replace("/", "_").replace(",", "_"), p_t],
            "boxes": boxes,
            "raw_boxes": raw_boxes,
            "labels": np.asarray(classes, np.float32).reshape(-1, self.class_num),
            "orig_size": np.array([int(nh), int(nw)]),
            "size": np.array([int(nh), int(nw)]),
        }
        self.index_cnt += 1
        return target

    def _load_clip(self, index: int):
        sample_id = self.data_list[index]
        vid, frame_second = sample_id.split("/")
        timef = int(frame_second) - 900
        start = max(timef * 30 - self.clip_len // 2 * self.frame_sample_rate, 0)

        frames = sorted(glob(os.path.join(self.frame_path, vid) + "/*.jpg"))
        if not frames:
            return [], {}
        target = self._load_annotation(sample_id, frames[0])
        idx = np.clip(
            range(start, start + self.clip_len * self.frame_sample_rate,
                  self.frame_sample_rate),
            0, len(frames) - 1,
        )
        h, w = target["orig_size"]
        if self.use_native_decode:
            from .native_decode import decode_batch

            arr = decode_batch([frames[i] for i in idx], int(w), int(h))
            if arr is not None:
                return [Image.fromarray(a) for a in arr], target
        imgs = [Image.open(frames[i]).resize((w, h)) for i in idx]
        return imgs, target

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng()
        imgs, target = self._load_clip(index)
        if target and target["boxes"].shape[0] and self._transforms:
            imgs, target = self._transforms(imgs, target, rng)
        while not target or target["boxes"].shape[0] == 0:
            index = int(rng.integers(len(self.data_list)))
            self.index_cnt -= 1
            imgs, target = self._load_clip(index)
            if target and target["boxes"].shape[0] and self._transforms:
                imgs, target = self._transforms(imgs, target, rng)
        clip = np.stack(imgs)                         # [T, H, W, 3] float32
        return clip, target


def build_dataset(cfg, mode: str) -> AVADataset:
    return AVADataset(
        cfg.CONFIG.DATA.DATA_PATH,
        clip_len=cfg.CONFIG.DATA.TEMP_LEN,
        frame_sample_rate=cfg.CONFIG.DATA.FRAME_RATE,
        transforms=make_transforms(mode, cfg),
        resize_size=cfg.CONFIG.DATA.IMG_SIZE,
        mode=mode,
        class_num=cfg.CONFIG.DATA.NUM_CLASSES,
        use_native_decode=cfg.CONFIG.DATA.get("NATIVE_DECODE", True),
    )
