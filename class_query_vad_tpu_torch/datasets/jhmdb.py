"""JHMDB51-21 frame dataset (whole-video samples).

Port of reference datasets/jhmdb_frame.py:

* ``JHMDB-GT.pkl`` with 3 official splits (:66-71);
* one sample = one whole video, replicate-padded (front/back) to
  clip_len=40 (:163-179, :208-213);
* one gt tube per video; boxes scaled to the short-side resize, clamped to
  [0, n]; padded frames replicate the edge boxes but get label 21
  (background) (:170-179);
* frames: indices range(nframes-1) 1-based files, replicate-padded.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from .transforms import Compose, make_transforms


class JHMDBDataset:
    def __init__(self, directory: str, video_path: str,
                 transforms: Optional[Compose], clip_len=40, resize_size=256,
                 mode="train", split=0, use_native_decode=True):
        with open(os.path.join(directory, "JHMDB-GT.pkl"), "rb") as f:
            self.dataset = pickle.load(f, encoding="iso-8859-1")
        self.video_path = video_path
        self._transforms = transforms
        self.clip_len = clip_len
        self.resize_size = resize_size
        self.mode = mode
        self.num_classes = 21
        self.index_cnt = 0
        self.use_native_decode = use_native_decode
        vids = (
            self.dataset["train_videos"][split]
            if mode == "train"
            else self.dataset["test_videos"][split]
        )
        self.index_to_sample = list(vids)

    def __len__(self):
        return len(self.index_to_sample)

    def _load_annotation(self, vid) -> Dict:
        oh, ow = self.dataset["resolution"][vid]
        if oh <= ow:
            nh = self.resize_size
            nw = self.resize_size * (ow / oh)
        else:
            nw = self.resize_size
            nh = self.resize_size * (oh / ow)

        boxes, classes, tube_len = [], [], []
        vis = 0
        for ilabel, tubes in self.dataset["gttubes"][vid].items():
            for t in tubes:
                box_ = np.asarray(t)[:, 0:5]
                tube = []
                for box in box_:
                    tube.append(
                        [box[0], int(box[1] / ow * nw), int(box[2] / oh * nh),
                         int(box[3] / ow * nw), int(box[4] / oh * nh)]
                    )
                    classes.append(int(np.clip(ilabel, 0, 21)))
                boxes.append(tube)
                tube_len.append(len(t))
                vis = 1

        boxes = np.asarray(boxes, np.float32).reshape(-1, 5)
        boxes[:, 1::3] = boxes[:, 1::3].clip(0, nw)
        boxes[:, 2::3] = boxes[:, 2::3].clip(0, nh)

        front_pad = (self.clip_len - len(boxes)) // 2
        end_pad = self.clip_len - len(boxes) - front_pad
        boxes = np.concatenate(
            [np.repeat(boxes[:1], front_pad, 0), boxes,
             np.repeat(boxes[-1:], end_pad, 0)]
        )
        raw_boxes = np.concatenate(
            [np.full((len(boxes), 1), self.index_cnt, np.float32), boxes], 1
        )
        classes = np.asarray(
            [21] * front_pad + classes + [21] * end_pad, np.int64
        )
        target = {
            "image_id": [str(vid).replace("/", "_")],
            "boxes": boxes,
            "raw_boxes": raw_boxes,
            "labels": classes,
            "orig_size": np.array([int(nh), int(nw)]),
            "size": np.array([int(nh), int(nw)]),
            "vis": np.array([vis]),
            "front_pad": front_pad,
            "end_pad": end_pad,
            "tube_len": np.asarray(tube_len),
        }
        self.index_cnt += 1
        return target

    def __getitem__(self, index, rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng()
        vid = self.index_to_sample[index]
        target = self._load_annotation(vid)
        end = self.dataset["nframes"][vid] - 1
        ids = list(range(end))
        if len(ids) < self.clip_len:
            front = [0] * target["front_pad"]
            back = [end] * (self.clip_len - len(ids) - target["front_pad"])
            ids = front + ids + back
        h, w = target["orig_size"]
        paths = [
            os.path.join(self.video_path, vid, f"{i + 1:0>5}.png") for i in ids
        ]
        imgs = None
        if self.use_native_decode:
            from .native_decode import decode_batch

            arr = decode_batch(paths, int(w), int(h))
            if arr is not None:
                imgs = [Image.fromarray(a) for a in arr]
        if imgs is None:
            imgs = [Image.open(p_).resize((w, h)) for p_ in paths]
        if self._transforms:
            imgs, target = self._transforms(imgs, target, rng)
        return np.stack(imgs), target


def build_dataset(cfg, mode: str) -> JHMDBDataset:
    return JHMDBDataset(
        directory=cfg.CONFIG.DATA.ANNO_PATH,
        video_path=cfg.CONFIG.DATA.DATA_PATH,
        transforms=make_transforms(mode, cfg),
        clip_len=cfg.CONFIG.DATA.TEMP_LEN,
        resize_size=cfg.CONFIG.DATA.IMG_SIZE,
        mode=mode,
        split=cfg.CONFIG.DATA.SPLIT,
        use_native_decode=cfg.CONFIG.DATA.get("NATIVE_DECODE", True),
    )
