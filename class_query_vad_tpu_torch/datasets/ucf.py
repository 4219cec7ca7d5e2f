"""UCF101-24 frame dataset (tube targets).

Port of reference datasets/ucf_frame.py:

* ``UCF101v2-GT.pkl``: {labels, train_videos, test_videos, nframes,
  resolution, gttubes: {vid: {label: [tube[T, 5+]]}}} (:57-61);
* every video is chunked into clip_len-sized clips with symmetric
  front/end padding; sample = (vid, center_frame, front_pad, end_pad,
  nframes) (:88-101);
* per-clip tube targets with the reference's 5 overlap cases: frames
  outside the gt carry box (-1,-1,-1,-1) and label = num_classes
  (background) (:149-260);
* boxes are scaled to the short-side resize and clamped to [-1, n] —
  NOT 0 (so the -1 invalid sentinels survive) (:273-275);
* frames replicate-pad at video boundaries (:301-330).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .transforms import Compose, make_transforms

UCF_CLASSES = [
    "Basketball", "BasketballDunk", "Biking", "CliffDiving", "CricketBowling",
    "Diving", "Fencing", "FloorGymnastics", "GolfSwing", "HorseRiding",
    "IceDancing", "LongJump", "PoleVault", "RopeClimbing", "SalsaSpin",
    "SkateBoarding", "Skiing", "Skijet", "SoccerJuggling", "Surfing",
    "TennisSwing", "TrampolineJumping", "VolleyballSpiking", "WalkingWithDog",
]


class UCFDataset:
    def __init__(self, directory: str, video_path: str,
                 transforms: Optional[Compose], clip_len=32, resize_size=256,
                 mode="train", use_native_decode=True):
        with open(os.path.join(directory, "UCF101v2-GT.pkl"), "rb") as f:
            self.dataset = pickle.load(f, encoding="iso-8859-1")
        self.video_path = video_path
        self._transforms = transforms
        self.clip_len = clip_len
        self.resize_size = resize_size
        self.mode = mode
        self.num_classes = len(UCF_CLASSES)
        self.index_cnt = 0
        self.use_native_decode = use_native_decode

        split = 0
        vids = (
            self.dataset["train_videos"][split]
            if mode == "train"
            else self.dataset["test_videos"][split]
        )
        self.index_to_sample: List[Tuple] = []
        for vid in vids:
            nframes = self.dataset["nframes"][vid]
            num_clips = nframes // clip_len + int(nframes % clip_len != 0)
            pad = clip_len - nframes % clip_len
            front_pad = pad // 2
            end_pad = pad - front_pad
            self.index_to_sample.extend(
                (vid, i * clip_len + clip_len // 2 - front_pad + 1, front_pad,
                 end_pad, nframes)
                for i in range(num_clips)
            )

    def __len__(self):
        return len(self.index_to_sample)

    def _resized_dims(self, vid):
        oh, ow = self.dataset["resolution"][vid]
        if oh <= ow:
            nh = self.resize_size
            nw = self.resize_size * (ow / oh)
        else:
            nw = self.resize_size
            nh = self.resize_size * (oh / ow)
        return ow, oh, nw, nh

    def _load_annotation(self, sample) -> Dict:
        vid, c_frame, front_pad, end_pad, nframes = sample
        ow, oh, nw, nh = self._resized_dims(vid)
        cs = c_frame - self.clip_len // 2
        ce = c_frame + self.clip_len // 2 - 1
        pad_front = cs <= 0
        pad_end = ce > nframes

        def scale_rows(rows):
            return [
                [r[0], int(r[1] / ow * nw), int(r[2] / oh * nh),
                 int(r[3] / ow * nw), int(r[4] / oh * nh)]
                for r in rows
            ]

        boxes, classes, tube_len = [], [], []
        vis = 0
        for ilabel, tubes in self.dataset["gttubes"][vid].items():
            for t in tubes:
                box_ = np.asarray(t)[:, 0:5]
                gs, ge = int(box_[0][0]), int(box_[-1][0])
                lab = int(np.clip(ilabel, 0, 24))
                bg = self.num_classes
                tube, cls = [], []
                if ce < gs or cs > ge:                       # no overlap
                    cls = [bg] * self.clip_len
                    tube = [[n, -1, -1, -1, -1] for n in range(cs, ce + 1)]
                    tube_len.append(self.clip_len)
                    vis = 0
                elif ce >= gs and cs <= gs and ce < ge:      # front overlap
                    cls = [bg] * (gs - cs)
                    tube = [[n, -1, -1, -1, -1] for n in range(cs, gs)]
                    seg = box_[: -ge + ce]
                    tube += scale_rows(seg)
                    cls += [lab] * len(seg)
                    tube_len.append(len(seg))
                    vis = 1
                elif ce >= ge and cs >= gs:                  # end overlap
                    seg = box_[cs - gs :]
                    tube = scale_rows(seg)
                    cls = [lab] * len(seg)
                    tube += [[n, -1, -1, -1, -1] for n in range(ge + 1, ce + 1)]
                    cls += [bg] * (ce - ge)
                    tube_len.append(len(seg))
                    vis = 1
                elif cs > gs and ce < ge:                    # inside
                    seg = box_[cs - gs : ce - ge]
                    tube = scale_rows(seg)
                    cls = [lab] * len(seg)
                    tube_len.append(self.clip_len)
                    vis = 1
                else:                                        # covers whole gt
                    cls = [bg] * (gs - cs)
                    tube = [[n, -1, -1, -1, -1] for n in range(cs, gs)]
                    tube += scale_rows(box_)
                    cls += [lab] * len(box_)
                    cls += [bg] * (ce - ge)
                    tube += [[n, -1, -1, -1, -1] for n in range(ge, ce)]
                    tube_len.append(self.clip_len)
                    vis = 1
                boxes.append(tube)
                classes.append(cls)

        boxes = np.asarray(boxes, np.float32).reshape(-1, 5)
        boxes[:, 1::3] = boxes[:, 1::3].clip(-1, nw)
        boxes[:, 2::3] = boxes[:, 2::3].clip(-1, nh)
        if boxes.shape[0]:
            raw_boxes = np.concatenate(
                [np.full((len(boxes), 1), self.index_cnt, np.float32), boxes], 1
            )
        else:
            raw_boxes = boxes
        target = {
            "image_id": [str(vid).replace("/", "_")],
            "boxes": boxes,
            "raw_boxes": raw_boxes,
            "labels": np.asarray(classes, np.int64),
            "orig_size": np.array([int(nh), int(nw)]),
            "size": np.array([int(nh), int(nw)]),
            "vis": np.array([vis]),
            "front_pad": front_pad if pad_front else 0,
            "end_pad": end_pad if pad_end else 0,
            "tube_len": np.asarray(tube_len),
        }
        self.index_cnt += 1
        return target

    def _frame_ids(self, sample):
        vid, c_frame, front_pad, end_pad, nframes = sample
        cs = c_frame - self.clip_len // 2
        ce = c_frame + self.clip_len // 2 - 1
        if cs <= 0:
            ids = [1] * front_pad + list(range(1, ce + 1))
        elif ce > nframes:
            ids = list(range(cs, nframes + 1)) + [nframes] * end_pad
        else:
            ids = list(range(cs, ce + 1))
        assert len(ids) == self.clip_len
        return ids

    def __getitem__(self, index, rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng()
        sample = self.index_to_sample[index]
        target = self._load_annotation(sample)
        h, w = target["orig_size"]
        vid0 = sample[0]
        paths = [
            os.path.join(self.video_path, vid0, f"{i:0>5}.jpg")
            for i in self._frame_ids(sample)
        ]
        if self.use_native_decode:
            from .native_decode import decode_batch

            arr = decode_batch(paths, int(w), int(h))
            if arr is not None:
                imgs = [Image.fromarray(a) for a in arr]
                if self._transforms:
                    imgs, target = self._transforms(imgs, target, rng)
                return np.stack(imgs), target
        vid = sample[0]
        imgs = [
            Image.open(
                os.path.join(self.video_path, vid, f"{i:0>5}.jpg")
            ).resize((w, h))
            for i in self._frame_ids(sample)
        ]
        if self._transforms:
            imgs, target = self._transforms(imgs, target, rng)
        return np.stack(imgs), target


def build_dataset(cfg, mode: str) -> UCFDataset:
    return UCFDataset(
        directory=cfg.CONFIG.DATA.ANNO_PATH,
        video_path=cfg.CONFIG.DATA.DATA_PATH,
        transforms=make_transforms(mode, cfg),
        clip_len=cfg.CONFIG.DATA.TEMP_LEN,
        resize_size=cfg.CONFIG.DATA.IMG_SIZE,
        mode=mode,
        use_native_decode=cfg.CONFIG.DATA.get("NATIVE_DECODE", True),
    )
