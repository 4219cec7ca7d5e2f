"""Clip-consistent transforms (geometric + photometric) on PIL images.

Numpy/PIL port of reference datasets/video_transforms.py with the
exact reference math — one random draw per CLIP (all frames share the
transform parameters):

* ``crop``: PIL crop; boxes shifted/clamped to the crop (reference :18-65,
  operating on the 5-col [t, x1, y1, x2, y2] layout);
* ``hflip`` (:68-83);
* ``RandomSizeCrop_Custom`` (:222-249): aspect-preserving max-square crop
  at a random position;
* ``Resize_Custom`` (:251-266): fake center-crop to the shorter-side=size
  box (the actual resize already happened at decode);
* ``ColorJitter`` (:376-407): HSV jitter in cv2's uint8 HSV space (H mod
  180, S/V clipped), integer shifts;
* ``PCAJitter`` (:162-200): AlexNet-style lighting noise with the
  reference's channel-reversal quirk (rgb[2 - idx] indexes the eigen
  component reversed across channels);
* ``ToTensor`` + ``Normalize``: float/255, ImageNet mean/std, boxes
  xyxy -> normalized cxcywh (:332-362).

RNG: every random transform takes a ``np.random.Generator`` so clips are
reproducible from a single per-clip seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def crop(images: List[Image.Image], target: Dict, region):
    """region = (top, left, h, w)."""
    i, j, h, w = region
    out = [img.crop((j, i, j + w, i + h)) for img in images]
    target = dict(target)
    target["size"] = np.array([h, w])
    if "boxes" in target and len(target["boxes"]):
        boxes = target["boxes"][:, 1:].astype(np.float32)
        boxes = boxes - np.array([j, i, j, i], np.float32)
        boxes = np.minimum(
            boxes.reshape(-1, 2, 2), np.array([w, h], np.float32)
        ).clip(min=0)
        target["boxes"] = np.concatenate(
            [target["boxes"][:, :1], boxes.reshape(-1, 4)], axis=1
        )
        target["raw_boxes"] = np.concatenate(
            [target["raw_boxes"][:, :1], target["boxes"]], axis=1
        )
    return out, target


def hflip(images: List[Image.Image], target: Dict):
    out = [img.transpose(Image.FLIP_LEFT_RIGHT) for img in images]
    w = images[0].size[0]
    target = dict(target)
    if "boxes" in target and len(target["boxes"]):
        b = target["boxes"][:, 1:]
        b = b[:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1]) + np.array([w, 0, w, 0])
        target["boxes"] = np.concatenate([target["boxes"][:, :1], b], axis=1)
        target["raw_boxes"] = np.concatenate(
            [target["raw_boxes"][:, :1], target["boxes"]], axis=1
        )
    return out, target


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, imgs, target, rng):
        if rng.random() < self.p:
            return hflip(imgs, target)
        return imgs, target


class RandomSizeCropCustom:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, imgs, target, rng):
        width, height = imgs[0].size
        if width < height:
            w = width if width < self.size else self.size
            h = int(w * (height / width))
        else:
            h = height if height < self.size else self.size
            w = int(h * (width / height))
        x1 = int(rng.integers(0, width - w + 1))
        y1 = int(rng.integers(0, height - h + 1))
        return crop(imgs, target, (y1, x1, h, w))


class ResizeCustom:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, imgs, target, rng=None):
        width, height = imgs[0].size
        if width < height:
            w = self.size
            h = int(self.size * (height / width))
        else:
            h = self.size
            w = int(self.size * (width / height))
        crop_top = int(round((height - h) / 2.0))
        crop_left = int(round((width - w) / 2.0))
        return crop(imgs, target, (crop_top, crop_left, h, w))


class ColorJitter:
    def __init__(self, hue_shift=20.0, sat_shift=0.1, val_shift=0.1):
        self.hue_bound = int(round(hue_shift / 2))
        self.sat_bound = int(round(sat_shift * 255))
        self.val_bound = int(round(val_shift * 255))

    def __call__(self, imgs, target, rng):
        import cv2

        hsv = np.stack(
            [cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2HSV) for img in imgs]
        ).astype(np.int32)
        hue_s = int(rng.integers(-self.hue_bound, self.hue_bound + 1))
        hsv[..., 0] = (hsv[..., 0] + hue_s + 180) % 180
        sat_s = int(rng.integers(-self.sat_bound, self.sat_bound + 1))
        hsv[..., 1] = np.clip(hsv[..., 1] + sat_s, 0, 255)
        val_s = int(rng.integers(-self.val_bound, self.val_bound + 1))
        hsv[..., 2] = np.clip(hsv[..., 2] + val_s, 0, 255)
        hsv = hsv.astype(np.uint8)
        out = [
            Image.fromarray(cv2.cvtColor(hsv[i], cv2.COLOR_HSV2RGB))
            for i in range(len(imgs))
        ]
        return out, target


class PCAJitter:
    def __init__(self, alphastd=0.1, eigval=None, eigvec=None):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, imgs, target, rng):
        if self.alphastd == 0:
            return imgs, target
        alpha = rng.normal(0, self.alphastd, size=(1, 3))
        rgb = np.sum(
            self.eigvec * np.repeat(alpha, 3, axis=0)
            * np.repeat(self.eigval.reshape(1, 3), 3, axis=0),
            axis=1,
        )
        out = []
        for img in imgs:
            arr = np.asarray(img)
            jit = np.zeros(arr.shape, arr.dtype)
            for idx in range(3):
                # reference quirk: channel idx takes component rgb[2 - idx],
                # and the uint8 add wraps (no clipping) — reproduce both
                jit[:, :, idx] = arr[:, :, idx] + rgb[2 - idx]
            out.append(Image.fromarray(jit))
        return out, target


class ToArray:
    """PIL -> float32 [H, W, 3] in [0, 1] (torchvision ToTensor, HWC)."""

    def __call__(self, imgs, target, rng=None):
        return [np.asarray(img, np.float32) / 255.0 for img in imgs], target


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, images, target, rng=None):
        images = [(img - self.mean) / self.std for img in images]
        target = dict(target)
        h, w = images[0].shape[:2]
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"][:, 1:]
            cxcywh = np.stack(
                [
                    (b[:, 0] + b[:, 2]) / 2,
                    (b[:, 1] + b[:, 3]) / 2,
                    b[:, 2] - b[:, 0],
                    b[:, 3] - b[:, 1],
                ],
                axis=1,
            )
            cxcywh = cxcywh / np.array([w, h, w, h], np.float32)
            target["boxes"] = np.concatenate(
                [target["boxes"][:, :1], cxcywh], axis=1
            )
        return images, target


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, images, target, rng=None):
        if rng is None:
            rng = np.random.default_rng()
        for t in self.transforms:
            images, target = t(images, target, rng)
        return images, target


def make_transforms(image_set: str, cfg):
    """Counterpart of the per-dataset make_transforms builders
    (ava_frame.py:203-240, ucf_frame.py:336-366)."""
    img_size = cfg.CONFIG.DATA.IMG_SIZE
    jitter = cfg.CONFIG.AUG.COLOR_JITTER
    name = cfg.CONFIG.DATA.DATASET_NAME
    if name != "ava":
        jitter = jitter + 0.1
        eigval = np.array(cfg.CONFIG.AUG.TRAIN_PCA_EIGVAL, np.float32)
        eigvec = np.array(cfg.CONFIG.AUG.TRAIN_PCA_EIGVEC, np.float32)
    else:
        eigval = np.array([0.2175, 0.0188, 0.0045], np.float32)
        eigvec = np.array(
            [
                [-0.5675, 0.7192, 0.4009],
                [-0.5808, -0.0045, -0.8140],
                [-0.5836, -0.6948, 0.4203],
            ],
            np.float32,
        )
    normalize = [ToArray(), Normalize()]
    if image_set == "train":
        return Compose(
            [
                RandomHorizontalFlip(),
                RandomSizeCropCustom(img_size),
                ColorJitter(sat_shift=jitter, val_shift=jitter),
                PCAJitter(0.1, eigval, eigvec),
            ]
            + normalize
        )
    return Compose([ResizeCustom(img_size)] + normalize)
