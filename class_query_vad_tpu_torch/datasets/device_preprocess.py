"""On-device preprocessing graphs (counterpart of
``class_query_vad_tpu/datasets/device_preprocess.py``).

uint8 decoded frames go to the device; the resize, crop, colour jitter and
normalize run there:

    eval:  uint8 frames -> Pillow-BICUBIC short-side resize -> ResizeCustom
           centre crop -> /255, ImageNet normalize -> dtype
    train: uint8 frames -> flip -> crop -> HSV jitter -> PCA lighting ->
           /255, ImageNet normalize -> dtype

* The resize is bit-exact Pillow (``Image.resize``'s default BICUBIC,
  a = -0.5), as ``native/decode.cpp`` is: per axis, Pillow's 8.22
  fixed-point coefficients (computed on the host per (in, out) size),
  then on the device an index-select gather and an integer weighted sum,
  the clip8 rounding, the horizontal pass before the vertical one with a
  uint8 intermediate.  No matmul and no float: the sums are exact (torch
  widens an integer ``sum`` to int64).
* The HSV stage is OpenCV's 8-bit RGB2HSV (``hsv_shift`` 12 division
  tables, arithmetic right shifts) and its float HSV2RGB (float32,
  round-half-even); the PCA stage is the reference's uint8 wrapping add
  (trunc toward zero, then modulo 256: ``torch.remainder``, whose result
  takes the divisor's sign as ``jnp.mod``'s does, not ``fmod``) with its
  channel reversal (``rgb[2 - idx]``).
* The random draws stay on the host (``draw_train_params``, in the host
  Compose's generator call order), as does the box math
  (``train_target_transform``).

Wire it as the JAX package's bench does (``scripts/bench_e2e_eval.py``):
a ``forward_fn`` that applies the graph before the model, e.g.
``lambda px, mask: model(fn(px), mask)``, and ``run_validation(...,
forward_fn=..., transfer_dtype=None)``, which ships the raw uint8 batches.
The loader and the loop keep their host transforms by default.  Imports
torch and numpy only (the card's machine has no PIL).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# datasets/transforms.py's (which imports PIL)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

PRECISION_BITS = 32 - 8 - 2          # Pillow PRECISION_BITS (8.22 fixed point)


def _bicubic_filter(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def pil_axis_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow bicubic coefficients for one axis: (idx [out, k] int32,
    coeff [out, k] int32).  Zero coefficients pad ragged tap counts, so the
    gather indices can clamp to 0 without affecting the sum."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int32)
    kk = np.zeros((out_size, ksize), np.int32)
    inv = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        n = xmax - xmin
        w = _bicubic_filter((np.arange(n) + xmin - center + 0.5) * inv)
        tot = w.sum()
        if tot != 0.0:
            w = w / tot
        # C truncation toward zero of w * 2^22 +/- 0.5 (decode.cpp:81-83)
        q = np.trunc(
            np.where(w < 0, w * (1 << PRECISION_BITS) - 0.5,
                     w * (1 << PRECISION_BITS) + 0.5)
        ).astype(np.int32)
        idx[xx, :n] = np.arange(xmin, xmax)
        kk[xx, :n] = q
    return idx, kk


def _clip8(ss: torch.Tensor) -> torch.Tensor:
    hi = 1 << (PRECISION_BITS + 8)
    return torch.where(ss >= hi, 255,
                       torch.where(ss <= 0, 0, ss >> PRECISION_BITS))


def _resample_axis(x: torch.Tensor, in_size: int, out_size: int,
                   axis: int) -> torch.Tensor:
    """One Pillow pass along ``axis``: int32 -> int32 with the axis length
    changed to ``out_size``, values already clip8-rounded."""
    idx, kk = pil_axis_coeffs(in_size, out_size)
    axis = axis % x.ndim
    g = x.index_select(axis, torch.from_numpy(idx.reshape(-1)).to(
        x.device, torch.long))
    g = g.reshape(x.shape[:axis] + (out_size, idx.shape[1])
                  + x.shape[axis + 1:])
    shape = [1] * g.ndim
    shape[axis] = out_size
    shape[axis + 1] = idx.shape[1]
    w = torch.from_numpy(kk).to(x.device).reshape(shape)
    ss = (g * w).sum(axis + 1) + (1 << (PRECISION_BITS - 1))
    return _clip8(ss).to(torch.int32)


def pil_resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Pillow-bit-exact BICUBIC resize of uint8 [..., H, W, C] to
    [..., h, w, C] uint8 (horizontal pass then vertical, like Pillow)."""
    H, W = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    y = x.to(torch.int32)
    if ow != W:
        y = _resample_axis(y, W, ow, axis=-2)
    if oh != H:
        y = _resample_axis(y, H, oh, axis=-3)
    return y.to(torch.uint8)


def resized_dims(size: int, ow: int, oh: int) -> Tuple[int, int]:
    """datasets/ava.py:70-77,111 — short side to ``size``, aspect kept,
    both dims int-truncated."""
    if oh <= ow:
        nh, nw = size, size * (ow / oh)
    else:
        nw, nh = size, size * (oh / ow)
    return int(nw), int(nh)


def center_crop_box(size: int, w: int, h: int) -> Tuple[int, int, int, int]:
    """transforms.ResizeCustom:99-113 — (top, left, ch, cw)."""
    if w < h:
        cw = size
        ch = int(size * (h / w))
    else:
        ch = size
        cw = int(size * (w / h))
    top = int(round((h - ch) / 2.0))
    left = int(round((w - cw) / 2.0))
    return top, left, ch, cw


_HSV_SHIFT = 12


@functools.lru_cache(maxsize=1)
def _hsv_tables() -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate(
        [[0], np.rint((255 << _HSV_SHIFT) / i)]
    ).astype(np.int32)
    hdiv = np.concatenate(
        [[0], np.rint((180 << _HSV_SHIFT) / (6.0 * i))]
    ).astype(np.int32)
    return sdiv, hdiv


def rgb_to_hsv_u8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV COLOR_RGB2HSV for uint8 ([..., 3] -> [..., 3] int32 with
    H in [0, 180), S/V in [0, 255]); fixed-point tables + rounded shifts
    exactly as imgproc/color_hsv (RGB2HSV_b)."""
    sdiv_t, hdiv_t = (torch.from_numpy(a).to(x.device) for a in _hsv_tables())
    r, g, b = (x[..., i].to(torch.int32) for i in range(3))
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv_t[v.long()] + half) >> _HSV_SHIFT
    h_num = torch.where(v == r, g - b,
                        torch.where(v == g, b - r + 2 * diff,
                                    r - g + 4 * diff))
    h = (h_num * hdiv_t[diff.long()] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1)


def _f32(v: float) -> float:
    """A python float holding ``v`` rounded to float32 (``jnp.float32(v)``)."""
    return float(np.float32(v))


def hsv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """OpenCV COLOR_HSV2RGB for uint8 (int32 [..., 3] H<180 -> uint8 RGB):
    the float sector formula with saturate_cast rounding (HSV2RGB_b)."""
    h = hsv[..., 0].float() * _f32(6.0 / 180.0)
    s = hsv[..., 1].float() * _f32(1.0 / 255.0)
    v = hsv[..., 2].float() * _f32(1.0 / 255.0)
    sector = torch.floor(h)
    f = h - sector
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sec = sector.to(torch.int32).clamp(0, 5)

    def select(*by_sector):          # sectors 0-4, then the default (5)
        out = by_sector[-1]
        for k in range(4, -1, -1):
            out = torch.where(sec == k, by_sector[k], out)
        return out

    rgb = torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                       select(p, p, t, v, v, q)], dim=-1) * 255.0
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)


def random_crop_dims(img_size: int, in_hw: Tuple[int, int]) -> Tuple[int, int]:
    """RandomSizeCrop_Custom's (static) crop height/width for a decoded
    frame of ``in_hw`` (video_transforms.py:222-249 / transforms.py:82-96)."""
    H0, W0 = in_hw
    if W0 < H0:
        w = W0 if W0 < img_size else img_size
        h = int(w * (H0 / W0))
    else:
        h = H0 if H0 < img_size else img_size
        w = int(h * (W0 / H0))
    return h, w


def draw_train_params(rng: np.random.Generator, img_size: int,
                      in_hw: Tuple[int, int], sat_shift: float,
                      val_shift: float, alphastd: float,
                      eigval: np.ndarray, eigvec: np.ndarray,
                      hue_shift: float = 20.0) -> dict:
    """Draw the per-clip augmentation parameters with the SAME generator
    call order as the host Compose (flip, crop x1/y1, hue/sat/val, pca
    alpha), so a shared per-clip seed makes host and device paths agree."""
    H0, W0 = in_hw
    flip = bool(rng.random() < 0.5)
    ch, cw = random_crop_dims(img_size, in_hw)
    x1 = int(rng.integers(0, W0 - cw + 1))
    y1 = int(rng.integers(0, H0 - ch + 1))
    hue_bound = int(round(hue_shift / 2))
    sat_bound = int(round(sat_shift * 255))
    val_bound = int(round(val_shift * 255))
    hue_s = int(rng.integers(-hue_bound, hue_bound + 1))
    sat_s = int(rng.integers(-sat_bound, sat_bound + 1))
    val_s = int(rng.integers(-val_bound, val_bound + 1))
    alpha = rng.normal(0, alphastd, size=(1, 3))
    rgb = np.sum(
        np.asarray(eigvec, np.float32) * np.repeat(alpha, 3, axis=0)
        * np.repeat(np.asarray(eigval, np.float32).reshape(1, 3), 3, axis=0),
        axis=1,
    )
    return {
        "flip": np.asarray(flip),
        "crop_yx": np.asarray([y1, x1], np.int32),
        "hsv_shift": np.asarray([hue_s, sat_s, val_s], np.int32),
        "pca_rgb": np.asarray(rgb, np.float32),
    }


def train_target_transform(target: dict, img_size: int,
                           in_hw: Tuple[int, int], params: dict) -> dict:
    """Apply the flip + crop BOX math of transforms.hflip/crop to a target
    dict without touching pixels (the device graph does those).  Same
    order as the Compose: flip first, then crop.  The Normalize stage's
    xyxy -> normalized-cxcywh conversion is left to the caller (it needs
    the final padded canvas size, like the host pipeline)."""
    H0, W0 = in_hw
    target = dict(target)
    if bool(params["flip"]) and "boxes" in target and len(target["boxes"]):
        b = target["boxes"][:, 1:]
        b = b[:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1]) + np.array(
            [W0, 0, W0, 0]
        )
        target["boxes"] = np.concatenate([target["boxes"][:, :1], b], axis=1)
        target["raw_boxes"] = np.concatenate(
            [target["raw_boxes"][:, :1], target["boxes"]], axis=1
        )
    ch, cw = random_crop_dims(img_size, in_hw)
    y1, x1 = (int(v) for v in params["crop_yx"])
    target["size"] = np.array([ch, cw])
    if "boxes" in target and len(target["boxes"]):
        boxes = target["boxes"][:, 1:].astype(np.float32)
        boxes = boxes - np.array([x1, y1, x1, y1], np.float32)
        boxes = np.minimum(
            boxes.reshape(-1, 2, 2), np.array([cw, ch], np.float32)
        ).clip(min=0)
        target["boxes"] = np.concatenate(
            [target["boxes"][:, :1], boxes.reshape(-1, 4)], axis=1
        )
        target["raw_boxes"] = np.concatenate(
            [target["raw_boxes"][:, :1], target["boxes"]], axis=1
        )
    return target


def _normalize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    x = x.float() / 255.0
    return ((x - mean) / std).to(dtype)


def _dynamic_slice(x: torch.Tensor, start: torch.Tensor, size: int,
                   axis: int) -> torch.Tensor:
    """``jax.lax.dynamic_slice_in_dim``: ``size`` entries of ``axis`` from a
    device-side ``start`` (no host sync); a negative start counts once from
    the end, then the start is clamped so that the slice fits."""
    n = x.shape[axis]
    start = torch.where(start < 0, start + n, start).clamp(0, n - size)
    rows = start + torch.arange(size, device=x.device)
    return x.index_select(axis, rows)


def make_train_preprocess(img_size: int, in_hw: Tuple[int, int],
                          dtype: torch.dtype = torch.float32):
    """The TRAIN pixel graph for decoded uint8 frames of shape ``in_hw``.
    Returns (fn, out_hw): fn(frames_u8 [..., H0, W0, 3], params) ->
    ``dtype`` [..., ch, cw, 3], where params is the dict of
    ``draw_train_params`` (numpy arrays or tensors, moved to the frames'
    device: one graph serves every clip of this shape)."""
    ch, cw = random_crop_dims(img_size, in_hw)

    def fn(frames_u8: torch.Tensor, params: dict) -> torch.Tensor:
        dev = frames_u8.device
        p = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
        x = torch.where(p["flip"], frames_u8.flip(-2), frames_u8)
        x = _dynamic_slice(x, p["crop_yx"][0].long(), ch, x.ndim - 3)
        x = _dynamic_slice(x, p["crop_yx"][1].long(), cw, x.ndim - 2)
        # HSV jitter (ColorJitter): int shifts in cv2's uint8 HSV space
        hsv = rgb_to_hsv_u8(x)
        shift = p["hsv_shift"].to(torch.int32)
        h = torch.remainder(hsv[..., 0] + shift[0] + 180, 180)
        s = (hsv[..., 1] + shift[1]).clamp(0, 255)
        v = (hsv[..., 2] + shift[2]).clamp(0, 255)
        x = hsv_to_rgb_u8(torch.stack([h, s, v], dim=-1))
        # PCA lighting: float add, numpy's unsafe float -> uint8 cast (trunc
        # toward zero, then wrap) and the reference's rgb[2 - idx] reversal
        vf = x.float() + p["pca_rgb"].float().flip(0)
        x = torch.remainder(torch.trunc(vf).to(torch.int32), 256).to(
            torch.uint8)
        return _normalize(x, dtype)

    return fn, (ch, cw)


def make_eval_preprocess(img_size: int, in_hw: Tuple[int, int],
                         dtype: torch.dtype = torch.float32):
    """The val pixel graph for native frames of shape ``in_hw``.  Returns
    (fn, out_hw): fn maps uint8 [..., H0, W0, 3] -> ``dtype`` [..., h2, w2,
    3] (resize -> centre crop -> /255 -> ImageNet normalize), exactly the
    host path's pixels."""
    H0, W0 = in_hw
    nw, nh = resized_dims(img_size, W0, H0)
    top, left, ch, cw = center_crop_box(img_size, nw, nh)

    def fn(frames_u8: torch.Tensor) -> torch.Tensor:
        x = pil_resize_bicubic(frames_u8, (nh, nw))
        x = x[..., top:top + ch, left:left + cw, :]
        return _normalize(x, dtype)

    return fn, (ch, cw)

