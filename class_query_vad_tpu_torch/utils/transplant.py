"""Exact-encoder -> fast-encoder weight transplant on the port's
state_dict (counterpart of the JAX package's ``utils/transplant.py``).

The fast (windowed) encoder shares every module with the exact deformable
encoder except the sampling heads:

* exact (``models/deform_encoder.py``): ``self_attn.sampling_offsets``,
  output lanes ordered (head, level, point, xyz), unbounded offsets in
  the reference's normalized units; ``self_attn.attention_weights``,
  lanes (head, level, point);
* fast (``models/fast_encoder.py``): ``self_attn.window_offsets``, lanes
  (level, component, head, point), offsets bounded to ``radius *
  tanh(.)`` pixels of the query grid; ``self_attn.window_weights``, lanes
  (level, head, point).

Shared modules copy over, the head lanes are permuted, and the offset
head is linearized through the tanh bound (weight scaled by 1/radius,
bias mapped through ``arctanh(clip(b / radius))``), so small trained
offsets are reproduced and large ones saturate at the window edge.  The
transplant is an initialization: the window clamp changes what
out-of-window samples see.  The arithmetic is the JAX package's, in
numpy on (in, out) kernels, so both give the same bits.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_HEAD = re.compile(r"^(.*\.self_attn\.)(sampling_offsets|attention_weights)"
                   r"\.(weight|bias)$")


def exact_to_fast_encoder(sd: Dict[str, torch.Tensor], *, n_heads: int,
                          n_levels: int, n_points: int, radius: int = 1,
                          window: str = "2d",
                          level_scales=None) -> Dict[str, torch.Tensor]:
    """A state_dict whose exact-encoder heads (``*.self_attn.
    sampling_offsets`` / ``attention_weights``) are converted to the fast
    encoder's (``window_offsets`` / ``window_weights``); every other key
    passes through.  ``level_scales`` ([n_levels, 3], optional) multiplies
    the offset head per (level, component) before the linearization
    (``native_level_scales`` for ``FAST_CROSS_LEVEL: native``)."""
    nc = 3 if window == "3d" else 2
    nh, nl, np_ = n_heads, n_levels, n_points
    kp = nh * np_
    out: Dict[str, torch.Tensor] = {}
    heads: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        m = _HEAD.match(k)
        if m is None:
            out[k] = v
            continue
        heads.setdefault(m.group(1), {})[f"{m.group(2)}.{m.group(3)}"] = (
            v.detach().cpu().numpy())
    for pre, h in heads.items():
        # offsets: exact lane e = ((h*nl + l)*np + p)*3 + c ->
        #          fast lane f = ((l*nc + c)*nh + h)*np + p   (c < nc)
        k = h["sampling_offsets.weight"].T              # [d, nh*nl*np*3]
        b = h["sampling_offsets.bias"]
        d_model = k.shape[0]
        k = k.reshape(d_model, nh, nl, np_, 3)
        b = b.reshape(nh, nl, np_, 3)
        perm_k = np.transpose(k, (0, 2, 4, 1, 3))[:, :, :nc]   # [d, l, c, h, p]
        perm_b = np.transpose(b, (1, 3, 0, 2))[:, :nc]         # [l, c, h, p]
        if level_scales is not None:
            s = np.asarray(level_scales, np.float64)[:, :nc]
            perm_k = perm_k * s[None, :, :, None, None]
            perm_b = perm_b * s[:, :, None, None]
        perm_k = perm_k.reshape(d_model, nl * nc * kp)
        perm_b = perm_b.reshape(nl * nc * kp)
        # radius*tanh(k/r . q + atanh(b/r)) ~= k . q + b in the window
        kernel = perm_k / float(radius)
        bias = np.arctanh(np.clip(perm_b / float(radius), -0.995, 0.995))
        # weights: exact lane (h*nl + l)*np + p -> fast (l*nh + h)*np + p
        wk = h["attention_weights.weight"].T.reshape(d_model, nh, nl, np_)
        wb = h["attention_weights.bias"].reshape(nh, nl, np_)
        wk = np.transpose(wk, (0, 2, 1, 3)).reshape(d_model, nl * kp)
        wb = np.transpose(wb, (1, 0, 2)).reshape(nl * kp)
        for name, arr in (("window_offsets.weight", kernel.T),
                          ("window_offsets.bias", bias),
                          ("window_weights.weight", wk.T),
                          ("window_weights.bias", wb)):
            out[pre + name] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))
    return out


def native_level_scales(spatial_shapes) -> np.ndarray:
    """Offset scales [(W/T, H/W, T/H) per level] converting the exact
    sampler's quirk-normalized offsets to native pixels."""
    return np.asarray(
        [[w / t, h / w, t / h] for (t, h, w) in spatial_shapes], np.float64)


def transplant_exact_to_fast(sd: Dict[str, torch.Tensor], cfg,
                             spatial_shapes=None) -> Dict[str, torch.Tensor]:
    """A whole model's state_dict with its exact encoder converted, with
    the fast hyper-parameters of ``cfg``.  With ``FAST_CROSS_LEVEL:
    native`` pass the model's per-level ``spatial_shapes`` (T, H, W)."""
    m = cfg.CONFIG.MODEL
    scales = None
    if str(m.get("FAST_CROSS_LEVEL", "resample")) == "native":
        if spatial_shapes is None:
            raise ValueError(
                "FAST_CROSS_LEVEL=native transplant needs spatial_shapes")
        scales = native_level_scales(spatial_shapes)
    return exact_to_fast_encoder(
        sd, n_heads=m.NHEAD, n_levels=m.NUM_FEATURE_LEVELS,
        n_points=m.NUM_ENC_N_POINTS, radius=int(m.get("FAST_RADIUS", 1)),
        window=str(m.get("FAST_WINDOW", "3d")), level_scales=scales)
