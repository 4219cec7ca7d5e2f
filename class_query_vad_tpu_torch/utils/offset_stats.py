"""Out-of-window statistics of the exact encoder's sampling offsets
(counterpart of the JAX package's ``utils/offset_stats.py``).

The fast encoder's windowed blend computes the same trilinear function as
the exact sampler wherever the (transplanted) offsets stay within
+-radius native pixels of the reference point; these functions measure
how often an exact encoder's offsets leave that window.  The offsets and
attention logits are collected with forward hooks on the exact encoder's
``sampling_offsets`` / ``attention_weights`` heads (flax captures
intermediates there).

Native pixels keep the reference's permuted-normalizer quirk
(``models/deform_encoder.py``): the raw (x, y, t) offset is divided by
the (T, W, H)-stacked normalizer, so at level l = (t_l, h_l, w_l)

    px = off_x * w_l / t_l,  py = off_y * h_l / w_l,  pt = off_t * t_l / h_l
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _collect(module: torch.nn.Module, names: Tuple[str, ...], *args,
             **kwargs):
    got: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    hooks = []
    for path, sub in module.named_modules():
        leaf = path.rsplit(".", 1)[-1]
        if leaf in names:
            hooks.append(sub.register_forward_hook(
                lambda _m, _i, out, leaf=leaf: got[leaf].append(
                    out.detach().float().cpu().numpy())))
    try:
        with torch.no_grad():
            out = module(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return out, got


def collect_sampling_offsets(module, *args, **kwargs):
    """(output, offsets): ``module(*args, **kwargs)`` with every
    ``sampling_offsets`` head output [..., nh*nl*np*3] captured, one per
    call, in call order (layer order)."""
    out, got = _collect(module, ("sampling_offsets",), *args, **kwargs)
    return out, got["sampling_offsets"]


def collect_offsets_and_weights(module, *args, **kwargs):
    """(output, [(offsets, attention logits [..., nh*nl*np]) per layer]):
    the out-of-window fraction can then be weighted by the softmax
    attention (a tap with ~zero weight adds ~nothing to the deviation)."""
    out, got = _collect(module, ("sampling_offsets", "attention_weights"),
                        *args, **kwargs)
    return out, list(zip(got["sampling_offsets"], got["attention_weights"]))


def native_pixel_offsets(raw: np.ndarray,
                         spatial_shapes: Sequence[Tuple[int, int, int]],
                         n_heads: int, n_points: int) -> np.ndarray:
    """raw [..., nh*nl*np*3] -> native-pixel displacements
    [..., nh, nl, np, 3] in (px, py, pt) order (quirk applied)."""
    nl = len(spatial_shapes)
    off = np.asarray(raw, np.float32).reshape(
        raw.shape[:-1] + (n_heads, nl, n_points, 3))
    scale = np.empty((nl, 3), np.float32)
    for l, (t, h, w) in enumerate(spatial_shapes):
        scale[l] = (w / t, h / w, t / h)
    return off * scale[None, :, None, :]


def window_fractions(pixels: np.ndarray,
                     spatial_shapes: Sequence[Tuple[int, int, int]],
                     thresholds: Sequence[float] = (1.0, 2.0),
                     weights: np.ndarray | None = None
                     ) -> List[Dict[str, float]]:
    """Per-level spatial out-of-window statistics of ``pixels`` [..., nh,
    nl, np, 3]: only (px, py) are judged against the window (the fast
    kernels' 2d window), |pt| is reported apart.  With ``weights``
    (softmax attention [..., nh, nl, np]) each tap's in-window indicator
    is also weighted by its attention mass."""
    out = []
    for l in range(len(spatial_shapes)):
        sp = np.abs(pixels[..., l, :, :2])
        pt = np.abs(pixels[..., l, :, 2]).reshape(-1)
        inw = sp.max(axis=-1)           # a tap is in the window iff both are
        row = {"level": l, "shape": tuple(spatial_shapes[l]),
               "mean_px": float(sp.mean()), "max_px": float(sp.max()),
               "mean_pt": float(pt.mean())}
        for th in thresholds:
            row[f"frac_within_{th:g}"] = float((sp.reshape(-1) <= th).mean())
            if weights is not None:
                wl = weights[..., l, :]
                row[f"wfrac_within_{th:g}"] = float(
                    ((inw <= th) * wl).sum() / wl.sum())
        out.append(row)
    return out


def softmax_weights(raw_logits: np.ndarray, n_heads: int, n_levels: int,
                    n_points: int) -> np.ndarray:
    """Raw attention_weights head output [..., nh*nl*np] -> softmax over
    (nl*np) per head, as [..., nh, nl, np]."""
    x = np.asarray(raw_logits, np.float64).reshape(
        raw_logits.shape[:-1] + (n_heads, n_levels * n_points))
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    w = e / e.sum(axis=-1, keepdims=True)
    return w.reshape(x.shape[:-1] + (n_levels, n_points))
