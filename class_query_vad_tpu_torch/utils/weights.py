"""JAX (flax) param tree -> the port's ``state_dict``.

``params_from_jax(params)`` takes the JAX package's DETR params as nested
dicts of numpy arrays (``{"params": ...}`` or the bare tree) and returns a
state_dict for ``model.load_state_dict(sd, strict=True)``.  Every layout
rule below is linear, so a gradient tree of the same structure maps onto
the port's parameter names the same way.  The keys are
the reference's torch names wherever the reference has the module
(``backbone.0.body.*``, ``backbone.0.lateral_convs.{l}.{i}.*``,
``transformer.decoder.layers.{i}.*``, ...).  Layout rules:

* Dense kernel [in, out]            -> Linear weight [out, in]
* Conv kernel [t, h, w, I, O]       -> Conv3d weight [O, I, t, h, w]
  (2D: [h, w, I, O] -> [O, I, h, w])
* ConvTranspose kernel [t, h, w, I, O] -> ConvTranspose3d [I, O, t, h, w],
  spatially FLIPPED: flax's transpose_kernel=False convention applies the
  kernel mirrored relative to torch
* the class layers' k/v Dense [in, out] -> 1x1 Conv2d [out, in, 1, 1]
* LayerNorm scale -> weight; ChannelLayerNorm's inner ``LayerNorm_0``
  level disappears
* the class layer's one ConvBlock -> ``conv_blocks.{0,1,2}`` (one module
  registered three times, as in the reference)
* the fast encoder's ``sampling_offsets_kernel/bias`` and
  ``attention_weights_kernel/bias`` -> ``self_attn.window_offsets`` and
  ``self_attn.window_weights`` (no reference counterpart; lane order kept)
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# flax lateral_convs_{l}/<name> -> index in the reference Sequential
_LATERAL = {
    0: dict(up1=0, up1_norm=1, up2=3, proj1=4, proj_norm=5, proj2=6),
    1: dict(up1=0, proj1=1, proj_norm=2, proj2=3),
    2: dict(proj1=0, proj_norm=1, proj2=2),
    3: dict(proj1=1, proj_norm=2, proj2=3),
}
_RENAME = {
    "backbone": "backbone.0",
    "patch_embed": "patch_embed.proj",
    "mlp_fc1": "mlp.fc1",
    "mlp_fc2": "mlp.fc2",
}
_FAST_HEADS = {
    "sampling_offsets_kernel": ("window_offsets", "weight"),
    "sampling_offsets_bias": ("window_offsets", "bias"),
    "attention_weights_kernel": ("window_weights", "weight"),
    "attention_weights_bias": ("window_weights", "bias"),
}
_NUM_CONV_BLOCKS = 3


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v, dtype=np.float32)


def _module_path(mods: Tuple[str, ...]) -> list:
    out = []
    for i, m in enumerate(mods):
        lat = re.fullmatch(r"lateral_convs_(\d)", m)
        if lat:
            lvl = int(lat.group(1))
            out += ["lateral_convs", str(lvl), str(_LATERAL[lvl][mods[i + 1]])]
            out += _module_path(mods[i + 2:])
            return out
        idx = re.fullmatch(r"(blocks|layers|cls_layers)_(\d+)", m)
        if idx:
            out += [idx.group(1), idx.group(2)]
        elif m == "LayerNorm_0":
            continue
        else:
            out.append(_RENAME.get(m, m))
    return out


def _convert(path: Tuple[str, ...], v: np.ndarray):
    """Yield (torch key, array) pairs for one flax leaf."""
    *mods, leaf = path
    if leaf in _FAST_HEADS:
        name, kind = _FAST_HEADS[leaf]
        yield ".".join(_module_path(tuple(mods)) + [name, kind]), (
            v.T if kind == "weight" else v)
        return
    if leaf == "qkv_kernel":
        yield ".".join(_module_path(tuple(mods)) + ["qkv", "weight"]), v.T
        return
    if leaf in ("class_queries", "refpoint_embed"):
        yield ".".join(_module_path(tuple(mods)) + [leaf, "weight"]), v
        return
    base = _module_path(tuple(mods))
    if leaf == "scale":
        out = ("weight", v)
    elif leaf == "kernel":
        if v.ndim == 2:
            if mods[-1] in ("k_proj", "v_proj") and "cls_layers" in base:
                out = ("weight", v.T[:, :, None, None])
            else:
                out = ("weight", v.T)
        elif v.ndim == 5 and mods[-1] in ("up1", "up2"):
            out = ("weight", v[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
        elif v.ndim == 5:
            out = ("weight", v.transpose(4, 3, 0, 1, 2))
        elif v.ndim == 4:
            out = ("weight", v.transpose(3, 2, 0, 1))
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
    else:                                   # bias, q_bias, v_bias, level_embed
        out = (leaf, v)
    if "conv_block" in base:
        i = base.index("conv_block")
        for k in range(_NUM_CONV_BLOCKS):
            key = base[:i] + ["conv_blocks", str(k)] + base[i + 1:]
            yield ".".join(key + [out[0]]), out[1]
        return
    yield ".".join(base + [out[0]]), out[1]


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """flax DETR params (nested dicts of arrays) -> port state_dict."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        for key, arr in _convert(path, v):
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd
