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

The Mamba family (the reference names of the JAX package's
``utils/checkpoint_convert.py`` ``convert_videomamba``,
``convert_mamba_proj``, ``convert_ssm_encoder``, ``convert_vss_block``,
``convert_mamba_block``):

* VideoMamba's params (flax ``backbone/...``, no ``body`` level) ->
  ``backbone.0.body.*``; ``mamba_proj_{k}`` -> ``backbone.0.mamba_proj.{k}``
* depthwise Conv1d kernel [k, 1, C] -> Conv1d weight [C, 1, k]
* ``dt_proj{,_b}_kernel`` [R, D] / ``_bias`` -> ``dt_proj{,_b}.weight``
  [D, R] / ``.bias``
* the SSM encoder's ``nn.scan`` subtree ``recurrent/step/...`` -> the
  layer itself (``ssm_norm``, ``ssm.*``)
* VSSBlock: ``proj_conv`` / ``proj_bn`` -> ``proj_conv.0`` / ``proj_conv.1``,
  its LayerNorm ``norm`` -> ``norm.norm`` (LayerNorm2d), SS2D's Dense
  ``in_proj`` / ``out_proj`` [I, O] -> 1x1 Conv2d [O, I, 1, 1]
* raw params (position tables, cls token, A_log, D, SS2D's x_proj_weight,
  dt_projs_*, A_logs, Ds, FrozenBatchNorm's weight / bias / running stats)
  as they are
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
_VSS_RENAME = {"proj_conv": "proj_conv.0", "proj_bn": "proj_conv.1",
               "norm": "norm.norm"}


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v, dtype=np.float32)


def _module_path(mods: Tuple[str, ...]) -> list:
    if mods and mods[0] == "backbone" and (
            len(mods) == 1 or not re.fullmatch(r"body|lateral_convs_\d",
                                               mods[1])):
        # VideoMamba: flax's backbone is the body itself
        return ["backbone", "0", "body"] + _module_path(mods[1:])
    mp = re.fullmatch(r"mamba_proj_(\d)", mods[0]) if mods else None
    if mp:
        return ["backbone", "0", "mamba_proj", mp.group(1)]
    out = []
    for i, m in enumerate(mods):
        if m in ("recurrent", "step"):        # the SSM encoder's nn.scan
            continue
        if i and mods[i - 1] == "ssm" and m in _VSS_RENAME:
            out.append(_VSS_RENAME[m])
            continue
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
    dt = re.fullmatch(r"(dt_proj(?:_b)?)_(kernel|bias)", leaf)
    if dt:
        yield ".".join(_module_path(tuple(mods)) + [
            dt.group(1), "weight" if dt.group(2) == "kernel" else "bias"]), (
            v.T if dt.group(2) == "kernel" else v)
        return
    base = _module_path(tuple(mods))
    if leaf == "scale":
        out = ("weight", v)
    elif leaf == "kernel":
        if v.ndim == 2:
            if ((mods[-1] in ("k_proj", "v_proj") and "cls_layers" in base)
                    or (mods[-1] in ("in_proj", "out_proj")
                        and mods[-2:-1] == ["op"])):
                out = ("weight", v.T[:, :, None, None])
            else:
                out = ("weight", v.T)
        elif v.ndim == 3:                    # depthwise Conv1d [k, 1, C]
            out = ("weight", v.transpose(2, 1, 0))
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
