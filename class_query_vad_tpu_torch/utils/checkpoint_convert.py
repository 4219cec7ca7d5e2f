"""Converters of pretrained backbone weights to the port's state_dict
names (counterpart of the JAX package's ``utils/checkpoint_convert.py``
``convert_csn_mat``, ``strip_mamba_prefixes``, ``_interp_mamba_pos_embed``,
``_interp_mamba_temporal`` and ``convert_videomamba_pretrain``).

The port keeps the reference's torch key names, so a reference DETR
``.pth`` loads as it is (``engine.checkpoint.load_pretrained_params``);
what needs converting is a backbone's own pretrain file:

* ``convert_csn_mat``: Caffe2 ``.mat`` weights of ir-CSN (the reference's
  ir_CSN_152.py:262-340 name map) -> ``backbone.0.body.*``; conv weights
  are [O, I, t, h, w] in both, the affine scale / bias are ``<name>_s`` /
  ``<name>_b``, the running statistics ``_rm`` / ``_riv`` where present;
* ``convert_videomamba_pretrain``: a raw VideoMamba pretrain state_dict
  (the OpenGVLab bimamba-v2 layout) -> ``backbone.0.body.*``, its
  ``backbone.`` / ``encoder.`` prefixes stripped, its head dropped and its
  position tables resampled to the model's clip, as the reference loader
  does (models/backbones/mamba.py:36-133).

Values come out float32, as ``utils.weights.params_from_jax`` gives them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BODY = "backbone.0.body."


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                   dtype=np.float32)))


def convert_csn_mat(mat: Dict[str, np.ndarray],
                    block_nums: Sequence[int] = (3, 8, 36, 3)
                    ) -> Dict[str, torch.Tensor]:
    """Caffe2 ``.mat`` weights (e.g. ``scipy.io.loadmat``) -> the CSN
    trunk's state_dict under ``backbone.0.body.``."""
    out: Dict[str, torch.Tensor] = {}

    def conv(dst, name):
        out[f"{BODY}{dst}.weight"] = _f32(mat[name])

    def bn(dst, name):
        out[f"{BODY}{dst}.weight"] = _f32(np.reshape(mat[name + "_s"], -1))
        out[f"{BODY}{dst}.bias"] = _f32(np.reshape(mat[name + "_b"], -1))
        if name + "_rm" in mat:
            out[f"{BODY}{dst}.running_mean"] = _f32(
                np.reshape(mat[name + "_rm"], -1))
            out[f"{BODY}{dst}.running_var"] = _f32(
                np.reshape(mat[name + "_riv"], -1))

    conv("conv1", "conv1_w")
    bn("bn1", "conv1_spatbn_relu")
    count = 0
    for s, n_blocks in enumerate(block_nums):
        for b in range(n_blocks):
            d = f"layer{s + 1}.{b}"
            for i in (1, 3, 4):
                conv(f"{d}.conv{i}", f"comp_{count}_conv_{i}_w")
                bn(f"{d}.bn{i}", f"comp_{count}_spatbn_{i}")
            if b == 0:
                conv(f"{d}.down_sample.0", f"shortcut_projection_{count}_w")
                bn(f"{d}.down_sample.1",
                   f"shortcut_projection_{count}_spatbn")
            count += 1
    return out


def interp_mamba_pos_embed(pos, num_patches: int,
                           num_extra: int = 1) -> torch.Tensor:
    """VideoMamba's spatial position table [1, extra + n, C] resampled to
    ``num_patches`` tokens: the tokens after the ``num_extra`` leading cls
    rows, on a square grid, bicubic with ``align_corners=False``
    (reference mamba.py:92-115)."""
    pos = _f32(pos)
    orig = int(round((pos.shape[-2] - num_extra) ** 0.5))
    new = int(round(num_patches ** 0.5))
    if orig == new:
        return pos
    c = pos.shape[-1]
    tok = pos[:, num_extra:].reshape(-1, orig, orig, c).permute(0, 3, 1, 2)
    tok = F.interpolate(tok, size=(new, new), mode="bicubic",
                        align_corners=False)
    tok = tok.permute(0, 2, 3, 1).reshape(-1, new * new, c)
    return torch.cat([pos[:, :num_extra], tok], dim=1)


def interp_mamba_temporal(tpe, new_t: int) -> torch.Tensor:
    """VideoMamba's temporal position table [1, T, C] resampled to
    ``new_t`` frames, linear with ``align_corners=False`` (reference
    mamba.py:117-130).  The source length is the tensor's own, as in the
    JAX package (the reference reads it from the config, so its temporal
    branch never fires)."""
    tpe = _f32(tpe)
    if tpe.shape[1] == new_t:
        return tpe
    t = F.interpolate(tpe.permute(0, 2, 1), size=(new_t,), mode="linear",
                      align_corners=False)
    return t.permute(0, 2, 1)


def strip_mamba_prefixes(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``backbone.`` / ``encoder.`` prefixes stripped and the classifier
    head dropped (reference mamba.py:63-88)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone."):
            k = k[9:]
        elif k.startswith("encoder."):
            k = k[8:]
        if k in ("head.weight", "head.bias"):
            continue
        out[k] = v
    return out


def _videomamba_keys(depth: int):
    yield "patch_embed.proj.weight"
    yield "patch_embed.proj.bias?"
    yield "cls_token"
    for i in range(depth):
        s, mx = f"layers.{i}", f"layers.{i}.mixer"
        yield from (f"{s}.norm.weight", f"{s}.norm.bias",
                    f"{mx}.in_proj.weight", f"{mx}.in_proj.bias?")
        for suf in ("", "_b"):
            yield from (f"{mx}.conv1d{suf}.weight", f"{mx}.conv1d{suf}.bias",
                        f"{mx}.x_proj{suf}.weight", f"{mx}.x_proj{suf}.bias?",
                        f"{mx}.dt_proj{suf}.weight", f"{mx}.dt_proj{suf}.bias",
                        f"{mx}.A{suf}_log", f"{mx}.D{suf}")
        yield from (f"{mx}.out_proj.weight", f"{mx}.out_proj.bias?")
    yield from ("norm_f.weight", "norm_f.bias")


def convert_videomamba_pretrain(sd: Dict[str, torch.Tensor], *, depth: int,
                                num_frames: int, num_patches: int
                                ) -> Dict[str, torch.Tensor]:
    """A raw VideoMamba pretrain state_dict -> the backbone's state_dict
    under ``backbone.0.body.`` (the model key unwrapped by
    ``engine.checkpoint.load_torch_state_dict``): prefixes stripped, the
    head dropped, the first ``depth`` layers taken and the position tables
    resampled to ``num_patches`` / ``num_frames``."""
    sd = strip_mamba_prefixes(sd)
    out = {f"{BODY}pos_embed": interp_mamba_pos_embed(sd["pos_embed"],
                                                      num_patches),
           f"{BODY}temporal_pos_embedding": interp_mamba_temporal(
               sd["temporal_pos_embedding"], num_frames)}
    for k in _videomamba_keys(depth):
        optional = k.endswith("?")
        k = k.rstrip("?")
        if optional and k not in sd:
            continue
        out[BODY + k] = _f32(sd[k])
    return out
