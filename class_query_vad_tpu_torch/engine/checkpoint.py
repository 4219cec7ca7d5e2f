"""Checkpoints: save / resume a training run, load reference weights
(counterpart of the JAX package's ``engine/checkpoint.py``).

* ``save_checkpoint`` / ``load_checkpoint``: one ``torch.save`` file per
  epoch, ``{BASE_PATH}/{EXP_NAME}/{SAVE_DIR}/ckpt_epoch_{epoch:02d}.pt``,
  holding the model's state_dict, ``MasterAdamW``'s whole state (float32
  masters, AdamW's moments, a half-done accumulation window, the
  counters), epoch, accuracy, the config, and the RNG streams a resumed
  run draws from, as the reference saves them
  (utils/model_utils.py:266-299): python's and numpy's (process 0's, as
  the JAX package keeps its hosts'), and every rank's torch CPU generator
  and, on a card, its CUDA generators (dropout and drop path draw there;
  ``Trainer`` seeds them ``seed + rank``), a list by rank, so that each
  rank of a resumed run draws its own stream, as the JAX package's
  dropout key in its ``TrainState`` resumes.  Under a process group every
  rank calls ``save_checkpoint`` (it gathers the streams to rank 0) and
  rank 0 alone writes.
* ``load_pretrained_params``: a reference ``.pth`` (the reference's
  DETR state_dict, whose key names the port's modules keep) or a port
  checkpoint, into a model.
* ``load_detr_weights``: the two-stage init (utils/model_utils.py:17-99):
  the encoder, decoder, ``level_embed`` and ``refpoint_embed`` of a
  stage-1 reference checkpoint transplanted into an initialized model.

The fast encoder (``ENCODER_TYPE: fast_attention``) has no reference
counterpart: its window heads ``self_attn.window_offsets`` /
``self_attn.window_weights`` are in no reference checkpoint, and the
reference's exact-encoder heads ``self_attn.sampling_offsets`` /
``self_attn.attention_weights`` have no place in it.  Both loaders report
these by name and leave the window heads at their init; every other key
the reference names is loaded.  (The JAX package sends this encoder type
to its SSM converter, which fails.)

``torch.load`` runs with ``weights_only=False``: reference files and
port checkpoints hold python objects.  Load trusted files only.
"""

from __future__ import annotations

import os
import random
import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

from .. import parallel

FORMAT = "class_query_vad_tpu_torch/checkpoint-1"
# keys of a reference DETR state_dict that no port module holds: the class
# decoder layer's ConvBlock has a ``q_proj`` its forward never calls
_REFERENCE_ONLY = re.compile(r"\.conv_blocks\.\d+\.q_proj\.")
# torch BatchNorm's step counters (CSN), which the port's batch norms do
# not keep: their running statistics are never updated
_BN_COUNTERS = re.compile(r"\.num_batches_tracked$")
# the fast encoder's window heads (no reference counterpart) and the exact
# encoder's heads they take the place of
_WINDOW_HEADS = re.compile(r"\.self_attn\.window_(offsets|weights)\.")
_EXACT_HEADS = re.compile(
    r"^transformer\.encoder\.layers\.\d+\.self_attn\."
    r"(sampling_offsets|attention_weights)\.")


def _ckpt_dir(cfg) -> str:
    return os.path.join(
        cfg.CONFIG.LOG.BASE_PATH, cfg.CONFIG.LOG.EXP_NAME,
        cfg.CONFIG.LOG.SAVE_DIR,
    )


def _device_rng_state() -> dict:
    """This process's torch CPU generator and, on a card, its CUDA
    generators."""
    state = {"torch": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state_all()
    return state


def _set_rng_state(state: dict) -> None:
    """Restore python's and numpy's streams, and this rank's torch / CUDA
    generators: its entry of ``state["ranks"]``.  A rank past the saved
    world keeps the stream its ``Trainer`` seeded; so do the ranks past 0
    on a checkpoint written before the streams were kept by rank, which
    holds rank 0's alone."""
    random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    ranks = state.get("ranks", [state])
    if parallel.rank() >= len(ranks):
        return
    own = ranks[parallel.rank()]
    torch.set_rng_state(own["torch"])
    if "cuda" in own and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(own["cuda"])


def save_checkpoint(cfg, trainer_or_model, epoch: int,
                    accuracy: float = 0.0) -> str:
    """Write ``ckpt_epoch_{epoch:02d}.pt`` for an ``engine.Trainer`` (model,
    optimizer, RNG streams) or a bare model; returns its path.  Under a
    process group every rank must call it: the ranks' generator states
    are gathered to rank 0, which writes the file, and the call returns
    on every rank once it is written."""
    trainer = None if isinstance(trainer_or_model, nn.Module) else trainer_or_model
    model = trainer_or_model if trainer is None else trainer.model
    path = os.path.abspath(
        os.path.join(_ckpt_dir(cfg), f"ckpt_epoch_{epoch:02d}.pt"))
    ranks = parallel.process_allgather(_device_rng_state())
    if parallel.rank() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ckpt = {
            "format": FORMAT,
            "model": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()},
            "epoch": int(epoch),
            "accuracy": float(accuracy),
            "config": cfg.dump(),
            "rng": {"python": random.getstate(),
                    "numpy": np.random.get_state(), "ranks": ranks},
        }
        if trainer is not None:
            ckpt["optimizer"] = trainer.optimizer.state_dict()
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    parallel.sync_hosts()
    return path


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def load_checkpoint(path: str, trainer) -> dict:
    """Restore a port checkpoint of a training run into ``trainer``: its
    model, its optimizer and the RNG streams (each rank its own torch /
    CUDA generators), so that the next step is the one an uninterrupted
    run takes.  Returns ``{"epoch", "accuracy",
    "config"}``.  (A bare model loads through ``load_pretrained_params``.)
    """
    ckpt = _read(path)
    if not (isinstance(ckpt, dict) and ckpt.get("format") == FORMAT):
        raise ValueError(f"{path} is not a checkpoint of this package")
    if "optimizer" not in ckpt:
        raise ValueError(f"{path} holds no optimizer state")
    trainer.model.load_state_dict(ckpt["model"], strict=True)
    trainer.optimizer.load_state_dict(ckpt["optimizer"])
    _set_rng_state(ckpt["rng"])
    return {k: ckpt[k] for k in ("epoch", "accuracy", "config")}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` as a flat state_dict: unwrap ``module`` /
    ``model`` / ``state_dict`` and strip a leading ``module.``
    (the JAX package's ``utils/checkpoint_convert.py:32-45``)."""
    return _flat(_read(path))


def _flat(ckpt) -> Dict[str, torch.Tensor]:
    for key in ("module", "model", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    out = {}
    for k, v in ckpt.items():
        k = k.replace("module.", "", 1) if k.startswith("module.") else k
        out[k] = torch.as_tensor(v)
    return out


def _is_fast(cfg) -> bool:
    return cfg.CONFIG.MODEL.get("ENCODER_TYPE", "attention") == "fast_attention"


def load_pretrained_params(cfg, path: str, model: nn.Module) -> List[str]:
    """Load ``path`` into ``model``: a port checkpoint (``save_checkpoint``)
    as it is; anything else as a reference DETR state_dict
    (``load_torch_state_dict``) onto the port's key names, which are the
    reference's.  The reference's unused ConvBlock ``q_proj`` is dropped.
    A CSN's ``*.num_batches_tracked`` buffers (the reference's
    BatchNorm3d's) are dropped too, and returned by name and printed.
    With the fast encoder the window heads stay at their init and the
    exact heads are not loaded; both are returned, by name, and printed.
    A VideoMamba backbone's position tables are resampled to
    ``(IMG_SIZE // 16)**2`` patches and ``DATA.TEMP_LEN`` frames, as the
    JAX package's ``convert_detr_checkpoint`` resamples them (a no-op at
    the checkpoint's own sizes).  Any other missing or unexpected key, or
    a shape that differs, raises.
    """
    ckpt = _read(path)
    if isinstance(ckpt, dict) and ckpt.get("format") == FORMAT:
        model.load_state_dict(ckpt["model"], strict=True)
        return []
    sd = _flat(ckpt)
    if "VideoMamba" in cfg.CONFIG.MODEL.BACKBONE_NAME:
        _resample_videomamba(sd, cfg)
    own = model.state_dict()
    sd = {k: v for k, v in sd.items() if not _REFERENCE_ONLY.search(k)}
    counters = [k for k in sd if _BN_COUNTERS.search(k) and k not in own]
    sd = {k: v for k, v in sd.items() if k not in counters}
    fast = _is_fast(cfg)
    kept = [k for k in own
            if fast and k not in sd and _WINDOW_HEADS.search(k)]
    unused = [k for k in sd
              if fast and k not in own and _EXACT_HEADS.search(k)]
    missing = [k for k in own if k not in sd and k not in kept]
    unexpected = [k for k in sd if k not in own and k not in unused]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing}, unexpected {unexpected}")
    # only ``kept`` is left out; a shape that differs raises here
    model.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=False)
    if counters:
        print(f"load_pretrained_params: {len(counters)} batch-norm step "
              f"counters are not loaded: {counters}")
    if kept or unused:
        print(f"load_pretrained_params: the fast encoder's window heads "
              f"{kept} stay at their init; the reference's exact heads "
              f"{unused} are not loaded")
    return counters + kept + unused


def _resample_videomamba(sd: Dict[str, torch.Tensor], cfg) -> None:
    from ..utils.checkpoint_convert import (
        BODY,
        interp_mamba_pos_embed,
        interp_mamba_temporal,
    )

    img = int(cfg.CONFIG.DATA.get("IMG_SIZE", 224))
    for key, fn, size in (
            ("pos_embed", interp_mamba_pos_embed, (img // 16) ** 2),
            ("temporal_pos_embedding", interp_mamba_temporal,
             int(cfg.CONFIG.DATA.TEMP_LEN))):
        if BODY + key in sd:
            sd[BODY + key] = fn(sd[BODY + key], size)


_DONOR = ("transformer.encoder.", "transformer.decoder.",
          "transformer.level_embed", "refpoint_embed.weight")


@torch.no_grad()
def load_detr_weights(model: nn.Module, pretrain_path: str, cfg) -> tuple:
    """Two-stage init: transplant the encoder, decoder, ``level_embed`` and
    ``refpoint_embed`` of a stage-1 reference checkpoint into ``model``
    in place.  ``refpoint_embed`` is reshaped between tube and
    single-frame (the centre frame's anchors, or the anchors tiled over
    the clip); a tensor whose shape still differs is skipped with a
    printed line.  With the fast encoder the window heads stay at their
    init (printed by name); any other donor key the reference lacks
    raises.  Returns (tensors transplanted, skipped), a tensor shared by
    several names (the ConvBlock) counted once."""
    sd = load_torch_state_dict(pretrain_path)
    m = cfg.CONFIG.MODEL
    if "refpoint_embed.weight" in sd:
        v = sd["refpoint_embed.weight"]
        t, nq = m.TEMP_LEN, m.QUERY_NUM
        n = model.refpoint_embed.weight.shape[0]
        if m.SINGLE_FRAME and n < v.shape[0]:
            v = v.reshape(t, nq, 4)[t // 2]
        elif not m.SINGLE_FRAME and n > v.shape[0]:
            v = v[:nq].repeat(t, 1)
        sd["refpoint_embed.weight"] = v
    fast = _is_fast(cfg)
    own = model.state_dict(keep_vars=True)
    kept, missing, seen = [], [], set()
    used = skipped = 0
    for k, p in own.items():
        if not k.startswith(_DONOR):
            continue
        if fast and _WINDOW_HEADS.search(k):
            kept.append(k)
            continue
        if k not in sd:
            missing.append(k)
            continue
        if id(p) in seen:
            continue
        seen.add(id(p))
        v = sd[k]
        if tuple(v.shape) == tuple(p.shape):
            p.copy_(v)
            used += 1
        else:
            print(f"Skip loading parameter {k}: {tuple(v.shape)} vs "
                  f"{tuple(p.shape)}")
            skipped += 1
    if missing:
        raise KeyError(f"{pretrain_path}: the donor lacks {missing}")
    if kept:
        print(f"load_detr_weights: the fast encoder's window heads {kept} "
              f"stay at their init")
    print(f"load_detr_weights: {used} tensors transplanted, {skipped} skipped")
    return used, skipped
