"""SSM / VSS encoder (Mamba path; counterpart of
``class_query_vad_tpu/models/ssm_encoder.py``; the reference's
``MambaEncoderLayer`` / ``VSSMambaEncoderLayer`` / ``GeneralEncoder``).

* each layer compresses d_model -> d_model / 2 (features and positional
  encodings separately), then runs a bidirectional recurrence over the
  frames: frame t's input is LayerNorm(src[t] + out[t - 1]) (plain src[t]
  at the boundary) and the spatial block (a Mamba sequence scan, ``ssm``,
  or a VSSBlock 2-D cross-scan, ``vssm``) runs on input + pos.  Both time
  directions share the one block; the backward direction runs on the
  reversed frames and is flipped back.  The JAX package's ``nn.scan``
  becomes a Python loop over T;
* intermediate layers emit f_src + b_src over all frames; the last layer
  (``return_key``) emits only frame ``key_idx = -1`` and that frame's
  original positional encoding;
* decompress + post-norm ReLU FFN close each layer; its dropouts are
  live in ``train()``;
* with ``remat`` (``CONFIG.GRADIENT_CHECKPOINTING``) each layer is
  recomputed in the backward (``remat_call``; JAX's ``nn.remat`` of
  ``SSMEncoderLayer``, ssm_encoder.py:161-170).

Everything runs in float32 (the JAX encoder is built in float32).
Parameter names follow the reference's (``layers.{i}.ssm_norm``,
``layers.{i}.ssm.*``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import LayerNorm, Linear, remat_call
from .mamba_block import Mamba
from .vss import VSSBlock


class SSMEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 2048,
                 kind: str = "vssm", dropout: float = 0.1):
        super().__init__()
        d_half = d_model // 2
        self.kind = kind
        self.compress = Linear(d_model, d_half)
        self.pos_compress = Linear(d_model, d_half)
        self.ssm_norm = LayerNorm(d_half)
        if kind == "ssm":
            self.ssm = Mamba(d_half, d_state=4, d_conv=2, expand=1, dt_rank=4)
        elif kind == "vssm":
            self.ssm = VSSBlock(d_half, d_half, ssm_d_state=4, mlp_ratio=0.0,
                                post_norm=True)
        else:
            raise ValueError(f"unknown SSM encoder kind {kind!r}")
        self.decompress = Linear(d_half, d_model)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.norm2 = LayerNorm(d_model)

    def _spatial(self, x: torch.Tensor) -> torch.Tensor:
        """The spatial block on one frame [B, H, W, C]."""
        if self.kind == "ssm":
            b, h, w, c = x.shape
            return self.ssm(x.reshape(b, h * w, c)).reshape(b, h, w, c)
        return self.ssm(x)

    def _run(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One direction of the frame recurrence over [B, T, H, W, C]."""
        outs = []
        for t in range(src.shape[1]):
            x_in = src[:, t] if t == 0 else self.ssm_norm(src[:, t] + outs[-1])
            outs.append(self._spatial(x_in + pos[:, t]))
        return torch.stack(outs, dim=1)

    def forward(self, src: torch.Tensor, orig_pos: torch.Tensor,
                shape: Tuple[int, int, int], return_key: bool = False,
                key_idx: int = -1):
        """src, orig_pos [B, T*H*W, C].  Returns the layer's output, or
        (key-frame output [B, H*W, C], its positional encoding) when
        ``return_key``."""
        t, h, w = shape
        b = src.shape[0]
        d_half = self.compress.out_features
        x = self.compress(src).reshape(b, t, h, w, d_half)
        pos = self.pos_compress(orig_pos).reshape(b, t, h, w, d_half)
        f_src = self._run(x, pos)
        b_src = self._run(x.flip(1), pos.flip(1)).flip(1)
        if return_key:
            out = (f_src[:, key_idx] + b_src[:, key_idx]).reshape(b, h * w, d_half)
            key_pos = orig_pos.reshape(b, t, h * w, -1)[:, key_idx]
        else:
            out = (f_src + b_src).reshape(b, t * h * w, d_half)
        out = self.decompress(out)
        y = self.dropout2(self.linear2(self.dropout1(F.relu(self.linear1(out)))))
        out = self.norm2(out + y)
        return (out, key_pos) if return_key else out


class SSMEncoder(nn.Module):
    """N layers; the last collapses to the key frame and returns (memory,
    key_pos)."""

    def __init__(self, num_layers: int = 6, d_model: int = 256,
                 d_ffn: int = 2048, kind: str = "vssm", dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            SSMEncoderLayer(d_model, d_ffn, kind, dropout)
            for _ in range(num_layers))

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                shape: Tuple[int, int, int]):
        out = src
        for layer in self.layers[:-1]:
            out = remat_call(self.remat, layer, out, pos, shape)
        return remat_call(self.remat, self.layers[-1], out, pos, shape, True)
