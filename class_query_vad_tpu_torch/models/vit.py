"""VideoMAE-style ViT-B video backbone (counterpart of
``class_query_vad_tpu/models/vit.py``).

* 3D tubelet patch embed, kernel = stride = (tubelet, patch, patch),
  computed as one matmul over the unfolded patches (exactly the conv);
* fixed sinusoid position table, bicubically re-interpolated per frame
  when the token grid differs from the pretrain grid;
* pre-norm blocks with joint space-time attention, fused qkv with q/v-only
  bias (k has none), LayerNorm eps 1e-6, exact GELU;
* ``out_frame_range`` restricts the LAST block's queries to those token
  frames (keys/values still read every token): exact, because its other
  rows have no consumer downstream.

Attention is plain torch ops, not ``scaled_dot_product_attention``: the
JAX package's softmax is kept as written — scores in the compute dtype,
exp and the row sum in float32, the exp rounded back to the compute dtype,
then ``e / s`` in the compute dtype.  In bf16 that rounds the scores, the
exp and the quotient to bf16 (about 3 significant digits) where a fused
attention kernel would keep them in float32.

Key names follow the reference's torch ViT (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``.q_bias``, ``.v_bias``, ``mlp.fc1``...).

Training (``train()`` mode): drop path on both residual branches at rates
rising linearly over the blocks, ``drop_path_rate * i / (depth - 1)``
(vit.py:212-214); with ``use_checkpoint`` or ``CONFIG.GRADIENT_CHECKPOINTING``
(the JAX package remats on either, backbone.py:149) each block is
recomputed in the backward (``torch.utils.checkpoint``, the JAX package's
``nn.remat`` of ``ViTBlock``, vit.py:209-210), which replays the
drop-path draws.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import DropPath, LayerNorm, Linear, remat_call
from .position_encoding import vit_sinusoid_table
from .resize import bicubic_resize_2d


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, tubelet: int, patch: int):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, (tubelet, patch, patch),
                              stride=(tubelet, patch, patch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x [B, T, H, W, C] -> [B, t, h, w, D]; kernel == stride, so the
        # conv is a matmul over non-overlapping (C, kt, kh, kw) patches
        w = self.proj.weight
        o, c, kt, kh, kw = w.shape
        b, T, H, W, _ = x.shape
        t, h, wd = T // kt, H // kh, W // kw
        x = x.to(w.dtype).reshape(b, t, kt, h, kh, wd, kw, c)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, t, h, wd, -1)
        return F.linear(x, w.reshape(o, -1), self.proj.bias)


class Attention(nn.Module):
    """Joint space-time attention with fused qkv and q/v-only bias."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None):
        # x [B, Nq, C] queries; kv [B, N, C] key/value tokens or None.  The
        # split path uses column slices of the same qkv weight.
        b, nq, c = x.shape
        nh, hd = self.num_heads, self.dim // self.num_heads
        w = self.qkv.weight                       # [3C, C]
        dt = w.dtype
        bias = None
        if self.q_bias is not None:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias),
                              self.v_bias])
        if kv is None:
            qkv = F.linear(x.to(dt), w, bias)
            q, k, v = qkv.reshape(b, nq, 3, nh, hd).unbind(2)
        else:
            q = F.linear(x.to(dt), w[: self.dim],
                         None if bias is None else bias[: self.dim])
            kvm = F.linear(kv.to(dt), w[self.dim :],
                           None if bias is None else bias[self.dim :])
            q = q.reshape(b, nq, nh, hd)
            k, v = kvm.reshape(b, kv.shape[1], 2, nh, hd).unbind(2)
        return self.proj(eager_attention(q, k, v, hd ** -0.5))


def eager_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax((q * scale) k^T) v per head in the inputs' dtype (the JAX
    package's einsum attention, vit.py:84-90): q [B, Nq, H, D], k and v
    [B, N, H, D] -> [B, Nq, H*D]."""
    b, nq, h, d = q.shape
    q = (q * scale).transpose(1, 2)               # [B, H, Nq, D]
    attn = softmax(q @ k.permute(0, 2, 3, 1))     # [B, H, Nq, N]
    return (attn @ v.transpose(1, 2)).transpose(1, 2).reshape(b, nq, h * d)


def softmax(scores: torch.Tensor) -> torch.Tensor:
    """Row softmax as the JAX package writes it (vit.py:107-115): the max
    subtracted in the scores' dtype, exp in float32 rounded back to that
    dtype, the row sum in float32 rounded to it, then ``e / s``.  torch's
    exp of a bf16 tensor computes in float32 and rounds once, so no
    float32 copy of the [B, H, Nq, N] scores is made."""
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True).detach())
    s = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
    return e / s.to(scores.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))     # exact (erf) GELU


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, q_rows=None) -> torch.Tensor:
        # q_rows=(start, stop): restrict this block's queries (and so its
        # whole output) to token rows [start:stop); k/v read every token
        y = self.norm1(x)
        if q_rows is None:
            y = self.attn(y)
        else:
            x = x[:, q_rows[0] : q_rows[1]]
            y = self.attn(y[:, q_rows[0] : q_rows[1]], kv=y)
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class ViT(nn.Module):
    """ViT backbone.  Input [B, T, H, W, 3] -> token map [B, t, h, w, C]."""

    def __init__(self, spec, gradient_checkpointing: bool = False):
        super().__init__()
        self.spec = spec
        # JAX remats the blocks on either flag (backbone.py:149)
        self.remat = gradient_checkpointing or spec.use_checkpoint
        d = spec.embed_dim
        self.patch_embed = PatchEmbed(3, d, spec.tubelet_size, spec.patch_size)
        rates = [spec.drop_path_rate * i / max(spec.depth - 1, 1)
                 for i in range(spec.depth)]
        self.blocks = nn.ModuleList(
            Block(d, spec.num_heads, spec.mlp_ratio, spec.qkv_bias, rate)
            for rate in rates
        )
        self.norm = LayerNorm(d)

    def pos_table(self, h: int, w: int, device) -> torch.Tensor:
        """[t0, h, w, C] float32 sinusoid table on the runtime token grid."""
        s = self.spec
        grid = s.pretrain_img_size // s.patch_size
        t0 = s.num_frames // s.tubelet_size
        table = vit_sinusoid_table(t0 * grid * grid, s.embed_dim, device)
        pos = table.reshape(t0, grid, grid, s.embed_dim)
        if (h, w) != (grid, grid):
            pos = bicubic_resize_2d(pos, (h, w))
        return pos

    def forward(self, x: torch.Tensor, out_frame_range=None) -> torch.Tensor:
        x = self.patch_embed(x)                                 # [B,t,h,w,C]
        b, t, h, w, c = x.shape
        x = x + self.pos_table(h, w, x.device).to(x.dtype)[None]
        x = x.reshape(b, t * h * w, c)
        q_rows, n_frames = None, t
        if out_frame_range is not None:
            f0, f1 = out_frame_range
            q_rows = (f0 * h * w, f1 * h * w)       # token rows are t-major
            n_frames = f1 - f0
        last = len(self.blocks) - 1
        for i, blk in enumerate(self.blocks):
            x = remat_call(self.remat, blk, x, q_rows if i == last else None)
        x = self.norm(x)
        return x.reshape(b, n_frames, h, w, c)
