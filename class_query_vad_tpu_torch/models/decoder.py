"""DAB-DETR decoder with the dual-branch layer pair (counterpart of
``class_query_vad_tpu/models/decoder.py``).

* ``LocDecoderLayer`` — query self-attention, softmax level mixing into a
  query-specific memory, and the concat-key cross-attention decomposed
  into a content term plus a positional term whose key side is shared
  across queries;
* ``ClsDecoderLayer`` — actor feature (detached) on the query-specific
  memory, ONE ConvBlock applied 3x (the reference registers the same
  module object three times, so ``conv_blocks.{0,1,2}`` share weights),
  class-query self-attention, cross-attention of the per-class queries
  against the conv features.

Layouts are batch-first: queries [BT, NQ, C], memory [BT, L, HW, C],
class state [BT*NQ, NC, C].  bf16 serving mode (``DECODER_DTYPE``):
the layers compute in the decoder dtype, while the sine embeds, the
query-scale / ref-point / anchor / box MLPs (iterative box refinement)
and every attention softmax stay float32.

Dropout as in the JAX package, active in ``train()`` mode: on the
attention weights of every attention (decoder.py:79, 115) and on the
layers' residual branches and FFN activations (:195-240, :292-353).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.misc import inverse_sigmoid
from .common import (MLP, LayerNorm, Linear, remat_call,
                     sine_embed_for_position)


def masked_softmax(logits: torch.Tensor, key_mask: torch.Tensor | None):
    """Max-subtracted float32 softmax over the last axis; key_mask True =
    ignore, broadcastable to logits."""
    logits = logits.float()
    if key_mask is not None:
        logits = logits.masked_fill(key_mask, float("-inf"))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    return torch.softmax(logits, dim=-1)


class ProjFreeMHA(nn.Module):
    """Multi-head attention on caller-projected q/k/v; owns only the output
    projection.  ``logits`` [B, nh, Lq, Lk] (already scaled) replaces the
    q.k dot when given."""

    def __init__(self, embed_dim: int, num_heads: int, vdim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.embed_dim, self.num_heads, self.vdim = embed_dim, num_heads, vdim
        self.attn_drop = nn.Dropout(dropout)
        self.out_proj = Linear(vdim, vdim)

    def forward(self, q, k, v, key_padding_mask=None, logits=None):
        nh = self.num_heads
        if logits is None:
            b, lq, _ = q.shape
            hd = self.embed_dim // nh
            qh = (q * float(hd) ** -0.5).reshape(b, lq, nh, hd)
            kh = k.reshape(b, -1, nh, hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
        else:
            b, lq = logits.shape[0], logits.shape[2]
        vh = v.reshape(b, -1, nh, self.vdim // nh)
        mask = (None if key_padding_mask is None
                else key_padding_mask[:, None, None, :])
        attn = self.attn_drop(masked_softmax(logits, mask).to(v.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, lq, self.vdim)
        return self.out_proj(out)


class QuerySpecificMHA(nn.Module):
    """Concat-key attention whose values carry a per-query axis, from
    caller-computed logits [B, nh, NQ, S]: v [B, NQ, S, V] -> [B, NQ, V]."""

    def __init__(self, embed_dim: int, num_heads: int, vdim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.vdim = num_heads, vdim
        self.attn_drop = nn.Dropout(dropout)
        self.out_proj = Linear(vdim, vdim)

    def forward(self, v, logits, key_padding_mask=None):
        nh = self.num_heads
        b, nq = logits.shape[0], logits.shape[2]
        vh = v.reshape(b, nq, -1, nh, self.vdim // nh)
        mask = (None if key_padding_mask is None
                else key_padding_mask[:, None, None, :])
        attn = self.attn_drop(masked_softmax(logits, mask).to(v.dtype))
        out = torch.einsum("bhqs,bqshd->bqhd", attn, vh).reshape(b, nq, self.vdim)
        return self.out_proj(out)


class ConvBlock(nn.Module):
    """3x3 conv + LayerNorm + pointwise MLP residual block, [N, H, W, C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.norm = LayerNorm(dim)
        self.conv2 = Linear(dim, 4 * dim)
        self.conv3 = Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv1.weight
        y = F.conv2d(x.to(w.dtype).permute(0, 3, 1, 2), w, self.conv1.bias,
                     padding=1).permute(0, 2, 3, 1)
        y = self.conv3(F.gelu(self.conv2(self.norm(y))))    # exact GELU
        return x + y


class PointConv2d(nn.Conv2d):
    """1x1 Conv2d (the reference's k/v projections) applied as a matmul on
    channels-last input."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(in_dim, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return F.linear(x.to(w.dtype), w.reshape(w.shape[0], -1), self.bias)


class LocDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, n_levels: int = 4,
                 has_query_pos_proj: bool = True, dropout: float = 0.1):
        super().__init__()
        d = d_model
        self.nhead = nhead
        # one module for the five dropout sites, as the JAX layer's ``drop``
        self.drop = nn.Dropout(dropout)
        self.sa_qcontent_proj = Linear(d, d)
        self.sa_qpos_proj = Linear(d, d)
        self.sa_kcontent_proj = Linear(d, d)
        self.sa_kpos_proj = Linear(d, d)
        self.sa_v_proj = Linear(d, d)
        self.self_attn = ProjFreeMHA(d, nhead, d, dropout)
        self.norm1 = LayerNorm(d)
        self.lvl_w_embed = Linear(d, n_levels)
        self.ca_qcontent_proj = Linear(d, d)
        # the reference keeps the query-pos projection of the first layer
        # only (keep_query_pos=False)
        self.ca_qpos_proj = Linear(d, d) if has_query_pos_proj else None
        self.ca_kcontent_proj = Linear(d, d)
        self.ca_kpos_proj = Linear(d, d)
        self.ca_v_proj = Linear(d, d)
        self.ca_qpos_sine_proj = Linear(d, d)
        self.cross_attn = QuerySpecificMHA(2 * d, nhead, d, dropout)
        self.norm_ = LayerNorm(d)
        self.linear1 = Linear(d, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d)
        self.norm2 = LayerNorm(d)
        self.norm3 = LayerNorm(d)

    def forward(self, tgt, memory, memory_key_padding_mask, pos, query_pos,
                query_sine_embed, is_first: bool):
        bt, nq, d = tgt.shape
        nh = self.nhead
        hd = d // nh

        # self attention over queries
        q = self.sa_qcontent_proj(tgt) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(tgt) + self.sa_kpos_proj(query_pos)
        v = self.sa_v_proj(tgt)
        tgt = self.norm1(tgt + self.drop(self.self_attn(q, k, v)))

        # level mixing -> query-specific memory [BT, NQ, HW, C]
        lvl_w = torch.softmax(self.lvl_w_embed(tgt), dim=-1)
        q_memory = self.norm_(torch.einsum("bnl,blsc->bnsc", lvl_w, memory))

        # concat-key cross attention, decomposed: the q.k dot over the
        # [content | sine] 2*hd head splits into a content term and a
        # positional term whose key side is shared across queries
        q_content = self.ca_qcontent_proj(tgt)
        k_content = self.ca_kcontent_proj(q_memory)
        v_mem = self.ca_v_proj(q_memory)
        k_pos = self.ca_kpos_proj(pos[:, 0])                    # [BT, HW, C]
        if is_first:
            q_content = q_content + self.ca_qpos_proj(query_pos)
            k_content = k_content + k_pos[:, None]
        qse = self.ca_qpos_sine_proj(query_sine_embed)
        hw = k_content.shape[2]
        scale = float(2 * hd) ** -0.5
        logits = torch.einsum(
            "bqhd,bqshd->bhqs",
            (q_content * scale).reshape(bt, nq, nh, hd),
            k_content.reshape(bt, nq, hw, nh, hd),
        ) + torch.einsum(
            "bqhd,bshd->bhqs",
            (qse * scale).reshape(bt, nq, nh, hd),
            k_pos.reshape(bt, hw, nh, hd),
        )
        tgt2 = self.cross_attn(v_mem, logits, memory_key_padding_mask)
        tgt = self.norm2(tgt + self.drop(tgt2))
        tgt_temp = tgt

        # FFN
        tgt2 = self.linear2(self.drop(F.relu(self.linear1(tgt))))
        tgt = self.norm3(tgt + self.drop(tgt2))
        return tgt, tgt_temp, q_memory


class ClsDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, num_conv_blocks: int = 3,
                 dropout: float = 0.1):
        super().__init__()
        d = d_model
        self.nhead = nhead
        self.drop = nn.Dropout(dropout)
        self.cls_linear1 = Linear(d, dim_feedforward)
        self.cls_linear2 = Linear(dim_feedforward, d)
        self.cls_norm = LayerNorm(d)
        self.conv_norm = LayerNorm(d)
        block = ConvBlock(d)
        self.conv_blocks = nn.ModuleList([block] * num_conv_blocks)
        self.self_attn = ProjFreeMHA(d, nhead, d, dropout)
        self.norm1 = LayerNorm(d)
        self.k_proj = PointConv2d(d, d)
        self.v_proj = PointConv2d(d, d)
        self.cls_qpos_sine_proj = Linear(d, d)
        self.cross_attn = ProjFreeMHA(2 * d, nhead, d, dropout)
        self.cls_linear1_ = Linear(d, dim_feedforward)
        self.cls_linear2_ = Linear(dim_feedforward, d)
        self.cls_norm_ = LayerNorm(d)

    def forward(self, actor_feature, q_memory, pos0, query_sine_embed,
                class_queries, orig_res: Tuple[int, int], is_first: bool):
        bt, nq, d = actor_feature.shape
        h, w = orig_res
        hw = h * w

        af2 = self.cls_linear2(self.drop(F.relu(self.cls_linear1(actor_feature))))
        actor_feature = self.cls_norm(actor_feature + self.drop(af2))

        # actor-centric conv features on the level grid
        cls_feature = self.conv_norm(actor_feature[:, :, None, :] + q_memory)
        cls_feature = cls_feature.reshape(bt * nq, h, w, d)
        for blk in self.conv_blocks:
            cls_feature = blk(cls_feature)
        cls_feature = cls_feature.reshape(bt, nq, hw, d)

        # class-query self-attention (batch BT*NQ, sequence NC)
        if is_first:
            nc = class_queries.shape[0]
            query = class_queries[None].expand(bt * nq, nc, d)
        else:
            query = class_queries
            nc = query.shape[1]
        query = self.norm1(query + self.drop(self.self_attn(query, query, query)))

        # cross-attention against actor-conditioned conv features: the
        # whole-lane [content | pos] concat puts content in heads
        # [0, nh/2) and position in heads [nh/2, nh); the positional logits
        # are class-independent, computed once per (batch, actor)
        nh = self.nhead
        hd2 = 2 * d // nh
        nhh = nh // 2
        scale = float(hd2) ** -0.5
        kc = self.k_proj(cls_feature).reshape(bt * nq, hw, nhh, hd2)
        logits_c = torch.einsum(
            "bqhd,bshd->bhqs", (query * scale).reshape(bt * nq, nc, nhh, hd2), kc)
        qp = self.cls_qpos_sine_proj(query_sine_embed)          # [BT, NQ, C]
        logits_p = torch.einsum(
            "bnhd,bshd->bnhs",
            (qp * scale).reshape(bt, nq, nhh, hd2),
            pos0.reshape(bt, hw, nhh, hd2),
        ).reshape(bt * nq, nhh, 1, hw).expand(bt * nq, nhh, nc, hw)
        logits = torch.cat([logits_c, logits_p], dim=1)
        value = self.v_proj(q_memory).reshape(bt * nq, hw, d)
        cls_out = self.cross_attn(None, None, value, logits=logits)

        co2 = self.cls_linear2_(self.drop(F.relu(self.cls_linear1_(cls_out))))
        cls_out = self.cls_norm_(cls_out + self.drop(co2))
        return cls_out.reshape(bt, nq, nc, d), cls_out


class TransformerDecoder(nn.Module):
    """Per layer: DAB anchor sine embed, query-scale transformation,
    modulated HW attention, the loc/cls pair, and iterative box refinement
    with a detached reference update."""

    def __init__(self, num_layers: int = 6, d_model: int = 256,
                 nhead: int = 8, dim_feedforward: int = 2048,
                 num_classes: int = 80, query_dim: int = 4,
                 bbox_embed_diff_each_layer: bool = False,
                 n_levels: int = 4, dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        d = d_model
        self.num_layers, self.d_model, self.query_dim = num_layers, d, query_dim
        self.bbox_embed_diff_each_layer = bbox_embed_diff_each_layer
        self.layers = nn.ModuleList(
            LocDecoderLayer(d, nhead, dim_feedforward, n_levels,
                            has_query_pos_proj=(i == 0), dropout=dropout)
            for i in range(num_layers)
        )
        self.cls_layers = nn.ModuleList(
            ClsDecoderLayer(d, nhead, dim_feedforward, dropout=dropout)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(d)
        self.cls_norm2 = LayerNorm(d)
        # float32 islands whatever the serving dtype
        self.query_scale = MLP(d, d, d, 2) if num_layers > 1 else None
        self.ref_point_head = MLP(2 * d, d, d, 2)
        self.ref_anchor_head = MLP(d, d, 2, 2)
        if bbox_embed_diff_each_layer:
            self.bbox_embed = nn.ModuleList(
                MLP(d, d, 4, 3) for _ in range(num_layers))
        else:
            self.bbox_embed = MLP(d, d, 4, 3)
        self.class_queries = nn.Embedding(num_classes, d)

    def run_bbox_embed(self, layer_id: int, x: torch.Tensor) -> torch.Tensor:
        if self.bbox_embed_diff_each_layer:
            return self.bbox_embed[layer_id](x)
        return self.bbox_embed(x)

    def forward(self, tgt, memory, memory_key_padding_mask, pos,
                refpoints_unsigmoid, orig_res: Tuple[int, int]):
        d = self.d_model
        output = tgt
        reference_points = torch.sigmoid(refpoints_unsigmoid.float())
        ref_points = [reference_points]
        class_queries = self.class_queries.weight

        intermediate, cls_intermediate = [], []
        for layer_id in range(self.num_layers):
            obj_center = reference_points[..., : self.query_dim]
            query_sine_embed_full = sine_embed_for_position(obj_center, d // 2)
            query_pos = self.ref_point_head(query_sine_embed_full)
            query_sine_embed = query_sine_embed_full[..., :d]
            if layer_id > 0:
                query_sine_embed = query_sine_embed * self.query_scale(output)
            # modulated HW attention
            ref_hw = torch.sigmoid(self.ref_anchor_head(output))   # [BT,NQ,2]
            scale_x = (ref_hw[..., 0] / obj_center[..., 2])[..., None]
            scale_y = (ref_hw[..., 1] / obj_center[..., 3])[..., None]
            query_sine_embed = torch.cat(
                [query_sine_embed[..., : d // 2] * scale_y,
                 query_sine_embed[..., d // 2:] * scale_x], dim=-1)

            output, actor_feature, q_memory = remat_call(
                self.remat, self.layers[layer_id], output, memory,
                memory_key_padding_mask, pos, query_pos, query_sine_embed,
                layer_id == 0)
            cls_output, class_queries = remat_call(
                self.remat, self.cls_layers[layer_id],
                actor_feature.detach(), q_memory, pos[:, 0],
                query_sine_embed, class_queries, orig_res, layer_id == 0)

            # iterative box refinement (detached reference update)
            tmp = self.run_bbox_embed(layer_id, output)
            new_reference_points = torch.sigmoid(
                tmp[..., : self.query_dim] + inverse_sigmoid(reference_points))
            if layer_id != self.num_layers - 1:
                ref_points.append(new_reference_points)
            reference_points = new_reference_points.detach()

            intermediate.append(self.norm(output))
            cls_intermediate.append(self.cls_norm2(cls_output))

        hs = torch.stack(intermediate)             # [NL, BT, NQ, C]
        cls_hs = torch.stack(cls_intermediate)     # [NL, BT, NQ, NC, C]
        references = torch.stack(ref_points)       # [NL, BT, NQ, 4]
        return hs, cls_hs, references
