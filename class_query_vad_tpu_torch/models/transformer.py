"""DAB transformer: encoder, common-grid interpolation, decoder
(counterpart of ``class_query_vad_tpu/models/transformer.py``: the exact
deformable, the fast-attention and the SSM / VSS encoder branches).

* every level gets a learned ``level_embed`` on its positional encoding;
* the encoder output levels are resampled onto the grid of level index -2
  (``make_interpolated_features``: grid_sample on a linspace(-1, 1)
  lattice), whose positional encoding all levels share;
* single-frame (AVA) decoding reads only the centre frame of that common
  grid, a temporal lerp of two encoder frames: with the 2d window the
  encoder never mixes time, so the centre-frame slice (``center_slice_plan``)
  runs the encoder on just those frames — exactly.  On the main path the
  backbone already delivers the sliced frames (``pre_sliced``);
* the SSM / VSS encoders (one level) return the key frame's memory and
  pose, decoded as a single frame;
* the exact deformable encoder (``ENCODER_TYPE: attention``) runs over the
  flattened levels in float32; in single-frame mode only its last layer's
  queries are cut to the rows of the centre-lerp frames (its sampling still
  reads every frame of the layer before), and the decode is the sliced
  one; otherwise (the tube configs) the levels are un-flattened onto the
  common grid.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn

from ..utils.misc import inverse_sigmoid
from .decoder import TransformerDecoder
from .deform_encoder import DeformableEncoder, get_valid_ratio
from .fast_encoder import FastDeformableEncoder, split_levels
from .resize import grid_resize_2d, grid_resize_3d, grid_resize_3d_at_frame

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def make_interpolated_features(
    features: List[torch.Tensor],   # per level [B, T_l, H_l, W_l, C]
    num_frames: int,
    level: int = -2,
    frame: int | None = None,
) -> List[torch.Tensor]:
    """Resample every level onto features[level]'s spatial grid at
    ``num_frames`` temporal extent; ``frame`` computes only that output
    frame (size-1 t axis)."""
    h, w = features[level].shape[2:4]
    out = []
    for feat in features:
        if feat.shape[1] == num_frames:
            # reference quirk: the 2D grid_sample path stacks (meshy,
            # meshx) as the (x, y) grid components, so the map comes out
            # transposed — resample to (w, h) and swap the spatial axes
            src = feat if frame is None else feat[:, frame : frame + 1]
            out.append(grid_resize_2d(src, (w, h)).transpose(-3, -2))
        elif frame is None:
            out.append(grid_resize_3d(feat, (num_frames, h, w)))
        else:
            out.append(grid_resize_3d_at_frame(feat, (num_frames, h, w), frame))
    return out


def center_slice_plan(eff_slice: bool, single_frame: bool, fast_window: str,
                      num_levels: int, temp_len: int, t_l: int):
    """Static centre-frame slice plan (frames, weights, transposed2d) for
    the fast encoder, or None when it does not apply."""
    if not (eff_slice and single_frame and fast_window == "2d"
            and num_levels > 1):
        return None
    if t_l == 1:
        return None
    f = temp_len // 2
    if t_l == temp_len:
        return (f,), (1.0,), True
    g = 0.0 if temp_len == 1 else -1.0 + 2.0 * f / (temp_len - 1)
    c = ((g + 1.0) * t_l - 1.0) / 2.0
    i0 = int(math.floor(c))
    frac = c - i0
    i1 = i0 + 1
    w0 = (1.0 - frac) * (1.0 if 0 <= i0 < t_l else 0.0)
    w1 = frac * (1.0 if 0 <= i1 < t_l else 0.0)
    i0c = min(max(i0, 0), t_l - 1)
    i1c = min(max(i1, 0), t_l - 1)
    return (i0c, i1c), (w0, w1), False


def center_planes(mem_levels, fweights, transposed2d: bool, i0: int, i1: int):
    """Centre-frame planes of every level [B, n_frames, H_l, W_l, C] on the
    ref level's grid: frames i0 and i1 lerped by ``fweights``, or frame 0
    through the transposed 2-D resample."""
    ref_lvl = len(mem_levels) - 2
    h, w = mem_levels[ref_lvl].shape[2:4]
    outs = []
    for m in mem_levels:
        if transposed2d:
            outs.append(grid_resize_2d(m[:, 0:1], (w, h)).transpose(-3, -2))
        else:
            # lerp in float32, as the JAX package's float32 weights promote
            # it (a 0-dim float32 tensor would leave bf16 in bf16)
            plane = (m[:, i0 : i0 + 1].float() * fweights[0]
                     + m[:, i1 : i1 + 1].float() * fweights[1])
            outs.append(grid_resize_2d(plane, (h, w)))
    return outs


class DABTransformer(nn.Module):
    def __init__(self, spec):
        super().__init__()
        s = self.spec = spec
        self.level_embed = nn.Parameter(
            torch.zeros(s.num_feature_levels, s.d_model))
        if s.encoder_type == "attention":
            self.encoder = DeformableEncoder(
                s.enc_layers, s.d_model, s.dim_feedforward,
                s.num_feature_levels, s.nhead, s.enc_n_points, s.dropout,
                s.gradient_checkpointing)
        elif s.encoder_type == "fast_attention":
            self.encoder = FastDeformableEncoder(
                s.enc_layers, s.d_model, s.dim_feedforward,
                s.num_feature_levels, s.nhead, s.enc_n_points, s.fast_radius,
                s.fast_window, s.fast_cross_level, s.dropout,
                s.fast_use_pallas, s.gradient_checkpointing,
            )
        elif s.encoder_type in ("ssm", "vssm"):
            from .ssm_encoder import SSMEncoder

            self.encoder = SSMEncoder(s.enc_layers, s.d_model,
                                      s.dim_feedforward, s.encoder_type,
                                      s.dropout, s.gradient_checkpointing)
        else:
            raise ValueError(f"unknown ENCODER_TYPE={s.encoder_type}")
        self.decoder = TransformerDecoder(
            s.dec_layers, s.d_model, s.nhead, s.dim_feedforward,
            s.num_classes, query_dim=4,
            bbox_embed_diff_each_layer=s.bbox_embed_diff_each_layer,
            n_levels=s.num_feature_levels, dropout=s.dropout,
            remat=s.gradient_checkpointing,
        )

    def forward(self, srcs, masks, poses, refpoint_embed, pre_sliced=None):
        """srcs/poses per level [B, T_l, H_l, W_l, C], masks [B, T_l, H_l,
        W_l] (True = pad), refpoint_embed [NQ, TQ, 4].  ``pre_sliced`` =
        (orig_t_l, pos_dec): the levels arrive already centre-sliced by the
        backbone, and pos_dec is the ref level's sine pose at the decode
        frame.  Returns (hs, cls_hs, references)."""
        s = self.spec
        if s.encoder_type in ("ssm", "vssm"):
            return self._ssm_forward(srcs, masks, poses, refpoint_embed)
        if s.encoder_type == "attention":
            return self._exact_forward(srcs, masks, poses, refpoint_embed)
        fdt = torch_dtype(s.fast_dtype)
        shapes = tuple(tuple(x.shape[1:4]) for x in srcs)
        if pre_sliced is not None:
            orig_t, pos_dec = pre_sliced
            plan = center_slice_plan(s.fast_eff_slice, s.single_frame,
                                     s.fast_window, s.num_feature_levels,
                                     s.temp_len, orig_t)
            assert plan is not None, "pre_sliced inputs without a plan"
            assert srcs[0].shape[1] == len(set(plan[0])), (
                "pre-sliced srcs do not match the slice plan")
            srcs_e, poses_e, masks_e = srcs, poses, masks
        else:
            plan = None
            if len(shapes) > 1 and len({x[0] for x in shapes}) == 1:
                plan = center_slice_plan(s.fast_eff_slice, s.single_frame,
                                         s.fast_window, s.num_feature_levels,
                                         s.temp_len, shapes[0][0])
            if plan is not None:
                idx = torch.tensor(plan[0], device=srcs[0].device)
                take = lambda x: x.index_select(1, idx)
                srcs_e = [take(x) for x in srcs]
                poses_e = [take(p) for p in poses]
                masks_e = [take(m) for m in masks]
            else:
                srcs_e, poses_e, masks_e = srcs, poses, masks

        pos_levels = [(p + self.level_embed[l]).to(fdt)
                      for l, p in enumerate(poses_e)]
        mem_levels = self.encoder([x.to(fdt) for x in srcs_e], pos_levels,
                                  masks_e)
        # hand off in the decoder's serving dtype
        hdt = torch.promote_types(torch_dtype(s.decoder_dtype), fdt)
        mem_levels = [m.to(hdt) for m in mem_levels]
        if plan is not None:
            if pre_sliced is not None:
                return self._center_frame_decode_presliced(
                    mem_levels, masks, refpoint_embed, plan, pos_dec, fdt, hdt)
            return self._center_frame_decode(
                mem_levels, poses, masks, shapes, refpoint_embed, plan,
                fdt, hdt)
        pos_levels = [p.to(hdt) for p in pos_levels]
        return self._common_grid_decode(mem_levels, pos_levels, masks,
                                        shapes, refpoint_embed)

    def _ssm_forward(self, srcs, masks, poses, refpoint_embed):
        """SSM / VSS encoder path (JAX ``transformer.py:246-272``): the
        levels flattened with ``level_embed`` on their poses, the encoder
        in float32 collapsing to the key frame (the last), and the decoder
        on that one frame (T = 1)."""
        b, d = srcs[0].shape[0], self.spec.d_model
        src_flat = torch.cat([x.reshape(b, -1, d) for x in srcs], 1).float()
        pos_flat = torch.cat([p.reshape(b, -1, d) + self.level_embed[l]
                              for l, p in enumerate(poses)], 1).float()
        memory, key_pos = self.encoder(src_flat, pos_flat,
                                       tuple(srcs[0].shape[1:4]))
        h0, w0 = srcs[0].shape[2:4]
        return self._decode([memory.reshape(b, 1, h0, w0, d)],
                            key_pos.reshape(b, 1, h0, w0, d),
                            masks[0][:, :1], refpoint_embed)

    def _exact_forward(self, srcs, masks, poses, refpoint_embed):
        """Exact deformable encoder path (JAX ``transformer.py:246-341``):
        levels, masks and poses (plus ``level_embed``) flattened in
        float32, the valid ratios, then either the last-layer query slice
        with the sliced centre-frame decode (single frame, levels of one T:
        ``center_slice_plan`` with the window forced to "2d", since only
        the last layer's queries are cut), or the common-grid decode."""
        s = self.spec
        b, d = srcs[0].shape[0], s.d_model
        shapes = tuple(tuple(x.shape[1:4]) for x in srcs)
        src_flat = torch.cat([x.reshape(b, -1, d) for x in srcs], 1).float()
        mask_flat = torch.cat([m.reshape(b, -1) for m in masks], 1)
        pos_flat = torch.cat([p.reshape(b, -1, d) + self.level_embed[l]
                              for l, p in enumerate(poses)], 1).float()
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks], 1)
        plan = None
        if (s.single_frame and len(shapes) > 1
                and len({x[0] for x in shapes}) == 1):
            plan = center_slice_plan(s.fast_eff_slice, True, "2d",
                                     s.num_feature_levels, s.temp_len,
                                     shapes[0][0])
        if plan is None:
            memory = self.encoder(src_flat, shapes, valid_ratios, pos_flat,
                                  mask_flat)
            return self._common_grid_decode(
                split_levels(memory, shapes), split_levels(pos_flat, shapes),
                masks, shapes, refpoint_embed)
        uniq = sorted(set(plan[0]))
        rows, start = [], 0
        for t, h, w in shapes:
            rows.append((start + uniq[0] * h * w,
                         start + (uniq[-1] + 1) * h * w))
            start += t * h * w
        memory = self.encoder(src_flat, shapes, valid_ratios, pos_flat,
                              mask_flat, last_layer_rows=tuple(rows))
        mem_levels = split_levels(
            memory, tuple((len(uniq), h, w) for _, h, w in shapes))
        ref_lvl = len(shapes) - 2
        fdec = (s.temp_len // 2) % shapes[ref_lvl][0]
        pos_dec = poses[ref_lvl][:, fdec : fdec + 1].float()
        return self._center_frame_decode_presliced(
            mem_levels, masks, refpoint_embed, plan, pos_dec, torch.float32,
            torch.float32)

    def _center_frame_decode(self, mem_levels, poses, masks, shapes,
                             refpoint_embed, plan, fdt, hdt):
        frames, fweights, transposed2d = plan
        ref_lvl = len(shapes) - 2
        t_l = shapes[ref_lvl][0]
        f = self.spec.temp_len // 2
        outs = center_planes(mem_levels, fweights, transposed2d, 0, 1)
        pos_common = ((poses[ref_lvl] + self.level_embed[ref_lvl]).to(fdt)
                      .to(hdt)[:, f % t_l : f % t_l + 1])
        mask_common = masks[ref_lvl][:, f % t_l : f % t_l + 1]
        return self._decode(outs, pos_common, mask_common, refpoint_embed)

    def _center_frame_decode_presliced(self, mem_levels, masks,
                                       refpoint_embed, plan, pos_dec, fdt,
                                       hdt):
        frames, fweights, transposed2d = plan
        uniq = sorted(set(frames))
        i0 = uniq.index(frames[0])
        i1 = uniq.index(frames[-1])
        outs = center_planes(mem_levels, fweights, transposed2d, i0, i1)
        ref_lvl = len(mem_levels) - 2
        pos_common = (pos_dec + self.level_embed[ref_lvl]).to(fdt).to(hdt)
        # level masks are time-replicated: any retained frame's mask is
        # the decode frame's
        mask_common = masks[ref_lvl][:, 0:1]
        return self._decode(outs, pos_common, mask_common, refpoint_embed)

    def _common_grid_decode(self, mem_levels, pos_levels, masks, shapes,
                            refpoint_embed):
        s = self.spec
        if s.num_feature_levels > 1:
            ref_lvl = len(shapes) - 2
            t_l = shapes[ref_lvl][0]
            if s.single_frame:
                f = s.temp_len // 2
                mem_levels = make_interpolated_features(
                    mem_levels, s.temp_len, frame=f)
                pos_common = pos_levels[ref_lvl][:, f % t_l : f % t_l + 1]
                mask_common = masks[ref_lvl][:, f % t_l : f % t_l + 1]
            else:
                mem_levels = make_interpolated_features(mem_levels, s.temp_len)
                reps = s.temp_len // t_l
                pos_common = pos_levels[ref_lvl].repeat(1, reps, 1, 1, 1)
                mask_common = masks[ref_lvl].repeat(1, reps, 1, 1)
        else:
            pos_common, mask_common = pos_levels[0], masks[0]
        return self._decode(mem_levels, pos_common, mask_common,
                            refpoint_embed)

    def _decode(self, mem_levels, pos_common, mask_common, refpoint_embed):
        s = self.spec
        d = s.d_model
        b = mem_levels[0].shape[0]
        t, h, w = mem_levels[0].shape[1:4]
        ddt = torch_dtype(s.decoder_dtype)
        mem = torch.stack([m.to(ddt) for m in mem_levels], dim=1)  # [B,L,T,H,W,C]
        pos_common = pos_common.to(ddt)
        if s.single_frame:
            mem = mem[:, :, t // 2 : t // 2 + 1]
            pos_common = pos_common[:, t // 2 : t // 2 + 1]
            mask_common = mask_common[:, t // 2 : t // 2 + 1]
            t_dec = 1
        else:
            t_dec = t
        nlev = mem.shape[1]
        # [B, L, T, H, W, C] -> [B*T, L, HW, C] (b-major, t-minor batch)
        mem = mem.transpose(1, 2).reshape(b * t_dec, nlev, h * w, d)
        pos_dec = pos_common.reshape(b, t_dec, 1, h * w, d).expand(
            b, t_dec, nlev, h * w, d).reshape(b * t_dec, nlev, h * w, d)
        mask_dec = mask_common.reshape(b * t_dec, h * w)
        nq, tq = refpoint_embed.shape[:2]
        refs = refpoint_embed[None].expand(b, nq, tq, 4).transpose(1, 2)
        refs = refs.reshape(b * tq, nq, 4)
        tgt = torch.zeros((b * t_dec, nq, d), dtype=ddt, device=mem.device)
        return self.decoder(tgt, mem, mask_dec, pos_dec, refs, (h, w))

    def decode_boxes(self, hs: torch.Tensor, references: torch.Tensor) -> torch.Tensor:
        """coord[l] = sigmoid(bbox_embed(hs[l]) + inverse_sigmoid(ref[l]))."""
        ref = inverse_sigmoid(references)
        if self.spec.bbox_embed_diff_each_layer:
            return torch.stack([
                torch.sigmoid(self.decoder.run_bbox_embed(l, hs[l])[..., :4]
                              + ref[l])
                for l in range(hs.shape[0])])
        return torch.sigmoid(self.decoder.run_bbox_embed(0, hs)[..., :4] + ref)
