"""DETR top module and ``build_model`` (counterpart of
``class_query_vad_tpu/models/detr.py``: the ViT branch, and the VideoMamba
branch in eval mode).

backbone -> transformer -> heads: learned anchors ``refpoint_embed``
[NQ, 4] (single-frame AVA), the binary actorness head ``class_embed_b``
(Linear(d, 3)), class logits = the MEAN over the feature axis of the
class-query outputs, and the box head shared with the decoder's iterative
refinement, in float32.  Outputs [B, NQ, ...] plus per-layer
``aux_outputs``.

Training and evaluation follow torch's ``train()`` / ``eval()`` (the JAX
package's ``deterministic`` flag): ``train()`` turns on the dropouts, the
ViT's drop path and checkpointing, and the class head's dropout (rate 0.5
on the class-query outputs, detr.py:126).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from ..ops.deform_attn import (
    directional_offset_init,
    directional_offset_init_l2hp,
    directional_offset_init_l3hp,
)
from .backbone import ViTBackboneFPN
from .common import Linear
from .mamba_block import a_log_init, dt_proj_init_
from .spec import ModelSpec, spec_from_cfg
from .transformer import DABTransformer, center_slice_plan, torch_dtype
from .videomamba import VideoMamba, VideoMambaBackbone, to_compute_dtype
from .vss import SS2D, FrozenBatchNorm

# VideoMamba's learned position table is shaped for one clip size (the JAX
# package shapes it from the clip its init sees): the main path's 256x320
DEFAULT_INPUT_HW = (256, 320)


class DETR(nn.Module):
    def __init__(self, spec: ModelSpec, input_hw=DEFAULT_INPUT_HW):
        super().__init__()
        if not spec.is_vit:
            raise NotImplementedError(
                f"BACKBONE_NAME={spec.backbone_name} is not ported yet "
                "(ROADMAP.md Queue 1 step 13: CSN)")
        self.spec = spec
        # index 0 as in the reference's Joiner(backbone, position_embedding)
        if spec.is_mamba:
            backbone = VideoMambaBackbone(spec, input_hw)
        else:
            backbone = ViTBackboneFPN(spec, spec.d_model)
        self.backbone = nn.ModuleList([backbone])
        self.transformer = DABTransformer(spec)
        n_ref = spec.num_queries if spec.single_frame else (
            spec.num_queries * spec.model_temp_len)
        self.refpoint_embed = nn.Embedding(n_ref, 4)
        self.class_embed_b = Linear(spec.d_model, 3)
        self.head_dropout = nn.Dropout(0.5)

    def forward(self, pixels: torch.Tensor, mask: torch.Tensor) -> Dict:
        """pixels [B, T, H, W, 3]; mask [B, H, W] bool, True = padded."""
        s = self.spec
        if self.training and s.gradient_checkpointing:
            raise NotImplementedError(
                "CONFIG.GRADIENT_CHECKPOINTING (encoder and decoder remat) is "
                "not ported yet (ROADMAP.md Queue 1, step 8a)")
        refs = self.refpoint_embed.weight
        if s.is_mamba:
            if self.training:
                raise NotImplementedError(
                    "training the Mamba family (K5's backward, VideoMamba "
                    "remat, train-mode FrozenBN) is not ported yet "
                    "(ROADMAP.md Queue 1, step 19)")
            srcs, masks, poses = self.backbone[0](pixels, mask)
            tq = 1 if s.single_frame else s.model_temp_len
            hs, cls_hs, references = self.transformer(
                srcs, masks, poses, refs.reshape(s.num_queries, tq, 4))
            return self._heads_and_outputs(hs, cls_hs, references,
                                           pixels.shape[0])
        t_tokens = pixels.shape[1] // s.vit.tubelet_size
        plan = None
        if s.encoder_type == "fast_attention":
            # only the fast encoder reads nothing but the plan's frames:
            # the exact encoder's lower layers sample every frame
            plan = center_slice_plan(s.fast_eff_slice, s.single_frame,
                                     s.fast_window, s.num_feature_levels,
                                     s.temp_len, t_tokens)
        if plan is not None:
            # centre-frame slice pushed into the backbone: the ViT's last
            # block, the FPN and the poses only compute the plan's frames
            dec_frame = (s.temp_len // 2) % t_tokens
            srcs, masks, poses, pos_dec = self.backbone[0](
                pixels, mask, out_frames=tuple(sorted(set(plan[0]))),
                dec_frame=dec_frame)
            hs, cls_hs, references = self.transformer(
                srcs, masks, poses, refs.reshape(s.num_queries, 1, 4),
                pre_sliced=(t_tokens, pos_dec))
        else:
            srcs, masks, poses = self.backbone[0](pixels, mask)
            tq = 1 if s.single_frame else s.model_temp_len
            hs, cls_hs, references = self.transformer(
                srcs, masks, poses, refs.reshape(s.num_queries, tq, 4))
        return self._heads_and_outputs(hs, cls_hs, references, pixels.shape[0])

    def _heads_and_outputs(self, hs, cls_hs, references, b: int) -> Dict:
        # hs [NL, BT, NQ, C]; cls_hs [NL, BT, NQ, NC, C]; refs [NL, BT, NQ, 4]
        s = self.spec
        outputs_class_b = self.class_embed_b(hs)
        outputs_coord = self.transformer.decode_boxes(hs, references)
        outputs_class = self.head_dropout(cls_hs).float().mean(dim=-1)  # [NL, BT, NQ, NC]
        nl = hs.shape[0]
        nq, nc = s.num_queries, s.num_classes
        if s.dataset_mode == "ava":
            if not s.single_frame:       # tube mode: keep the keyframe slice
                t = s.model_temp_len
                outputs_class = outputs_class.reshape(nl, b, t, nq, nc)[:, :, t // 2]
                outputs_coord = outputs_coord.reshape(nl, b, t, nq, 4)[:, :, t // 2]
                outputs_class_b = outputs_class_b.reshape(nl, b, t, nq, 3)[:, :, t // 2]
            shape = (nl, b, nq)
        else:
            shape = (nl, b, s.model_temp_len, nq)
        outputs_class = outputs_class.reshape(*shape, nc)
        outputs_coord = outputs_coord.reshape(*shape, 4)
        outputs_class_b = outputs_class_b.reshape(*shape, 3)
        return {
            "pred_logits": outputs_class[-1],
            "pred_boxes": outputs_coord[-1],
            "pred_logits_b": outputs_class_b[-1],
            "aux_outputs": [
                {"pred_logits": outputs_class[i],
                 "pred_boxes": outputs_coord[i],
                 "pred_logits_b": outputs_class_b[i]}
                for i in range(nl - 1)
            ],
        }


# --------------------------------------------------------------------------
# init: the JAX package's initialisers, drawn from an explicit generator
# --------------------------------------------------------------------------

_TN_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)
_TN_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))    # Phi(2)


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax lecun_normal: truncated normal on [-2, 2] sigma, std scaled so
    the variance is 1 / fan_in."""
    u = _TN_LO + torch.rand(shape, generator=g) * (_TN_HI - _TN_LO)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return x * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def _fan_in(module: nn.Module, w: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose3d):     # [I, O, k...]
        return w.shape[0] * math.prod(w.shape[2:])
    return math.prod(w.shape[1:])                    # [O, I, k...]


@torch.no_grad()
def init_weights(model: DETR, generator: torch.Generator) -> None:
    """Overwrite every parameter with a draw of the JAX package's
    initialiser, in module order, on the CPU generator (identical weights
    on every device): Dense/Conv kernels lecun-normal with zero bias, the
    ViT qkv xavier-uniform, LayerNorm ones/zeros, the embeddings N(0, 1),
    the fast encoder's offset/weight kernels zero with the directional
    offset bias (its x, y components, or x, y, t under the 3d window), the
    exact encoder's ``sampling_offsets`` / ``attention_weights`` likewise
    (the bias in (head, level, point, x/y/t) order); in
    the Mamba family the dt projections as mamba_simple's
    (``dt_proj_init_``), A_log = log(1..N), D = 1, VideoMamba's position
    tables N(0, 0.02) and cls token 0, SS2D's x_proj_weight lecun-normal,
    dt_projs N(0, 1), A_logs 0, Ds 1, FrozenBatchNorm as identity."""
    g = generator
    s = model.spec
    for name, mod in model.named_modules():
        if name.endswith(("dt_proj", "dt_proj_b")):
            dt_proj_init_(mod, g)
        elif isinstance(mod, FrozenBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, SS2D):
            w = mod.x_proj_weight            # flax fans: in (R+2N) x K
            w.copy_(_lecun_normal(w.shape, w.shape[0] * w.shape[1], g))
            for p in (mod.dt_projs_weight, mod.dt_projs_bias):
                p.copy_(torch.randn(p.shape, generator=g))
            mod.A_logs.zero_()
            mod.Ds.fill_(1.0)
        elif isinstance(mod, VideoMamba):
            for p in (mod.pos_embed, mod.temporal_pos_embedding):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
            mod.cls_token.zero_()
        elif name.endswith("self_attn.window_offsets"):
            mod.weight.zero_()
            init = (directional_offset_init_l3hp if s.fast_window == "3d"
                    else directional_offset_init_l2hp)
            mod.bias.copy_(init(s.nhead, s.num_feature_levels,
                                s.enc_n_points))
        elif name.endswith("self_attn.sampling_offsets"):
            mod.weight.zero_()
            mod.bias.copy_(directional_offset_init(
                s.nhead, s.num_feature_levels, s.enc_n_points))
        elif name.endswith(("self_attn.window_weights",
                            "self_attn.attention_weights")):
            mod.weight.zero_()
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g))
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d,
                              nn.ConvTranspose3d)):
            w = mod.weight
            if name.endswith("attn.qkv"):            # xavier_uniform [C, 3C]
                lim = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * lim)
            else:
                w.copy_(_lecun_normal(w.shape, _fan_in(mod, w), g))
            if mod.bias is not None:
                mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("q_bias", "v_bias")):
            p.zero_()
        elif name.endswith(("A_log", "A_b_log")):
            p.copy_(a_log_init(*p.shape))
        elif name.endswith((".D", ".D_b")):
            p.fill_(1.0)
    model.transformer.level_embed.copy_(
        torch.randn(model.transformer.level_embed.shape, generator=g))


# the encoders' offset / weight heads, whose kernels the init zeroes
_HEADS_AT_ZERO = tuple(f"self_attn.{k}" for k in (
    "window_offsets", "window_weights", "sampling_offsets",
    "attention_weights"))


@torch.no_grad()
def randomize_constants(model: DETR, generator: torch.Generator) -> None:
    """Redraw the parameters that ``init_weights`` sets to constants, as the
    parity tests' random params do: LayerNorm scales 1 + N(0, 0.1), the
    biases N(0, 0.1) (the directional offset bias and the dt biases stay),
    the encoders' offset/weight kernels N(0, 1/fan_in); in the Mamba
    family FrozenBatchNorm's scale 1 + N(0, 0.1), mean N(0, 0.1) and
    variance U(0.5, 1.5), A_log(s) and D(s) + N(0, 0.1) and the cls token
    N(0, 0.02).

    For checks with random weights only: at the JAX init the class logits
    (the mean over the feature axis of a LayerNorm output with unit scale
    and zero bias) are identically 0, and every query of the fast encoder
    gets the same offsets and weights (of either deformable encoder)."""
    g = generator
    noise = lambda x, std: (std * torch.randn(x.shape, generator=g)).to(x.device)
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.LayerNorm, FrozenBatchNorm)):
            mod.weight.copy_(1.0 + noise(mod.weight, 0.1))
        if isinstance(mod, FrozenBatchNorm):
            mod.running_mean.copy_(noise(mod.running_mean, 0.1))
            mod.running_var.copy_(
                0.5 + torch.rand(mod.running_var.shape, generator=g))
        elif isinstance(mod, VideoMamba):
            mod.cls_token.copy_(noise(mod.cls_token, 0.02))
        elif name.endswith(_HEADS_AT_ZERO):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(w.shape[1]))
    for name, p in model.named_parameters():
        if name.endswith(("A_log", "A_b_log", "A_logs", ".D", ".D_b", ".Ds")):
            p.add_(noise(p, 0.1))
        elif (name.endswith("bias") and "dt_proj" not in name
              and not name.endswith(("window_offsets.bias",
                                     "sampling_offsets.bias"))):
            p.copy_(noise(p, 0.1))


def build_model(cfg, dtype: torch.dtype = torch.float32, device=None,
                generator: torch.Generator | None = None,
                input_hw=DEFAULT_INPUT_HW) -> DETR:
    """Build the model of ``cfg`` with seeded weights, in ``eval()`` mode
    (``model.train()`` for training, ``engine.train``).

    ``dtype`` is the backbone's compute dtype (the JAX package's DETR
    ``dtype``; VideoMamba keeps its LayerNorms, dt projections, A, D and
    position tables float32, and ``mamba_proj`` runs in float32); the fast
    encoder takes ``MODEL.FAST_DTYPE``, the exact and the SSM / VSS
    encoders float32, the
    decoder ``MODEL.DECODER_DTYPE``, with the decoder's float32 islands
    (sine-embed MLPs, box refinement, class queries) and the heads kept
    float32.  ``input_hw`` is the clip size a VideoMamba model is built
    for (its learned position table has one row per 16x16 patch).  The
    model goes to ``device``, CUDA by default: with no card present and no
    ``device="cpu"`` it raises rather than run on the CPU.  ``generator``
    (a CPU ``torch.Generator``, seed 0 when omitted) draws the init; load
    real weights with ``load_state_dict`` (``utils.weights``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_model: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        device = "cuda"
    spec = spec_from_cfg(cfg)
    model = DETR(spec, input_hw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    if spec.is_mamba:
        to_compute_dtype(model.backbone[0].body, dtype)
    else:
        model.backbone.to(dtype)
    if spec.encoder_type == "fast_attention":
        model.transformer.encoder.to(torch_dtype(spec.fast_dtype))
    dec = model.transformer.decoder
    for part in (dec.layers, dec.cls_layers, dec.norm, dec.cls_norm2):
        part.to(torch_dtype(spec.decoder_dtype))
    return model.to(device).eval()
