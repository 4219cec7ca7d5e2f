"""Static model specification.

A copy of ``class_query_vad_tpu/models/spec.py``: ``ModelSpec`` is the
immutable projection of the config tree that the model modules consume —
one place that maps the reference's config keys onto the model
hyperparameters, so both packages build the same model from one YAML.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ViTSpec:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    patch_size: int = 16
    tubelet_size: int = 2
    pretrain_img_size: int = 224
    num_frames: int = 16
    drop_path_rate: float = 0.0
    # ViT per-block gradient checkpointing — the reference defaults this ON
    # independently of CONFIG.GRADIENT_CHECKPOINTING (the reference's
    # pipelines/video_action_recognition_config.py and
    # models/backbones/vit.py).
    use_checkpoint: bool = True


@dataclass(frozen=True)
class ModelSpec:
    dataset_mode: str = "ava"
    num_classes: int = 80
    d_model: int = 256
    nhead: int = 8
    num_queries: int = 15
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    num_feature_levels: int = 4
    enc_n_points: int = 8
    temp_len: int = 32           # DATA.TEMP_LEN — decoder grid length
    model_temp_len: int = 32     # MODEL.TEMP_LEN — refpoint tube length
    single_frame: bool = True
    encoder_type: str = "attention"
    fast_radius: int = 1
    fast_dtype: str = "float32"
    fast_window: str = "3d"
    fast_cross_level: str = "resample"
    # centre-frame encoder slice (exact; see transformer.DABTransformer
    # .eff_slice) — MODEL.FAST_EFF_SLICE
    fast_eff_slice: bool = True
    # MODEL.FAST_USE_PALLAS=False takes the fast encoder's plain PyTorch
    # blends on any device (same function, no CUDA kernels), as the JAX
    # package takes its XLA-oracle blend: the A/B switch for debugging
    fast_use_pallas: bool = True
    decoder_type: str = "attention"
    # serving compute dtype for the DAB decoder (Dense/LN/conv matmuls).
    # float32 = the reference's fp32 semantics (parity default); bfloat16
    # mirrors the reference's fp16-AMP serving mode — box refinement,
    # sine embeds and attention softmax stay fp32 either way.
    decoder_dtype: str = "float32"
    backbone_name: str = "ViT"
    bbox_embed_diff_each_layer: bool = False
    gradient_checkpointing: bool = False
    last_stride: bool = True
    mamba_backbone_type: str = "videomamba_tiny"
    mamba_out_channels: int = 192
    vit: ViTSpec = ViTSpec()

    @property
    def is_vit(self) -> bool:
        return "ViT" in self.backbone_name or "Mamba" in self.backbone_name

    @property
    def is_mamba(self) -> bool:
        return "Mamba" in self.backbone_name


def spec_from_cfg(cfg) -> ModelSpec:
    m = cfg.CONFIG.MODEL
    v = cfg.CONFIG.ViT
    return ModelSpec(
        dataset_mode=cfg.CONFIG.DATA.DATASET_NAME,
        num_classes=cfg.CONFIG.DATA.NUM_CLASSES,
        d_model=m.D_MODEL,
        nhead=m.NHEAD,
        num_queries=m.QUERY_NUM,
        enc_layers=m.ENC_LAYERS,
        dec_layers=m.DEC_LAYERS,
        dim_feedforward=m.DIM_FEEDFORWARD,
        dropout=m.DROPOUT,
        num_feature_levels=m.NUM_FEATURE_LEVELS,
        enc_n_points=m.NUM_ENC_N_POINTS,
        temp_len=cfg.CONFIG.DATA.TEMP_LEN,
        model_temp_len=m.TEMP_LEN,
        single_frame=m.SINGLE_FRAME,
        encoder_type=m.get("ENCODER_TYPE", "attention"),
        fast_radius=int(m.get("FAST_RADIUS", 1)),
        fast_dtype=str(m.get("FAST_DTYPE", "float32")),
        fast_window=str(m.get("FAST_WINDOW", "3d")),
        fast_cross_level=str(m.get("FAST_CROSS_LEVEL", "resample")),
        fast_eff_slice=bool(m.get("FAST_EFF_SLICE", True)),
        fast_use_pallas=bool(m.get("FAST_USE_PALLAS", True)),
        decoder_type=m.get("DECODER_TYPE", "attention"),
        decoder_dtype=str(m.get("DECODER_DTYPE", "float32")),
        backbone_name=m.BACKBONE_NAME,
        bbox_embed_diff_each_layer=m.BBOX_EMBED_DIFF_EACH_LAYER,
        gradient_checkpointing=bool(cfg.CONFIG.GRADIENT_CHECKPOINTING),
        last_stride=bool(m.LAST_STRIDE),
        mamba_backbone_type=m.get("BACKBONE_TYPE", "videomamba_tiny"),
        mamba_out_channels=cfg.CONFIG.get("MAMBA", {})
        .get("OUT_CHANNELS", {})
        .get(m.get("BACKBONE_TYPE", "videomamba_tiny"), 192),
        vit=ViTSpec(
            embed_dim=v.EMBED_DIM,
            depth=v.DEPTH,
            num_heads=v.NUM_HEADS,
            mlp_ratio=float(v.MLP_RATIO),
            qkv_bias=v.QKV_BIAS,
            patch_size=v.PATCH_SIZE,
            tubelet_size=v.TUBELET_SIZE,
            pretrain_img_size=v.PRETRAIN_IMG_SIZE,
            num_frames=cfg.CONFIG.DATA.TEMP_LEN,
            drop_path_rate=float(v.DROP_PATH_RATE),
            use_checkpoint=bool(v.USE_CHECKPOINT),
        ),
    )
