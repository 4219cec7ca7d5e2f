"""Helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
move flax params into port modules and compare outputs as numpy."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from class_query_vad_tpu_torch.utils.weights import params_from_jax

# The suite runs under pytest-xdist, several workers sharing the cores: one
# torch thread per worker.  torch's default pool (a thread per core in
# every worker) oversubscribes them, and its threads spin while they wait:
# the port's test files took twice the wall time that way.
torch.set_num_threads(1)


def random_params(apply_init, *args, seed: int = 0):
    """Seeded numpy params for a flax module, shaped by tracing its init
    (``jax.eval_shape``: no eager init, which costs minutes on the CPU).
    ``apply_init(key, *args)`` calls ``module.init``.  Kernels are
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.1) and
    embeddings N(0, 1); the fast encoder's offset/weight heads, zero at
    init, get random kernels and offset biases of order 1 so that every
    lane of the fused head matters.  Mamba-family leaves: FrozenBatchNorm
    variances 0.5 + |N(0, 1)|, SS2D's x_proj / dt_projs weights N(0,
    1/fan_in); the other raw params N(0, 1)."""
    import jax

    shapes = jax.eval_shape(apply_init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        z = rng.standard_normal(shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "sampling_offsets_bias":
            pass
        elif name.endswith("bias"):
            z = 0.1 * z
        elif name.endswith("kernel"):
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif name == "running_var":
            z = 0.5 + np.abs(z)
        elif name in ("x_proj_weight", "dt_projs_weight"):
            z = z / np.sqrt(shape[-1])
        return z.astype(np.float32)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else leaf(k, v.shape)
                for k, v in tree.items()}

    return walk(shapes)


def load_from_flax(module: torch.nn.Module, flax_params, jax_prefix=(),
                   torch_prefix: str = "") -> None:
    """Load a flax sub-tree into a port module with strict key checking:
    the tree is nested at ``jax_prefix`` of the DETR tree, converted with
    ``params_from_jax`` and stripped of ``torch_prefix``."""
    tree = flax_params.get("params", flax_params)
    for k in reversed(jax_prefix):
        tree = {k: tree}
    sd = params_from_jax(tree)
    n = len(torch_prefix)
    assert all(k.startswith(torch_prefix) for k in sd), list(sd)[:5]
    module.load_state_dict({k[n:]: v for k, v in sd.items()}, strict=True)


def t(x, dtype=None) -> torch.Tensor:
    a = torch.from_numpy(np.array(x))
    return a if dtype is None else a.to(dtype)


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def tiny_cfg(cfg, eff_slice: bool, depth2: bool = False):
    """The tiny AVA configuration of the port's whole-model tests (ViT
    depth 1 or 2, 2 encoder and 1 or 2 decoder layers, d_ffn 64, 12
    classes, 8 frames), set on a config tree of either package."""
    c = cfg.CONFIG
    c.DATA.DATASET_NAME = "ava"
    c.DATA.NUM_CLASSES = 12
    c.DATA.TEMP_LEN = 8
    c.MODEL.TEMP_LEN = 8
    c.MODEL.SINGLE_FRAME = True
    c.MODEL.BACKBONE_NAME = "ViT"
    c.MODEL.ENCODER_TYPE = "fast_attention"
    c.MODEL.FAST_RADIUS = 1
    c.MODEL.FAST_WINDOW = "2d"
    c.MODEL.FAST_EFF_SLICE = eff_slice
    c.MODEL.ENC_LAYERS = 2
    c.MODEL.DEC_LAYERS = 2 if depth2 else 1
    c.MODEL.DIM_FEEDFORWARD = 64
    c.MODEL.QUERY_NUM = 4
    c.ViT.DEPTH = 2 if depth2 else 1
    c.ViT.USE_CHECKPOINT = False
    return cfg


TRAIN_M = 6          # gt slots per clip in the train tests


def train_cfg(get_defaults):
    """``tiny_cfg`` with two decoder layers (one aux layer) and dropout and
    drop path at 0, for the train-step tests."""
    cfg = tiny_cfg(get_defaults(), eff_slice=True, depth2=True)
    c = cfg.CONFIG
    c.MODEL.DROPOUT = 0.0
    c.ViT.DROP_PATH_RATE = 0.0
    c.DATA.MAX_BOXES = TRAIN_M
    return cfg


def train_batch(seed: int = 0):
    """A seeded batch of 2 clips [8, 64, 64] (the second padded right), 6
    gt slots with 3 and 2 live boxes, 20 % multi-hot labels of 12 classes."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True
    return {
        "pixels": rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32),
        "mask": mask,
        "boxes": rng.uniform(0.2, 0.7, (2, TRAIN_M, 4)).astype(np.float32),
        "labels": (rng.random((2, TRAIN_M, 12)) < 0.2).astype(np.float32),
        "n_boxes": np.array([3, 2], np.int32),
    }


VSS_YAML = str(Path(__file__).resolve().parents[1] / "configuration"
               / "AVA22_train-mamba_VSS.yaml")
TINY_VIDEOMAMBA = {"videomamba_tiny": dict(embed_dim=32, depth=2)}


def tiny_vss_cfg(cfg):
    """AVA22_train-mamba_VSS.yaml cut to size, on a config tree of either
    package: D_MODEL 32, 2 encoder and 2 decoder layers, d_ffn 64, 12
    classes, 4 queries, 8 frames, mamba_proj width 48.  The VideoMamba
    spec itself is patched to embed 32, depth 2 (``TINY_VIDEOMAMBA``)."""
    c = cfg.CONFIG
    c.DATA.NUM_CLASSES = 12
    c.DATA.TEMP_LEN = 8
    c.MODEL.TEMP_LEN = 8
    c.MODEL.D_MODEL = 32
    c.MODEL.DIM_FEEDFORWARD = 64
    c.MODEL.ENC_LAYERS = 2
    c.MODEL.DEC_LAYERS = 2
    c.MODEL.QUERY_NUM = 4
    c.MAMBA.OUT_CHANNELS.videomamba_tiny = 48
    return cfg


CONFIG_DIR = Path(__file__).resolve().parents[1] / "configuration"


def cut_cfg(cfg, temp_len: int = 8, enc_layers: int = 2, dec_layers: int = 2,
            queries: int = 3):
    """A YAML's configuration cut to the parity tests' size, on a config
    tree of either package: ViT depth 1, ``enc_layers`` + ``dec_layers``
    layers, d_ffn 64, ``queries`` queries, ``temp_len`` frames, float32
    encoder and decoder, no ViT checkpointing; the widths (ViT-B, D_MODEL,
    heads, levels, points, classes) stay the YAML's."""
    c = cfg.CONFIG
    c.DATA.TEMP_LEN = temp_len
    c.MODEL.TEMP_LEN = temp_len
    c.ViT.DEPTH = 1
    c.ViT.USE_CHECKPOINT = False
    c.MODEL.ENC_LAYERS = enc_layers
    c.MODEL.DEC_LAYERS = dec_layers
    c.MODEL.DIM_FEEDFORWARD = 64
    c.MODEL.QUERY_NUM = queries
    c.MODEL.FAST_DTYPE = "float32"
    c.MODEL.DECODER_DTYPE = "float32"
    return cfg


def tube_targets(seed: int, b: int, t: int, a_slots: int = 2,
                 num_classes: int = 24, front_pad=(2, 0), end_pad=(0, 1),
                 n_actors=(2, 1)):
    """Seeded tube targets as the loader packs them (boxes [B, A, T, 4],
    labels [B, A, T], frame_valid [B, T], n_actors [B]): clip i has
    ``front_pad[i]`` / ``end_pad[i]`` padded frames; slot 0 is live over
    part of the clip, with empty (zero) boxes elsewhere; slot 1 is live in
    every other frame, as are the slots after it; slots >= n_actors are
    loader padding."""
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0.25, 0.6, (b, a_slots, t, 4)).astype(np.float32)
    labels = rng.integers(0, num_classes, (b, a_slots, t)).astype(np.int64)
    boxes[:, 0, : t // 4] = 0.0
    boxes[:, 1:, ::2] = 0.0
    frame_valid = np.zeros((b, t), bool)
    for i in range(b):
        frame_valid[i, front_pad[i] : t - end_pad[i]] = True
    return {"boxes": boxes, "labels": labels, "frame_valid": frame_valid,
            "n_actors": np.array(n_actors[:b], np.int32)}
