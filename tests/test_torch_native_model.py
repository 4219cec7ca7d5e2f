"""Tiny whole models of ``AVA22_ViT-B_fast_native.yaml`` in the PyTorch
port against the JAX package, on the CPU in float32: as written (2d
window, centre-frame slice) and with ``FAST_WINDOW: 3d``, cut as
``tests/test_fast_encoder.py:494-519`` cuts its native model (ViT depth 1,
1 + 1 layers, TEMP_LEN 4, 64x96), the same params through
``params_from_jax``; and the seeded init's window offset bias.

One JAX jit per window, shared (``functools.lru_cache``).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_custom as jax_cfg_custom
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu_torch.config import get_cfg_custom
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.ops import deform_attn as da
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import n, random_params, t

NATIVE_YAML = str(Path(__file__).resolve().parents[1] / "configuration"
                  / "AVA22_ViT-B_fast_native.yaml")


def _native_cfg(get_cfg, window: str):
    """AVA22_ViT-B_fast_native.yaml cut to size (as test_fast_encoder.py:
    494-519 cuts its native model): ViT depth 1, one encoder and one
    decoder layer, TEMP_LEN 4, float32 on both sides; ``window`` "3d" is
    the YAML's documented variant."""
    cfg = get_cfg(NATIVE_YAML)
    c = cfg.CONFIG
    c.DATA.TEMP_LEN = 4
    c.MODEL.TEMP_LEN = 4
    c.ViT.DEPTH = 1
    c.MODEL.ENC_LAYERS = 1
    c.MODEL.DEC_LAYERS = 1
    c.MODEL.FAST_DTYPE = "float32"
    c.MODEL.DECODER_DTYPE = "float32"
    c.MODEL.FAST_WINDOW = window
    return cfg


@functools.lru_cache(maxsize=None)
def _model_world(window: str):
    rng = np.random.default_rng(50 + (window == "3d"))
    pixels = rng.normal(size=(2, 4, 64, 96, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 96), bool)
    mask[1, :, 72:] = True                       # second clip padded right
    jm = jax_build_model(_native_cfg(jax_cfg_custom, window))
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask),
                           seed=60 + (window == "3d"))
    args = (params, jnp.asarray(pixels), jnp.asarray(mask))
    # compiled without LLVM's optimisation passes: the same graph, in about
    # half the compile time of the optimised build
    out_j = jax.jit(lambda p, x, m: jm.apply(p, x, m, True)).lower(
        *args).compile({"xla_backend_optimization_level": 0})(*args)
    model = build_model(_native_cfg(get_cfg_custom, window), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    return out_j, out_t, model


# as tests/test_torch_model.py: float32 on both sides, other summation
# orders through the ViT block, the encoder and decoder layers
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("window", ["2d", "3d"])
def test_tiny_native_model_matches_jax(window):
    out_j, out_t, model = _model_world(window)
    attn = model.transformer.encoder.layers[0].self_attn
    assert attn.native and not attn.fused_route
    assert attn.window_offsets.bias.shape == (4 * (3 if window == "3d" else 2)
                                              * 64,)
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        assert out_t[k].shape == out_j[k].shape, k
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), **MODEL_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("window", ["2d", "3d"])
def test_native_model_init_uses_the_window_offset_init(window):
    """The seeded init puts the l2hp (2d) or l3hp (3d) directional bias in
    the offset head, so a saved state loads back strictly."""
    cfg = _native_cfg(get_cfg_custom, window)
    model = build_model(cfg, device="cpu")
    init = (da.directional_offset_init_l3hp if window == "3d"
            else da.directional_offset_init_l2hp)
    bias = model.transformer.encoder.layers[0].self_attn.window_offsets.bias
    np.testing.assert_array_equal(n(bias), n(init(8, 4, 8)))
    build_model(cfg, device="cpu").load_state_dict(model.state_dict(),
                                                   strict=True)
