"""The whole port forward against the JAX model, on the CPU in float32.

Tiny configuration of tests/test_eff_slice.py (ViT depth 1, 2 encoder and
1 decoder layers, d_ffn 64, 12 classes, 8 frames of 64x64): the same seeded
pixels and the same (perturbed) flax params, moved into the port with
``params_from_jax`` + ``load_state_dict(strict=True)``.  On the CPU the JAX
fast encoder takes its XLA blend path and the port its plain PyTorch K1
version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.losses import postprocess_ava
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import n, random_params, t, tiny_cfg


@functools.lru_cache(maxsize=None)
def _world(eff_slice: bool, depth2: bool, seed: int):
    rng = np.random.default_rng(seed)
    pixels = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True                       # second clip padded right
    jm = jax_build_model(tiny_cfg(jax_cfg_defaults(), eff_slice, depth2))
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask), seed=seed)
    out_j = jax.jit(lambda p, x, m: jm.apply(p, x, m, True))(
        params, jnp.asarray(pixels), jnp.asarray(mask))
    model = build_model(tiny_cfg(get_cfg_defaults(), eff_slice, depth2),
                        device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    return out_j, out_t


# fp32 on both sides; the two frameworks sum matmuls, convs and the
# blend's taps in other orders, and the differences pass through the
# ViT, two encoder layers and the decoder's LayerNorms and softmaxes
# (measured ~1e-6; 2e-4 leaves margin, anything semantic is O(1)).
ATOL, RTOL = 2e-4, 2e-4


@pytest.mark.parametrize("eff_slice,depth2,seed", [
    (True, False, 0),      # main-path route: backbone pre-sliced
    (True, True, 1),       # two decoder layers: query_scale, refinement
    (False, False, 2),     # unsliced backbone + common-grid decode
])
def test_tiny_model_matches_jax(eff_slice, depth2, seed):
    out_j, out_t = _world(eff_slice, depth2, seed)
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert len(out_t["aux_outputs"]) == len(out_j["aux_outputs"])
    for a_t, a_j in zip(out_t["aux_outputs"], out_j["aux_outputs"]):
        for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
            np.testing.assert_allclose(n(a_t[k]), n(a_j[k]), atol=ATOL,
                                       rtol=RTOL, err_msg="aux " + k)


def test_tiny_model_postprocess_shapes():
    _, out_t = _world(True, False, 0)
    sizes = torch.tensor([[64, 64], [64, 48]])
    scores, boxes, actor = postprocess_ava(out_t, sizes)
    assert scores.shape == (2, 4, 12)
    assert boxes.shape == (2, 4, 4)
    assert actor.shape == (2, 4, 1)
    for x in (scores, boxes, actor):
        assert torch.isfinite(x).all()
