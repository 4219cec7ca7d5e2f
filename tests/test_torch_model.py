"""The whole port forward against the JAX model, on the CPU in float32.

Tiny configuration of tests/test_eff_slice.py (ViT depth 1, 2 encoder and
1 decoder layers, d_ffn 64, 12 classes, 8 frames of 64x64): the same seeded
pixels and the same (perturbed) flax params, moved into the port with
``params_from_jax`` + ``load_state_dict(strict=True)``.  On the CPU the JAX
fast encoder takes its XLA blend path and the port its plain PyTorch K1
version.  Also ``utils.flops.model_cost`` of the port model against the
dense-product and convolution FLOPs of JAX's lowered program.
"""

import functools
import re

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
from class_query_vad_tpu_torch.utils.flops import model_cost
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
    args = (params, jnp.asarray(pixels), jnp.asarray(mask))
    lowered = jax.jit(lambda p, x, m: jm.apply(p, x, m, True)).lower(*args)
    # compiled without LLVM's optimisation passes: half the compile time
    out_j = lowered.compile({"xla_backend_optimization_level": 0})(*args)
    model = build_model(tiny_cfg(get_cfg_defaults(), eff_slice, depth2),
                        device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    return out_j, out_t, lowered.as_text(), model


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
    out_j, out_t = _world(eff_slice, depth2, seed)[:2]
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert len(out_t["aux_outputs"]) == len(out_j["aux_outputs"])
    for a_t, a_j in zip(out_t["aux_outputs"], out_j["aux_outputs"]):
        for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
            np.testing.assert_allclose(n(a_t[k]), n(a_j[k]), atol=ATOL,
                                       rtol=RTOL, err_msg="aux " + k)


def test_tiny_model_postprocess_shapes():
    out_t = _world(True, False, 0)[1]
    sizes = torch.tensor([[64, 64], [64, 48]])
    scores, boxes, actor = postprocess_ava(out_t, sizes)
    assert scores.shape == (2, 4, 12)
    assert boxes.shape == (2, 4, 4)
    assert actor.shape == (2, 4, 1)
    for x in (scores, boxes, actor):
        assert torch.isfinite(x).all()


def _dims(tensor_type: str):
    return [int(d) for d in tensor_type.split("x")[:-1]]


def hlo_flops(text: str) -> dict:
    """2 x multiply-adds of the ``dot_general`` and ``convolution`` ops of a
    lowered StableHLO program, by op family.  A transposed convolution
    (flax ``ConvTranspose``, the FPN's upsampling) lowers to a convolution
    over the input dilated by its stride (``lhs_dilate``): of its kernel
    taps, 1 in prod(lhs_dilate) meets an input element and the rest meet
    inserted zeros, which it does not count (as torch's counter counts
    ``conv_transpose3d``)."""
    out = {"dot_general": 0, "convolution": 0}
    sig = r": \(tensor<([^>]*)>, tensor<([^>]*)>\) -> tensor<([^>]*)>"
    for line in text.splitlines():
        if "stablehlo.dot_general" in line:
            lhs, _, res = re.search(sig, line).groups()
            contract = re.search(r"contracting_dims = \[([\d, ]*)\]", line)
            k = np.prod([_dims(lhs)[int(i)] for i in
                         contract.group(1).split(",") if i.strip()])
            out["dot_general"] += 2 * int(np.prod(_dims(res))) * int(k)
        elif "stablehlo.convolution" in line:
            _, rhs, res = re.search(sig, line).groups()
            spec = re.search(r"x\[([^\]]*)\]->", line).group(1).split(", ")
            kdims = _dims(rhs)
            # output elements x (kernel taps x input features per group)
            taps = np.prod([kdims[j] for j, d in enumerate(spec)
                            if d not in ("o",)])
            dil = re.search(r"lhs_dilate = \[([\d, ]*)\]", line)
            if dil:
                dil = [int(v) for v in dil.group(1).split(",")]
                sp = [kdims[j] for j, d in enumerate(spec) if d.isdigit()]
                assert all(k % d == 0 for k, d in zip(sp, dil)), line
                taps //= int(np.prod(dil))
            out["convolution"] += 2 * int(np.prod(_dims(res))) * int(taps)
    return out


def test_flops_match_the_jax_programs_dots_and_convolutions():
    """``model_cost`` (torch's ``FlopCounterMode``) of the tiny main-path
    model (the pre-sliced route) against the ``dot_general`` and
    ``convolution`` FLOPs of JAX's lowered forward on the same clips.

    One family differs.  On the CPU JAX's K1 runs as its XLA stand-in
    (``_fused2d_composite``), which sums each head's softmax by one matmul
    of the fused logits [B, N, nl x kp] against a constant head matrix per
    encoder layer; torch's counter does not see K1's plain version
    (``ops.cuda_build.plain_version``), as XLA gives the Pallas call no
    cost on the TPU, so those matmuls leave JAX's count.  What remains
    agrees within 2e-4 (measured 1.3e-4: the levels' alignment matmuls,
    2.1 MFLOP of 16 GFLOP, split differently)."""
    _, _, text, model = _world(True, False, 0)
    want = hlo_flops(text)
    c = tiny_cfg(get_cfg_defaults(), True, False).CONFIG.MODEL
    tokens = 2 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2)   # B x 2 frames x levels
    lanes = c.NUM_FEATURE_LEVELS * c.NHEAD * c.NUM_ENC_N_POINTS
    head_sums = c.ENC_LAYERS * 2 * 2 * tokens * lanes * lanes
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(
        rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32))
    got = model_cost(model, pixels, torch.zeros((2, 64, 64), dtype=torch.bool))
    assert got["bytes_accessed"] is None and "not counted" in got["note"]
    expected = want["dot_general"] + want["convolution"] - head_sums
    assert abs(got["flops"] - expected) <= 2e-4 * expected, (got, want)
