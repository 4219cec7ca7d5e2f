"""The port's Mamba family (VideoMamba backbone, Mamba block, SS2D / VSS
blocks, SSM encoder, the VSS DETR) against its flax/JAX counterparts, on
the CPU at small sizes.  Inputs come from numpy with a seed; weights are
seeded numpy params moved into the port with ``params_from_jax`` +
``load_state_dict(strict=True)``.  The scans run through K5's plain
version here; the JAX side runs its Pallas kernel in interpret mode where
the shape takes it (KD a multiple of 128, L a multiple of 32) and its
associative scan elsewhere.

Tolerances: float32 on both sides, differing in summation order and in
the math library's exp / erf: 1e-4 for modules (measured <= 1e-6), 2e-4
for the whole model (tests/test_torch_model.py's); a slip (a flipped
direction, a transposed merge, an epsilon, a GELU variant) is O(1e-2).
bf16: both sides compute each layer in bf16 from the same float32
weights, but round at other places (flax's per-op casts, torch's fused
kernels): 2e-2 x max|ref| (a few bf16 ulps after two blocks).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_custom as jax_cfg_custom
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu.models import mamba_block as j_mamba
from class_query_vad_tpu.models import ssm_encoder as j_enc
from class_query_vad_tpu.models import videomamba as j_vm
from class_query_vad_tpu.models import vss as j_vss
from class_query_vad_tpu_torch.config import get_cfg_custom
from class_query_vad_tpu_torch.losses import postprocess_ava
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.models import mamba_block, ssm_encoder, videomamba, vss
from class_query_vad_tpu_torch.models.detr import init_weights, randomize_constants
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import (
    TINY_VIDEOMAMBA,
    VSS_YAML,
    jit_opt0,
    load_from_flax,
    n,
    random_params,
    t,
    tiny_vss_cfg,
)

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = 2e-2


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flax(module, *inputs, seed=0):
    """Seeded params and the eager forward of a flax module."""
    args = [jnp.asarray(a) for a in inputs]
    params = random_params(lambda k, *a: module.init(k, *a), *args, seed=seed)
    return params, module.apply(params, *args)


def _bf16_close(got, want):
    got, want = n(got), n(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BF16_TOL, f"max|err| = {err:.2e} x max|ref| > {BF16_TOL}"


# --------------------------------------------------------------------------
# VSS pieces
# --------------------------------------------------------------------------

def test_cross_scan_and_merge_are_exact():
    x = _x((2, 3, 5, 4))
    np.testing.assert_array_equal(n(vss.cross_scan(t(x))),
                                  n(j_vss.cross_scan(jnp.asarray(x))))
    ys = _x((2, 4, 4, 15), seed=1)
    np.testing.assert_array_equal(n(vss.cross_merge(t(ys), 3, 5)),
                                  n(j_vss.cross_merge(jnp.asarray(ys), 3, 5)))


@pytest.mark.parametrize("name", ["SS2D", "LSBlock", "RGBlock", "VSSBlock"])
def test_vss_blocks_match_flax(name):
    """At 4x8 (L=32) and d_inner 32 (KD=128) the JAX SS2D takes the Pallas
    kernel; the VSSBlock is the encoder's (post-norm, no MLP)."""
    c = 16
    x = _x((2, 4, 8, c), seed=2)
    if name == "SS2D":
        jm, tm, pre = j_vss.SS2D(c, d_state=4), vss.SS2D(c, d_state=4), "op"
    elif name == "LSBlock":
        jm, tm, pre = j_vss.LSBlock(c), vss.LSBlock(c), None
    elif name == "RGBlock":
        jm, tm, pre = j_vss.RGBlock(c, 4 * c), vss.RGBlock(c, 4 * c), None
    else:
        jm = j_vss.VSSBlock(c, c, ssm_d_state=4, mlp_ratio=0.0, post_norm=True)
        tm = vss.VSSBlock(c, c, ssm_d_state=4, mlp_ratio=0.0, post_norm=True)
        pre = "ssm"
    params, want = _flax(jm, x)
    load_from_flax(tm, params, (pre,) if pre else (), f"{pre}." if pre else "")
    with torch.no_grad():
        np.testing.assert_allclose(n(tm(t(x))), n(want), **TOL)


def test_vss_block_pre_norm_with_mlp_matches_flax():
    c = 16
    x = _x((1, 4, 6, c), seed=3)
    jm = j_vss.VSSBlock(c, 2 * c, ssm_d_state=4, mlp_ratio=2.0)
    tm = vss.VSSBlock(c, 2 * c, ssm_d_state=4, mlp_ratio=2.0)
    params, want = _flax(jm, x)
    load_from_flax(tm, params, ("ssm",), "ssm.")
    with torch.no_grad():
        np.testing.assert_allclose(n(tm(t(x))), n(want), **TOL)


# --------------------------------------------------------------------------
# Mamba and VideoMamba
# --------------------------------------------------------------------------

def test_mamba_block_matches_flax():
    """The ``ssm`` encoder's block: d_state 4, d_conv 2, expand 1, rank 4."""
    x = _x((2, 20, 16), seed=4)
    params, want = _flax(j_mamba.Mamba(16, d_state=4, d_conv=2, expand=1,
                                       dt_rank=4), x)
    tm = mamba_block.Mamba(16, d_state=4, d_conv=2, expand=1, dt_rank=4)
    load_from_flax(tm, params)
    with torch.no_grad():
        np.testing.assert_allclose(n(tm(t(x))), n(want), **TOL)


def test_bimamba_matches_flax():
    x = _x((2, 37, 32), seed=5)
    params, want = _flax(j_vm.BiMamba(32, d_state=16), x)
    tm = videomamba.BiMamba(32, d_state=16)
    load_from_flax(tm, params)
    with torch.no_grad():
        np.testing.assert_allclose(n(tm(t(x))), n(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_videomamba_block_matches_flax(dtype):
    """bf16: flax casts the block's input and its Dense / Conv weights to
    bf16 while A_log, D and the dt projection stay float32; the residual
    stays float32 (a float32 input plus the bf16 mixer output)."""
    x = _x((2, 37, 32), seed=6)
    jm = j_vm.VideoMambaBlock(32, d_state=16, dtype=jnp.dtype(dtype))
    params, want = _flax(jm, x)
    tm = videomamba.VideoMambaBlock(32, d_state=16)
    load_from_flax(tm, params)
    videomamba.to_compute_dtype(tm, getattr(torch, dtype))
    with torch.no_grad():
        got = tm(t(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    if dtype == "float32":
        np.testing.assert_allclose(n(got), n(want), **TOL)
    else:
        _bf16_close(got - t(x), np.asarray(want) - x)   # the mixer's output


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_videomamba_matches_flax(dtype):
    """A tiny VideoMamba (embed 32, depth 2, 8 frames of 32x48): token map
    and frame summary in the compute dtype."""
    pixels = _x((2, 8, 32, 48, 3), seed=7)
    jm = j_vm.VideoMamba(embed_dim=32, depth=2, num_frames=8,
                         dtype=jnp.dtype(dtype))
    params = random_params(lambda k, x: jm.init(k, x), jnp.asarray(pixels))
    tok_j, sum_j = jit_opt0(jm.apply, params, jnp.asarray(pixels))
    tm = videomamba.VideoMamba(6, embed_dim=32, depth=2, num_frames=8)
    load_from_flax(tm, params, ("backbone",), "backbone.0.body.")
    cdt = getattr(torch, dtype)
    videomamba.to_compute_dtype(tm, cdt)
    assert tm.layers[0].mixer.dt_proj.weight.dtype == torch.float32
    assert tm.layers[0].mixer.A_log.dtype == torch.float32
    assert tm.pos_embed.dtype == tm.layers[0].norm.weight.dtype == torch.float32
    with torch.no_grad():
        tok_t, sum_t = tm(t(pixels))
    assert tok_t.dtype == sum_t.dtype == cdt and tok_t.shape == tok_j.shape
    for got, want in ((tok_t, tok_j), (sum_t, sum_j)):
        if dtype == "float32":
            np.testing.assert_allclose(n(got), n(want), **TOL)
        else:
            _bf16_close(got, want)


# --------------------------------------------------------------------------
# SSM / VSS encoder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("return_key", [False, True])
@pytest.mark.parametrize("kind", ["ssm", "vssm"])
def test_ssm_encoder_layer_matches_flax(kind, return_key):
    """Both time directions share one block; the last layer keeps the key
    frame (the last) and its original pose."""
    d, shape = 32, (3, 4, 8)
    src = _x((2, 3 * 4 * 8, d), seed=8)
    pos = _x((2, 3 * 4 * 8, d), seed=9)
    jm = j_enc.SSMEncoderLayer(d, 64, kind, dropout=0.0)
    args = [jnp.asarray(src), jnp.asarray(pos)]
    params = random_params(lambda k, s, p: jm.init(k, s, p, shape, return_key),
                           *args, seed=10)
    want = jm.apply(params, *args, shape, return_key)
    tm = ssm_encoder.SSMEncoderLayer(d, 64, kind, dropout=0.0).eval()
    load_from_flax(tm, params)
    with torch.no_grad():
        got = tm(t(src), t(pos), shape, return_key)
    if return_key:
        (got, key_pos), (want, key_pos_j) = got, want
        np.testing.assert_array_equal(n(key_pos), n(key_pos_j))
        assert got.shape == (2, 4 * 8, d)
    np.testing.assert_allclose(n(got), n(want), **TOL)


# --------------------------------------------------------------------------
# the whole tiny VSS model
# --------------------------------------------------------------------------

def _tiny_spec():
    return (mock.patch.dict(j_vm.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA),
            mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA))


@functools.lru_cache(maxsize=None)
def _vss_world():
    """8 frames of 64x128 (h, w = 4, 8): the backbone sequence is 257 long
    (odd: the JAX side's associative scan); the encoder sees 2 frames of
    L = 32 at KD = 4 x 32 = 128 (its Pallas kernel, interpret mode)."""
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(2, 8, 64, 128, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 128), bool)
    mask[1, :, 96:] = True                       # second clip padded right
    jpatch, tpatch = _tiny_spec()
    with jpatch, tpatch:
        jm = jax_build_model(tiny_vss_cfg(jax_cfg_custom(VSS_YAML)))
        params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                               jnp.asarray(pixels), jnp.asarray(mask))
        out_j = jit_opt0(lambda p, x, m: jm.apply(p, x, m, True),
                         params, jnp.asarray(pixels), jnp.asarray(mask))
        model = build_model(tiny_vss_cfg(get_cfg_custom(VSS_YAML)),
                            device="cpu", input_hw=(64, 128))
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    return out_j, out_t, model, pixels, mask


def test_tiny_vss_model_matches_jax():
    out_j, out_t = _vss_world()[:2]
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), err_msg=k,
                                   **MODEL_TOL)
    assert len(out_t["aux_outputs"]) == len(out_j["aux_outputs"]) == 1
    for a_t, a_j in zip(out_t["aux_outputs"], out_j["aux_outputs"]):
        for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
            np.testing.assert_allclose(n(a_t[k]), n(a_j[k]),
                                       err_msg="aux " + k, **MODEL_TOL)


def test_tiny_vss_model_serves_in_bf16():
    """The bf16 build (the serving dtype) of the same weights: finite
    outputs near the float32 ones, and postprocess_ava's shapes."""
    out_t, model, pixels, mask = _vss_world()[1:]
    sd = model.state_dict()
    with _tiny_spec()[1]:
        m16 = build_model(tiny_vss_cfg(get_cfg_custom(VSS_YAML)),
                          torch.bfloat16, "cpu", input_hw=(64, 128))
    m16.load_state_dict(sd, strict=True)
    dt = {k: v.dtype for k, v in m16.state_dict().items()}
    body = "backbone.0.body.layers.0.mixer."
    assert dt[body + "in_proj.weight"] == torch.bfloat16
    for k in (body + "dt_proj.weight", body + "A_log", body + "D",
              "backbone.0.body.pos_embed", "backbone.0.mamba_proj.0.weight",
              "transformer.encoder.layers.0.ssm.op.x_proj_weight"):
        assert dt[k] == torch.float32, k
    with torch.inference_mode():
        out16 = m16(t(pixels), t(mask))
        sizes = torch.tensor([[64, 128], [64, 96]])
        scores, boxes, actor = postprocess_ava(out16, sizes)
    assert (scores.shape, boxes.shape, actor.shape) == (
        (2, 4, 12), (2, 4, 4), (2, 4, 1))
    for x in (scores, boxes, actor):
        assert torch.isfinite(x).all()
    _bf16_close(out16["pred_boxes"], out_t["pred_boxes"])


def test_vss_init_follows_the_jax_initialisers():
    with _tiny_spec()[1]:
        model = build_model(tiny_vss_cfg(get_cfg_custom(VSS_YAML)),
                            device="cpu", input_hw=(64, 128))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    mixer = "backbone.0.body.layers.1.mixer."
    n_state = sd[mixer + "A_log"].shape[1]
    torch.testing.assert_close(
        sd[mixer + "A_b_log"][3], torch.log(torch.arange(1.0, n_state + 1)))
    assert torch.equal(sd[mixer + "D_b"], torch.ones_like(sd[mixer + "D_b"]))
    dt = torch.nn.functional.softplus(sd[mixer + "dt_proj.bias"])
    assert 1e-4 <= dt.min() and dt.max() <= 0.1 + 1e-6
    rank = sd[mixer + "dt_proj.weight"].shape[1]
    assert sd[mixer + "dt_proj.weight"].abs().max() <= rank ** -0.5
    assert not sd["backbone.0.body.cls_token"].any()
    assert 0.01 < sd["backbone.0.body.pos_embed"].std() < 0.03
    op = "transformer.encoder.layers.0.ssm.op."
    assert not sd[op + "A_logs"].any() and (sd[op + "Ds"] == 1).all()
    bn = "transformer.encoder.layers.0.ssm.proj_conv.1."
    assert (sd[bn + "running_var"] == 1).all() and not sd[bn + "running_mean"].any()
    randomize_constants(model, torch.Generator().manual_seed(1))
    sd2 = model.state_dict()
    for k in (mixer + "A_b_log", mixer + "D_b", op + "A_logs", op + "Ds",
              bn + "running_var", "backbone.0.body.cls_token"):
        assert not torch.equal(sd2[k], sd[k]), k
    assert (sd2[bn + "running_var"] > 0).all()
    assert torch.equal(sd2[mixer + "dt_proj.bias"], sd[mixer + "dt_proj.bias"])
    init_weights(model, torch.Generator().manual_seed(0))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
