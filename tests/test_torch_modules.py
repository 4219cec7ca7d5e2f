"""Each module of the port's eval forward against its flax/JAX counterpart,
on the CPU in float32 at small sizes.  Inputs come from numpy with a seed;
weights are seeded numpy params moved into the port with
``params_from_jax`` + ``load_state_dict(strict=True)``.

Tolerances: both sides compute in float32 and differ only in summation
order and in the math library's sin/cos/exp/tanh, so elementwise functions
agree to ~1e-6 and the small networks to ~1e-5; 1e-4 leaves margin, while
a semantic slip (a layout, an epsilon, a GELU variant, a flipped kernel)
is O(1e-2) or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.losses.criterion import postprocess_ava as j_post
from class_query_vad_tpu.models import backbone as j_backbone
from class_query_vad_tpu.models import common as j_common
from class_query_vad_tpu.models import position_encoding as j_pe
from class_query_vad_tpu.models import resize as j_resize
from class_query_vad_tpu.models import spec as j_spec
from class_query_vad_tpu.models import transformer as j_tr
from class_query_vad_tpu.models.decoder import TransformerDecoder as JDecoder
from class_query_vad_tpu.models.fast_encoder import (
    FastDeformableEncoder as JEncoder,
)
from class_query_vad_tpu.models.vit import ViT as JViT
from class_query_vad_tpu.ops import deform_attn as j_da
from class_query_vad_tpu.ops import fast_deform as j_fd
from class_query_vad_tpu.utils import box_ops as j_box
from class_query_vad_tpu.utils import misc as j_misc
from class_query_vad_tpu_torch.losses import postprocess_ava
from class_query_vad_tpu_torch.models import backbone, common
from class_query_vad_tpu_torch.models import position_encoding as pe
from class_query_vad_tpu_torch.models import resize, spec, transformer, vit
from class_query_vad_tpu_torch.models.decoder import TransformerDecoder
from class_query_vad_tpu_torch.models.fast_encoder import FastDeformableEncoder
from class_query_vad_tpu_torch.models.vit import ViT
from class_query_vad_tpu_torch.ops import deform_attn as da
from class_query_vad_tpu_torch.ops import fast_deform as fd
from class_query_vad_tpu_torch.utils import box_ops, misc

from torch_parity import jit_opt0, load_from_flax, n, random_params, t

TOL = dict(atol=1e-4, rtol=1e-4)
EXACT = dict(atol=1e-6, rtol=1e-6)
# torch.linspace and jnp.linspace round the grid_sample lattice differently
# in the last bit, which moves a bilinear weight by ~1e-7
LERP = dict(atol=1e-5, rtol=1e-5)


def _mask(rng, shape, pad_cols: int):
    m = np.zeros(shape, bool)
    m[-1, ..., shape[-1] - pad_cols:] = True      # last clip padded right
    return m


# --------------------------------------------------------------------------
# elementwise pieces
# --------------------------------------------------------------------------

def test_position_embedding_sine_3d():
    m = _mask(None, (2, 3, 5, 6), 2)
    np.testing.assert_allclose(
        n(pe.position_embedding_sine_3d(t(m), 64)),
        n(j_pe.position_embedding_sine_3d(jnp.asarray(m), 64)), **EXACT)


@pytest.mark.parametrize("frames,t_total", [((1, 2), 4), ((0,), 8)])
def test_position_embedding_sine_3d_frames(frames, t_total):
    m = _mask(None, (2, 5, 6), 3)
    np.testing.assert_allclose(
        n(pe.position_embedding_sine_3d_frames(t(m), frames, t_total, 64)),
        n(j_pe.position_embedding_sine_3d_frames(jnp.asarray(m), frames,
                                                 t_total, 64)), **EXACT)


def test_vit_sinusoid_table():
    np.testing.assert_allclose(n(pe.vit_sinusoid_table(300, 96)),
                               n(j_pe.vit_sinusoid_table(300, 96)),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("dims", [2, 4])
def test_sine_embed_for_position(dims):
    pos = np.random.default_rng(dims).uniform(size=(3, 5, dims)).astype(
        np.float32)
    np.testing.assert_allclose(
        n(common.sine_embed_for_position(t(pos), 32)),
        n(j_common.sine_embed_for_position(jnp.asarray(pos), 32)), **EXACT)


def test_misc_and_box_ops():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.1, 1.1, size=(4, 7)).astype(np.float32)
    np.testing.assert_allclose(n(misc.inverse_sigmoid(t(x))),
                               n(j_misc.inverse_sigmoid(jnp.asarray(x))),
                               **EXACT)
    m = rng.uniform(size=(2, 13, 17)) > 0.6
    for hw in [(4, 5), (26, 9), (13, 17)]:
        np.testing.assert_array_equal(
            n(misc.interpolate_mask(t(m), hw)),
            n(j_misc.interpolate_mask(jnp.asarray(m), hw)))
    b = rng.uniform(size=(2, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(n(box_ops.box_cxcywh_to_xyxy(t(b))),
                               n(j_box.box_cxcywh_to_xyxy(jnp.asarray(b))),
                               **EXACT)


# --------------------------------------------------------------------------
# resizes and level alignment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src,out", [((8, 10), (4, 5)), ((4, 5), (4, 5)),
                                     ((2, 3), (8, 12)), ((6, 4), (5, 7))])
def test_grid_resize_2d(src, out):
    x = np.random.default_rng(0).standard_normal((2, 1, *src, 8)).astype(
        np.float32)
    np.testing.assert_allclose(n(resize.grid_resize_2d(t(x), out)),
                               n(j_resize.grid_resize_2d(jnp.asarray(x), out)),
                               **LERP)


def test_grid_resize_3d_and_at_frame():
    x = np.random.default_rng(1).standard_normal((2, 4, 6, 5, 8)).astype(
        np.float32)
    full = j_resize.grid_resize_3d(jnp.asarray(x), (8, 3, 4))
    np.testing.assert_allclose(n(resize.grid_resize_3d(t(x), (8, 3, 4))),
                               n(full), **LERP)
    np.testing.assert_allclose(
        n(resize.grid_resize_3d_at_frame(t(x), (8, 3, 4), 4)),
        n(full[:, 4:5]), **LERP)


def test_bicubic_resize_2d():
    x = np.random.default_rng(2).standard_normal((3, 14, 14, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        n(resize.bicubic_resize_2d(t(x), (16, 20))),
        n(j_resize.bicubic_resize_2d(jnp.asarray(x), (16, 20))), **TOL)


def test_align_all_levels():
    rng = np.random.default_rng(3)
    shapes = [(16, 20), (8, 10), (4, 5), (2, 5)]
    vals = [rng.standard_normal((2, 2, h, w, 16)).astype(np.float32)
            for h, w in shapes]
    got = fd.align_all_levels([t(v) for v in vals], shapes)
    want = j_fd.align_all_levels([jnp.asarray(v) for v in vals], shapes)
    for gi, wi in zip(got, want):
        for g, w in zip(gi, wi):
            assert g.shape == w.shape
            np.testing.assert_allclose(n(g), n(w), **TOL)


@pytest.mark.parametrize("frame", [None, 4])
def test_make_interpolated_features(frame):
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, tl, h, w, 8)).astype(np.float32)
             for tl, h, w in [(4, 8, 10), (8, 4, 5), (4, 2, 3)]]
    got = transformer.make_interpolated_features([t(f) for f in feats], 8,
                                                 frame=frame)
    want = j_tr.make_interpolated_features([jnp.asarray(f) for f in feats],
                                           8, frame=frame)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **LERP)


def test_center_slice_plan():
    for args in [(True, True, "2d", 4, 16, 8), (True, True, "2d", 4, 8, 4),
                 (True, True, "2d", 4, 8, 8), (True, True, "3d", 4, 16, 8),
                 (False, True, "2d", 4, 16, 8), (True, False, "2d", 4, 16, 8),
                 (True, True, "2d", 4, 9, 4), (True, True, "2d", 1, 16, 8)]:
        assert transformer.center_slice_plan(*args) == \
            j_tr.center_slice_plan(*args), args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_center_planes(dtype):
    """The presliced decode's centre-frame lerp onto the ref level's (the
    second-to-last) grid: in bf16 the JAX package's float32 lerp weights
    promote the encoder output to float32."""
    rng = np.random.default_rng(12)
    mem = [rng.standard_normal((2, 2, h, w, 8)).astype(np.float32)
           for h, w in [(16, 20), (8, 10), (4, 5), (2, 3)]]
    frames, fweights, transposed2d = j_tr.center_slice_plan(
        True, True, "2d", 4, 16, 8)
    assert not transposed2d and len(set(frames)) == 2
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    wts = jnp.asarray(fweights, jnp.float32)
    want = []
    for m in mem:
        mj = jnp.asarray(m, jdt)
        want.append(j_resize.grid_resize_2d(mj[:, 0:1] * wts[0]
                                            + mj[:, 1:2] * wts[1], (4, 5)))
    got = transformer.center_planes(
        [t(np.asarray(jnp.asarray(m, jdt).astype(jnp.float32))).to(tdt)
         for m in mem], fweights, False, 0, 1)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(n(g), n(w), **LERP)


def test_directional_offset_init_l2hp():
    np.testing.assert_allclose(
        n(da.directional_offset_init_l2hp(8, 4, 8)),
        n(j_da.directional_offset_init_l2hp(8, 4, 8)), **EXACT)


# --------------------------------------------------------------------------
# networks
# --------------------------------------------------------------------------

_VIT = dict(embed_dim=96, depth=2, num_heads=4, pretrain_img_size=64,
            num_frames=8, use_checkpoint=False)


@pytest.mark.parametrize("out_frame_range", [None, (1, 3)])
def test_vit(out_frame_range):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 64, 80, 3)).astype(np.float32)
    jm = JViT(embed_dim=96, depth=2, num_heads=4, pretrain_img_size=64,
              num_frames=8)
    params = random_params(lambda k, a: jm.init(k, a, True), jnp.asarray(x),
                           seed=5)
    want = jit_opt0(lambda p, a: jm.apply(p, a, True, out_frame_range),
                    params, jnp.asarray(x))
    tm = ViT(spec.ViTSpec(**_VIT)).eval()              # deterministic=True
    load_from_flax(tm, params, ("backbone", "body"), "backbone.0.body.")
    with torch.inference_mode():
        got = tm(t(x), out_frame_range=out_frame_range)
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_vit_softmax_bf16():
    """The ViT's softmax in bf16 against the JAX package's lines
    (vit.py:107-115) on the same bf16 scores: the two exp libraries may
    land either side of a bf16 rounding boundary (one ulp, 2**-8)."""
    s = (4.0 * np.random.default_rng(13).standard_normal((2, 3, 17, 300))
         ).astype(np.float32)
    sj = jnp.asarray(s, jnp.bfloat16)
    e = jnp.exp((sj - sj.max(-1, keepdims=True)).astype(jnp.float32)).astype(
        jnp.bfloat16)
    want = e / e.astype(jnp.float32).sum(-1, keepdims=True).astype(jnp.bfloat16)
    got = vit.softmax(t(np.asarray(sj.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), n(want), atol=0, rtol=2.0 ** -8)


@pytest.mark.parametrize("sliced", [False, True])
def test_backbone_fpn(sliced):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 64, 64, 3)).astype(np.float32)
    m = _mask(rng, (2, 64, 64), 16)
    js = j_spec.ModelSpec(d_model=32, vit=j_spec.ViTSpec(**_VIT))
    jm = j_backbone.ViTBackboneFPN(js, 32)
    kw = dict(out_frames=(1, 2), dec_frame=0) if sliced else {}
    params = random_params(lambda k, a, b: jm.init(k, a, b, True),
                           jnp.asarray(x), jnp.asarray(m), seed=6)
    want = jit_opt0(lambda p, a, b: jm.apply(p, a, b, True, **kw),
                    params, jnp.asarray(x), jnp.asarray(m))
    tm = backbone.ViTBackboneFPN(
        spec.ModelSpec(d_model=32, vit=spec.ViTSpec(**_VIT)), 32).eval()
    load_from_flax(tm, params, ("backbone",), "backbone.0.")
    with torch.inference_mode():
        got = tm(t(x), t(m), **kw)
    assert len(got) == len(want) == (4 if sliced else 3)
    for g_l, w_l in zip(got[:3], want[:3]):
        for g, w in zip(g_l, w_l):
            assert g.shape == w.shape
            np.testing.assert_allclose(n(g), n(w), **TOL)
    if sliced:
        np.testing.assert_allclose(n(got[3]), n(want[3]), **EXACT)


def test_fast_encoder():
    rng = np.random.default_rng(7)
    grids = [(2, 8, 12), (2, 4, 6), (2, 2, 3)]
    srcs = [rng.standard_normal((2, *g, 256)).astype(np.float32) for g in grids]
    poses = [rng.standard_normal((2, *g, 256)).astype(np.float32) for g in grids]
    masks = [_mask(rng, (2, *g), 1) for g in grids]
    jm = JEncoder(2, 256, 64, 3, 8, 8, 1, "2d", "resample")
    args = [[jnp.asarray(a) for a in x] for x in (srcs, poses, masks)]
    params = random_params(lambda k, *a: jm.init(k, *a, True), *args, seed=7)
    want = jit_opt0(lambda p, *a: jm.apply(p, *a, True), params, *args)
    tm = FastDeformableEncoder(2, 256, 64, 3, 8, 8, 1, "2d", "resample").eval()
    load_from_flax(tm, params, ("transformer", "encoder"),
                   "transformer.encoder.")
    with torch.inference_mode():
        got = tm([t(a) for a in srcs], [t(a) for a in poses],
                 [t(a) for a in masks])
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_decoder(num_layers):
    rng = np.random.default_rng(8)
    d, nq, nl, (h, w) = 64, 3, 3, (4, 5)
    tgt = np.zeros((2, nq, d), np.float32)
    mem = rng.standard_normal((2, nl, h * w, d)).astype(np.float32)
    mask = np.zeros((2, h * w), bool)
    mask[1, -3:] = True
    pos = rng.standard_normal((2, nl, h * w, d)).astype(np.float32)
    refs = rng.standard_normal((2, nq, 4)).astype(np.float32)
    jm = JDecoder(num_layers, d, 8, 32, 0.1, 5, n_levels=nl)
    args = [jnp.asarray(a) for a in (tgt, mem, mask, pos, refs)]
    params = random_params(lambda k, *a: jm.init(k, *a, (h, w), True), *args,
                           seed=8)
    want = jit_opt0(lambda p, *a: jm.apply(p, *a, (h, w), True), params,
                    *args)
    tm = TransformerDecoder(num_layers, d, 8, 32, 5, n_levels=nl).eval()
    load_from_flax(tm, params, ("transformer", "decoder"),
                   "transformer.decoder.")
    with torch.inference_mode():
        got = tm(*[t(a) for a in (tgt, mem, mask, pos, refs)], (h, w))
    for g, w_ in zip(got, want):                   # hs, cls_hs, references
        assert g.shape == w_.shape
        np.testing.assert_allclose(n(g), n(w_), **TOL)


def test_postprocess_ava():
    rng = np.random.default_rng(9)
    out = {"pred_logits": rng.standard_normal((2, 15, 80)),
           "pred_boxes": rng.uniform(size=(2, 15, 4)),
           "pred_logits_b": rng.standard_normal((2, 15, 3))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    sizes = np.array([[256, 320], [256, 288]])
    got = postprocess_ava({k: t(v) for k, v in out.items()}, t(sizes))
    want = j_post({k: jnp.asarray(v) for k, v in out.items()},
                  jnp.asarray(sizes))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(n(g), n(w), **EXACT)


# --------------------------------------------------------------------------
# trouble spots of a flax -> torch port, pinned directly
# --------------------------------------------------------------------------

def test_every_layernorm_has_flax_epsilon():
    """flax nn.LayerNorm's default eps is 1e-6, torch's 1e-5."""
    tm = backbone.ViTBackboneFPN(
        spec.ModelSpec(d_model=32, vit=spec.ViTSpec(**_VIT)), 32)
    dec = TransformerDecoder(2, 64, 8, 32, 5, n_levels=3)
    enc = FastDeformableEncoder(1, 256, 64, 3)
    norms = [m for mod in (tm, dec, enc) for m in mod.modules()
             if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) > 10
    assert all(m.eps == 1e-6 for m in norms)


def test_every_gelu_is_exact():
    """flax ``nn.gelu`` defaults to the tanh approximation (common.py:35);
    the path's GELUs pass approximate=False (vit.py:152, backbone.py:55,
    decoder.py:132), which is torch's default erf form."""
    x = np.linspace(-4.0, 4.0, 101, dtype=np.float32)
    exact = n(jax.nn.gelu(jnp.asarray(x), approximate=False))
    np.testing.assert_allclose(n(torch.nn.functional.gelu(t(x))), exact,
                               **EXACT)
    assert np.abs(n(jax.nn.gelu(jnp.asarray(x))) - exact).max() > 1e-4
    tm = backbone.ViTBackboneFPN(
        spec.ModelSpec(d_model=32, vit=spec.ViTSpec(**_VIT)), 32)
    gelus = [m for m in tm.modules() if isinstance(m, torch.nn.GELU)]
    assert gelus and all(m.approximate == "none" for m in gelus)


def test_conv_transpose_kernel_flip():
    """flax ConvTranspose (transpose_kernel=False) applies the kernel
    mirrored relative to torch's ConvTranspose3d."""
    import flax.linen as fnn

    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, 2, 3, 4, 6)).astype(np.float32)
    jm = fnn.ConvTranspose(5, (1, 2, 2), strides=(1, 2, 2))
    params = random_params(lambda k, a: jm.init(k, a), jnp.asarray(x), seed=10)
    want = jm.apply(params, jnp.asarray(x))
    tm = backbone.UpConv2x(6, 5)
    load_from_flax(tm, {"lateral_convs_1": {"up1": params["params"]}},
                   ("backbone",), "backbone.0.lateral_convs.1.0.")
    with torch.inference_mode():
        got = tm(t(x))
        ref = torch.nn.functional.conv_transpose3d(
            t(x).permute(0, 4, 1, 2, 3), tm.weight, tm.bias,
            stride=(1, 2, 2)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got), n(ref), **TOL)   # torch semantics
