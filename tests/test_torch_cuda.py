"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip without a CUDA device.  This file imports
nothing of JAX, so it also runs where JAX is not installed; from the repo
root on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.models.detr import randomize_constants
from class_query_vad_tpu_torch.models.vit import softmax
from class_query_vad_tpu_torch.ops.blend2d import (
    FWD_SHAPES,
    K3_SHAPES,
    K4_SHAPES,
    blend2d,
    blend2d_backward_reference,
    blend2d_bwd_dcomps,
    blend2d_bwd_dcomps_reference,
    blend2d_bwd_dvol,
    blend2d_bwd_dvol_reference,
    blend2d_reference,
)
from class_query_vad_tpu_torch.ops.blend3d import (
    blend3d,
    blend3d_backward_reference,
    blend3d_bwd_dcomps,
    blend3d_bwd_dvol,
    blend3d_fwd,
    blend3d_reference,
)
from class_query_vad_tpu_torch.ops.cuda_build import launch
from class_query_vad_tpu_torch.ops.fast_deform_cuda import (
    fused_blend2d,
    fused_blend2d_reference,
    fused_components,
)
from class_query_vad_tpu_torch.ops.fused_ffn import (
    ffn_reference,
    fused_ffn,
    fused_ffn_kernel,
    fused_ffn_plain,
)
from class_query_vad_tpu_torch.ops.native_blend import (
    native_blend,
    native_blend2d,
    native_blend3d,
    native_blend_reference,
)
from class_query_vad_tpu_torch.ops.row_gather import row_gather, row_gather_ref
from class_query_vad_tpu_torch.ops.selective_scan import (
    scan_carries,
    scan_chunk,
    selective_scan,
    selective_scan_bwd,
    selective_scan_bwd_reference,
    selective_scan_reference,
)
from class_query_vad_tpu_torch.ops.vit_attention import (
    attention_from_qkv_ref,
    flash_attention_plain,
    flash_attention_qkv,
    vit_attention,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# float32: summation order only.  bf16: offsets and weights rounded to bf16
# on both sides; tanh/exp may round across a bf16 boundary.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("jl,thw", [(4, (2, 7, 9)), (2, (1, 16, 20)),
                                    (3, (1, 1, 5))])
def test_fused_blend2d_matches_plain(card, dtype, tol, jl, thw):
    tt, h, w = thw
    rng = np.random.default_rng(jl)
    vol = torch.from_numpy(rng.standard_normal(
        (2, jl, tt, h, w, 256), np.float32)).to(card, dtype)
    fused = torch.from_numpy(2.0 * rng.standard_normal(
        (2, tt, h, w, 3 * jl * 64), np.float32)).to(card, dtype)
    before = fused_blend2d.launches
    out = fused_blend2d(vol, fused, 8, 1.0)
    torch.cuda.synchronize()
    assert fused_blend2d.launches == before + 1
    ref = fused_blend2d_reference(vol, fused, 8, 1.0)
    err = (out - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


@pytest.mark.cuda
def test_vit_softmax_rounds_like_the_cast_form(card):
    """On the card, exp of bf16 scores rounds exp-in-float32 once: the
    same values as the JAX package's explicit float32 round trip."""
    g = torch.Generator().manual_seed(0)
    s = (4.0 * torch.randn((2, 12, 64, 2560), generator=g)).bfloat16().to(card)
    d = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(d.float()).bfloat16()
    want = e / e.float().sum(dim=-1, keepdim=True).bfloat16()
    assert torch.equal(torch.exp(d), e)
    torch.testing.assert_close(softmax(s), want, atol=0, rtol=2.0 ** -8)


def _comps(card, dtype, jl, thw, points, seed, ties=False):
    tt, h, w = thw
    g = torch.Generator().manual_seed(seed)
    shape = (2, jl, tt, h, w, 8 * points)
    vol = torch.randn((2, jl, tt, h, w, 256), generator=g)
    dx = torch.rand(shape, generator=g) * 2 - 1
    dy = torch.rand(shape, generator=g) * 2 - 1
    if ties:
        for x in (dx, dy):
            pick = torch.rand(shape, generator=g) < 1 / 3
            x[pick] = torch.randint(-1, 2, shape, generator=g).float()[pick]
    a = torch.rand(shape, generator=g) * 0.3
    grad = torch.randn((2, tt, h, w, 256), generator=g)
    return ([x.to(card, dtype) for x in (vol, dx, dy, a)],
            grad.to(card))


def _close(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), 1e-30), (what, err)


# K2-K4: float32 differs only in summation order; bf16 outputs (K3, K4)
# are rounded to bf16 after sums in another order (one ulp, 2^-8).  K3 and
# K4 tile the grid (``k3_block``, ``k4_block``): 7x9, 13x21 and 1x5 leave
# ragged tiles on both axes; K3 stages the components in chunks of 8
# points, copied 16, 8, 4 or 2 bytes at a time (P = 12: two chunks; P = 3
# in bf16: 2-byte copies), and K4 splits a head's points over 4 lanes (P = 3,
# 4, 12: runs of 1, 1 and 3; P = 8 its vector path).
BLEND2D_CASES = [
    (4, (2, 7, 9), 8, False), (4, (2, 7, 9), 8, True),
    (2, (1, 16, 20), 8, True), (3, (1, 1, 5), 4, False),
    (1, (2, 13, 21), 8, True), (2, (2, 13, 21), 12, True),
    (3, (2, 7, 9), 3, True), (4, (1, 1, 5), 3, True), (1, (2, 9, 11), 4, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("jl,thw,points,ties", BLEND2D_CASES)
def test_blend2d_kernels_match_plain(card, dtype, tol, jl, thw, points, ties):
    (vol, dx, dy, a), g = _comps(card, dtype, jl, thw, points, 7, ties)
    before = (blend2d.launches, blend2d_bwd_dvol.launches,
              blend2d_bwd_dcomps.launches)
    out = blend2d(vol, dx, dy, a, 8)
    dvol = blend2d_bwd_dvol(dx, dy, a, g, vol.dtype, 8)
    ddx, ddy, da = blend2d_bwd_dcomps(vol, dx, dy, a, g, 8)
    torch.cuda.synchronize()
    assert (blend2d.launches, blend2d_bwd_dvol.launches,
            blend2d_bwd_dcomps.launches) == tuple(x + 1 for x in before)
    _close(out, blend2d_reference(vol, dx, dy, a, 8), 1e-5, "K2")
    want = blend2d_backward_reference(vol, dx, dy, a, g, 8)
    for name, got, w in zip(("K3 dvol", "K4 ddx", "K4 ddy", "K4 da"),
                            (dvol, ddx, ddy, da), want):
        assert got.dtype == dtype, name
        _close(got, w, tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("jl,thw,points", [(4, (2, 13, 21), 8), (3, (1, 7, 9), 3),
                                           (2, (2, 9, 11), 12)])
def test_blend2d_bwd_every_block_shape(card, dtype, tol, jl, thw, points):
    """K3 and K4 through their launchers at every block shape they take
    (``K3_SHAPES``, ``K4_SHAPES``), not only those ``k3_block`` /
    ``k4_block`` pick, against the plain versions."""
    (vol, dx, dy, a), g = _comps(card, dtype, jl, thw, points, 11, True)
    want = blend2d_backward_reference(vol, dx, dy, a, g, 8)
    b, _, tt, h, w, _ = vol.shape
    ints = [int(dtype == torch.bfloat16), b, jl, tt, h, w, points]
    for shape in K3_SHAPES:
        dvol = torch.full_like(vol, float("nan"))
        launch("blend2d_bwd_dvol", card, dx.data_ptr(), dy.data_ptr(), a.data_ptr(),
               g.data_ptr(), dvol.data_ptr(), *ints, *shape)
        torch.cuda.synchronize()
        _close(dvol, want[0], tol, f"K3 {shape}")
    for shape in K4_SHAPES:
        outs = [torch.full_like(dx, float("nan")) for _ in range(3)]
        launch("blend2d_bwd_dcomps", card, vol.data_ptr(), dx.data_ptr(), dy.data_ptr(),
               a.data_ptr(), g.data_ptr(), *(x.data_ptr() for x in outs), *ints, *shape)
        torch.cuda.synchronize()
        for name, got, w_ in zip(("ddx", "ddy", "da"), outs, want[1:]):
            _close(got, w_, tol, f"K4 {name} {shape}")


# K1 and K2 tile the grid (``fwd_block``): 7x9, 13x21, 9x11 and 5x17
# leave ragged tiles on both axes at every block shape, 1x5 a tile row
# below the grid; K2 reads its components as vectors at P = 4, point by
# point at P = 8 and 3.
FWD_TILED_CASES = [(4, (2, 13, 21)), (3, (1, 9, 11)), (2, (2, 5, 17)),
                   (1, (1, 7, 9)), (4, (1, 1, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("jl,thw", FWD_TILED_CASES)
def test_fused_blend2d_every_block_shape(card, dtype, tol, jl, thw):
    """K1 through its launcher at every block shape it takes
    (``FWD_SHAPES``), not only those ``fwd_block`` picks, against its plain
    version; what the kernel never writes starts as NaN."""
    tt, h, w = thw
    rng = np.random.default_rng(10 + jl)
    vol = torch.from_numpy(rng.standard_normal(
        (2, jl, tt, h, w, 256), np.float32)).to(card, dtype)
    fused = torch.from_numpy(2.0 * rng.standard_normal(
        (2, tt, h, w, 3 * jl * 64), np.float32)).to(card, dtype)
    want = fused_blend2d_reference(vol, fused, 8, 1.0)
    before = fused_blend2d.launches
    for shape in FWD_SHAPES:
        out = torch.full_like(want, float("nan"))
        launch("fused_blend2d", card, vol.data_ptr(), fused.data_ptr(), out.data_ptr(),
               int(dtype == torch.bfloat16), 2, jl, tt, h, w, 1.0, *shape)
        torch.cuda.synchronize()
        _close(out, want, tol, f"K1 {shape}")
    assert fused_blend2d.launches == before     # the launcher counts nothing


# bf16 only at a power-of-two radius: elsewhere the plain version rounds
# tanh to bf16 and radius x tanh again (as the JAX package's composite
# does), the kernel radius x tanh once (as the TPU kernel does)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,radius", [(torch.float32, 1e-5, 0.5),
                                              (torch.bfloat16, 1e-2, 0.5),
                                              (torch.float32, 1e-5, 1.5)])
def test_fused_blend2d_radius(card, dtype, tol, radius):
    """K1 at a radius under one pixel and past it, against its plain
    version."""
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.standard_normal((2, 4, 2, 9, 11, 256), np.float32)).to(card, dtype)
    fused = torch.from_numpy(2.0 * rng.standard_normal(
        (2, 2, 9, 11, 3 * 4 * 64), np.float32)).to(card, dtype)
    _close(fused_blend2d(vol, fused, 8, radius),
           fused_blend2d_reference(vol, fused, 8, radius), tol, f"K1 radius {radius}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("jl,thw", FWD_TILED_CASES)
@pytest.mark.parametrize("points", [8, 4, 3])
def test_blend2d_every_block_shape(card, dtype, jl, thw, points):
    """K2 through its launcher at every block shape it takes
    (``FWD_SHAPES``) against its plain version (float32 summation order
    only, in either dtype: 1e-5), then through its wrapper, which counts
    one launch."""
    (vol, dx, dy, a), _ = _comps(card, dtype, jl, thw, points, 13, True)
    want = blend2d_reference(vol, dx, dy, a, 8)
    b, _, tt, h, w, _ = vol.shape
    for shape in FWD_SHAPES:
        out = torch.full_like(want, float("nan"))
        launch("blend2d", card, *(x.data_ptr() for x in (vol, dx, dy, a, out)),
               int(dtype == torch.bfloat16), b, jl, tt, h, w, points, *shape)
        torch.cuda.synchronize()
        _close(out, want, 1e-5, f"K2 {shape}")
    before = blend2d.launches
    _close(blend2d(vol, dx, dy, a, 8), want, 1e-5, "K2 wrapper")
    assert blend2d.launches == before + 1


@pytest.mark.cuda
def test_fwd_kernels_reject_what_they_do_not_take(card):
    """K1's and K2's launchers refuse a block shape they were not built
    for and J outside 1..4, with a CUDA error the wrapper raises."""
    (vol, dx, dy, a), _ = _comps(card, torch.bfloat16, 2, (1, 4, 4), 8, 1)
    out = torch.empty((2, 1, 4, 4, 256), device=card)
    fused = torch.zeros((2, 1, 4, 4, 3 * 2 * 64), device=card, dtype=torch.bfloat16)
    for bad in ((8, 8), (3, 3)):
        with pytest.raises(RuntimeError):
            launch("blend2d", card, *(x.data_ptr() for x in (vol, dx, dy, a, out)),
                   1, 2, 2, 1, 4, 4, 8, *bad)
        with pytest.raises(RuntimeError):
            launch("fused_blend2d", card, vol.data_ptr(), fused.data_ptr(),
                   out.data_ptr(), 1, 2, 2, 1, 4, 4, 1.0, *bad)
    with pytest.raises(RuntimeError):
        launch("blend2d", card, *(x.data_ptr() for x in (vol, dx, dy, a, out)),
               1, 2, 5, 1, 4, 4, 8, *FWD_SHAPES[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_fused_blend2d_autograd_matches_plain(card, dtype, tol):
    """K1 forward + its backward (recompute, K3, K4) against autograd
    through the plain composite on the same card."""
    g = torch.Generator().manual_seed(3)
    vol = torch.randn((2, 4, 2, 8, 10, 256), generator=g).to(card, dtype)
    fused = (2 * torch.randn((2, 2, 8, 10, 768), generator=g)).to(card, dtype)
    grad = torch.randn((2, 2, 8, 10, 256), generator=g).to(card)
    before = (fused_blend2d.launches, blend2d_bwd_dvol.launches,
              blend2d_bwd_dcomps.launches, blend2d.launches)
    a = [vol.clone().requires_grad_(), fused.clone().requires_grad_()]
    fused_blend2d(*a, 8, 1.0).backward(grad)
    torch.cuda.synchronize()
    assert (fused_blend2d.launches, blend2d_bwd_dvol.launches,
            blend2d_bwd_dcomps.launches, blend2d.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    b = [vol.clone().requires_grad_(), fused.clone().requires_grad_()]
    blend2d_reference(b[0], *fused_components(b[1], 4, 8, 1.0), 8).backward(grad)
    _close(a[0].grad, b[0].grad, tol, "d vol")
    _close(a[1].grad, b[1].grad, tol, "d fused")


@pytest.mark.cuda
def test_tiny_train_step_on_the_card(card):
    """One tiny float32 train step on the card and on the CPU, same seeded
    weights and batch, dropout off: same losses and gradients, and K1, K3,
    K4 each launched once per encoder layer and query level."""
    cfg = get_cfg_defaults()
    c = cfg.CONFIG
    c.DATA.NUM_CLASSES, c.DATA.TEMP_LEN, c.MODEL.TEMP_LEN = 12, 8, 8
    c.MODEL.SINGLE_FRAME = True
    c.MODEL.ENCODER_TYPE, c.MODEL.FAST_WINDOW = "fast_attention", "2d"
    c.MODEL.ENC_LAYERS, c.MODEL.DEC_LAYERS = 2, 2
    c.MODEL.DIM_FEEDFORWARD, c.MODEL.QUERY_NUM, c.ViT.DEPTH = 64, 4, 1
    c.MODEL.DROPOUT, c.ViT.DROP_PATH_RATE = 0.0, 0.0
    m_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    randomize_constants(m_cpu, torch.Generator().manual_seed(2))
    m_gpu = build_model(cfg, device=card)
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    batch = {
        "pixels": rng.standard_normal((2, 8, 64, 64, 3), np.float32),
        "mask": np.zeros((2, 64, 64), bool),
        "boxes": rng.uniform(0.2, 0.7, (2, 6, 4)).astype(np.float32),
        "labels": (rng.random((2, 6, 12)) < 0.2).astype(np.float32),
        "n_boxes": np.array([3, 2], np.int32),
    }
    res = []
    for model, dev in ((m_cpu, "cpu"), (m_gpu, card)):
        model.head_dropout.p = 0.0
        trainer = Trainer(model, cfg, device=dev)
        before = [k.launches for k in (fused_blend2d, blend2d_bwd_dvol,
                                       blend2d_bwd_dcomps)]
        total, losses, match = trainer.loss(
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        total.backward()
        after = [k.launches for k in (fused_blend2d, blend2d_bwd_dvol,
                                      blend2d_bwd_dcomps)]
        res.append((total.item(), match, {k: p.grad.cpu() for k, p in
                                          model.named_parameters()},
                    [x - y for x, y in zip(after, before)]))
    (t_c, m_c, g_c, n_c), (t_g, m_g, g_g, n_g) = res
    assert n_c == [0, 0, 0] and n_g == [2 * 4] * 3
    ok = m_c.match_ok
    assert torch.equal(ok, m_g.match_ok.cpu())
    assert torch.equal(m_c.gt_idx[ok], m_g.gt_idx.cpu()[ok])
    assert abs(t_g - t_c) <= 1e-4 * abs(t_c)
    # 1e-2 of each tensor's largest gradient, with a floor of 1e-5 of the
    # model's: some gradients are zero up to rounding (a key bias shifts
    # all of a query's logits alike) and their noise has no scale
    floor = 1e-5 * max(g.abs().max().item() for g in g_c.values())
    for k in g_c:
        err = (g_g[k] - g_c[k]).abs().max().item()
        assert err <= 1e-2 * g_c[k].abs().max().item() + floor, (k, err)


@pytest.mark.cuda
def test_tiny_model_card_matches_cpu(card):
    """A tiny float32 model on the card (kernel) and on the CPU (plain
    version), same seeded weights and input."""
    cfg = get_cfg_defaults()
    c = cfg.CONFIG
    c.DATA.NUM_CLASSES, c.DATA.TEMP_LEN, c.MODEL.TEMP_LEN = 12, 8, 8
    c.MODEL.SINGLE_FRAME = True
    c.MODEL.ENCODER_TYPE, c.MODEL.FAST_WINDOW = "fast_attention", "2d"
    c.MODEL.ENC_LAYERS, c.MODEL.DEC_LAYERS = 2, 1
    c.MODEL.DIM_FEEDFORWARD, c.MODEL.QUERY_NUM, c.ViT.DEPTH = 64, 4, 1
    m_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    randomize_constants(m_cpu, torch.Generator().manual_seed(2))
    m_gpu = build_model(cfg, device=card)
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.standard_normal((2, 8, 64, 64, 3), np.float32))
    mask = torch.zeros((2, 64, 64), dtype=torch.bool)
    mask[1, :, 48:] = True
    before = fused_blend2d.launches
    with torch.inference_mode():
        out_g = m_gpu(pixels.to(card), mask.to(card))
        out_c = m_cpu(pixels, mask)
    assert fused_blend2d.launches == before + 2 * 4      # layers x levels
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        g, r = out_g[k].cpu(), out_c[k]
        assert (g - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), k



# float32: the same arithmetic in other orders, carried by the recurrence;
# bf16: y rounded to bf16 on both sides
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,time_major", [
    ((2, 384, 700, 16, 1), True),        # backbone-like: delta [B, L, KD]
    ((2, 1024, 320, 4, 4), False),       # the VSS encoder's
    ((1, 96, 37, 8, 2), False),          # ragged channel tile, odd L
])
def test_selective_scan_matches_plain(card, dtype, tol, shape, time_major):
    b, kd, length, ns, g = shape
    rng = np.random.default_rng(kd)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(card)
    u = f(b, kd, length).to(dtype)
    delta = (0.5 * f(b, length, kd)).transpose(1, 2) if time_major else 0.5 * f(b, kd, length)
    bc = f(b, g, 2 * ns, length).to(dtype)
    bm, cm = bc[:, :, :ns], bc[:, :, ns:]
    a = -torch.exp(f(kd, ns))
    d, bias = f(kd), f(kd) - 2.0
    for kw in (dict(D=d, delta_bias=bias, delta_softplus=True),
               dict(delta_softplus=True)):
        before = selective_scan.launches
        with torch.no_grad():
            y, last = selective_scan(u, delta, a, bm, cm, return_last_state=True, **kw)
        torch.cuda.synchronize()
        assert selective_scan.launches == before + 1
        y_p, last_p = selective_scan_reference(u, delta, a, bm, cm,
                                               return_last_state=True, **kw)
        assert y.dtype == dtype and torch.isfinite(y).all()
        for got, want in ((y, y_p), (last, last_p)):
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * want.float().abs().max().item(), (kw.keys(), err)


def _scan_inputs(card, dtype, b, kd, length, ns, g, layout, seed):
    """K5's inputs laid out as the VSS path hands them over: the backbone
    (G=1) reads u [B, KD, L], delta as a time-major view of [B, L, KD] and
    B, C as views of the x_proj output [B, L, R + 2N] (R = 12); the
    encoder reads delta [B, KD, L] and B, C as slices of [B, G, R + 2N, L]
    (R = 8)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(card)
    u = f(b, kd, length).to(dtype)
    if layout == "backbone":
        delta = (0.5 * f(b, length, kd)).transpose(1, 2)
        dbl = f(b, length, 12 + 2 * ns).to(dtype)
        bm = dbl[..., 12:12 + ns].transpose(1, 2)[:, None]
        cm = dbl[..., 12 + ns:].transpose(1, 2)[:, None]
    else:
        delta = 0.5 * f(b, kd, length)
        dbl = f(b, g, 8 + 2 * ns, length).to(dtype)
        bm, cm = dbl[:, :, 8:8 + ns], dbl[:, :, 8 + ns:]
    return u, delta, -torch.exp(f(kd, ns)), bm, cm, f(kd), f(kd) - 2.0


# K5 parallel over L: one chunk (L <= chunk), exact multiples of the chunk,
# one step past one, several and a remainder; float32 and bf16 at their
# strides on the VSS path; tolerances as above
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,layout", [
    ((2, 384, 16, 1), "backbone"),
    ((2, 1024, 4, 4), "encoder"),
    ((1, 96, 8, 2), "encoder"),
])
@pytest.mark.parametrize("length", [1, 37, "chunk", "chunk+1", "3chunks+5"])
def test_selective_scan_lengths_and_chunks(card, dtype, tol, shape, layout, length):
    b, kd, ns, g = shape
    if isinstance(length, str):                  # resolved against the chunk
        c = scan_chunk(b, kd, 64, g)
        length = {"chunk": c, "chunk+1": c + 1, "3chunks+5": 3 * c + 5}[length]
    u, delta, a, bm, cm, d, bias = _scan_inputs(card, dtype, b, kd, length, ns, g,
                                                layout, length)
    for kw in (dict(D=d, delta_bias=bias, delta_softplus=True),
               dict(delta_softplus=False)):
        if not kw["delta_softplus"]:
            delta = delta.abs()
        before = selective_scan.launches
        with torch.no_grad():
            y, last = selective_scan(u, delta, a, bm, cm, return_last_state=True, **kw)
        torch.cuda.synchronize()
        assert selective_scan.launches == before + 1
        y_p, last_p = selective_scan_reference(u, delta, a, bm, cm,
                                               return_last_state=True, **kw)
        assert y.dtype == dtype and torch.isfinite(y).all()
        for got, want in ((y, y_p), (last, last_p)):
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * want.float().abs().max().item(), (length, kw.keys(), err)


@pytest.mark.cuda
def test_selective_scan_autograd_on_the_card(card):
    """With a gradient needed, K5 keeps its chunk carry-ins and its
    backward kernel runs once per backward: the gradients of every input
    within 1e-4 of autograd through the plain version on the CPU."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))
    args = [f(1, 64, 150), 0.5 * f(1, 64, 150).abs(), -torch.exp(f(64, 4)),
            f(1, 2, 4, 150), f(1, 2, 4, 150), f(64), f(64)]
    dy = f(1, 64, 150)
    grads = []
    for dev in ("cpu", card):
        leaves = [x.detach().to(dev).requires_grad_(True) for x in args]
        counts = (selective_scan.launches, selective_scan_bwd.launches)
        y = selective_scan(*leaves[:5], D=leaves[5], delta_bias=leaves[6],
                           delta_softplus=True)
        (y * dy.to(dev)).sum().backward()
        moved = (selective_scan.launches - counts[0],
                 selective_scan_bwd.launches - counts[1])
        assert moved == ((0, 0) if dev == "cpu" else (1, 1))
        grads.append([x.grad.cpu() for x in leaves])
    for i, (got, want) in enumerate(zip(grads[1], grads[0])):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (i, err)
    before = selective_scan.launches
    with torch.no_grad():
        selective_scan(*[x.detach().to(card).requires_grad_(True) for x in args])
    assert selective_scan.launches == before + 1


# K5's backward against its plain version at the VSS path's shapes and
# strides (the backbone's bf16 scan, B=1, L=5121; the encoder's; a ragged
# channel block and odd L), each flag set of chip_smoke's phase 7: every
# gradient within 1e-4 (float32) / 1e-2 (bf16: du, dB, dC rounded to bf16
# on both sides) x max|ref|; dA, dD and d delta_bias, sums over B x L
# steps, within 1e-3
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,layout", [
    (torch.bfloat16, (1, 384, 5121, 16, 1), "backbone"),
    (torch.float32, (1, 1024, 320, 4, 4), "encoder"),
    (torch.float32, (1, 96, 37, 8, 2), "encoder"),
    (torch.bfloat16, (2, 96, 37, 8, 1), "backbone"),
])
@pytest.mark.parametrize("flags", ["all", "none", "softplus"])
def test_selective_scan_bwd_matches_plain(card, dtype, shape, layout, flags):
    b, kd, length, ns, g = shape
    u, delta, a, bm, cm, d, bias = _scan_inputs(card, dtype, b, kd, length, ns,
                                                g, layout, seed=length + ns)
    kw = dict(D=d, delta_bias=bias, delta_softplus=True)
    if flags == "none":
        kw, delta = dict(delta_softplus=False), delta.abs()
    elif flags == "softplus":
        kw = dict(delta_softplus=True)
    dy = torch.randn(u.shape, device=card).to(dtype)
    dlast = torch.randn((b, kd, ns), device=card)
    carries = scan_carries(u, delta, a, bm, cm, **kw)
    before = selective_scan_bwd.launches
    got = selective_scan_bwd(u, delta, a, bm, cm, dy, carries=carries,
                             dlast=dlast, **kw)
    torch.cuda.synchronize()
    assert selective_scan_bwd.launches == before + 1
    want = selective_scan_bwd_reference(u, delta, a, bm, cm, dy, dlast=dlast,
                                        **kw)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
    for name, x, r in zip(names, got, want):
        assert (x is None) == (r is None), name
        if x is None:
            continue
        assert x.dtype == r.dtype and x.shape == r.shape, name
        assert torch.isfinite(x).all(), name
        lim = 1e-3 if name in ("dA", "dD", "dbias") else tol
        err = (x.float() - r.float()).abs().max().item()
        assert err <= lim * r.float().abs().max().item(), (name, err)


# The backward kernel's edges: a channel count per group that is not a
# multiple of its 64-channel tile (80; 1100, 18 tiles, the last 12 wide), L
# one past a 32-step chunk and several chunks, the backbone's transposed
# strided views, with and without dlast; tolerances as above.  Two calls on
# the same inputs agree bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,layout,length", [
    (torch.bfloat16, (1, 384, 16, 1), "backbone", 33),
    (torch.float32, (2, 80, 8, 1), "backbone", 33),
    (torch.float32, (1, 1100, 4, 1), "encoder", 101),
    (torch.bfloat16, (1, 160, 16, 2), "encoder", 101),
])
@pytest.mark.parametrize("last", [True, False])
def test_selective_scan_bwd_edges(card, dtype, shape, layout, length, last):
    b, kd, ns, g = shape
    chunk = scan_chunk(b, kd, length, g)
    assert chunk == 32 and length in (chunk + 1, 3 * chunk + 5)
    u, delta, a, bm, cm, d, bias = _scan_inputs(card, dtype, b, kd, length, ns,
                                                g, layout, seed=kd + length)
    kw = dict(D=d, delta_bias=bias, delta_softplus=True)
    dy = torch.randn(u.shape, device=card).to(dtype)
    dlast = torch.randn((b, kd, ns), device=card) if last else None
    carries = scan_carries(u, delta, a, bm, cm, **kw)
    got = [selective_scan_bwd(u, delta, a, bm, cm, dy, carries=carries,
                              dlast=dlast, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(*got):
        assert torch.equal(x, y)
    want = selective_scan_bwd_reference(u, delta, a, bm, cm, dy, dlast=dlast,
                                        **kw)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
    for name, x, r in zip(names, got[0], want):
        assert x.dtype == r.dtype and x.shape == r.shape, name
        assert torch.isfinite(x).all(), name
        lim = 1e-3 if name in ("dA", "dD", "dbias") else tol
        err = (x.float() - r.float()).abs().max().item()
        assert err <= lim * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_tiny_vss_model_card_matches_cpu(card):
    """A tiny float32 VSS model on the card (K5) and on the CPU (plain
    scan), same seeded weights and input: 2 x 2 backbone scans and 2
    layers x 2 directions x 2 frames of encoder scans."""
    from unittest import mock

    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import videomamba

    from torch_parity import TINY_VIDEOMAMBA, VSS_YAML, tiny_vss_cfg

    with mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA):
        cfg = tiny_vss_cfg(get_cfg_custom(VSS_YAML))
        m_cpu = build_model(cfg, device="cpu", input_hw=(64, 128),
                            generator=torch.Generator().manual_seed(1))
        m_gpu = build_model(cfg, device=card, input_hw=(64, 128))
    randomize_constants(m_cpu, torch.Generator().manual_seed(2))
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.standard_normal((2, 8, 64, 128, 3), np.float32))
    mask = torch.zeros((2, 64, 128), dtype=torch.bool)
    mask[1, :, 96:] = True
    before = selective_scan.launches
    with torch.inference_mode():
        out_g = m_gpu(pixels.to(card), mask.to(card))
        out_c = m_cpu(pixels, mask)
    assert selective_scan.launches == before + 2 * 2 + 2 * 2 * 2
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        g, r = out_g[k].cpu(), out_c[k]
        assert (g - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), k


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_tiny_vss_train_step_on_the_card(card, remat):
    """One tiny float32 VSS train step on the card (K5 and its backward)
    and on the CPU (the plain versions), same seeded weights and batch,
    dropout off: the same loss and assignment, every gradient within 1e-2 x
    its max (as test_tiny_train_step_on_the_card); 12 forward scans (24
    under remat: each one again in its block's recompute) and 12 backward
    ones."""
    from unittest import mock

    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import videomamba

    from torch_parity import TINY_VIDEOMAMBA, VSS_YAML, tiny_vss_cfg

    with mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA):
        cfg = tiny_vss_cfg(get_cfg_custom(VSS_YAML))
        cfg.CONFIG.MODEL.DROPOUT = 0.0
        cfg.CONFIG.GRADIENT_CHECKPOINTING = remat
        m_cpu = build_model(cfg, device="cpu", input_hw=(64, 128),
                            generator=torch.Generator().manual_seed(1))
        m_gpu = build_model(cfg, device=card, input_hw=(64, 128))
    randomize_constants(m_cpu, torch.Generator().manual_seed(2))
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    batch = {
        "pixels": rng.standard_normal((2, 8, 64, 128, 3), np.float32),
        "mask": np.zeros((2, 64, 128), bool),
        "boxes": rng.uniform(0.2, 0.7, (2, 4, 4)).astype(np.float32),
        "labels": (rng.random((2, 4, 12)) < 0.2).astype(np.float32),
        "n_boxes": np.array([3, 2], np.int32),
    }
    res = []
    for model, dev in ((m_cpu, "cpu"), (m_gpu, card)):
        model.head_dropout.p = 0.0
        trainer = Trainer(model, cfg, device=dev)
        before = (selective_scan.launches, selective_scan_bwd.launches)
        total, losses, match = trainer.loss(
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        total.backward()
        moved = (selective_scan.launches - before[0],
                 selective_scan_bwd.launches - before[1])
        res.append((total.item(), match, {k: p.grad.cpu() for k, p in
                                          model.named_parameters()}, moved))
    (t_c, m_c, g_c, n_c), (t_g, m_g, g_g, n_g) = res
    assert n_c == (0, 0) and n_g == (24 if remat else 12, 12)
    ok = m_c.match_ok
    assert torch.equal(ok, m_g.match_ok.cpu())
    assert torch.equal(m_c.gt_idx[ok], m_g.gt_idx.cpu()[ok])
    assert abs(t_g - t_c) <= 1e-4 * abs(t_c)
    floor = 1e-5 * max(g.abs().max().item() for g in g_c.values())
    for k in g_c:
        assert g_g[k].dtype == g_c[k].dtype, k
        err = (g_g[k] - g_c[k]).abs().max().item()
        assert err <= 1e-2 * g_c[k].abs().max().item() + floor, (k, err)


def _native_inputs(card, dtype, b, t, grid, vshapes, nc, seed, c=256):
    """Value levels as views of one flat stream (dense past the batch
    axis, as the encoder hands them over), offsets in (-1, 1) with a fifth
    on the ties -1, -0.5, 0, 0.5, 1, weights in [0, 0.3)."""
    g = torch.Generator().manual_seed(seed)
    n = sum(t * hv * wv for hv, wv in vshapes)
    flat = torch.randn((b, n, c), generator=g)
    values, start = [], 0
    for hv, wv in vshapes:
        values.append(flat[:, start:start + t * hv * wv].reshape(b, t, hv, wv, c))
        start += t * hv * wv
    shape = (b, len(vshapes), t) + grid + (64,)
    comps = []
    for _ in range(nc):
        x = torch.rand(shape, generator=g) * 2 - 1
        pick = torch.rand(shape, generator=g) < 0.2
        ties = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0])
        x[pick] = ties[torch.randint(0, 5, shape, generator=g)][pick]
        comps.append(x)
    comps.append(torch.rand(shape, generator=g) * 0.3)
    return ([v.to(card, dtype) for v in values],
            [x.to(card, dtype) for x in comps])


NATIVE_PYRAMID = [(64, 80), (32, 40), (16, 20), (8, 10)]


# K10 / K11: both sides read the same values and offsets and sum in float32
# (no rounding of the masses), so only the summation order differs, in bf16
# as in float32: a kernel that rounded the masses to bf16 would fail
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("window", ["2d", "3d"])
@pytest.mark.parametrize("grid,vshapes,t", [
    ((12, 20), [(12, 20), (6, 10), (3, 5), (24, 40)], 3),
    ((16, 20), NATIVE_PYRAMID, 2),
    ((8, 10), NATIVE_PYRAMID[1:], 1),
    ((7, 5), [(14, 10)], 2)])
def test_native_blend_kernels_match_plain(card, dtype, tol, window, grid,
                                          vshapes, t):
    nc = 3 if window == "3d" else 2
    values, comps = _native_inputs(card, dtype, 2, t, grid, vshapes, nc, 5)
    dx, dy, a = comps[0], comps[1], comps[-1]
    dt = comps[2] if nc == 3 else None
    counter = native_blend3d if dt is not None else native_blend2d
    before = counter.launches
    out = native_blend(values, dx, dy, a, 8, dt=dt)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.dtype == torch.float32
    _close(out, native_blend_reference(values, dx, dy, a, 8, dt), tol,
           f"native {window}")


# K11's tiles of 8x8 queries: a grid that no tile divides, levels coarser
# at ratios that are not powers of two and one finer than the grid, the
# temporal border cutting T = 1, 2, 3, 8, and C = 512 (two 256-channel
# passes, 64-channel heads); tolerances as above
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 2, 3, 8])
@pytest.mark.parametrize("c", [256, 512])
def test_native_blend3d_tiles_frames_and_channels(card, dtype, t, c):
    vshapes = [(13, 21), (7, 11), (4, 6), (26, 42)]
    values, comps = _native_inputs(card, dtype, 2, t, (13, 21), vshapes, 3, t + c, c=c)
    dx, dy, dt, a = comps
    before = native_blend3d.launches
    out = native_blend(values, dx, dy, a, 8, dt=dt)
    torch.cuda.synchronize()
    assert native_blend3d.launches == before + 1
    assert out.shape == (2, t, 13, 21, c) and out.dtype == torch.float32
    _close(out, native_blend_reference(values, dx, dy, a, 8, dt), 1e-5,
           f"native 3d T={t} C={c}")


# K10: K11's tiled kernel with one temporal tap, at the same grid, levels,
# frames and channels; tolerances as above
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 2, 3, 8])
@pytest.mark.parametrize("c", [256, 512])
def test_native_blend2d_tiles_frames_and_channels(card, dtype, t, c):
    vshapes = [(13, 21), (7, 11), (4, 6), (26, 42)]
    values, comps = _native_inputs(card, dtype, 2, t, (13, 21), vshapes, 2, t + c, c=c)
    dx, dy, a = comps
    before = native_blend2d.launches
    out = native_blend(values, dx, dy, a, 8)
    torch.cuda.synchronize()
    assert native_blend2d.launches == before + 1
    assert out.shape == (2, t, 13, 21, c) and out.dtype == torch.float32
    _close(out, native_blend_reference(values, dx, dy, a, 8), 1e-5,
           f"native 2d T={t} C={c}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["2d", "3d"])
def test_native_blend_gradient_on_the_card(card, window):
    """The card's forward runs the kernel; its backward (the plain
    version's VJP, recomputed) equals autograd through the plain sum."""
    nc = 3 if window == "3d" else 2
    values, comps = _native_inputs(card, torch.float32, 1, 2, (8, 10),
                                   [(8, 10), (4, 5), (16, 20)], nc, 6)
    g = torch.randn((1, 2, 8, 10, 256), device=card)
    grads = []
    for fn in (native_blend, native_blend_reference):
        xs = [x.detach().clone().requires_grad_() for x in (*values, *comps)]
        vs, cs = xs[:3], xs[3:]
        dt = cs[2] if nc == 3 else None
        fn(vs, cs[0], cs[1], cs[-1], 8, dt=dt).backward(g)
        grads.append([x.grad for x in xs])
    for x, y in zip(*grads):
        _close(x, y, 1e-5, f"native {window} gradient")


@pytest.mark.cuda
def test_native_blend_kernel_rejects_what_it_does_not_take(card):
    values, comps = _native_inputs(card, torch.float32, 1, 1, (4, 5),
                                   [(4, 5)], 2, 7)
    with pytest.raises(ValueError):                     # kp = 32
        native_blend(values, *(x[..., :32].contiguous() for x in comps), 8)
    with pytest.raises(ValueError):                     # mixed dtypes
        native_blend([values[0].bfloat16()], *comps, 8)
    with pytest.raises(ValueError):                     # one CPU tensor
        native_blend([values[0].cpu()], *comps, 8)
    narrow, comps3 = _native_inputs(card, torch.float32, 1, 1, (4, 5), [(4, 5)], 3, 7,
                                    c=128)
    with pytest.raises(ValueError):                     # C not a multiple of 256
        native_blend(narrow, *comps3[:2], comps3[3], 8, dt=comps3[2])
    five, comps5 = _native_inputs(card, torch.float32, 1, 1, (4, 5), [(4, 5)] * 5, 3, 7)
    with pytest.raises(ValueError):                     # more than 4 levels
        native_blend(five, *comps5[:2], comps5[3], 8, dt=comps5[2])


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["2d", "3d"])
def test_tiny_native_model_card_matches_cpu(card, window):
    """A tiny float32 native model on the card (K10 / K11) and on the CPU
    (plain version), same seeded weights and input."""
    cfg = get_cfg_defaults()
    c = cfg.CONFIG
    c.DATA.NUM_CLASSES, c.DATA.TEMP_LEN, c.MODEL.TEMP_LEN = 12, 8, 8
    c.MODEL.SINGLE_FRAME = True
    c.MODEL.ENCODER_TYPE, c.MODEL.FAST_WINDOW = "fast_attention", window
    c.MODEL.FAST_CROSS_LEVEL = "native"
    c.MODEL.ENC_LAYERS, c.MODEL.DEC_LAYERS = 2, 1
    c.MODEL.DIM_FEEDFORWARD, c.MODEL.QUERY_NUM, c.ViT.DEPTH = 64, 4, 1
    m_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    randomize_constants(m_cpu, torch.Generator().manual_seed(2))
    m_gpu = build_model(cfg, device=card)
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.standard_normal((2, 8, 64, 64, 3), np.float32))
    mask = torch.zeros((2, 64, 64), dtype=torch.bool)
    mask[1, :, 48:] = True
    counter = native_blend3d if window == "3d" else native_blend2d
    before = (counter.launches, fused_blend2d.launches)
    with torch.inference_mode():
        out_g = m_gpu(pixels.to(card), mask.to(card))
        out_c = m_cpu(pixels, mask)
    assert (counter.launches, fused_blend2d.launches) == (
        before[0] + 2 * 4, before[1])                      # layers x grids
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        g, r = out_g[k].cpu(), out_c[k]
        assert (g - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), k


def _comps3d(card, dtype, b, jl, thw, points, seed, ties=False):
    """vol, dx, dy, dt, a and a float32 cotangent; with ``ties`` a third of
    the offsets exactly on -1, 0 or 1."""
    tt, h, w = thw
    g = torch.Generator().manual_seed(seed)
    shape = (b, jl, tt, h, w, 8 * points)
    vol = torch.randn((b, jl, tt, h, w, 256), generator=g)
    offs = []
    for _ in range(3):
        x = torch.rand(shape, generator=g) * 2 - 1
        if ties:
            pick = torch.rand(shape, generator=g) < 1 / 3
            x[pick] = torch.randint(-1, 2, shape, generator=g).float()[pick]
        offs.append(x)
    a = torch.rand(shape, generator=g) * 0.3
    grad = torch.randn((b, tt, h, w, 256), generator=g)
    return ([x.to(card, dtype) for x in (vol, *offs, a)], grad.to(card))


# K6 (which serves K7), K8, K9.  K6: both sides sum the same values in
# float32, in bf16 too (no rounding of the masses), so only the order
# differs; K8/K9's bf16 outputs are rounded to bf16 after sums in another
# order (one ulp, 2^-8).  The 128x160 grid at T=8 is K7's regime in the
# JAX package (`_v2_vmem_mb` ~128 MB > 96 MB in bf16).  K6 and K8 tile the
# grid by 8x8 (BLEND3D_TILE): 9x9 is one past a tile on both axes, 1x17 a
# single row of ragged tiles; K8 stages the components in chunks of 8
# points, copied 16, 8, 4 or 2 bytes at a time (P = 12: two chunks; P = 3
# in bf16: 2-byte copies).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,jl,thw,points,ties", [
    (2, 4, (3, 7, 9), 8, False), (2, 4, (3, 7, 9), 8, True),
    (1, 2, (8, 16, 20), 8, True), (2, 3, (1, 1, 5), 4, False),
    (1, 1, (8, 128, 160), 8, True), (1, 4, (2, 9, 9), 8, True),
    (2, 2, (3, 1, 17), 8, True), (1, 1, (2, 10, 13), 8, True),
    (1, 2, (2, 10, 13), 8, False), (1, 3, (2, 10, 13), 8, True),
    (1, 4, (2, 10, 13), 8, False), (1, 3, (3, 9, 11), 12, True),
    (1, 2, (2, 5, 9), 3, True)],
    ids=["7x9", "7x9-ties", "16x20-ties", "1x5-T1", "k7-regime", "9x9",
         "1x17", "J1-T2", "J2-T2", "J3-T2", "J4-T2", "P12", "P3"])
def test_blend3d_kernels_match_plain(card, dtype, tol, b, jl, thw, points,
                                     ties):
    (vol, dx, dy, dt, a), g = _comps3d(card, dtype, b, jl, thw, points, 8,
                                       ties)
    counters = (blend3d_fwd, blend3d_bwd_dvol, blend3d_bwd_dcomps)
    before = [c.launches for c in counters]
    out = blend3d_fwd(vol, dx, dy, dt, a, 8)
    dvol = blend3d_bwd_dvol(dx, dy, dt, a, g, vol.dtype, 8)
    grads = blend3d_bwd_dcomps(vol, dx, dy, dt, a, g, 8)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [x + 1 for x in before]
    assert out.dtype == torch.float32
    _close(out, blend3d_reference(vol, dx, dy, dt, a, 8), 1e-5, "K6")
    want = blend3d_backward_reference(vol, dx, dy, dt, a, g, 8)
    for name, got, w in zip(("K8 dvol", "K9 ddx", "K9 ddy", "K9 ddt",
                             "K9 da"), (dvol, *grads), want):
        assert got.dtype == dtype, name
        _close(got, w, tol, name)


# K6 blends 1-4 frames per block (ops/blend3d.py k6_frames_per_block picks
# them from the grid): each count, T not a multiple of it, ragged tiles
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames", [1, 2, 3, 4])
@pytest.mark.parametrize("jl,thw", [(4, (5, 9, 9)), (3, (3, 12, 17))])
def test_blend3d_k6_frames_per_block(card, monkeypatch, dtype, frames, jl,
                                     thw):
    from class_query_vad_tpu_torch.ops import blend3d as b3
    (vol, dx, dy, dt, a), _ = _comps3d(card, dtype, 2, jl, thw, 8, 11,
                                       ties=True)
    monkeypatch.setattr(b3, "k6_frames_per_block", lambda *args: frames)
    before = blend3d_fwd.launches
    out = blend3d_fwd(vol, dx, dy, dt, a, 8)
    torch.cuda.synchronize()
    assert blend3d_fwd.launches == before + 1
    _close(out, blend3d_reference(vol, dx, dy, dt, a, 8), 1e-5, "K6")


# K9 serves 1-4 frames per block (ops/blend3d.py k9_frames_per_block picks
# them from the grid): each count, T not a multiple of it, ragged tiles,
# P = 8 (16-byte components) and P = 3 (point by point)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("frames", [1, 2, 3, 4])
@pytest.mark.parametrize("jl,thw,points", [(4, (5, 9, 9), 8),
                                           (3, (3, 12, 17), 3)])
def test_blend3d_k9_frames_per_block(card, monkeypatch, dtype, tol, frames,
                                     jl, thw, points):
    from class_query_vad_tpu_torch.ops import blend3d as b3
    (vol, dx, dy, dt, a), g = _comps3d(card, dtype, 2, jl, thw, points, 12,
                                       ties=True)
    monkeypatch.setattr(b3, "k9_frames_per_block", lambda *args: frames)
    before = blend3d_bwd_dcomps.launches
    grads = blend3d_bwd_dcomps(vol, dx, dy, dt, a, g, 8)
    torch.cuda.synchronize()
    assert blend3d_bwd_dcomps.launches == before + 1
    want = blend3d_backward_reference(vol, dx, dy, dt, a, g, 8)[1:]
    for name, got, w in zip(("ddx", "ddy", "ddt", "da"), grads, want):
        assert got.dtype == dtype, name
        _close(got, w, tol, f"K9 {name}")


@pytest.mark.cuda
def test_blend3d_autograd_on_the_card(card):
    """blend3d's forward runs K6, its backward K8 and K9, and only what
    autograd needs; the gradients equal the plain backward's."""
    (vol, dx, dy, dt, a), g = _comps3d(card, torch.float32, 1, 4, (2, 8, 10),
                                       8, 9, ties=True)
    counters = (blend3d_fwd, blend3d_bwd_dvol, blend3d_bwd_dcomps)
    xs = [x.clone().requires_grad_() for x in (vol, dx, dy, dt, a)]
    before = [c.launches for c in counters]
    blend3d(*xs, 8).backward(g)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [x + 1 for x in before]
    want = blend3d_backward_reference(vol, dx, dy, dt, a, g, 8)
    for x, w in zip(xs, want):
        _close(x.grad, w, 1e-5, "blend3d gradient")
    v = vol.clone().requires_grad_()
    before = [c.launches for c in counters]
    blend3d(v, dx, dy, dt, a, 8).backward(g)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + 1,
                                              before[2]]


@pytest.mark.cuda
def test_blend3d_kernels_reject_what_they_do_not_take(card):
    """nh != 8, C != 256, J > 4, mixed dtypes or devices: a raise, and no
    launch counted."""
    (vol, dx, dy, dt, a), g = _comps3d(card, torch.float32, 1, 2, (1, 4, 5),
                                       8, 10)
    counters = (blend3d_fwd, blend3d_bwd_dvol, blend3d_bwd_dcomps)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError):                     # nh = 4
        blend3d_fwd(vol, dx, dy, dt, a, 4)
    with pytest.raises(ValueError):                     # C = 128
        blend3d_fwd(vol[..., :128].contiguous(), dx, dy, dt, a, 8)
    five = [torch.cat([x] * 3, dim=1) for x in (vol, dx, dy, dt, a)]
    with pytest.raises(ValueError):                     # J = 6
        blend3d_fwd(*five, 8)
    with pytest.raises(ValueError):                     # mixed dtypes
        blend3d_bwd_dcomps(vol.bfloat16(), dx, dy, dt, a, g, 8)
    with pytest.raises(ValueError):                     # dvol dtype
        blend3d_bwd_dvol(dx, dy, dt, a, g, torch.bfloat16, 8)
    with pytest.raises(ValueError):                     # one CPU tensor
        blend3d_fwd(vol, dx, dy, dt.cpu(), a, 8)
    assert [c.launches for c in counters] == before


@pytest.mark.cuda
def test_tiny_resample3d_model_card_matches_cpu(card):
    """A tiny float32 model with the 3d resample window on the card (K6)
    and on the CPU (plain version), same seeded weights and input."""
    cfg = get_cfg_defaults()
    c = cfg.CONFIG
    c.DATA.NUM_CLASSES, c.DATA.TEMP_LEN, c.MODEL.TEMP_LEN = 12, 8, 8
    c.MODEL.SINGLE_FRAME = True
    c.MODEL.ENCODER_TYPE, c.MODEL.FAST_WINDOW = "fast_attention", "3d"
    c.MODEL.FAST_CROSS_LEVEL = "resample"
    c.MODEL.ENC_LAYERS, c.MODEL.DEC_LAYERS = 2, 1
    c.MODEL.DIM_FEEDFORWARD, c.MODEL.QUERY_NUM, c.ViT.DEPTH = 64, 4, 1
    m_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    randomize_constants(m_cpu, torch.Generator().manual_seed(2))
    m_gpu = build_model(cfg, device=card)
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.standard_normal((2, 8, 64, 64, 3), np.float32))
    mask = torch.zeros((2, 64, 64), dtype=torch.bool)
    mask[1, :, 48:] = True
    before = (blend3d_fwd.launches, fused_blend2d.launches, blend2d.launches)
    with torch.inference_mode():
        out_g = m_gpu(pixels.to(card), mask.to(card))
        out_c = m_cpu(pixels, mask)
    assert (blend3d_fwd.launches, fused_blend2d.launches,
            blend2d.launches) == (before[0] + 2 * 4, before[1], before[2])
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        g, r = out_g[k].cpu(), out_c[k]
        assert (g - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), k


# K12: float32 differs from the plain version in summation order only; bf16
# p is rounded to bf16 after scores summed in another order, and the output
# is bf16 (one ulp, 2^-8)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,n,heads", [(1, 37, 2), (2, 200, 3), (1, 2560, 12),
                                       (1, 1, 1)])
def test_vit_attention_matches_plain(card, dtype, tol, b, n, heads):
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn((b, n, 3 * heads * 64), generator=g).to(card, dtype)
    before = vit_attention.launches
    out = vit_attention(qkv, heads, 64 ** -0.5)
    torch.cuda.synchronize()
    assert vit_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, n, heads * 64)
    _close(out, flash_attention_plain(qkv, heads, 64 ** -0.5), tol, "K12")


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card(card):
    """The forward launches K12; the backward is autograd through the
    einsum reference, as in the JAX package."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn((2, 70, 3 * 2 * 64), generator=g).to(card)
    cot = torch.randn((2, 70, 128), generator=g).to(card)
    x = qkv.clone().requires_grad_()
    before = vit_attention.launches
    flash_attention_qkv(x, 2, 0.125).backward(cot)
    torch.cuda.synchronize()
    assert vit_attention.launches == before + 1
    y = qkv.clone().requires_grad_()
    attention_from_qkv_ref(y, 2, 0.125).backward(cot)
    _close(x.grad, y.grad, 1e-6, "K12 gradient")


# K12 keeps no score row, so it takes any N: 3312 is the first N past the
# cap of its first version (16 float32 score rows in shared memory), 4096 a
# 16-frame 256x512 clip (8 x 16 x 32 tokens), which JAX's kernel also runs
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n", [3312, 4096])
def test_vit_attention_takes_long_token_rows(card, dtype, tol, n):
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn((1, n, 3 * 2 * 64), generator=g).to(card, dtype)
    before = vit_attention.launches
    out = vit_attention(qkv, 2, 64 ** -0.5)
    torch.cuda.synchronize()
    assert vit_attention.launches == before + 1
    _close(out, flash_attention_plain(qkv, 2, 64 ** -0.5), tol, "K12")


@pytest.mark.cuda
def test_vit_attention_rejects_what_it_does_not_take(card):
    """head dim != 64, a scale that is not positive, a non-contiguous or
    float16 qkv: a raise, and no launch."""
    qkv = torch.zeros((1, 32, 3 * 128), device=card)
    before = vit_attention.launches
    with pytest.raises(ValueError):                     # D = 32
        vit_attention(qkv, 4, 0.1)
    with pytest.raises(ValueError):                     # the max needs scale > 0
        vit_attention(qkv, 2, -0.1)
    with pytest.raises(ValueError):                     # not contiguous
        vit_attention(qkv[:, ::2], 2, 0.1)
    with pytest.raises(ValueError):                     # float16
        vit_attention(qkv.half(), 2, 0.1)
    assert vit_attention.launches == before


# K13: float32 in another summation order; bf16 rounds the hidden units and
# the output to bf16 after sums in another order (one ulp, 2^-8)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("activation", ["relu", "gelu_exact", "gelu_tanh"])
@pytest.mark.parametrize("n,c,f", [(300, 256, 128), (77, 768, 192),
                                   (1, 256, 64)])
def test_fused_ffn_matches_plain(card, dtype, tol, activation, n, c, f):
    g = torch.Generator().manual_seed(n + c)
    x = torch.randn((n, c), generator=g).to(card, dtype)
    w1 = (torch.randn((c, f), generator=g) / c ** 0.5).to(card)
    b1 = (0.1 * torch.randn((f,), generator=g)).to(card)
    w2 = (torch.randn((f, c), generator=g) / f ** 0.5).to(card)
    b2 = (0.1 * torch.randn((c,), generator=g)).to(card)
    before = fused_ffn_kernel.launches
    out = fused_ffn_kernel(x, w1, b1, w2, b2, activation)
    torch.cuda.synchronize()
    assert fused_ffn_kernel.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, c)
    _close(out, fused_ffn_plain(x, w1, b1, w2, b2, activation), tol, "K13")


@pytest.mark.cuda
def test_fused_ffn_autograd_on_the_card(card):
    """The forward launches K13; the backward is autograd through
    ``ffn_reference``, each gradient in its input's dtype."""
    g = torch.Generator().manual_seed(5)
    args = [torch.randn(s, generator=g).to(card)
            for s in ((50, 256), (256, 128), (128,), (128, 256), (256,))]
    cot = torch.randn((50, 256), generator=g).to(card)
    xs = [a.clone().requires_grad_() for a in args]
    before = fused_ffn_kernel.launches
    fused_ffn(*xs, "gelu_tanh").backward(cot)
    torch.cuda.synchronize()
    assert fused_ffn_kernel.launches == before + 1
    ys = [a.clone().requires_grad_() for a in args]
    ffn_reference(*ys, "gelu_tanh").backward(cot)
    for x, y in zip(xs, ys):
        assert x.grad.dtype == torch.float32
        _close(x.grad, y.grad, 1e-6, "K13 gradient")


@pytest.mark.cuda
def test_fused_ffn_kernel_rejects_what_it_does_not_take(card):
    """C outside (256, 768), F not a multiple of 64, mismatched shapes, an
    unknown activation, a CPU tensor among CUDA ones: a raise, no launch."""
    def args(n, c, f):
        return [torch.zeros(s, device=card)
                for s in ((n, c), (c, f), (f,), (f, c), (c,))]
    before = fused_ffn_kernel.launches
    with pytest.raises(ValueError):                     # C = 128
        fused_ffn_kernel(*args(8, 128, 64))
    with pytest.raises(ValueError):                     # F = 100
        fused_ffn_kernel(*args(8, 256, 100))
    x, w1, b1, w2, b2 = args(8, 256, 64)
    with pytest.raises(ValueError):                     # w2 transposed
        fused_ffn_kernel(x, w1, b1, w2.t(), b2)
    with pytest.raises(ValueError):
        fused_ffn_kernel(x, w1, b1, w2, b2, "silu")
    with pytest.raises(ValueError):                     # one CPU tensor
        fused_ffn(x, w1, b1.cpu(), w2, b2)
    assert fused_ffn_kernel.launches == before


# MODEL.FAST_USE_PALLAS: false keeps every route of the fast encoder and
# takes its plain versions on the card: no blend kernel runs, forward or
# backward, and the heads match the default model's (its kernels) within
# the tiny models' card-vs-plain tolerance
_BLEND_COUNTERS = (fused_blend2d, blend2d, blend2d_bwd_dvol,
                   blend2d_bwd_dcomps, blend3d_fwd, blend3d_bwd_dvol,
                   blend3d_bwd_dcomps, native_blend2d, native_blend3d)


@pytest.mark.cuda
@pytest.mark.parametrize("window,cross,points", [
    ("2d", "resample", 8), ("2d", "resample", 4), ("3d", "resample", 8),
    ("2d", "native", 8), ("3d", "native", 8)],
    ids=["K1", "K2", "K6", "K10", "K11"])
def test_fast_use_pallas_false_runs_no_kernel_on_the_card(card, window, cross,
                                                          points):
    cfg = get_cfg_defaults()
    c = cfg.CONFIG
    c.DATA.NUM_CLASSES, c.DATA.TEMP_LEN, c.MODEL.TEMP_LEN = 12, 8, 8
    c.MODEL.SINGLE_FRAME = True
    c.MODEL.ENCODER_TYPE, c.MODEL.FAST_WINDOW = "fast_attention", window
    c.MODEL.FAST_CROSS_LEVEL, c.MODEL.NUM_ENC_N_POINTS = cross, points
    c.MODEL.ENC_LAYERS, c.MODEL.DEC_LAYERS = 2, 1
    c.MODEL.DIM_FEEDFORWARD, c.MODEL.QUERY_NUM, c.ViT.DEPTH = 64, 4, 1
    m_kern = build_model(cfg, device=card, generator=torch.Generator().manual_seed(1))
    randomize_constants(m_kern, torch.Generator().manual_seed(2))
    c.MODEL.FAST_USE_PALLAS = False
    m_plain = build_model(cfg, device=card)
    m_plain.load_state_dict(m_kern.state_dict(), strict=True)
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.standard_normal((2, 8, 64, 64, 3), np.float32))
    mask = torch.zeros((2, 64, 64), dtype=torch.bool)
    mask[1, :, 48:] = True
    outs, launched = [], []
    for model in (m_kern, m_plain):
        before = [k.launches for k in _BLEND_COUNTERS]
        out = model(pixels.to(card), mask.to(card))
        (out["pred_logits"].square().sum() + out["pred_boxes"].sum()).backward()
        torch.cuda.synchronize()
        launched.append(sum(k.launches for k in _BLEND_COUNTERS) - sum(before))
        outs.append({k: v.detach().cpu() for k, v in out.items()
                     if k in ("pred_logits", "pred_boxes", "pred_logits_b")})
    assert launched[0] > 0 and launched[1] == 0, launched
    for k, r in outs[0].items():
        g = outs[1][k]
        assert (g - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), k


# ---- the exact deformable encoder and the tube configs -------------------

_ALL_COUNTERS = _BLEND_COUNTERS + (selective_scan, vit_attention,
                                   fused_ffn_kernel)


def _yaml_cfg(yaml, enc_layers=2):
    """A configuration YAML cut as the CPU parity tests cut it
    (``torch_parity.cut_cfg``), dropout and drop path off."""
    from pathlib import Path

    from class_query_vad_tpu_torch.config import get_cfg_custom
    from torch_parity import cut_cfg

    path = Path(__file__).resolve().parents[1] / "configuration" / yaml
    cfg = cut_cfg(get_cfg_custom(str(path)), enc_layers=enc_layers)
    cfg.CONFIG.MODEL.DROPOUT, cfg.CONFIG.ViT.DROP_PATH_RATE = 0.0, 0.0
    return cfg


def _card_and_cpu(cfg, card):
    m_cpu = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    randomize_constants(m_cpu, torch.Generator().manual_seed(2))
    m_gpu = build_model(cfg, device=card)
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    return m_cpu, m_gpu


def _tiny_request(b=2):
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.standard_normal((b, 8, 64, 64, 3), np.float32))
    mask = torch.zeros((b, 64, 64), dtype=torch.bool)
    mask[b - 1, :, 48:] = True
    return pixels, mask


@pytest.mark.cuda
@pytest.mark.parametrize("yaml", ["AVA22_ViT-B.yaml", "UCF_ViT-B.yaml",
                                  "JHMDB_ViT-B.yaml"])
def test_tiny_exact_model_card_matches_cpu(card, yaml):
    """The exact encoder's plain sampler on the card and on the CPU, tiny
    float32 models of the YAML, same weights and input: the same heads, and
    no kernel launched (the JAX package has none on this path)."""
    m_cpu, m_gpu = _card_and_cpu(_yaml_cfg(yaml), card)
    pixels, mask = _tiny_request()
    before = [k.launches for k in _ALL_COUNTERS]
    with torch.inference_mode():
        out_g = m_gpu(pixels.to(card), mask.to(card))
        out_c = m_cpu(pixels, mask)
    assert [k.launches for k in _ALL_COUNTERS] == before
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        g, r = out_g[k].cpu(), out_c[k]
        assert (g - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item()), k


def _train_card_vs_cpu(cfg, card, batch, counters):
    """One tiny float32 train step on the CPU and on the card; returns the
    card's launches of ``counters`` and checks the losses, the matcher's
    assignment and every gradient as ``test_tiny_train_step_on_the_card``."""
    m_cpu, m_gpu = _card_and_cpu(cfg, card)
    res = []
    for model, dev in ((m_cpu, "cpu"), (m_gpu, card)):
        model.head_dropout.p = 0.0
        trainer = Trainer(model, cfg, device=dev)
        before = [k.launches for k in counters]
        total, _, match = trainer.loss(
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        total.backward()
        torch.cuda.synchronize()
        res.append((total.item(), match, {k: p.grad.cpu() for k, p in
                                          model.named_parameters()},
                    [k.launches - b for k, b in zip(counters, before)]))
    (t_c, m_c, g_c, n_c), (t_g, m_g, g_g, n_g) = res
    assert not any(n_c)
    ok = m_c.match_ok
    assert ok.any() and torch.equal(ok, m_g.match_ok.cpu())
    assert torch.equal(m_c.gt_idx[ok], m_g.gt_idx.cpu()[ok])
    assert abs(t_g - t_c) <= 1e-4 * abs(t_c)
    floor = 1e-5 * max(g.abs().max().item() for g in g_c.values())
    for k in g_c:
        err = (g_g[k] - g_c[k]).abs().max().item()
        assert err <= 1e-2 * g_c[k].abs().max().item() + floor, (k, err)
    return n_g


@pytest.mark.cuda
def test_tiny_exact_train_step_on_the_card(card):
    """One tiny AVA22_ViT-B float32 train step (the exact encoder's plain
    sampler and its autograd) on the card and on the CPU: no kernel."""
    cfg = _yaml_cfg("AVA22_ViT-B.yaml")
    cfg.CONFIG.DATA.NUM_CLASSES = 12
    rng = np.random.default_rng(0)
    batch = {"pixels": rng.standard_normal((2, 8, 64, 64, 3), np.float32),
             "mask": np.zeros((2, 64, 64), bool),
             "boxes": rng.uniform(0.2, 0.7, (2, 6, 4)).astype(np.float32),
             "labels": (rng.random((2, 6, 12)) < 0.2).astype(np.float32),
             "n_boxes": np.array([3, 2], np.int32)}
    assert _train_card_vs_cpu(cfg, card, batch, _ALL_COUNTERS) == [0] * len(
        _ALL_COUNTERS)


@pytest.mark.cuda
@pytest.mark.parametrize("yaml", ["UCF_ViT-B_fast.yaml", "UCF_ViT-B.yaml"])
def test_tiny_tube_train_step_on_the_card(card, yaml):
    """One tiny UCF train step (per-frame matcher, criterion_frames) on the
    card and on the CPU; the fast config runs K1 forward and K3, K4
    backward once per encoder layer and query level, the exact one none."""
    from torch_parity import tube_targets

    cfg = _yaml_cfg(yaml)
    pixels, mask = _tiny_request()
    batch = {"pixels": pixels.numpy(), "mask": mask.numpy(),
             **tube_targets(6, 2, 8, a_slots=2, num_classes=24)}
    counters = (fused_blend2d, blend2d_bwd_dvol, blend2d_bwd_dcomps)
    want = [2 * 4] * 3 if "fast" in yaml else [0] * 3
    assert _train_card_vs_cpu(cfg, card, batch, counters) == want


# K1, K3 and K4 at the tube-fast configs' grids: UCF 28x28, 14x14, 7x7 (the
# ragged ones; 56x56 in chip_smoke.py) and JHMDB 8x8, T = 16 / 20 frames,
# B=1, four aligned levels.  K3 / K4 on components with offsets on the
# ties, against the plain backward (float32: summation order only; bf16:
# sums rounded to bf16, one ulp); K1 forward against its plain version and
# its autograd (the recompute, K3, K4) against the plain recompute fed the
# plain K3 / K4, as chip_smoke.py's phase 2 holds it (bf16: K1's offsets
# and weights round to bf16 on both sides, tanh / exp may round across a
# boundary)
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,grad_tol", [(torch.float32, 1e-5, 1e-5),
                                                (torch.bfloat16, 1e-2, 2e-2)])
@pytest.mark.parametrize("thw", [(16, 28, 28), (16, 14, 14), (16, 7, 7),
                                 (20, 8, 8)])
def test_k1_k3_k4_at_the_tube_grids(card, dtype, tol, grad_tol, thw):
    g = torch.Generator().manual_seed(sum(thw))
    shape = (1, 4) + thw + (64,)
    vol = torch.randn((1, 4) + thw + (256,), generator=g).to(card, dtype)
    offs = []
    for _ in range(2):
        x = torch.rand(shape, generator=g) * 2 - 1
        pick = torch.rand(shape, generator=g) < 1 / 3
        x[pick] = torch.randint(-1, 2, shape, generator=g).float()[pick]
        offs.append(x.to(card, dtype))
    a = (torch.rand(shape, generator=g) * 0.3).to(card, dtype)
    grad = torch.randn((1,) + thw + (256,), generator=g).to(card)
    counters = (fused_blend2d, blend2d_bwd_dvol, blend2d_bwd_dcomps)
    before = [k.launches for k in counters]
    got = (blend2d_bwd_dvol(*offs, a, grad, dtype, 8),
           *blend2d_bwd_dcomps(vol, *offs, a, grad, 8))
    want = blend2d_backward_reference(vol, *offs, a, grad, 8)
    for name, x, w in zip(("K3 dvol", "K4 ddx", "K4 ddy", "K4 da"), got, want):
        _close(x, w, tol, name)

    fused = (2 * torch.randn((1,) + thw + (768,), generator=g)).to(card, dtype)
    a1 = [vol.clone().requires_grad_(), fused.clone().requires_grad_()]
    out = fused_blend2d(*a1, 8, 1.0)
    out.backward(grad)
    torch.cuda.synchronize()
    assert [k.launches for k in counters] == [before[0] + 1, before[1] + 2,
                                              before[2] + 2]
    _close(out, fused_blend2d_reference(vol, fused, 8, 1.0), K1_TOL[dtype],
           "K1")
    f = fused.clone().requires_grad_()
    comps = fused_components(f, 4)
    cd = [c.detach() for c in comps]
    d_fused = torch.autograd.grad(comps, f, blend2d_bwd_dcomps_reference(
        vol, *cd, grad, 8))[0]
    _close(a1[0].grad, blend2d_bwd_dvol_reference(*cd, grad, dtype, 8),
           grad_tol, "K1 d vol")
    _close(a1[1].grad, d_fused, grad_tol, "K1 d fused")



@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bits", [(torch.float32, torch.int32),
                                        (torch.bfloat16, torch.int16)])
@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_row_gather_matches_plain_bit_for_bit(card, dtype, bits, d,
                                               index_dtype):
    """K14 against ``row_gather_ref``, bit for bit: a ragged G (not a
    multiple of a warp's 32 rows), wrapped and out-of-range indices (NaN
    rows), a [3, 17] index."""
    g = torch.Generator().manual_seed(14)
    s = 1000
    table = torch.randn((s, d), generator=g).to(card, dtype)
    idx = torch.randint(-s, s, (51,), generator=g)
    idx[::7] = torch.tensor([s, -s - 1, 2**31 - 1, -2**31, s + 3, -1, 0,
                             s - 1])
    idx = idx.reshape(3, 17).to(card, index_dtype)
    before = row_gather.launches
    got = row_gather(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    want = row_gather_ref(table, idx)
    assert got.shape == want.shape == (3, 17, d)
    assert torch.equal(got.view(bits), want.view(bits))
    assert int(torch.isnan(got.float()).all(-1).sum()) == 5
