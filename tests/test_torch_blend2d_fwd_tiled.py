"""The card kernels K1 and K2 in their own order, mirrored in plain PyTorch
on the CPU, against the JAX package.

``csrc/fused_blend2d.cu`` (K1) and ``csrc/blend2d.cu`` (K2) share the
tiled forward of ``csrc/blend2d_fwd.cuh``: a block owns a TY x TX tile of
one frame's queries and all eight heads, a warp per query (``FWD_SHAPES``;
``fwd_block`` picks one per grid, and the wrappers pass it).  The mirrors below walk the same blocks in the same
launch order and compute the same flat indices: every level's value
window, rows y0-1 .. y0+TY and columns x0-1 .. x0+TX, zero-filled off the
grid; the per-warp front end, lane = (level, head) (K1: the max over all
weight lanes, each lane's sum over its 8 points, the per-head
denominator across lanes h, h+8, h+16, h+24 as two xor shuffles, one
reciprocal, tanh as 1 - 2 / (e^2x + 1), the bf16 roundings; K2: the
lane's P points of dx, dy, a); each point's 3 hats per axis added into
the lane's 9 tap masses (here a [warp][level][head]
[tap] tensor, on the card the lane's registers, shuffled to the head's
lanes); and each lane's sum over (level, tap) of mass x window row.
What the kernels never write starts as NaN here, so a position left out
would show.

They are held to the JAX package in float32 within 1e-5: K1 to
``_fused2d`` with the Pallas kernel ``_fused_kernel_2d`` in interpret mode
and to ``_fused2d_composite``; K2 to ``_blend_pallas_b1_v2_2d`` in
interpret mode and to the oracle ``_blend_xla_vol_2d``; and to the port's
plain versions; at ragged grids (13x21, 9x11, 5x17: tiles straddling
every border at every block shape), J = 4 and 2, T = 1 and 2, P = 8 (K2
also P = 4 and 3), with a third of K2's offsets exactly on -1, 0 or 1;
K1 with bf16 inputs, whose offsets and weights it rounds to bf16, and at
radius 1.5, whose offsets reach past one pixel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.fast_deform_pallas import (
    _blend_pallas_b1_v2_2d,
    _blend_xla_vol_2d,
    _fused2d,
    _fused2d_composite,
)
from class_query_vad_tpu_torch.ops import blend2d as b2
from class_query_vad_tpu_torch.ops import cuda_build
from class_query_vad_tpu_torch.ops import fast_deform_cuda as fdc
from class_query_vad_tpu_torch.ops.blend2d import (
    FWD_SHAPES,
    blend2d_reference,
    hat,
    fwd_block,
)
from class_query_vad_tpu_torch.ops.fast_deform_cuda import fused_blend2d_reference

from torch_parity import n, t

NH, C, KP = 8, 256, 64
NAN = float("nan")
TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 head lanes: the offsets and weights are rounded to bf16 on both
# sides, but the two tanh / exp / sums may land either side of a rounding
# boundary (one bf16 ulp of a tap weight), as tests/test_torch_fused_blend.py
# allows for
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)

# the main path's four query grids
GRIDS = [(64, 80), (32, 40), (16, 20), (8, 10)]
# K1: (B, J, T, H, W); K2: (B, J, T, H, W, P)
K1_CASES = {"13x21-J4-T2": (1, 4, 2, 13, 21),
            "9x11-J2-T1": (2, 2, 1, 9, 11),
            "5x17-J4-T1": (1, 4, 1, 5, 17)}
K2_CASES = {"13x21-J4-T2-P8": (1, 4, 2, 13, 21, 8),
            "9x11-J2-T1-P4": (2, 2, 1, 9, 11, 4),
            "5x17-J4-T2-P3": (1, 4, 2, 5, 17, 3)}


def _blocks(b, frames, h, w, shape):
    """The kernels' blocks in launch order: (b, t, y0, x0) decoded from
    the flat block index as ``blend2d_fwd_tile`` decodes it."""
    ty, tx = shape
    tiles_x = -(-w // tx)
    n_tiles = tiles_x * -(-h // ty)
    for blk in range(b * frames * n_tiles):
        tile, frame = blk % n_tiles, blk // n_tiles
        yield frame // frames, frame % frames, tile // tiles_x * ty, tile % tiles_x * tx


def _round(x, on):
    return x.to(torch.bfloat16).float() if on else x


def _add_points(m, ox, oy, av):
    """``add_point`` over the points (last axis), in their order: m [...,
    9] += (a hat_y[sy]) hat_x[sx], hat(u - s) for s = -1, 0, 1."""
    for p in range(ox.shape[-1]):
        hx = [hat(ox[..., p] - (k - 1)) for k in range(3)]
        hy = [hat(oy[..., p] - (k - 1)) for k in range(3)]
        for sy in range(3):
            ay = av[..., p] * hy[sy]
            for sx in range(3):
                m[..., sy * 3 + sx] = ay * hx[sx] + m[..., sy * 3 + sx]
    return m


def _tanh(x):
    """The kernel's tanh, 1 - 2 / (e^2x + 1) (``fast_tanh``)."""
    return 1.0 - 2.0 / (torch.exp(2.0 * x) + 1.0)


def _fused_front(f, jl, radius, rnd):
    """K1's front end for the warps of a block: f [warps, 3*J*KP] float32
    -> masses [warps, J, NH, 9].  Lane j * 8 + h holds level j, head h."""
    lanes = torch.arange(jl * NH)
    lj, lh = lanes // NH, lanes % NH
    pts = torch.arange(8)
    e = f[:, (2 * jl * KP + lj * KP + lh * 8)[:, None] + pts]       # [warps, lanes, 8]
    dx = f[:, (2 * lj * KP + lh * 8)[:, None] + pts]
    dy = f[:, ((2 * lj + 1) * KP + lh * 8)[:, None] + pts]
    mx = e.amax(dim=(1, 2), keepdim=True)                          # the 5-shuffle all-reduce
    e = torch.exp(e - mx)
    s = e[..., 0]
    for p in range(1, 8):                                          # the lane's sum, in order
        s = s + e[..., p]
    s32 = torch.zeros(f.shape[0], 32)
    s32[:, :jl * NH] = s
    idx = torch.arange(32)
    s32 = s32 + s32[:, idx ^ 8]                                    # across levels j ^ 1
    s32 = s32 + s32[:, idx ^ 16]                                   # then j ^ 2
    inv = 1.0 / s32[:, :jl * NH]
    a = _round(e * inv[..., None], rnd)
    ox = _round(radius * _tanh(dx), rnd)
    oy = _round(radius * _tanh(dy), rnd)
    m = _add_points(torch.zeros(f.shape[0], jl * NH, 9), ox, oy, a)
    return m.reshape(-1, jl, NH, 9)


def _comps_front(comps, bi, ti, ys, xs, p):
    """K2's front end for the warps of a block: the lane (j, h)'s P points
    of dx, dy, a at each warp's query -> masses [warps, J, NH, 9]."""
    dx, dy, a = (x[bi, :, ti, ys, xs].transpose(0, 1).reshape(len(ys), -1, NH, p)
                 for x in comps)
    jl = dx.shape[1]
    m = _add_points(torch.zeros(len(ys), jl, NH, 9), dx, dy, a)
    return m


def fwd_tiled(vol, front, shape):
    """The tiled forward (csrc/blend2d_fwd.cuh) in its own order, with
    ``front(bi, ti, ys, xs)`` -> the masses [warps, J, NH, 9] of the valid
    warps' queries: float32 [B, T, H, W, C]."""
    ty, tx = shape
    b, jl, tt, h, w, c = vol.shape
    vol32 = vol.float()
    out = torch.full((b, tt, h, w, c), NAN)
    winx, nwin = tx + 2, (ty + 2) * (tx + 2)
    wi = torch.arange(nwin)
    warp = torch.arange(ty * tx)
    oy, ox = warp // tx, warp % tx
    head_of = torch.arange(c) // (c // NH)
    for bi, ti, y0, x0 in _blocks(b, tt, h, w, shape):
        # phase 0: every level's window, zeros off the grid
        yy, xx = y0 - 1 + wi // winx, x0 - 1 + wi % winx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        win = torch.zeros(jl, nwin, c)
        win[:, ok] = vol32[bi, :, ti, yy[ok], xx[ok]]
        # phase 1: the valid warps' masses
        y, x = y0 + oy, x0 + ox
        valid = (y < h) & (x < w)
        table = torch.full((ty * tx, jl, NH, 9), NAN)
        table[valid] = front(bi, ti, y[valid], x[valid])
        # phase 2: each lane's 8 channels (here all C at once) over (level, tap)
        acc = torch.zeros(ty * tx, c)
        for j in range(jl):
            for sy in range(3):
                for sx in range(3):
                    mm = table[:, j, :, sy * 3 + sx][:, head_of]          # [warps, C]
                    acc = acc + mm * win[j, (oy + sy) * winx + ox + sx]
        out[bi, ti, y[valid], x[valid]] = acc[valid]
    return out


def k1_tiled(vol, fused, shape=FWD_SHAPES[0], radius=1.0):
    """K1 (csrc/fused_blend2d.cu) in its own order."""
    jl = vol.shape[1]
    rnd = fused.dtype == torch.bfloat16
    f32 = fused.float()
    return fwd_tiled(vol, lambda bi, ti, ys, xs: _fused_front(
        f32[bi, ti, ys, xs], jl, radius, rnd), shape)


def k2_tiled(vol, dx, dy, a, shape=FWD_SHAPES[0]):
    """K2 (csrc/blend2d.cu) in its own order."""
    p = dx.shape[-1] // NH
    comps = [x.float() for x in (dx, dy, a)]
    return fwd_tiled(vol, lambda bi, ti, ys, xs: _comps_front(comps, bi, ti, ys, xs, p),
                     shape)


def _k1_inputs(case, seed):
    b, jl, tt, h, w = K1_CASES[case]
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((b, jl, tt, h, w, C)).astype(np.float32)
    fused = (2.0 * rng.standard_normal((b, tt, h, w, 3 * jl * KP))).astype(np.float32)
    return vol, fused


def _k2_inputs(case, seed):
    """vol, dx, dy, a: offsets uniform in (-1, 1), a third of them exactly
    on -1, 0 or 1; weights in [0, 0.3)."""
    b, jl, tt, h, w, p = K2_CASES[case]
    rng = np.random.default_rng(seed)
    cs = (b, jl, tt, h, w, NH * p)
    vol = rng.standard_normal((b, jl, tt, h, w, C)).astype(np.float32)
    offs = []
    for _ in range(2):
        x = rng.uniform(-1.0, 1.0, cs).astype(np.float32)
        pick = rng.random(cs) < 1 / 3
        x[pick] = rng.integers(-1, 2, cs)[pick]
        offs.append(x)
    a = rng.uniform(0.0, 0.3, cs).astype(np.float32)
    return [vol, *offs, a]


@functools.lru_cache(maxsize=None)
def _k1_world(case: str, kernel: bool, bf16: bool = False, radius: float = 1.0):
    """K1's inputs (as the port sees them) and JAX's output: ``_fused2d``
    with the Pallas kernel in interpret mode (``kernel``), else
    ``_fused2d_composite``."""
    vol, fused = _k1_inputs(case, 31)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    vj, fj = jnp.asarray(vol, dt), jnp.asarray(fused, dt)
    if kernel:
        out = jax.jit(lambda v, f: _fused2d(v, f, NH, radius, True, False, True))(vj, fj)
    else:
        out = jax.jit(lambda v, f: _fused2d_composite(v, f, NH, radius, False, True))(vj, fj)
    tdt = torch.bfloat16 if bf16 else torch.float32
    # identical rounded values on both sides
    return (t(np.asarray(vj.astype(jnp.float32))).to(tdt),
            t(np.asarray(fj.astype(jnp.float32))).to(tdt), np.asarray(out))


@functools.lru_cache(maxsize=None)
def _k2_world(case: str, kernel: bool):
    """K2's inputs and JAX's output: ``_blend_pallas_b1_v2_2d`` in
    interpret mode per batch element (``kernel``), else the oracle
    ``_blend_xla_vol_2d``."""
    xs = _k2_inputs(case, 41)
    js = [jnp.asarray(x) for x in xs]
    if kernel:
        vp = jnp.pad(js[0], [(0, 0)] * 3 + [(1, 1), (1, 1), (0, 0)])
        run = jax.jit(jax.vmap(functools.partial(_blend_pallas_b1_v2_2d, interpret=True)))
        out = run(vp, *js[1:])
    else:
        out = jax.jit(_blend_xla_vol_2d)(*js)
    return [t(x) for x in xs], np.asarray(out)


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
@pytest.mark.parametrize("kernel", [True, False], ids=["interpret", "composite"])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_order_matches_jax(case, kernel, shape):
    vol, fused, want = _k1_world(case, kernel)
    got = k1_tiled(vol, fused, shape)
    np.testing.assert_allclose(n(got), want, **TOL)
    if kernel:      # and the port's plain version, on the same inputs
        np.testing.assert_allclose(n(fused_blend2d_reference(vol, fused, NH, 1.0)),
                                   n(got), **TOL)


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
def test_k1_order_rounds_like_the_bf16_kernel(shape):
    """bf16 head lanes: the offsets and weights rounded to bf16 before the
    hats, as ``_fused_kernel_2d`` does in interpret mode."""
    vol, fused, want = _k1_world("13x21-J4-T2", True, bf16=True)
    got = k1_tiled(vol, fused, shape)
    np.testing.assert_allclose(n(got), want, **TOL_BF16)
    np.testing.assert_allclose(n(got), n(fused_blend2d_reference(vol, fused, NH, 1.0)),
                               **TOL_BF16)


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
def test_k1_order_past_one_pixel(shape):
    """radius 1.5: offsets past one pixel."""
    vol, fused, want = _k1_world("9x11-J2-T1", True, radius=1.5)
    got = k1_tiled(vol, fused, shape, radius=1.5)
    np.testing.assert_allclose(n(got), want, **TOL)
    np.testing.assert_allclose(n(fused_blend2d_reference(vol, fused, NH, 1.5)), n(got),
                               **TOL)


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
@pytest.mark.parametrize("kernel", [True, False], ids=["interpret", "xla"])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_order_matches_jax(case, kernel, shape):
    ts, want = _k2_world(case, kernel)
    got = k2_tiled(*ts, shape)
    np.testing.assert_allclose(n(got), want, **TOL)
    if kernel:
        np.testing.assert_allclose(n(blend2d_reference(*ts)), n(got), **TOL)


@pytest.mark.parametrize("name", ["fused_blend2d", "blend2d"])
def test_wrappers_pass_the_block_shape(monkeypatch, name):
    """K1's and K2's wrappers hand ``fwd_block``'s shape to their
    launchers, as the last two arguments before the stream of
    ``cuda_build.KERNELS``."""
    calls = []
    for mod in (b2, fdc):
        monkeypatch.setattr(mod, "device_of", lambda *xs: "cuda")
        monkeypatch.setattr(mod, "launch", lambda k, dev, *args: calls.append((k, args)))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    if name == "fused_blend2d":
        vol, fused = (t(x) for x in _k1_inputs("13x21-J4-T2", 1))
        fdc.fused_blend2d(vol, fused)
        want, shapes = fwd_block(1, 2, 13, 21, 132), FWD_SHAPES
    else:
        b2.blend2d(*(t(x) for x in _k2_inputs("13x21-J4-T2-P8", 1)))
        want, shapes = fwd_block(1, 2, 13, 21, 132), FWD_SHAPES
    (kernel, args), = calls
    assert kernel == name
    assert len(args) == len(cuda_build.KERNELS[name][2]) - 1   # but the stream
    assert tuple(args[-2:]) == want and want in shapes


def test_block_shapes_per_grid():
    """K1 at the eval batch (B=2, T=2) and K2 at the train batch (B=1,
    T=2) over the main path's four query grids: 2x4 tiles where they fill
    every SM's four places, 2x2 tiles below."""
    big, small = FWD_SHAPES
    assert [fwd_block(2, 2, h, w, 132) for h, w in GRIDS] == [big, big, small, small]
    assert [fwd_block(1, 2, h, w, 132) for h, w in GRIDS] == [big] + [small] * 3
    assert fwd_block(1, 2, 32, 40, 132) == small
