"""The card kernels K3 and K4 in their own order, mirrored in plain PyTorch
on the CPU, against the JAX package.

``csrc/blend2d_bwd_dvol.cu`` (K3) and ``csrc/blend2d_bwd_dcomps.cu`` (K4)
give a block a TY x TX tile of one frame's positions and the 32 channels
of each of HB heads (``K3_SHAPES``, ``K4_SHAPES``; ``k3_block`` and
``k4_block`` pick one per grid, and the wrappers pass it).  The mirrors
below walk the same blocks in the same launch order and compute the same
flat indices: K3's halo of (TY+2) x (TX+2) positions, its components
staged for every level in chunks of 8 points with zeros outside the grid,
the 9 masses of each (level, halo position, head) scattered into a
[level][neighbour][output][head] table, and phase 2 reading G once per
neighbour for every level; K4's G held by lane (query, head, 8
channels), its value window per level, each window row dotted by the
lane's 8 channels, the all-reduce over the query's 4 lanes (across
lane ^ 1, then lane ^ 2), and each lane's contiguous run of the head's
points.  What the kernels never copy or write starts as NaN here, so a
read of it would show.

They are held to the oracle ``_blend_xla_vol_2d`` and its ``jax.vjp``, to
``jax.vjp`` of ``_blend2d`` with the Pallas kernels K3 and K4 in interpret
mode, and to the port's plain versions, in float32 within 1e-5, at ragged
shapes (H and W not multiples of 8, tiles straddling every border), T = 1
and 2, J = 1, 3 and 4, P = 4, 8 and 12 (two staged chunks), with a third
of the offsets exactly on -1, 0 or 1; and at every block shape the
launchers take.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.fast_deform_pallas import _blend2d, _blend_xla_vol_2d
from class_query_vad_tpu_torch.ops import blend2d as b2
from class_query_vad_tpu_torch.ops import cuda_build
from class_query_vad_tpu_torch.ops.blend2d import (
    K3_SHAPES,
    K4_SHAPES,
    blend2d_bwd_dcomps_reference,
    blend2d_bwd_dvol_reference,
    hat,
    hat_grad,
    k3_block,
    k4_block,
)

from torch_parity import n, t

NH, C, SLICE, CHUNK = 8, 256, 32, 8
NAN = float("nan")
TOL = dict(atol=1e-5, rtol=1e-5)

# the main path's four query grids
GRIDS = [(64, 80), (32, 40), (16, 20), (8, 10)]
# (B, J, T, H, W, P)
SHAPES = {"13x21-J4-T2-P8": (1, 4, 2, 13, 21, 8),
          "9x11-J3-T1-P4": (2, 3, 1, 9, 11, 4),
          "5x17-J1-T2-P12": (1, 1, 2, 5, 17, 12)}


def _inputs(shape, seed):
    """vol, dx, dy, a and G as numpy: offsets uniform in (-1, 1), a third
    of them exactly on -1, 0 or 1; weights in [0, 0.3)."""
    b, jl, tt, h, w, p = shape
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
    g = rng.standard_normal((b, tt, h, w, C)).astype(np.float32)
    return [vol, *offs, a], g


def _blocks(b, frames, h, w, shape):
    """The kernels' blocks in launch order, head group fastest: (b, t, y0,
    x0, h0) decoded from the flat block index as the kernels decode it."""
    ty, tx, heads = shape
    tiles_x = -(-w // tx)
    n_tiles = tiles_x * -(-h // ty)
    groups = NH // heads
    for blk in range(b * frames * n_tiles * groups):
        h0, r = blk % groups * heads, blk // groups
        tile, r = r % n_tiles, r // n_tiles
        yield r // frames, r % frames, tile // tiles_x * ty, tile % tiles_x * tx, h0


def _gather(flat, idx, ok):
    """flat[idx] where ok, else 0 (a copy zero-filled off the grid)."""
    return torch.where(ok, flat[torch.where(ok, idx, 0)], 0.0)


def _lanes(shape):
    """Thread tid = (q HB + hh) 4 + cg: (tid, cg, hh, q, oy, ox)."""
    ty, tx, heads = shape
    tid = torch.arange(ty * tx * heads * 4)
    q = tid // (4 * heads)
    return tid, tid % 4, tid // 4 % heads, q, q // tx, q % tx


def k3_tiled(dx, dy, a, g, shape=K3_SHAPES[0]):
    """K3 (csrc/blend2d_bwd_dvol.cu) in its own order: float32 dvol
    [B, J, T, H, W, C]."""
    ty, tx, heads = shape
    b, jl, tt, h, w, kp = dx.shape
    c = g.shape[-1]
    p = kp // NH
    winx, hw, outs = tx + 2, h * w, ty * tx
    halo = (ty + 2) * winx
    gflat = g.reshape(-1)
    cflat = [x.reshape(-1) for x in (dx, dy, a)]
    dvol = torch.full((b, jl, tt, h, w, c), NAN)
    items = jl * halo * heads                           # (level, halo, head)
    e = torch.arange(items)
    hh, i, j = e % heads, e // heads % halo, e // (heads * halo)
    wy, wx = i // winx, i % winx
    gi = torch.arange(halo)
    _, cg, hq, q, oy, ox = _lanes(shape)
    chan = (hq * SLICE + cg * 8)[:, None] + torch.arange(8)   # in the window
    for bi, ti, y0, x0, h0 in _blocks(b, tt, h, w, shape):
        def at(k):                                   # halo position k
            yy, xx = y0 - 1 + k // winx, x0 - 1 + k % winx
            return (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w), yy * w + xx
        gok, gpos = at(gi)
        gsrc = ((bi * tt + ti) * hw + gpos)[:, None] * c + h0 * SLICE + torch.arange(
            heads * SLICE)
        gwin = _gather(gflat, gsrc, gok[:, None])       # [halo][HB * 32]
        ok, pos = at(i)
        table = torch.full((jl * 9 * outs * heads,), NAN)
        # phase 1: per chunk of 8 points, the staged components of every
        # (level, halo position, head); points past the chunk never copied
        for p0 in range(0, p, CHUNK):
            pc = min(CHUNK, p - p0)
            src = ((((bi * jl + j) * tt + ti) * hw + pos) * kp + (h0 + hh) * p
                   + p0)[:, None] + torch.arange(pc)
            stage = torch.full((3, items, CHUNK), NAN)
            for comp, fl in enumerate(cflat):
                stage[comp, :, :pc] = _gather(fl, src, ok[:, None])
            vdx, vdy, va = stage[..., :pc]
            hx = [hat(vdx - (k - 1)) for k in range(3)]
            for sy in range(3):
                ay = va * hat(vdy - (sy - 1))
                for sx in range(3):
                    m = (ay * hx[sx]).sum(-1)
                    oty, otx = wy + sy - 2, wx + sx - 2
                    inside = (oty >= 0) & (oty < ty) & (otx >= 0) & (otx < tx)
                    d = (2 - sy) * 3 + (2 - sx)
                    slot = (((j * 9 + d) * outs + oty * tx + otx) * heads + hh)[inside]
                    table[slot] = m[inside] if p0 == 0 else table[slot] + m[inside]
        # phase 2: thread (output, head, 8 channels), every level at once
        y, x = y0 + oy, x0 + ox
        valid = (y < h) & (x < w)
        acc = torch.zeros(jl, len(q), 8)
        for dyi in range(3):
            for dxi in range(3):
                d = dyi * 3 + dxi
                gv = gwin[((oy + dyi) * winx + ox + dxi)[:, None], chan]
                for jj in range(jl):
                    mm = table[((jj * 9 + d) * outs + q) * heads + hq]
                    acc[jj] = acc[jj] + mm[:, None] * gv
        ch = ((h0 + hq) * SLICE + cg * 8)[:, None] + torch.arange(8)
        for jj in range(jl):
            dvol[bi, jj, ti, y[valid][:, None], x[valid][:, None], ch[valid]] = acc[jj][valid]
    return dvol


def k4_tiled(vol, dx, dy, a, g, shape=K4_SHAPES[0]):
    """K4 (csrc/blend2d_bwd_dcomps.cu) in its own order: (ddx, ddy, da),
    float32 [B, J, T, H, W, nh*P]."""
    ty, tx, heads = shape
    b, jl, tt, h, w, c = vol.shape
    kp = dx.shape[-1]
    p = kp // NH
    winx, hw = tx + 2, h * w
    nwin = (ty + 2) * winx
    vflat, gflat = vol.reshape(-1), g.reshape(-1)
    cflat = [x.reshape(-1) for x in (dx, dy, a)]
    outs = [torch.full(dx.shape, NAN) for _ in range(3)]
    tid, cg, hq, q, oy, ox = _lanes(shape)
    chan = (hq * SLICE + cg * 8)[:, None] + torch.arange(8)   # in the window
    run = -(-p // 4)
    p_lo = torch.clamp(cg * run, max=p)
    p_hi = torch.clamp(p_lo + run, max=p)
    wi = torch.arange(nwin)
    for bi, ti, y0, x0, h0 in _blocks(b, tt, h, w, shape):
        y, x = y0 + oy, x0 + ox
        valid = (y < h) & (x < w)
        head = h0 + hq
        gsrc = (((bi * tt + ti) * hw + y * w + x) * c + head * SLICE + cg * 8)[:, None] + \
            torch.arange(8)
        gq = _gather(gflat, gsrc, valid[:, None])       # [threads, 8]
        wyy, wxx = y0 - 1 + wi // winx, x0 - 1 + wi % winx
        wok = (wyy >= 0) & (wyy < h) & (wxx >= 0) & (wxx < w)
        for j in range(jl):
            src = ((((bi * jl + j) * tt + ti) * hw + wyy * w + wxx) * c
                   + h0 * SLICE)[:, None] + torch.arange(heads * SLICE)
            window = _gather(vflat, src, wok[:, None])  # [position][HB * 32]
            # phase 1: a window row per tap, then the all-reduce
            r = torch.zeros(len(tid), 9)
            for sy in range(3):
                for sx in range(3):
                    v = window[((oy + sy) * winx + ox + sx)[:, None], chan]
                    d = (gq * v).sum(-1)
                    d = d + d[tid ^ 1]
                    d = d + d[tid ^ 2]
                    r[:, sy * 3 + sx] = d
            # phase 2: lane's run of the head's points
            rr = r.reshape(-1, 3, 3)                    # [thread, sy, sx]
            for k in range(run):
                pt = p_lo + k
                live = valid & (pt < p_hi)
                off = (((bi * jl + j) * tt + ti) * hw + y * w + x) * kp + head * p + pt
                ox_, oy_, av = (_gather(fl, off, live) for fl in cflat)
                hx, hy, dhx, dhy = (torch.stack([f(u - (s - 1)) for s in range(3)], -1)
                                    for f, u in ((hat, ox_), (hat, oy_),
                                                 (hat_grad, ox_), (hat_grad, oy_)))
                rh = (rr * hx[:, None, :]).sum(-1)      # [thread, sy]
                rd = (rr * dhx[:, None, :]).sum(-1)
                grads = (av * (rd * hy).sum(-1), av * (rh * dhy).sum(-1),
                         (rh * hy).sum(-1))
                for out, gr in zip(outs, grads):
                    out.view(-1)[off[live]] = gr[live]
    return tuple(outs)


def _pad8(x):
    h, w = x.shape[3], x.shape[4]
    return jnp.pad(x, [(0, 0)] * 3 + [(0, (-h) % 8), (0, (-w) % 8), (0, 0)])


def _kernel_blend(vol, dx, dy, a):
    """``_blend2d`` with K2, K3 and K4 in interpret mode, on grids padded
    to multiples of 8 (zero components and cotangent past the grid)."""
    h, w = vol.shape[3], vol.shape[4]
    out = _blend2d(*(_pad8(x) for x in (vol, dx, dy, a)), False, True)
    return out[:, :, :h, :w]


@functools.lru_cache(maxsize=None)
def _jax_world(shape_key: str, kernel: bool):
    """d vol and d components (dx, dy, a) of the oracle (``kernel`` False)
    or of ``_blend2d`` with K3 and K4 in interpret mode, jitted."""
    xs, g = _inputs(SHAPES[shape_key], 21)
    fn = _kernel_blend if kernel else _blend_xla_vol_2d

    @jax.jit
    def run(*args):
        _, vjp = jax.vjp(fn, *args[:-1])
        return vjp(args[-1])

    dvol, *dcomps = run(*(jnp.asarray(x) for x in xs), jnp.asarray(g))
    return xs, g, np.asarray(dvol), [np.asarray(x) for x in dcomps]


@pytest.mark.parametrize("kernel", [False, True], ids=["xla_vjp", "interpret"])
@pytest.mark.parametrize("shape_key", list(SHAPES))
def test_k3_order_matches_jax_vjp(shape_key, kernel):
    xs, g, dvol_j, _ = _jax_world(shape_key, kernel)
    comps = [t(x) for x in xs[1:]]
    got = k3_tiled(*comps, t(g))
    np.testing.assert_allclose(n(got), dvol_j, **TOL)
    if kernel:      # and the port's plain version, on the same inputs
        want = blend2d_bwd_dvol_reference(*comps, t(g), torch.float32)
        np.testing.assert_allclose(n(want), n(got), **TOL)


@pytest.mark.parametrize("kernel", [False, True], ids=["xla_vjp", "interpret"])
@pytest.mark.parametrize("shape_key", list(SHAPES))
def test_k4_order_matches_jax_vjp(shape_key, kernel):
    xs, g, _, dcomps_j = _jax_world(shape_key, kernel)
    ts = [t(x) for x in xs]
    got = k4_tiled(*ts, t(g))
    for name, x, want in zip(("ddx", "ddy", "da"), got, dcomps_j):
        np.testing.assert_allclose(n(x), want, err_msg=name, **TOL)
    if kernel:
        plain = blend2d_bwd_dcomps_reference(*ts, t(g))
        for name, x, y in zip(("ddx", "ddy", "da"), got, plain):
            np.testing.assert_allclose(n(y), n(x), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", K3_SHAPES[1:], ids=str)
def test_k3_order_holds_at_every_block_shape(shape):
    """K3 at the launcher's other block shape (a 4x4 tile of one head) at
    P = 12 (two chunks) and J = 1, and at P = 8, J = 4."""
    for key in ("5x17-J1-T2-P12", "13x21-J4-T2-P8"):
        xs, g, dvol_j, _ = _jax_world(key, False)
        got = k3_tiled(*(t(x) for x in xs[1:]), t(g), shape=shape)
        np.testing.assert_allclose(n(got), dvol_j, err_msg=key, **TOL)


@pytest.mark.parametrize("shape", K4_SHAPES[1:], ids=str)
def test_k4_order_holds_at_every_block_shape(shape):
    """K4 at the launcher's other block shape (a 4x4 tile of one head) at
    P = 4 and 12 (runs of 1 and 3 points per lane)."""
    for key in ("9x11-J3-T1-P4", "5x17-J1-T2-P12"):
        xs, g, _, dcomps_j = _jax_world(key, False)
        got = k4_tiled(*(t(x) for x in xs), t(g), shape=shape)
        for name, x, want in zip(("ddx", "ddy", "da"), got, dcomps_j):
            np.testing.assert_allclose(n(x), want, err_msg=f"{key} {name}", **TOL)


@pytest.mark.parametrize("name", ["blend2d_bwd_dvol", "blend2d_bwd_dcomps"])
def test_wrappers_pass_the_block_shape(monkeypatch, name):
    """K3's and K4's wrappers hand ``k3_block`` / ``k4_block``'s shape to
    their launchers, as the last three arguments before the stream of
    ``cuda_build.KERNELS``."""
    xs, g = _inputs(SHAPES["13x21-J4-T2-P8"], 22)
    ts = [t(x) for x in xs]
    calls = []
    monkeypatch.setattr(b2, "device_of", lambda *xs: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(b2, "launch", lambda k, dev, *args: calls.append((k, args)))
    if name == "blend2d_bwd_dvol":
        b2.blend2d_bwd_dvol(*ts[1:], t(g), torch.float32, NH)
        want, shapes = k3_block(1, 2, 13, 21, 132), K3_SHAPES
    else:
        b2.blend2d_bwd_dcomps(*ts, t(g), NH)
        want, shapes = k4_block(1, 2, 13, 21, 132), K4_SHAPES
    (kernel, args), = calls
    assert kernel == name
    assert len(args) == len(cuda_build.KERNELS[name][2]) - 1   # but the stream
    assert tuple(args[-3:]) == want and want in shapes


def test_block_shapes_per_grid():
    """K3: 4x8 tiles of two heads where they give every SM a block, 4x4
    tiles of one head below; K4: 2x8 tiles of all heads where they give
    every SM four blocks, 4x4 tiles of one head below; at the main path's
    four query grids (B=1, T=2) and at B=2."""
    big3, small3 = K3_SHAPES[:2]
    big4, small4 = K4_SHAPES[:2]
    assert [k3_block(1, 2, h, w, 132) for h, w in GRIDS] == [big3, big3, small3, small3]
    assert [k4_block(1, 2, h, w, 132) for h, w in GRIDS] == [big4] + [small4] * 3
    assert k3_block(2, 2, 16, 20, 132) == big3
    assert k4_block(2, 2, 32, 40, 132) == small4
