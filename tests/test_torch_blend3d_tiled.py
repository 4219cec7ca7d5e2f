"""The card kernels K6, K8 and K9 in their own order, mirrored in plain
PyTorch on the CPU, against the JAX package.

``csrc/blend3d.cu`` (K6), ``csrc/blend3d_bwd_dvol.cu`` (K8) and
``csrc/blend3d_bwd_dcomps.cu`` (K9) give a block an 8x8 (y, x) tile
(``BLEND3D_TILE``, which the wrappers pass and the kernels check) and one
head's 32 channels; a K6 or K9 block serves F frames
(``k6_frames_per_block``, ``k9_frames_per_block``: 4, or 2 or 1 at small
grids), a K8 block one.  The
mirrors below walk the same blocks in the same launch order and compute
the same flat indices: K6's value window (F + 2 frames x (tile+2)^2
positions, zeros outside the grid, frames outside never copied), the 27
masses of (query, frame) held by lane (query, frame) and read by every
lane of the query, each window row blended into every frame that reaches
it; K8's halo of 3 x (tile+2)^2 positions, its components staged in chunks
of 8 points with zeros outside the grid, the 9 masses of each halo
position scattered into a [level][neighbour][output] table, and phase 2
reading G once per neighbour for every level; K9's G tile (F frames,
zeros past the grid and the chunk) and K6's window, each window row dotted
by lane (query, 8 channels) with the G of every frame that reaches it, the
reduce-scatter over the query's 4 lanes that leaves lane (query, frame)
with the frame's 27 per-head dots, and that lane's points.  What the
kernels never copy or write starts as NaN here, so a read of it would
show.

They are held to the oracle ``_blend_xla_vol`` and its ``jax.vjp``, and to
``_blend`` with the Pallas kernels K6, K8 and K9 in interpret mode, in
float32 within 1e-5, at ragged shapes (H and W not multiples of 8, tiles
straddling every border), T = 1, J = 1 and 3, P = 8 and 12 (two staged
chunks), with a third of the offsets exactly on -1, 0 or 1; and at other
tiles and frames per block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.fast_deform_pallas import _blend, _blend_xla_vol
from class_query_vad_tpu_torch.ops import blend3d as b3
from class_query_vad_tpu_torch.ops import cuda_build
from class_query_vad_tpu_torch.ops.blend2d import hat, hat_grad
from class_query_vad_tpu_torch.ops.blend3d import (
    BLEND3D_FRAMES,
    BLEND3D_TILE,
    blend3d_bwd_dcomps_reference,
    blend3d_bwd_dvol_reference,
    blend3d_reference,
    k6_frames_per_block,
    k9_frames_per_block,
)

from torch_parity import n, t

NH, C, SLICE, CHUNK = 8, 256, 32, 8
TOL = dict(atol=1e-5, rtol=1e-5)

# (B, J, T, H, W, P)
SHAPES = {"9x11-J3-T2": (1, 3, 2, 9, 11, 8),
          "13x10-J1-T1": (2, 1, 1, 13, 10, 8),
          "1x17-J3-T3-P12": (1, 3, 3, 1, 17, 12)}


def _inputs(shape, seed):
    """vol, dx, dy, dt, a and G as numpy: offsets uniform in (-1, 1), a
    third of them exactly on -1, 0 or 1; weights in [0, 0.3)."""
    b, jl, tt, h, w, p = shape
    rng = np.random.default_rng(seed)
    cs = (b, jl, tt, h, w, NH * p)
    vol = rng.standard_normal((b, jl, tt, h, w, C)).astype(np.float32)
    offs = []
    for _ in range(3):
        x = rng.uniform(-1.0, 1.0, cs).astype(np.float32)
        pick = rng.random(cs) < 1 / 3
        x[pick] = rng.integers(-1, 2, cs)[pick]
        offs.append(x)
    a = rng.uniform(0.0, 0.3, cs).astype(np.float32)
    g = rng.standard_normal((b, tt, h, w, C)).astype(np.float32)
    return [vol, *offs, a], g


def _blocks(b, frames, h, w, tile, per_block=1):
    """The kernels' blocks in launch order, head fastest: (b, t0, y0, x0,
    head) decoded from the flat block index as the kernels decode it; a
    block covers frames t0 .. t0 + per_block - 1."""
    tiles_x = -(-w // tile)
    n_tiles = tiles_x * -(-h // tile)
    chunks = -(-frames // per_block)
    for blk in range(b * chunks * n_tiles * NH):
        head, r = blk % NH, blk // NH
        tile_i, r = r % n_tiles, r // n_tiles
        yield (r // chunks, r % chunks * per_block, tile_i // tiles_x * tile,
               tile_i % tiles_x * tile, head)


def _gather(flat, idx, ok):
    """flat[idx] where ok, else 0 (a copy zero-filled off the grid)."""
    return torch.where(ok, flat[torch.where(ok, idx, 0)], 0.0)


def k6_tiled(vol, dx, dy, dt, a, tile=BLEND3D_TILE, frames=BLEND3D_FRAMES):
    """K6 (csrc/blend3d.cu) in its own order: float32 [B, T, H, W, C].  A
    block owns a tile x tile query tile, one head and ``frames`` frames
    (``k6_frames_per_block``); per level it holds the window of its frames
    + 2 planes; lane (query, cg) holds the 27 masses of the query's frame
    cg (zero past the chunk), which phase 2 reads from lane (query, f) for
    frame f."""
    b, jl, tt, h, w, c = vol.shape
    kp = dx.shape[-1]
    p = kp // NH
    win, hw = tile + 2, h * w
    vflat = vol.reshape(-1)
    cflat = [x.reshape(-1) for x in (dx, dy, dt, a)]
    out = torch.full((b, tt, h, w, c), float("nan"))
    pos = torch.arange((frames + 2) * win * win)         # window positions
    col, row, pl = pos % win, pos // win % win, pos // (win * win)
    q = torch.arange(tile * tile)
    oy, ox = q // tile, q % tile
    lane = torch.arange(SLICE)
    for bi, t0, y0, x0, head in _blocks(b, tt, h, w, tile, frames):
        nf = min(frames, tt - t0)
        y, x = y0 + oy, x0 + ox
        valid = (y < h) & (x < w)
        acc = torch.zeros(frames, tile * tile, SLICE)
        for j in range(jl):
            # the window: planes outside [0, T) or past the chunk's last
            # frame + 1 are never copied (NaN here)
            tw, yy, xx = t0 - 1 + pl, y0 - 1 + row, x0 - 1 + col
            copied = (tw >= 0) & (tw < tt) & (pl <= nf + 1)
            ok = copied & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            src = (((bi * jl + j) * tt * hw + tw * hw + yy * w + xx) * c
                   + head * SLICE)[:, None] + lane
            window = _gather(vflat, src, ok[:, None])
            window[~copied] = float("nan")
            # phase 1: lane (q, cg) sums frame t0 + cg's 27 masses
            m = torch.zeros(tile * tile, frames, 27)
            for cg in range(nf):
                off = ((((bi * jl + j) * tt + t0 + cg) * hw + y * w + x) * kp
                       + head * p)[:, None] + torch.arange(p)
                ox_, oy_, ot_, av = (_gather(f, off, valid[:, None])
                                     for f in cflat)
                for it in range(3):
                    at = av * hat(ot_ - (it - 1))
                    for sy in range(3):
                        aty = at * hat(oy_ - (sy - 1))
                        for sx in range(3):
                            m[:, cg, (it * 3 + sy) * 3 + sx] = torch.where(
                                valid, (aty * hat(ox_ - (sx - 1))).sum(-1), 0.0)
            # phase 2, every lane: each window row once, for every frame
            # it reaches, with that frame's masses from its lane
            for pi in range(frames + 2):
                if pi > nf + 1 or not 0 <= t0 - 1 + pi < tt:
                    continue
                for sy in range(3):
                    for sx in range(3):
                        v = window[(pi * win + sy + oy) * win + sx + ox]
                        for f in range(frames):
                            it = pi - f
                            if 0 <= it <= 2:
                                mm = m[:, f, (it * 3 + sy) * 3 + sx]
                                acc[f] = acc[f] + mm[:, None] * v
        for f in range(nf):
            out[bi, t0 + f, y[valid], x[valid],
                head * SLICE:(head + 1) * SLICE] = acc[f][valid]
    return out


def k8_tiled(dx, dy, dt, a, g, tile=BLEND3D_TILE):
    """K8 (csrc/blend3d_bwd_dvol.cu) in its own order: float32 dvol
    [B, J, T, H, W, C]."""
    b, jl, tt, h, w, kp = dx.shape
    c = g.shape[-1]
    p = kp // NH
    win, hw, outs = tile + 2, h * w, tile * tile
    plane = win * win
    chunks = -(-p // CHUNK)
    gflat = g.reshape(-1)
    cflat = [x.reshape(-1) for x in (dx, dy, dt, a)]
    dvol = torch.full((b, jl, tt, h, w, c), float("nan"))
    i = torch.arange(3 * plane)                          # halo positions
    f, wy, wx = i // plane, i // win % win, i % win
    q = torch.arange(outs)
    oy, ox = q // tile, q % tile
    lane = torch.arange(SLICE)
    for bi, ti, y0, x0, head in _blocks(b, tt, h, w, tile):
        th, yy, xx = ti - 1 + f, y0 - 1 + wy, x0 - 1 + wx
        frame_ok = (th >= 0) & (th < tt)
        ok = frame_ok & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        pos = th * hw + yy * w + xx
        gsrc = ((bi * tt * hw + pos) * c + head * SLICE)[:, None] + lane
        gwin = _gather(gflat, gsrc, ok[:, None])
        gwin[~frame_ok] = float("nan")
        pairs = torch.full((jl * 27 * outs,), float("nan"))
        # phase 1: stage s = (level, chunk of 8 points)
        for s in range(jl * chunks):
            j, p0 = s // chunks, s % chunks * CHUNK
            pc = min(CHUNK, p - p0)
            src = (((bi * jl + j) * tt * hw + pos) * kp + head * p
                   + p0)[:, None] + torch.arange(pc)
            vdx, vdy, vdt, va = (_gather(fl, src, ok[:, None]) for fl in cflat)
            at = va * hat(vdt - (1 - f)[:, None].float())   # st = 1 - f
            for sy in range(3):
                aty = at * hat(vdy - (sy - 1))
                for sx in range(3):
                    m = (aty * hat(vdx - (sx - 1))).sum(-1)
                    oty, otx = wy + sy - 2, wx + sx - 2
                    inside = (frame_ok & (oty >= 0) & (oty < tile)
                              & (otx >= 0) & (otx < tile))
                    d = f * 9 + (2 - sy) * 3 + (2 - sx)
                    slot = ((j * 27 + d) * outs + oty * tile + otx)[inside]
                    pairs[slot] = m[inside] if p0 == 0 else pairs[slot] + m[inside]
        # phase 2: every level at once, one G load per neighbour
        y, x = y0 + oy, x0 + ox
        valid = (y < h) & (x < w)
        acc = torch.zeros(jl, outs, SLICE)
        for fi in range(3):
            if not 0 <= ti - 1 + fi < tt:
                continue
            for dyi in range(3):
                for dxi in range(3):
                    d = (fi * 3 + dyi) * 3 + dxi
                    gv = gwin[(fi * win + oy + dyi) * win + ox + dxi]
                    for j in range(jl):
                        mm = pairs[(j * 27 + d) * outs + q]
                        acc[j] = acc[j] + torch.where(valid[:, None],
                                                      mm[:, None] * gv, 0.0)
        for j in range(jl):
            dvol[bi, j, ti, y[valid], x[valid],
                 head * SLICE:(head + 1) * SLICE] = acc[j][valid]
    return dvol


def k9_tiled(vol, dx, dy, dt, a, g, tile=BLEND3D_TILE, frames=BLEND3D_FRAMES):
    """K9 (csrc/blend3d_bwd_dcomps.cu) in its own order: (ddx, ddy, ddt,
    da), float32 [B, J, T, H, W, nh*P].  K6's blocks and windows; lane
    (query, cg) holds channels 8 cg .. 8 cg + 7 of the block's G at every
    frame and dots each window row with the G of every frame that reaches
    it; a reduce-scatter over the query's lanes (across cg ^ 2, then cg ^ 1)
    leaves lane (query, f) the 27 dots of frame f, from which it writes the
    frame's points."""
    b, jl, tt, h, w, c = vol.shape
    kp = dx.shape[-1]
    p = kp // NH
    win, hw, nq = tile + 2, h * w, tile * tile
    vflat, gflat = vol.reshape(-1), g.reshape(-1)
    cflat = [x.reshape(-1) for x in (dx, dy, dt, a)]
    outs = [torch.full(dx.shape, float("nan")) for _ in range(4)]
    pos = torch.arange((frames + 2) * win * win)         # window positions
    col, row, pl = pos % win, pos // win % win, pos // (win * win)
    q = torch.arange(nq)
    oy, ox = q // tile, q % tile
    lane = torch.arange(SLICE)
    for bi, t0, y0, x0, head in _blocks(b, tt, h, w, tile, frames):
        nf = min(frames, tt - t0)
        y, x = y0 + oy, x0 + ox
        valid = (y < h) & (x < w)
        # the G tile: [frame][query][channel], zeros past the grid and chunk
        gsrc = (((bi * tt + t0 + torch.arange(frames))[:, None] * hw
                 + (y * w + x)[None]) * c + head * SLICE)[..., None] + lane
        gok = (torch.arange(frames) < nf)[:, None] & valid[None]
        gtile = _gather(gflat, gsrc, gok[..., None]).reshape(frames, nq, 4, 8)
        for j in range(jl):
            tw, yy, xx = t0 - 1 + pl, y0 - 1 + row, x0 - 1 + col
            copied = (tw >= 0) & (tw < tt) & (pl <= nf + 1)
            ok = copied & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            src = (((bi * jl + j) * tt * hw + tw * hw + yy * w + xx) * c
                   + head * SLICE)[:, None] + lane
            window = _gather(vflat, src, ok[:, None])
            window[~copied] = float("nan")
            # phase 1: d[tap][frame][query][lane group], one window row read
            # per (plane, sy, sx) for every frame that reaches it
            d = torch.zeros(27, frames, nq, 4)
            for pi in range(frames + 2):
                if pi > nf + 1 or not 0 <= t0 - 1 + pi < tt:
                    continue
                for sy in range(3):
                    for sx in range(3):
                        v = window[(pi * win + sy + oy) * win + sx + ox]
                        v = v.reshape(nq, 4, 8)
                        for f in range(frames):
                            it = pi - f
                            if 0 <= it <= 2:
                                d[(it * 3 + sy) * 3 + sx, f] = (
                                    gtile[f] * v).sum(-1)
            # the reduce-scatter: lane group f ends with frame f's dots
            r = torch.stack([(d[:, f, :, f] + d[:, f, :, f ^ 2])
                             + (d[:, f, :, f ^ 1] + d[:, f, :, f ^ 3])
                             for f in range(frames)], dim=1)
            # phase 2: lane (query, f) writes the head's points of frame f
            for f in range(nf):
                off = ((((bi * jl + j) * tt + t0 + f) * hw + y * w + x) * kp
                       + head * p)[:, None] + torch.arange(p)
                ox_, oy_, ot_, av = (_gather(fl, off, valid[:, None])
                                     for fl in cflat)
                rq = r[:, f].T.reshape(nq, 3, 3, 3)[:, None]  # [q, 1, st, sy, sx]
                hats = [torch.stack([hat(u - (k - 1)) for k in range(3)], -1)
                        for u in (ox_, oy_, ot_)]
                dhats = [torch.stack([hat_grad(u - (k - 1)) for k in range(3)], -1)
                         for u in (ox_, oy_, ot_)]
                (hx, hy, ht), (dhx, dhy, dht) = hats, dhats
                rh = (rq * hx[:, :, None, None, :]).sum(-1)   # [q, p, st, sy]
                rd = (rq * dhx[:, :, None, None, :]).sum(-1)
                ra = (rh * hy[:, :, None, :]).sum(-1)         # [q, p, st]
                rdy = (rh * dhy[:, :, None, :]).sum(-1)
                rdx = (rd * hy[:, :, None, :]).sum(-1)
                grads = (av * (rdx * ht).sum(-1), av * (rdy * ht).sum(-1),
                         av * (ra * dht).sum(-1), (ra * ht).sum(-1))
                for out, gr in zip(outs, grads):
                    out[bi, j, t0 + f, y[valid], x[valid],
                        head * p:(head + 1) * p] = gr[valid]
    return tuple(outs)


def _kernel_blend(*xs):
    return _blend(*xs, False, True)


@functools.lru_cache(maxsize=None)
def _jax_world(shape_key: str, kernel: bool):
    """Forward, d vol and d components (dx, dy, dt, a) of the oracle
    (``kernel`` False) or of ``_blend`` with K6, K8 and K9 in interpret
    mode, jitted together."""
    xs, g = _inputs(SHAPES[shape_key], 11)
    fn = _kernel_blend if kernel else _blend_xla_vol

    @jax.jit
    def run(*args):
        out, vjp = jax.vjp(fn, *args[:-1])
        return out, vjp(args[-1])

    out, (dvol, *dcomps) = run(*(jnp.asarray(x) for x in xs), jnp.asarray(g))
    return (xs, g, np.asarray(out), np.asarray(dvol),
            [np.asarray(x) for x in dcomps])


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "interpret"])
@pytest.mark.parametrize("shape_key", list(SHAPES))
def test_k6_order_matches_jax(shape_key, kernel):
    xs, _, out_j, _, _ = _jax_world(shape_key, kernel)
    got = k6_tiled(*(t(x) for x in xs))
    np.testing.assert_allclose(n(got), out_j, **TOL)
    if kernel:      # and the port's plain version, on the same inputs
        np.testing.assert_allclose(n(blend3d_reference(*(t(x) for x in xs))),
                                   n(got), **TOL)


@pytest.mark.parametrize("kernel", [False, True], ids=["xla_vjp", "interpret"])
@pytest.mark.parametrize("shape_key", list(SHAPES))
def test_k8_order_matches_jax_vjp(shape_key, kernel):
    xs, g, _, dvol_j, _ = _jax_world(shape_key, kernel)
    comps = [t(x) for x in xs[1:]]
    got = k8_tiled(*comps, t(g))
    np.testing.assert_allclose(n(got), dvol_j, **TOL)
    if kernel:
        want = blend3d_bwd_dvol_reference(*comps, t(g), torch.float32)
        np.testing.assert_allclose(n(want), n(got), **TOL)


@pytest.mark.parametrize("kernel", [False, True], ids=["xla_vjp", "interpret"])
@pytest.mark.parametrize("shape_key", list(SHAPES))
def test_k9_order_matches_jax_vjp(shape_key, kernel):
    xs, g, _, _, dcomps_j = _jax_world(shape_key, kernel)
    ts = [t(x) for x in xs]
    got = k9_tiled(*ts, t(g))
    for name, x, want in zip(("ddx", "ddy", "ddt", "da"), got, dcomps_j):
        np.testing.assert_allclose(n(x), want, err_msg=name, **TOL)
    if kernel:
        plain = blend3d_bwd_dcomps_reference(*ts, t(g))
        for name, x, want in zip(("ddx", "ddy", "ddt", "da"), got, plain):
            np.testing.assert_allclose(n(want), n(x), err_msg=name, **TOL)


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_k9_order_holds_at_every_frames_per_block(frames):
    """K9 at the frames per block its launcher takes besides 4: each
    count, T = 3 not a multiple of 2."""
    xs, g, _, _, dcomps_j = _jax_world("1x17-J3-T3-P12", False)
    got = k9_tiled(*(t(x) for x in xs), t(g), frames=frames)
    for name, x, want in zip(("ddx", "ddy", "ddt", "da"), got, dcomps_j):
        np.testing.assert_allclose(n(x), want, err_msg=name, **TOL)


@pytest.mark.parametrize("tile,frames,shape_key", [
    (4, 1, "1x17-J3-T3-P12"), (16, 3, "9x11-J3-T2")])
def test_orders_hold_at_other_tiles(tile, frames, shape_key):
    """The mirrors' arithmetic is the tile's, not 8's and 4's: a tile of 4
    with a frame per block, and of 16 with three frames per block over T =
    2 (one short chunk), agree too."""
    xs, g, out_j, dvol_j, dcomps_j = _jax_world(shape_key, False)
    ts = [t(x) for x in xs]
    np.testing.assert_allclose(n(k6_tiled(*ts, tile=tile, frames=frames)),
                               out_j, **TOL)
    np.testing.assert_allclose(n(k8_tiled(*ts[1:], t(g), tile=tile)), dvol_j,
                               **TOL)
    got = k9_tiled(*ts, t(g), tile=tile, frames=frames)
    for name, x, want in zip(("ddx", "ddy", "ddt", "da"), got, dcomps_j):
        np.testing.assert_allclose(n(x), want, err_msg=name, **TOL)


@pytest.mark.parametrize("name", ["blend3d", "blend3d_bwd_dvol",
                                  "blend3d_bwd_dcomps"])
def test_wrappers_pass_the_tile(monkeypatch, name):
    """K6's, K8's and K9's wrappers hand ``BLEND3D_TILE`` to their
    launchers, as the last argument before the stream of
    ``cuda_build.KERNELS`` (K6 and K9 then the frames per block)."""
    xs, g = _inputs(SHAPES["9x11-J3-T2"], 12)
    ts = [t(x) for x in xs]
    calls = []
    monkeypatch.setattr(b3, "device_of", lambda *xs: "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(b3, "launch", lambda k, dev, *args: calls.append((k, args)))
    if name == "blend3d":
        b3.blend3d_fwd(*ts, NH)
    elif name == "blend3d_bwd_dvol":
        b3.blend3d_bwd_dvol(*ts[1:], t(g), torch.float32, NH)
    else:
        b3.blend3d_bwd_dcomps(*ts, t(g), NH)
    (kernel, args), = calls
    assert kernel == name
    assert len(args) == len(cuda_build.KERNELS[name][2]) - 1   # but the stream
    if name == "blend3d":       # then the frames per block
        args, frames = args[:-1], args[-1]
        assert frames == k6_frames_per_block(1, 2, 9, 11, 132) == 2
    elif name == "blend3d_bwd_dcomps":
        args, frames = args[:-1], args[-1]
        assert frames == k9_frames_per_block(1, 2, 9, 11, 132) == 1
    assert args[-1] == BLEND3D_TILE == 8


def test_k6_frames_per_block():
    """Four frames per block where that gives every SM a block, two where
    it would not (the resample mode's 8x10 query grid at B=2, T=8)."""
    f = k6_frames_per_block
    assert f(2, 8, 64, 80, 132) == f(2, 8, 16, 20, 132) == 4
    assert f(1, 8, 128, 160, 132) == f(1, 1, 512, 512, 132) == 4
    assert f(2, 8, 8, 10, 132) == 2


def test_k9_frames_per_block():
    """The most frames per block (4, 2, 1) whose blocks reach half the SMs:
    four at the resample mode's grids down to 16x20 (B=1, T=8: 96 blocks),
    one at 8x10 (32 blocks at four, 64 at two); K6's choices at B=2."""
    f = k9_frames_per_block
    assert f(1, 8, 64, 80, 132) == f(1, 8, 32, 40, 132) == 4
    assert f(1, 8, 16, 20, 132) == 4
    assert f(1, 8, 8, 10, 132) == 1
    assert f(2, 8, 8, 10, 132) == 2 == k6_frames_per_block(2, 8, 8, 10, 132)
