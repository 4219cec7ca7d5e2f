"""The card kernel K10 in its own order, mirrored in plain PyTorch on the
CPU, against the JAX package.

``csrc/native_blend.cu`` runs K10 and K11 as one kernel templated on the
temporal taps (K10: one, the query's own frame).  A block owns an 8x8
tile of one frame's query grid and 32 channels of one head; per level each
of the 4 lanes of a query sums the 16 masses of two of the head's 8
points, a reduce-scatter over the lanes (across lane ^ 2, then lane ^ 1)
leaves lane sy the sums of tap row sy, which it writes into a [tap][query]
table, and each lane blends its 8 channels over the 16 taps, reading a
level no finer than the grid from a window in shared memory (the tile's
base span plus the {-1..2} tap border, at most 11 x 11 positions, zeros
outside the level) and gathering a finer level from global memory,
borders masked.  The mirror below walks the same blocks in launch order
and computes the same window origins, extents and table indices; what the
kernel never copies or writes starts as NaN, so a read of it would show.

It is held to ``windowed_blend_native`` with the TPU kernel K10 in
interpret mode and to the port's plain version (the sum of
``native_blend_level``), in float32 within 1e-5, at query grids that no
tile divides, with levels coarser (ratios 2 and not), equal and finer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.ops.fast_deform_pallas import windowed_blend_native
from class_query_vad_tpu_torch.ops.blend2d import hat
from class_query_vad_tpu_torch.ops.fast_deform import native_tables_on
from class_query_vad_tpu_torch.ops.native_blend import native_blend_reference

from torch_parity import n, t

NH, P, TILE, SLICE, SIDE = 8, 8, 8, 32, 4
WIN = TILE + 3
TOL = dict(atol=1e-5, rtol=1e-5)

# name: (B, T, (H, W), value levels (Hv, Wv), C)
CASES = {
    "13x21": (2, 2, (13, 21), [(13, 21), (7, 11), (4, 6), (26, 42)], 256),
    "9x17-C512": (1, 1, (9, 17), [(5, 9), (18, 34), (3, 5)], 512),
}


def _inputs(case, seed):
    """Values, dx, dy, a as numpy: offsets uniform in (-1, 1), a fifth on
    -1, -0.5, 0, 0.5 or 1; weights in [0, 0.3)."""
    b, tt, (h, w), vshapes, c = CASES[case]
    rng = np.random.default_rng(seed)
    values = [rng.standard_normal((b, tt, hv, wv, c)).astype(np.float32)
              for hv, wv in vshapes]
    shape = (b, len(vshapes), tt, h, w, NH * P)
    offs = []
    for _ in range(2):
        x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        pick = rng.random(shape) < 0.2
        x[pick] = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], shape)[pick]
        offs.append(x)
    a = rng.uniform(0.0, 0.3, shape).astype(np.float32)
    return values, offs[0], offs[1], a


def k10_tiled(values, dx, dy, a):
    """K10 in its own order: float32 [B, T, H, W, C]."""
    b, jl, tt, h, w, kp = dx.shape
    c = values[0].shape[-1]
    base, phi = native_tables_on(h, w, tuple((v.shape[2], v.shape[3])
                                             for v in values),
                                 torch.device("cpu"))
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    out = torch.full((b, tt, h, w, c), float("nan"))
    q = torch.arange(TILE * TILE)
    lane = torch.arange(SLICE)
    cflat = [x.reshape(-1) for x in (dx, dy, a)]
    # launch order: x = tile, y = channel slice, z = b * T + t
    for z in range(b * tt):
        bi, ti = z // tt, z % tt
        for s in range(c // SLICE):
            c0 = s * SLICE
            head = c0 // (c // NH)
            for tile in range(tiles_x * tiles_y):
                y0, x0 = tile // tiles_x * TILE, tile % tiles_x * TILE
                ny, nx = min(TILE, h - y0), min(TILE, w - x0)
                y, x = y0 + q // TILE, x0 + q % TILE
                valid = (q // TILE < ny) & (q % TILE < nx)
                yv, xv = y.clamp(max=h - 1), x.clamp(max=w - 1)
                acc = torch.zeros(TILE * TILE, SLICE)
                for j, v in enumerate(values):
                    hv, wv = int(base[j, 0]), int(base[j, 1])
                    by_t, bx_t = base[j, 2:2 + h].long(), base[j, 2 + h:].long()
                    py_t, px_t = phi[j, :h], phi[j, h:]
                    vflat = v[bi, ti].reshape(-1)
                    coarse = hv <= h and wv <= w
                    # phase 1: lane cg sums the 16 masses of points 2 cg
                    # and 2 cg + 1 [query, lane, sy, sx]; the reduce-scatter
                    # leaves lane sy row sy
                    mass = torch.full((SIDE * SIDE, TILE * TILE), float("nan"))
                    off = (((((bi * jl + j) * tt + ti) * h + yv) * w + xv) * kp
                           + head * P)[:, None] + torch.arange(P)
                    vdx, vdy, va = (fl[off] for fl in cflat)
                    u = vdx + px_t[xv][:, None]
                    vv_ = vdy + py_t[yv][:, None]
                    s4 = torch.arange(SIDE) - 1.0
                    hx = hat(u[..., None] - s4)               # [q, point, sx]
                    hy = hat(vv_[..., None] - s4)             # [q, point, sy]
                    part = (va[..., None] * hy)[..., None] * hx[..., None, :]
                    lanes = part[:, 0::2] + part[:, 1::2]     # [q, lane, sy, sx]
                    for sy in range(SIDE):
                        m = ((lanes[:, sy, sy] + lanes[:, sy ^ 2, sy])
                             + (lanes[:, sy ^ 1, sy] + lanes[:, sy ^ 3, sy]))
                        mass[sy * SIDE:(sy + 1) * SIDE][:, valid] = m[valid].T
                    by, bx = by_t[yv], bx_t[xv]
                    if coarse:
                        # the window: origin at the tile's first base - 1,
                        # extent to its last base + 2; zeros off the level
                        wy0 = int(by_t[y0]) - 1
                        wx0 = int(bx_t[x0]) - 1
                        wh = int(by_t[y0 + ny - 1]) + 3 - wy0
                        ww = int(bx_t[x0 + nx - 1]) + 3 - wx0
                        window = torch.full((WIN, WIN, SLICE), float("nan"))
                        for row in range(wh):
                            for col in range(ww):
                                yy, xx = wy0 + row, wx0 + col
                                if 0 <= yy < hv and 0 <= xx < wv:
                                    window[row, col] = vflat[
                                        (yy * wv + xx) * c + c0 + lane]
                                else:
                                    window[row, col] = 0.0
                        for sy in range(SIDE):
                            for sx in range(SIDE):
                                rows = (by - 1 - wy0 + sy)[valid]
                                cols = (bx - 1 - wx0 + sx)[valid]
                                mm = mass[sy * SIDE + sx, valid]
                                acc[valid] += mm[:, None] * window[rows, cols]
                    else:
                        # a finer level: gathered, borders masked
                        for sy in range(SIDE):
                            for sx in range(SIDE):
                                yy, xx = by + sy - 1, bx + sx - 1
                                ok = valid & (yy >= 0) & (yy < hv) & (xx >= 0) & (xx < wv)
                                idx = ((yy * wv + xx) * c + c0)[ok][:, None] + lane
                                mm = mass[sy * SIDE + sx, ok]
                                acc[ok] += mm[:, None] * vflat[idx]
                out[bi, ti, y[valid], x[valid], c0:c0 + SLICE] = acc[valid]
    return out


@functools.lru_cache(maxsize=None)
def _jax_k10(case):
    """K10 in interpret mode through the JAX package's entry."""
    values, dx, dy, a = _inputs(case, 7)

    @jax.jit
    def run(vals, dx_, dy_, a_):
        return windowed_blend_native(vals, dx_, dy_, a_, nh=NH,
                                     use_pallas=True, interpret=True)

    out = run([jnp.asarray(v) for v in values], jnp.asarray(dx),
              jnp.asarray(dy), jnp.asarray(a))
    return (values, dx, dy, a), np.asarray(out)


@pytest.mark.parametrize("case", list(CASES))
def test_k10_order_matches_jax_kernel_in_interpret_mode(case):
    (values, dx, dy, a), want = _jax_k10(case)
    got = k10_tiled([t(v) for v in values], t(dx), t(dy), t(a))
    np.testing.assert_allclose(n(got), want, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_k10_order_matches_the_plain_version(case):
    values, dx, dy, a = _inputs(case, 8)
    vs = [t(v) for v in values]
    got = k10_tiled(vs, t(dx), t(dy), t(a))
    want = native_blend_reference(vs, t(dx), t(dy), t(a), NH)
    np.testing.assert_allclose(n(got), n(want), **TOL)
