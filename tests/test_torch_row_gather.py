"""K14's plain version ``row_gather_ref`` and its wrapper against the JAX
side, on the CPU.

* ``row_gather_ref`` against ``jnp.take(table, idx, axis=0)`` in its
  default mode, bit for bit (NaN rows included): in-range, wrapped
  ([-S, 0)) and out-of-range indices, float32 and bf16 tables, int32 and
  int64 indices (int64 within int32's range: JAX without x64 casts to
  int32).
* ``row_gather_ref`` against K14's Pallas body in interpret mode, at
  S = 64, D = 32 and two blocks of 16 indices.  The repo root's
  ``scripts/probe_gather.py`` defines the kernel inside ``main()``
  (:72-94), so ``_pallas_gather`` below keeps a copy of its body and grid.
* ``row_gather``'s routing (CPU tensors and ``kernels=False`` to the
  plain version, no launch counted) and the shapes and types the kernel
  refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from class_query_vad_tpu_torch.ops import row_gather as rg
from class_query_vad_tpu_torch.ops.row_gather import row_gather, row_gather_ref

S, D = 64, 32
BG = 16                      # indices per Pallas block; two blocks
DTYPES = {"float32": (torch.float32, jnp.float32, np.uint32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, np.uint16)}


def _indices(dtype):
    """In range, wrapped and out of range (both ends, int32's extremes)."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([rng.integers(0, S, 20), [0, S - 1, -1, -S, -S - 1,
                                                    S, S + 5, 2**31 - 1,
                                                    -2**31],
                          rng.integers(-S, 0, 3)]).astype(dtype)
    return idx.reshape(4, 8)


def _table(name):
    t_dt, j_dt, _ = DTYPES[name]
    x = np.random.default_rng(4).normal(size=(S, D)).astype(np.float32)
    return torch.from_numpy(x).to(t_dt), jnp.asarray(x, j_dt)


def _bits(x, name):
    """The tensor's or array's bits as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int32 if name == "float32" else torch.int16).numpy()
    return np.asarray(x).view(DTYPES[name][2])


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", list(DTYPES))
def test_row_gather_ref_is_jnp_take_bit_for_bit(name, index_dtype):
    tab_t, tab_j = _table(name)
    idx = _indices(index_dtype)
    got = row_gather_ref(tab_t, torch.from_numpy(idx))
    want = jnp.take(tab_j, jnp.asarray(idx), axis=0)
    assert got.shape == want.shape == (4, 8, D)
    assert got.dtype == tab_t.dtype
    nan_rows = np.isnan(np.asarray(want, np.float32)).all(-1)
    assert nan_rows.sum() == 5           # S, S + 5, -S - 1, int32's ends
    np.testing.assert_array_equal(_bits(got, name), _bits(want, name))


def _pallas_gather(tab, indices):
    """K14's Pallas body and grid (scripts/probe_gather.py:72-94) at
    ``BG`` indices per block, in interpret mode."""
    g = indices.shape[0]

    def kernel(tab_ref, idx_ref, out_ref):
        # per-element gather: out[i, j] = tab[idx[i], j]
        idx2d = jnp.broadcast_to(idx_ref[:][:, None], (BG, D))
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx2d, axis=0)

    return pl.pallas_call(
        kernel,
        grid=(g // BG,),
        in_specs=[
            pl.BlockSpec((S, D), lambda i: (0, 0)),
            pl.BlockSpec((BG,), lambda i: (i,)),
        ],
        out_specs=pl.BlockSpec((BG, D), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((g, D), tab.dtype),
        interpret=True,
    )(tab, indices)


def test_row_gather_ref_matches_the_pallas_kernel_in_interpret_mode():
    """Both dtypes in one interpret-mode call each; the indices of
    ``_indices`` (in range, wrapped, out of range): the kernel's
    ``take_along_axis`` follows ``jnp.take``'s rules too."""
    idx = _indices(np.int32).reshape(-1)[: 2 * BG]
    assert idx.shape == (2 * BG,)
    for name in DTYPES:
        tab_t, tab_j = _table(name)
        want = _pallas_gather(tab_j, jnp.asarray(idx))
        got = row_gather_ref(tab_t, torch.from_numpy(idx))
        np.testing.assert_array_equal(_bits(got, name), _bits(want, name))


def test_row_gather_takes_cpu_tensors_to_the_plain_version():
    tab, _ = _table("bfloat16")
    idx = torch.from_numpy(_indices(np.int64))
    before = row_gather.launches
    want = row_gather_ref(tab, idx)
    for got in (row_gather(tab, idx), row_gather(tab, idx, kernels=False)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert row_gather.launches == before
    with pytest.raises(ValueError, match="CPU tensors or CUDA tensors"):
        row_gather(tab, idx.to("meta"))


@pytest.mark.parametrize("table,idx,match", [
    (torch.zeros(4, 3), torch.zeros(2, dtype=torch.int32), "multiple of 16"),
    (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(2, dtype=torch.int32),
     "float32 or bf16"),
    (torch.zeros(4, 4), torch.zeros(2), "int32 or int64"),
    (torch.zeros(4, 4, 4), torch.zeros(2, dtype=torch.int32), r"\[S, D\]"),
])
def test_row_gather_kernel_refuses_what_it_does_not_take(table, idx, match):
    with pytest.raises(ValueError, match=match):
        rg._check(table, idx)
