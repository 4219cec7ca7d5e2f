"""Row gather, out[i, :] = table[idx[i], :]: kernel K14 and its plain
PyTorch version.

Counterpart of the TPU kernel of ``scripts/probe_gather.py`` (``kernel``,
:72-94; ``pallas_call`` in ``pgather`` :82): a ``jnp.take_along_axis``
over a VMEM-resident [S, D] table, the probe of the gather options for
the exact encoder's sampler (``ops/deform_attn.py``, whose corners go
through ``F.embedding_bag``).  On the card it is ``csrc/row_gather.cu``;
what bounds it and its design are in that file's header.

Both versions are ``jnp.take(table, idx, axis=0)`` in its default mode: an
index in [-S, 0) wraps to idx + S, any other index outside [0, S) gives a
row of NaN.  The table is [S, D] float32 or bf16, a row a multiple of 16
bytes (D = 32, 128, 256 and the like); the indices any shape, int32 or
int64; the output ``idx.shape + (D,)`` in the table's dtype.

``row_gather`` takes CPU tensors, or any tensors with ``kernels=False``,
to ``row_gather_ref`` (through ``cuda_build.plain_version``) and CUDA
tensors to K14; anything else raises, and there is no fallback.  As the
TPU kernel, it is forward only, and no model path calls it: its entry
point is ``python -m class_query_vad_tpu_torch.scripts.probe_gather``.
Each kernel launch counts one in ``row_gather.launches``.
"""

from __future__ import annotations

import torch

from .cuda_build import device_of, launch, plain_version

DTYPES = (torch.float32, torch.bfloat16)
# the 32-bit word of a NaN row: the NaN that ``masked_fill(nan)`` writes,
# twice over in bf16
FILL_WORD = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC07FC0}


def row_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K14 on any device: ``jnp.take(table, idx, axis=0)``
    for a [S, D] table (wrapped negatives, NaN rows past either end)."""
    s, d = table.shape
    i = idx.reshape(-1).long()
    i = torch.where(i < 0, i + s, i)
    ok = (i >= 0) & (i < s)
    rows = (table[torch.where(ok, i, 0)] if s
            else table.new_empty((i.numel(), d)))
    return rows.masked_fill(~ok[:, None], float("nan")).reshape(*idx.shape, d)


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2:
        raise ValueError(f"the table must be [S, D]; got {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise ValueError(f"K14 takes a float32 or bf16 table; got "
                         f"{table.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"K14 takes int32 or int64 indices; got {idx.dtype}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 0 or row_bytes % 16:
        raise ValueError(f"K14 moves 16-byte vectors: a row of {row_bytes} "
                         f"bytes is not a multiple of 16")


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K14 on CUDA tensors; a non-contiguous table or index is copied
    first.  Raises on a table it does not take."""
    _check(table, idx)
    table, flat = table.contiguous(), idx.reshape(-1).contiguous()
    if table.data_ptr() % 16:
        raise ValueError("K14 reads 16-byte vectors: the table must be "
                         "16-byte aligned")
    s, d = table.shape
    out = torch.empty((flat.numel(), d), dtype=table.dtype,
                      device=table.device)
    if flat.numel():
        launch("row_gather", table.device, table.data_ptr(), flat.data_ptr(),
               out.data_ptr(), s, flat.numel(),
               d * table.element_size() // 16, int(flat.dtype == torch.int64),
               FILL_WORD[table.dtype])
        row_gather.launches += 1
    return out.reshape(*idx.shape, d)


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               kernels: bool = True) -> torch.Tensor:
    """``table[idx]`` with ``jnp.take``'s out-of-range rules: K14 on CUDA
    tensors, its plain version on CPU tensors or when not ``kernels``."""
    if device_of(table, idx) == "cpu" or not kernels:
        return plain_version(kernels, row_gather_ref, table, idx)
    return _launch(table, idx)


row_gather.launches = 0
