"""Linear sum assignment (Hungarian matching) on the host.

Counterpart of ``class_query_vad_tpu/ops/lsap.py``: the same
shortest-augmenting-path (Jonker–Volgenant) solver — the same float32
arithmetic in the same order, the same first-index tie breaking — so that
both packages return the same assignment.  Costs are padded to a square
K = max(N, M) with ``PAD_COST``, which preserves the rectangular optimum
(every full assignment pays the same constant for the dummies).

Placement.  The JAX package runs this solver inside its jitted step; here
it runs on a host (numpy) copy of the small cost tensor: each augmenting
path is a ``while`` loop whose length depends on the data, tiny vector
steps a GPU would spend on launches and syncs.  The matcher copies the
costs of a whole step to the host once (``losses/matcher.py``).  A device
solver is later speed work.
"""

from __future__ import annotations

import numpy as np

PAD_COST = 1.0e4


def _solve_squares(cost: np.ndarray) -> np.ndarray:
    """Solve n independent K x K float32 LSAPs [n, K, K] in lockstep;
    returns col4row [n, K].  Per matrix this is the JAX package's
    ``_solve_square`` (lsap.py:99): rows in order, each by
    ``_augment_row`` (:30) — a Dijkstra-like scan of the reduced costs
    until a free column is reached, the dual update, the augmentation.
    The scan steps of all matrices run together, one numpy call per array
    op for the whole batch."""
    n, k = cost.shape[:2]
    inf = np.float32(np.inf)
    u = np.zeros((n, k), np.float32)
    v = np.zeros((n, k), np.float32)
    row4col = np.full((n, k), -1, np.int64)
    col4row = np.full((n, k), -1, np.int64)
    mats = np.arange(n)
    for cur in range(k):
        sr = np.zeros((n, k), bool)
        sc = np.zeros((n, k), bool)
        shortest = np.full((n, k), inf, np.float32)
        path = np.full((n, k), -1, np.int64)
        row = np.full(n, cur, np.int64)
        min_val = np.zeros(n, np.float32)
        sink = np.full(n, -1, np.int64)
        live = mats
        while live.size:
            i = row[live]
            sr[live, i] = True
            reduced = (min_val[live, None] + cost[live, i]
                       - u[live, i][:, None] - v[live])
            sc_l, sh = sc[live], shortest[live]
            better = ~sc_l & (reduced < sh)
            sh = np.where(better, reduced, sh)
            shortest[live] = sh
            path[live] = np.where(better, i[:, None], path[live])
            masked = np.where(sc_l, inf, sh)
            j = masked.argmin(axis=1)
            min_val[live] = masked[np.arange(live.size), j]
            sc[live, j] = True
            nxt = row4col[live, j]
            done = nxt < 0
            sink[live[done]] = j[done]
            row[live] = nxt
            live = live[~done]
        # duals: u for the visited rows, v for the scanned columns
        others = sr.copy()
        others[:, cur] = False
        delta = np.where(
            others,
            min_val[:, None] - np.take_along_axis(
                shortest, np.clip(col4row, 0, k - 1), axis=1),
            np.float32(0.0))
        u[:, cur] += min_val
        u += delta
        v = np.where(sc, v + shortest - min_val[:, None], v)
        # augment: walk the predecessors from the sink back to cur
        for m in range(n):
            j = int(sink[m])
            while j >= 0:
                i = int(path[m, j])
                row4col[m, j] = i
                j, col4row[m, i] = int(col4row[m, i]), j
    return col4row


def linear_sum_assignment(cost: np.ndarray, n_valid_cols=None,
                          n_valid_rows=None):
    """Masked rectangular LSAP, batched over leading axes.

    cost [..., N, M]; entries in columns >= ``n_valid_cols`` or rows >=
    ``n_valid_rows`` (ints or arrays over the batch axes) are replaced by
    ``PAD_COST``.  Returns (col4row [..., K], valid [..., K]) over the
    padded square K = max(N, M): ``col4row[i]`` is the column matched to
    row i, ``valid[i]`` marks real row-column matches."""
    cost = np.asarray(cost, np.float32)
    *batch, n, m = cost.shape
    k = max(n, m)
    nc = np.broadcast_to(np.asarray(m if n_valid_cols is None else n_valid_cols),
                         batch)
    nr = np.broadcast_to(np.asarray(n if n_valid_rows is None else n_valid_rows),
                         batch)
    nc, nr = nc.reshape(-1, 1), nr.reshape(-1, 1)
    rows = np.arange(k)
    sq = np.full((nc.shape[0], k, k), PAD_COST, np.float32)
    sq[:, :n, :m] = cost.reshape(-1, n, m)
    ok = (rows[None, :, None] < nr[:, :, None]) & (rows[None, None, :] < nc[:, :, None])
    with np.errstate(invalid="ignore"):
        col4row = _solve_squares(np.where(ok, sq, np.float32(PAD_COST)))
    valid = (rows[None] < nr) & (col4row < nc)
    return col4row.reshape(*batch, k), valid.reshape(*batch, k)
