"""Training-log plotting (counterpart of the JAX package's
``utils/plot_utils.py``; the reference's models/detr/util/plot_utils.py).

``utils.logging.MetricsLogger`` writes JSON lines to ``metrics.jsonl``;
these functions read and plot them.  matplotlib is optional: without it
the plot functions raise an ``ImportError`` that says so.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Sequence


def load_log(log_dir: str, log_name: str = "metrics.jsonl") -> List[Dict]:
    """The JSON lines of a metrics log, as dicts."""
    rows = []
    with open(os.path.join(log_dir, log_name)) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                rows.append(json.loads(line))
    return rows


def _require_matplotlib():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "plot_utils needs matplotlib; install it or read the "
            "metrics.jsonl files directly") from e
    return plt


def plot_logs(logs: Sequence[str],
              fields: Iterable[str] = ("total_loss", "loss_bbox", "mAP"),
              ewm_alpha: float = 0.0, log_name: str = "metrics.jsonl"):
    """``fields`` of one or more experiment dirs: one subplot per field,
    one line per experiment, optionally smoothed by an exponentially
    weighted mean (``ewm_alpha``).  Returns (figure, axes)."""
    if isinstance(logs, (str, os.PathLike)):
        logs = [logs]
    plt = _require_matplotlib()
    fields = list(fields)
    fig, axs = plt.subplots(ncols=len(fields), figsize=(5 * len(fields), 4))
    if len(fields) == 1:
        axs = [axs]
    for log_dir in logs:
        rows = load_log(str(log_dir), log_name)
        for ax, field in zip(axs, fields):
            ys = [r[field] for r in rows if field in r]
            if ewm_alpha > 0:
                sm, out = None, []
                for y in ys:
                    sm = y if sm is None else ewm_alpha * sm + (1 - ewm_alpha) * y
                    out.append(sm)
                ys = out
            ax.plot(ys, label=os.path.basename(str(log_dir)))
            ax.set_title(field)
            ax.legend()
    return fig, axs


def plot_precision_recall(files: Sequence[str]):
    """Precision / recall curves saved as ``.npz`` archives with
    ``precision``, ``recall`` and ``ap`` arrays.  Returns (figure, axes)."""
    import numpy as np

    plt = _require_matplotlib()
    fig, axs = plt.subplots(ncols=2, figsize=(10, 4))
    for f in files:
        data = np.load(f)
        prec, rec = data["precision"], data["recall"]
        axs[0].plot(rec, prec, label=os.path.basename(str(f)))
        axs[1].plot(rec, label=os.path.basename(str(f)))
        print(f"{os.path.basename(str(f))}: mAP={float(data['ap']):.3f} "
              f"score={float(prec.mean()):.3f}")
    axs[0].set_title("Precision / Recall")
    axs[1].set_title("Recall vs results")
    for ax in axs:
        ax.legend()
    return fig, axs
