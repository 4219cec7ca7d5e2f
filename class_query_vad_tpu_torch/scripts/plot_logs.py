"""Plot training curves from ``MetricsLogger``'s ``metrics.jsonl`` logs
(the repo root's ``scripts/plot_logs.py`` on the port):

    python -m class_query_vad_tpu_torch.scripts.plot_logs <log_dir> \\
        [<log_dir> ...] --fields train/total_loss mAP --out curves.png

Needs matplotlib.
"""

from __future__ import annotations

import argparse

from class_query_vad_tpu_torch.utils.plot_utils import plot_logs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log_dirs", nargs="+",
                    help="directories containing metrics.jsonl")
    ap.add_argument("--fields", nargs="+", default=["train/total_loss"])
    ap.add_argument("--out", default="curves.png")
    args = ap.parse_args(argv)
    fig, _ = plot_logs(args.log_dirs, fields=tuple(args.fields))
    fig.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
