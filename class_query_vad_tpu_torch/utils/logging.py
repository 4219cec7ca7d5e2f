"""Logging / metering utilities (the JAX package's ``utils/logging.py``).

Counterparts of the reference logging helpers: ``print_log`` (stdout + tee
to ``log.txt`` — utils/utils.py:185-192), ``build_log_dir`` (:29-51),
``AverageMeter`` (:54-70), ``ExpAverageMeter`` (train.py:111-124), and the
optional wandb hook (train.py:84-105, rank 0 only).  wandb and
tensorboard (``torch.utils.tensorboard``) are imported only when the
config turns them on.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def print_log(log_path: Optional[str], *args):
    print(*args)
    if log_path:
        os.makedirs(log_path, exist_ok=True)
        with open(os.path.join(log_path, "log.txt"), "a") as f:
            print(*args, file=f)


def build_log_dir(cfg) -> str:
    if cfg.CONFIG.LOG.EXP_NAME == "use_time":
        cfg.CONFIG.LOG.EXP_NAME = time.strftime(
            "%Y-%m-%d-%H-%M-%S", time.localtime(time.time())
        )
    log_path = os.path.join(cfg.CONFIG.LOG.BASE_PATH, cfg.CONFIG.LOG.EXP_NAME)
    os.makedirs(log_path, exist_ok=True)
    with open(os.path.join(log_path, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    return log_path


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class ExpAverageMeter:
    """Exponential moving average (reference train.py:111-124)."""

    def __init__(self, alpha: float = 0.9):
        self.alpha = alpha
        self.avg = 0.0
        self.initialized = False

    def update(self, val):
        if not self.initialized:
            self.avg = val
            self.initialized = True
        else:
            self.avg = self.alpha * self.avg + (1 - self.alpha) * val


class MetricsLogger:
    """Console + JSON-lines + optional wandb / tensorboard sinks
    (reference: wandb on rank 0 in train.py:84-105; tensorboard hooks in
    utils/misc.py:243-250)."""

    def __init__(self, cfg, rank: int = 0, use_wandb: bool = False,
                 use_tensorboard: bool = False):
        self.rank = rank
        self.step = 0
        self.log_path = os.path.join(
            cfg.CONFIG.LOG.BASE_PATH, cfg.CONFIG.LOG.EXP_NAME
        )
        self.wandb = None
        self.tb = None
        if use_wandb and rank == 0:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=cfg.CONFIG.MODEL.NAME or "class-query-vad")
            except ImportError:
                print("wandb not available; falling back to JSON lines")
        if use_tensorboard and rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(
                    os.path.join(self.log_path, cfg.CONFIG.LOG.LOG_DIR)
                )
            except ImportError:
                print("tensorboard not available; falling back to JSON lines")

    def log(self, metrics: Dict):
        if self.rank != 0:
            return
        self.step += 1
        print(json.dumps(metrics))
        os.makedirs(self.log_path, exist_ok=True)
        with open(os.path.join(self.log_path, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(metrics) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics)
        if self.tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(k, v, self.step)
