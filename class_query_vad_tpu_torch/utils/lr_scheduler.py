"""Learning-rate schedules (counterpart of
``class_query_vad_tpu/utils/lr_scheduler.py``, whose optax schedules this
writes out as plain functions of the optimizer step).

``CONFIG.TRAIN.LR_POLICY``: constant (the reference's training), cosine,
linear, step or multistep, with an optional linear warm-up over
``WARMUP_EPOCHS``.  YAML 1.1 reads a bare ``1e-4`` as a string, so the
scalars are cast here, at the consumer.
"""

from __future__ import annotations

import math
from typing import Callable


def build_scheduler(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step (0-based count of optimizer updates) -> learning rate."""
    train = cfg.CONFIG.TRAIN
    base_lr = float(train.LR)
    policy = train.get("LR_POLICY", "constant")
    epochs = int(train.NUM_EPOCHS)
    warmup = int(train.get("WARMUP_EPOCHS", 0)) * steps_per_epoch
    min_lr = float(train.get("MIN_LR", 0.0))
    span = max(epochs * steps_per_epoch - warmup, 1)

    if policy == "constant":
        def sched(step):
            return base_lr
    elif policy == "cosine":
        alpha = min_lr / max(base_lr, 1e-12)

        def sched(step):
            c = min(step, span)
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span))
                              + alpha)
    elif policy == "linear":
        def sched(step):
            frac = 1 - min(max(step, 0), span) / span
            return (base_lr - min_lr) * frac + min_lr
    elif policy == "step":
        every = int(train.get("DECAY_EPOCHS", 30)) * steps_per_epoch
        rate = float(train.get("DECAY_RATE", 0.1))

        def sched(step):
            return base_lr if step <= 0 else base_lr * rate ** math.floor(step / every)
    elif policy == "multistep":
        bounds = sorted({int(m) * steps_per_epoch
                         for m in train.get("LR_MILESTONE", [])})
        rate = float(train.get("DECAY_RATE", 0.1))

        def sched(step):
            return base_lr * rate ** sum(step >= b for b in bounds)
    else:
        raise ValueError(f"unknown LR_POLICY {policy}")

    if warmup <= 0:
        return sched
    return lambda step: (base_lr * min(step, warmup) / warmup if step < warmup
                         else sched(step - warmup))
