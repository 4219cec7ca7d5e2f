from .train import (  # noqa: F401
    MasterAdamW,
    Trainer,
    backbone_freeze_labels,
    make_optimizer,
)
