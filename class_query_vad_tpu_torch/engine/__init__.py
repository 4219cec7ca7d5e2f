from .checkpoint import (  # noqa: F401
    load_checkpoint,
    load_detr_weights,
    load_pretrained_params,
    save_checkpoint,
)
from .evaluate import run_validation  # noqa: F401
from .train import (  # noqa: F401
    MasterAdamW,
    Trainer,
    backbone_freeze_labels,
    make_optimizer,
)
