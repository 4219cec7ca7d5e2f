"""The dataset evaluators (numpy only; a copy of the JAX package's
``evaluates/``): frame mAP for AVA, frame and video mAP for UCF101-24 and
JHMDB51-21, from the per-rank txt files of ``engine.evaluate``."""

from .evaluators import (  # noqa: F401
    STDetectionEvaluaterAVA,
    STDetectionEvaluaterJHMDB,
    STDetectionEvaluaterSinglePerson,
    STDetectionEvaluaterUCF,
    read_labelmap,
)
from .pascal_map import PascalMAPEvaluator  # noqa: F401
from .video_map import VideoMAPEvaluator  # noqa: F401
