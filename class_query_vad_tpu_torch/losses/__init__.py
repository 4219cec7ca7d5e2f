from .criterion import (  # noqa: F401
    build_criterion_and_postprocessor,
    criterion_ava,
    postprocess_ava,
)
from .matcher import build_matcher, match_ava  # noqa: F401
