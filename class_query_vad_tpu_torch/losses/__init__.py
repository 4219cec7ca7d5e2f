from .criterion import (  # noqa: F401
    build_criterion_and_postprocessor,
    criterion_ava,
    criterion_frames,
    postprocess_ava,
    postprocess_frames,
)
from .matcher import build_matcher, frame_valid_gt, match_ava, match_frames  # noqa: F401
