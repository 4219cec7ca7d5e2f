"""Core tensor utilities (counterpart of ``class_query_vad_tpu/utils/misc.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PaddedClip(NamedTuple):
    """A batch of video clips with a spatial padding mask (the reference's
    ``NestedTensor``, utils/misc.py:375), on the host.

    pixels: [B, T, H, W, C] float32, channels-last as the model takes it.
    mask:   [B, H, W] bool, True on padded pixels.
    """

    pixels: torch.Tensor
    mask: torch.Tensor

    @property
    def batch(self) -> int:
        return self.pixels.shape[0]

    @property
    def temporal(self) -> int:
        return self.pixels.shape[1]


def pad_clips_to_shape(clips: list[np.ndarray], height: int,
                       width: int) -> PaddedClip:
    """Pack per-sample [T, h, w, C] arrays into one batch padded to a fixed
    (height, width): the reference's nested_tensor_from_tensor_list
    (utils/misc.py:338-372) with a fixed canvas.  CPU tensors; the eval
    loop and the trainer copy them to the device."""
    bsz = len(clips)
    t, c = clips[0].shape[0], clips[0].shape[-1]
    pixels = np.zeros((bsz, t, height, width, c), dtype=np.float32)
    mask = np.ones((bsz, height, width), dtype=bool)
    for i, clip in enumerate(clips):
        th, tw = clip.shape[1], clip.shape[2]
        if th > height or tw > width:
            raise ValueError(
                f"clip spatial size ({th},{tw}) exceeds canvas ({height},{width})"
            )
        pixels[i, :, :th, :tw] = clip
        mask[i, :th, :tw] = False
    return PaddedClip(torch.from_numpy(pixels), torch.from_numpy(mask))


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def interpolate_mask(mask: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-resize a [B, H, W] bool mask to [B, h, w]: torch's default
    'nearest' picks src_idx = floor(dst_idx * scale), computed in float32
    as the JAX package does."""
    b, h, w = mask.shape
    oh, ow = out_hw
    ys = torch.floor(
        torch.arange(oh, dtype=torch.float32) * (h / oh)
    ).long().to(mask.device)
    xs = torch.floor(
        torch.arange(ow, dtype=torch.float32) * (w / ow)
    ).long().to(mask.device)
    return mask[:, ys][:, :, xs]
