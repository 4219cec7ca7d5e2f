"""Bounding-box operations (counterpart of ``class_query_vad_tpu/utils/box_ops.py``).

Shape-polymorphic: every function broadcasts over leading batch axes.
Degenerate boxes give the algebraic result (no asserts), as in the JAX
package: static-shape padding rows are masked by the callers.
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = x.unbind(-1)
    return torch.stack(
        [xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], dim=-1
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of xyxy boxes [..., N, 4] x [..., M, 4] -> (iou, union)
    [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def pairwise_l1(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """cdist(.., p=1): [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    return (boxes1[..., :, None, :] - boxes2[..., None, :, :]).abs().sum(-1)


def batched_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """IoU with a leading batch axis, [B, N, 4] x [B, M, 4] -> (iou, union)
    [B, N, M] (the JAX package's ``batched_box_iou``, box_ops.py:71):
    ``box_iou`` already broadcasts over leading axes."""
    return box_iou(boxes1, boxes2)


def batched_generalized_box_iou(boxes1: torch.Tensor,
                                boxes2: torch.Tensor) -> torch.Tensor:
    """Batched GIoU [B, N, M] (the JAX package's
    ``batched_generalized_box_iou``, box_ops.py:84)."""
    return generalized_box_iou(boxes1, boxes2)
