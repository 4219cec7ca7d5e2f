"""Hungarian matching for AVA, UCF and JHMDB (counterpart of
``class_query_vad_tpu/losses/matcher.py``).

The float32 costs are computed on the outputs' device, without gradient;
the assignment is solved on the host (``ops.lsap``, the same solver as the
JAX package's): a matcher copies the costs of every problem it is given
to the host at once, so a train step that matches its stacked decoder
layers in one call makes one device-to-host copy and one solver call
(B problems per layer for AVA, B x T per-frame problems for the tubes).

Targets are static-shape masked arrays:

* AVA: boxes [B, M, 4] cxcywh and n_boxes [B] (columns >= n_boxes are
  padding);
* UCF: boxes [B, A, T, 4]; a gt (b, a, t) is live iff its (cy, w, h) are
  not all zero (``frame_valid_gt``), in a frame of ``frame_valid`` [B, T]
  and a slot below ``n_actors`` [B] (loader padding), when given;
* JHMDB: the same without the empty-box filter (one gt per frame).

Results are per-query arrays: ``gt_idx`` [..., NQ] (column matched to
each query, meaningless where not ``match_ok``) and ``match_ok`` [..., NQ]
bool.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lsap import PAD_COST, linear_sum_assignment
from ..utils.box_ops import box_cxcywh_to_xyxy, generalized_box_iou, pairwise_l1


class MatchResult(NamedTuple):
    gt_idx: torch.Tensor    # [..., NQ] int64
    match_ok: torch.Tensor  # [..., NQ] bool


def cost_matrix(pred_boxes, pred_logits_b, gt_boxes, cost_class, cost_bbox,
                cost_giou) -> torch.Tensor:
    """pred_boxes [..., NQ, 4], pred_logits_b [..., NQ, 3], gt_boxes
    [..., M, 4] -> [..., NQ, M] float32 cost (the JAX ``_cost_matrix``,
    matcher.py:40)."""
    pred_boxes = pred_boxes.float()
    gt_boxes = gt_boxes.float()
    c_bbox = pairwise_l1(pred_boxes, gt_boxes)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(gt_boxes))
    p_actor = torch.softmax(pred_logits_b.float(), dim=-1)[..., 1:2]
    c_class = -p_actor.expand_as(c_bbox)
    return cost_bbox * c_bbox + cost_giou * c_giou + cost_class * c_class


@torch.no_grad()
def match_ava(outputs, targets, cost_class, cost_bbox, cost_giou) -> MatchResult:
    """outputs: pred_boxes [..., B, NQ, 4], pred_logits_b [..., B, NQ, 3]
    (leading axes, e.g. stacked decoder layers, are matched independently);
    targets: boxes [B, M, 4], n_boxes [B]."""
    cost = cost_matrix(outputs["pred_boxes"], outputs["pred_logits_b"],
                       targets["boxes"], cost_class, cost_bbox, cost_giou)
    nq, m = cost.shape[-2:]
    n_boxes = targets["n_boxes"].to(cost.device)
    live = torch.arange(m, device=cost.device) < n_boxes[:, None]   # [B, M]
    # padding columns get PAD_COST here, as the solver would set them, so
    # the host needs the costs alone
    cost = torch.where(live[:, None, :], cost, PAD_COST)
    col4row, _ = linear_sum_assignment(cost.cpu().numpy())
    gt_idx = torch.from_numpy(col4row[..., :nq]).to(cost.device,
                                                    non_blocking=True)
    return MatchResult(gt_idx, gt_idx < n_boxes[:, None])


def frame_valid_gt(boxes: torch.Tensor) -> torch.Tensor:
    """boxes [..., A, 4] -> [..., A] bool: a gt is live iff its (cy, w, h)
    are not all zero (the reference drops rows whose columns 1: are 0)."""
    return ~(boxes[..., 1:] == 0.0).all(-1)


def live_frame_gts(targets, filter_empty: bool) -> torch.Tensor:
    """[B, T, A] bool: the live gts of tube targets (boxes [B, A, T, 4],
    frame_valid [B, T], optional n_actors [B])."""
    boxes = targets["boxes"].transpose(1, 2)               # [B, T, A, 4]
    if filter_empty:
        live = frame_valid_gt(boxes)
    else:
        live = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                          device=boxes.device)
    if "n_actors" in targets:
        slots = torch.arange(boxes.shape[2], device=boxes.device)
        live = live & (slots < targets["n_actors"].to(boxes.device)[:, None]
                       )[:, None, :]
    return live & targets["frame_valid"].to(boxes.device)[:, :, None]


@torch.no_grad()
def match_frames(outputs, targets, cost_class, cost_bbox, cost_giou,
                 filter_empty: bool) -> MatchResult:
    """Per-frame matching for UCF (``filter_empty``) and JHMDB.

    outputs: pred_boxes [..., B, T, NQ, 4], pred_logits_b [..., B, T, NQ,
    3] (leading axes, e.g. stacked decoder layers, matched independently);
    targets: boxes [B, A, T, 4], frame_valid [B, T] bool, optional
    n_actors [B].  Dead gts and padded frames cost 1e4, as the JAX
    package's vmapped solver sets them, so ``match_ok`` is False there;
    every (layer, clip, frame) problem is solved in one host call."""
    boxes = targets["boxes"].transpose(1, 2)               # [B, T, A, 4]
    live = live_frame_gts(targets, filter_empty)
    cost = cost_matrix(outputs["pred_boxes"], outputs["pred_logits_b"],
                       boxes, cost_class, cost_bbox, cost_giou)
    nq, a_slots = cost.shape[-2:]
    cost = torch.where(live[..., None, :], cost, PAD_COST)
    col4row, valid = linear_sum_assignment(cost.cpu().numpy())
    gt_idx = torch.from_numpy(col4row[..., :nq]).to(cost.device,
                                                    non_blocking=True)
    valid = torch.from_numpy(valid[..., :nq]).to(cost.device,
                                                 non_blocking=True)
    hit = torch.gather(live.expand(*gt_idx.shape[:-1], a_slots), -1,
                       gt_idx.clamp(0, a_slots - 1))
    return MatchResult(gt_idx, valid & hit)


def build_matcher(cfg):
    """Counterpart of the JAX ``build_matcher`` (matcher.py:124)."""
    mc = cfg.CONFIG.MATCHER
    name = cfg.CONFIG.DATA.DATASET_NAME
    cc, cb, cg = mc.COST_CLASS, mc.COST_BBOX, mc.COST_GIOU
    if name == "ava":
        return lambda outputs, targets: match_ava(outputs, targets, cc, cb, cg)
    if name in ("ucf", "jhmdb"):
        return lambda outputs, targets: match_frames(
            outputs, targets, cc, cb, cg, filter_empty=name == "ucf")
    raise ValueError(f"unknown dataset {name}")
