"""AVA set criterion and postprocessing (counterpart of
``class_query_vad_tpu/losses/criterion.py``).

Loss semantics as the JAX package pins them against the reference:

* actorness: cross entropy over 3 classes with weights [1, 1, eos_coef]
  (target 1 = matched query, 2 = no actor);
* classes: multilabel sigmoid-focal loss on label-smoothed targets
  (true -> (1 - a) + a/2, false -> a/2), matched queries weighted by
  ``weight``, normalized by n_p = max(sum of raw positive labels, 1); with
  ``evaluation=True`` a plain BCE mean;
* boxes: L1 + GIoU over matched pairs / the batch's gt count;
* aux losses: every decoder layer is matched and scored again, under keys
  ``{name}_{i}``.  All layers are matched in ONE matcher call (one host
  copy of the costs per step).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..utils.box_ops import box_cxcywh_to_xyxy, generalized_box_iou
from .matcher import MatchResult

_LOSS_KEYS = ("loss_ce", "loss_ce_b", "loss_bbox", "loss_giou")


def sigmoid_focal_loss(inputs, targets, weights=None, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal terms (weights multiply the BCE term before the
    modulating factor), mean over the last axis, sum over the rest."""
    inputs = inputs.float()
    targets = targets.float()
    prob = torch.sigmoid(inputs)
    ce = inputs.clamp(min=0) - inputs * targets + torch.log1p(
        torch.exp(-inputs.abs()))
    if weights is not None:
        ce = ce * weights
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss.mean(dim=-1).sum()


def weighted_cross_entropy(logits, labels, class_weights) -> torch.Tensor:
    """F.cross_entropy with per-class weights: sum w[y]·nll / sum w[y]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = class_weights[labels]
    return (w * nll).sum() / w.sum()


def gather_matched(values: torch.Tensor, match: MatchResult) -> torch.Tensor:
    """values [..., M, D] at each query's matched slot -> [..., NQ, D]: an
    exact gather.  Unmatched queries carry slot-0 values; callers mask them
    with ``match_ok``."""
    idx = match.gt_idx.clamp(0, values.shape[-2] - 1)
    idx = idx[..., None].expand(*idx.shape, values.shape[-1])
    return torch.gather(values, -2, idx)


def box_losses(src_boxes, tgt_boxes, pair_ok, denom):
    """Masked L1 + GIoU over aligned (query, gt) pairs [..., 4]."""
    ok = pair_ok.float()
    src = src_boxes.float()
    tgt = tgt_boxes.float()
    l1 = ((src - tgt).abs().sum(-1) * ok).sum() / denom
    giou = generalized_box_iou(box_cxcywh_to_xyxy(src)[..., None, :],
                               box_cxcywh_to_xyxy(tgt)[..., None, :])[..., 0, 0]
    return l1, ((1.0 - giou) * ok).sum() / denom


def criterion_ava(outputs: Dict, targets: Dict, matcher: Callable,
                  num_classes: int, weight: float = 10.0,
                  eos_coef: float = 0.1, label_smoothing_alpha: float = 0.1,
                  evaluation: bool = False, return_match: bool = False):
    """targets: boxes [B, M, 4] cxcywh, labels [B, M, NC] multi-hot,
    n_boxes [B].  Returns the loss dict, and with ``return_match`` also the
    MatchResult of every decoder layer [L, B, NQ] (layer order; the last
    layer is index -1)."""
    num_boxes = targets["n_boxes"].sum().float().clamp(min=1.0)
    layers = list(outputs.get("aux_outputs", [])) + [outputs]
    match = matcher({k: torch.stack([o[k] for o in layers])
                     for k in ("pred_boxes", "pred_logits_b")}, targets)
    cw = torch.tensor([1.0, 1.0, eos_coef], device=num_boxes.device)
    a = label_smoothing_alpha
    true_l, false_l = (1 - a) + a / 2, a / 2

    def layer_losses(out, m: MatchResult):
        matched = m.match_ok.float()
        tgt_b = torch.where(m.match_ok, 1, 2)
        loss_ce_b = weighted_cross_entropy(out["pred_logits_b"], tgt_b, cw)

        raw = gather_matched(targets["labels"].float(), m) * matched[..., None]
        n_p = raw.sum().clamp(min=1.0)
        smoothed = raw * true_l + (1 - raw) * false_l
        target_classes = torch.where(m.match_ok[..., None], smoothed, false_l)
        logits = out["pred_logits"].float()
        if evaluation:
            p = torch.sigmoid(logits)
            eps = 1e-12
            loss_ce = -(target_classes * torch.log(p.clamp(min=eps))
                        + (1 - target_classes)
                        * torch.log((1 - p).clamp(min=eps))).mean()
        else:
            weights = torch.where(m.match_ok, weight, 1.0)[..., None]
            loss_ce = sigmoid_focal_loss(logits, target_classes, weights) / n_p

        gt_boxes = gather_matched(targets["boxes"].float(), m)
        l1, giou = box_losses(out["pred_boxes"], gt_boxes, m.match_ok,
                              num_boxes)
        return dict(zip(_LOSS_KEYS, (loss_ce, loss_ce_b, l1, giou)))

    per_layer = [layer_losses(o, MatchResult(match.gt_idx[i], match.match_ok[i]))
                 for i, o in enumerate(layers)]
    losses = per_layer[-1]
    for i, aux in enumerate(per_layer[:-1]):
        losses.update({f"{k}_{i}": v for k, v in aux.items()})
    return (losses, match) if return_match else losses


def postprocess_ava(outputs, target_sizes: torch.Tensor):
    """-> (scores [B, NQ, NC], boxes xyxy in pixels [B, NQ, 4], actorness
    [B, NQ, 1]); ``target_sizes`` [B, 2] = (height, width)."""
    prob = torch.sigmoid(outputs["pred_logits"].float())
    boxes = box_cxcywh_to_xyxy(outputs["pred_boxes"].float())
    ts = target_sizes.to(boxes.device, torch.float32)
    img_h, img_w = ts[:, 0], ts[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)[:, None, :]
    actor = torch.softmax(outputs["pred_logits_b"].float(), dim=-1)[..., 1:2]
    return prob, boxes * scale, actor


def build_criterion_and_postprocessor(cfg, matcher):
    """Counterpart of the JAX package's function (criterion.py:333), AVA
    only.  Returns (criterion_fn, postprocess_fn, weight_dict);
    ``weight_dict`` holds the last layer's four losses only, so the aux
    losses are logged but carry no gradient."""
    lc = cfg.CONFIG.LOSS_COFS
    weight_dict = {
        "loss_ce": lc.DICE_COF,
        "loss_bbox": lc.BBOX_COF,
        "loss_giou": lc.GIOU_COF,
        "loss_ce_b": lc.PERSON_COF,
    }
    name = cfg.CONFIG.DATA.DATASET_NAME
    if name != "ava":
        raise NotImplementedError(
            f"criterion_frames for {name} is not ported yet (ROADMAP.md "
            "Queue 1, step 11)")
    common = dict(
        matcher=matcher,
        num_classes=cfg.CONFIG.DATA.NUM_CLASSES,
        weight=lc.WEIGHT,
        eos_coef=lc.EOS_COF,
        label_smoothing_alpha=cfg.CONFIG.MODEL.LABEL_SMOOTHING_ALPHA,
    )

    def criterion(outputs, targets, evaluation=False, return_match=False):
        return criterion_ava(outputs, targets, evaluation=evaluation,
                             return_match=return_match, **common)

    return criterion, postprocess_ava, weight_dict
