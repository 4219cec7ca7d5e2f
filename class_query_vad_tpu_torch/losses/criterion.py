"""Set criteria (AVA, UCF, JHMDB) and postprocessing (counterpart of
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

Under a process group the train step passes ``reduce``
(``parallel.all_reduce_sum``): every normalizer over the batch (the gt
count, n_p, the class-weight sum of the cross entropy, the clip and frame
counts) is then summed over the ranks before it divides, as the JAX
package's global batch gives it under a mesh, so each rank's loss is its
share of the global one and the ranks' summed gradients are the global
step's.  The eval path passes none and issues no collective.

The tube criteria (``criterion_frames``) score per frame, with the
reference's quirks as the JAX package keeps them: the k-th matched query
(in query order) pairs with the k-th live gt slot, whatever the matcher's
permutation; the 10x focal weights of matched queries land at frame
f - front_pad; the class focal loss runs on the fused logit
``inverse_sigmoid(sigmoid(logits) * p_actor)`` over all frames / (B * T)
(UCF) or over the valid frames / valid_len (JHMDB); the boxes over the
live gts / their count.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..utils.box_ops import box_cxcywh_to_xyxy, generalized_box_iou
from ..utils.misc import inverse_sigmoid
from .matcher import MatchResult, live_frame_gts

_LOSS_KEYS = ("loss_ce", "loss_ce_b", "loss_bbox", "loss_giou")


def sigmoid_focal_loss(inputs, targets, weights=None, alpha: float = 0.25,
                       gamma: float = 2.0, elem_mask=None) -> torch.Tensor:
    """Per-element focal terms (weights multiply the BCE term before the
    modulating factor), mean over the last axis, sum over the rest;
    ``elem_mask`` (broadcastable to inputs[..., 0]) zeroes rows before the
    sum (JHMDB's valid frames)."""
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
    loss = loss.mean(dim=-1)
    if elem_mask is not None:
        loss = loss * elem_mask
    return loss.sum()


def _global(x: torch.Tensor, reduce: Optional[Callable]) -> torch.Tensor:
    """``x`` summed over the ranks when ``reduce`` is given."""
    return x if reduce is None else reduce(x)


def weighted_cross_entropy(logits, labels, class_weights,
                           reduce: Optional[Callable] = None) -> torch.Tensor:
    """F.cross_entropy with per-class weights: sum w[y]·nll / sum w[y]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = class_weights[labels]
    return (w * nll).sum() / _global(w.sum(), reduce)


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
                  evaluation: bool = False, return_match: bool = False,
                  reduce: Optional[Callable] = None):
    """targets: boxes [B, M, 4] cxcywh, labels [B, M, NC] multi-hot,
    n_boxes [B].  Returns the loss dict, and with ``return_match`` also the
    MatchResult of every decoder layer [L, B, NQ] (layer order; the last
    layer is index -1).  ``reduce``: see the module docstring."""
    num_boxes = _global(targets["n_boxes"].sum().float(), reduce).clamp(
        min=1.0)
    layers, match = _layer_matches(outputs, matcher, targets)
    cw = torch.tensor([1.0, 1.0, eos_coef], device=num_boxes.device)
    a = label_smoothing_alpha
    true_l, false_l = (1 - a) + a / 2, a / 2

    def layer_losses(out, m: MatchResult):
        matched = m.match_ok.float()
        tgt_b = torch.where(m.match_ok, 1, 2)
        loss_ce_b = weighted_cross_entropy(out["pred_logits_b"], tgt_b, cw,
                                           reduce)

        raw = gather_matched(targets["labels"].float(), m) * matched[..., None]
        n_p = _global(raw.sum(), reduce).clamp(min=1.0)
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
    return _losses_by_layer(per_layer, match, return_match)


def _layer_matches(outputs: Dict, matcher: Callable, targets: Dict):
    """Every decoder layer's outputs (aux first, the last layer last) and
    their MatchResult [L, ...], from one matcher call."""
    layers = list(outputs.get("aux_outputs", [])) + [outputs]
    match = matcher({k: torch.stack([o[k] for o in layers])
                     for k in ("pred_boxes", "pred_logits_b")}, targets)
    return layers, match


def _losses_by_layer(per_layer, match, return_match: bool):
    losses = per_layer[-1]
    for i, aux in enumerate(per_layer[:-1]):
        losses.update({f"{k}_{i}": v for k, v in aux.items()})
    return (losses, match) if return_match else losses


def criterion_frames(outputs: Dict, targets: Dict, matcher: Callable,
                     num_classes: int, weight: float = 10.0,
                     eos_coef: float = 0.1, label_smoothing_alpha: float = 0.1,
                     jhmdb: bool = False, return_match: bool = False,
                     reduce: Optional[Callable] = None):
    """UCF / JHMDB per-frame criterion (the JAX ``criterion_frames``,
    criterion.py:186).  outputs [B, T, NQ, ...]; targets: boxes [B, A, T,
    4], labels [B, A, T] int (``num_classes`` = background), frame_valid
    [B, T] bool, optional n_actors [B].  Returns the loss dict, and with
    ``return_match`` also the matcher's MatchResult of every decoder layer
    [L, B, T, NQ] (before the sequential pairing).  ``reduce``: see the
    module docstring."""
    b, t, nq = outputs["pred_logits"].shape[:3]
    frame_valid = targets["frame_valid"]
    boxes_t = targets["boxes"].transpose(1, 2).float()         # [B, T, A, 4]
    labels_t = targets["labels"].transpose(1, 2).long()        # [B, T, A]
    live_gt = live_frame_gts(targets, filter_empty=not jhmdb)  # [B, T, A]
    a_slots = live_gt.shape[-1]
    num_valid_boxes = _global(live_gt.sum().float(), reduce).clamp(min=1.0)
    layers, match = _layer_matches(outputs, matcher, targets)
    cw = torch.tensor([1.0, 1.0, eos_coef], device=boxes_t.device)
    a = label_smoothing_alpha
    true_l, false_l = (1 - a) + a / num_classes, a / num_classes
    # reference quirk: the k-th matched query (ascending query index) pairs
    # with the k-th live gt in slot order, not with the matcher's column
    order = torch.argsort((~live_gt).int(), dim=-1, stable=True)  # [B, T, A]
    # reference quirk: the matched-query focal weights index the full-
    # length frame rows with valid-range frame indices, landing at frame
    # f - front_pad
    front_pad = torch.argmax(frame_valid.int(), dim=1)            # [B]
    shift = torch.arange(t, device=front_pad.device)[None] + front_pad[:, None]
    shift_ok = (shift < t)[..., None]                             # [B, T, 1]
    shift = shift.clamp(max=t - 1)[..., None].expand(b, t, nq)
    clips = b if reduce is None else reduce(
        torch.tensor(float(b), device=boxes_t.device))

    def layer_losses(out, matched):
        rank = (matched.long().cumsum(-1) - 1).clamp(0, a_slots - 1)
        pairs = MatchResult(torch.gather(order, -1, rank), matched)
        tgt_b = torch.where(matched, 1, 2)
        loss_ce_b = weighted_cross_entropy(out["pred_logits_b"], tgt_b, cw,
                                           reduce)

        gt_label = gather_matched(labels_t[..., None], pairs)[..., 0]
        tgt_cls = torch.where(matched, gt_label, num_classes)
        onehot = F.one_hot(tgt_cls, num_classes + 1).float()
        onehot = onehot * (true_l - false_l) + false_l
        shifted = torch.gather(matched, 1, shift) & shift_ok
        weights = torch.where(shifted, weight, 1.0)[..., None]
        p_b = torch.softmax(out["pred_logits_b"].float(), dim=-1)[..., 1:2]
        fused = inverse_sigmoid(torch.sigmoid(out["pred_logits"].float()) * p_b)
        if jhmdb:
            valid_len = frame_valid.sum(1).clamp(min=1).float()
            mean_len = (valid_len.mean() if reduce is None else
                        reduce(valid_len.sum()) / clips)
            loss_ce = sigmoid_focal_loss(
                fused, onehot[..., :-1], weights,
                elem_mask=frame_valid[:, :, None]) / mean_len
        else:
            loss_ce = sigmoid_focal_loss(fused, onehot[..., :-1],
                                         weights) / (clips * t)

        gt_boxes = gather_matched(boxes_t, pairs)
        l1, giou = box_losses(out["pred_boxes"], gt_boxes, matched,
                              num_valid_boxes)
        return dict(zip(_LOSS_KEYS, (loss_ce, loss_ce_b, l1, giou)))

    per_layer = [layer_losses(o, match.match_ok[i])
                 for i, o in enumerate(layers)]
    return _losses_by_layer(per_layer, match, return_match)


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


def postprocess_frames(outputs, target_sizes: torch.Tensor):
    """UCF / JHMDB: the fused score sigmoid(inverse_sigmoid(sigmoid(logits)
    * p_actor)), boxes xyxy in pixels and p_actor, in the outputs' [B, T,
    NQ, ...] layout; ``target_sizes`` [B, 2] = (height, width)."""
    p_b = torch.softmax(outputs["pred_logits_b"].float(), dim=-1)[..., 1:2]
    prob = torch.sigmoid(inverse_sigmoid(
        torch.sigmoid(outputs["pred_logits"].float()) * p_b))
    boxes = box_cxcywh_to_xyxy(outputs["pred_boxes"].float())
    ts = target_sizes.to(boxes.device, torch.float32)
    img_h, img_w = ts[:, 0], ts[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)[:, None, None, :]
    return prob, boxes * scale, p_b


def build_criterion_and_postprocessor(cfg, matcher):
    """Counterpart of the JAX package's function (criterion.py:333).
    Returns (criterion_fn, postprocess_fn, weight_dict);
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
    common = dict(
        matcher=matcher,
        num_classes=cfg.CONFIG.DATA.NUM_CLASSES,
        weight=lc.WEIGHT,
        eos_coef=lc.EOS_COF,
        label_smoothing_alpha=cfg.CONFIG.MODEL.LABEL_SMOOTHING_ALPHA,
    )

    if name == "ava":
        def criterion(outputs, targets, evaluation=False, return_match=False,
                      reduce=None):
            return criterion_ava(outputs, targets, evaluation=evaluation,
                                 return_match=return_match, reduce=reduce,
                                 **common)

        return criterion, postprocess_ava, weight_dict

    def criterion(outputs, targets, evaluation=False, return_match=False,
                  reduce=None):
        # ``evaluation`` changes nothing in the tube criteria, as in JAX
        return criterion_frames(outputs, targets, jhmdb=name == "jhmdb",
                                return_match=return_match, reduce=reduce,
                                **common)

    return criterion, postprocess_frames, weight_dict
