"""Jobs for ``launch.start_ranks``: each runs on one CPU rank of a gloo
group, on that rank's share of a batch (clips ``rank::world``, as the
loaders split them), and returns what the caller holds against a
single-process run.  Configs travel as ``cfg.dump()`` text."""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch
import yaml

from .mesh import all_reduce_sum, rank, world_size


def cfg_from_dump(text: str):
    from ..config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg(yaml.safe_load(text))
    return cfg


def rank_share(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's clips of a batch (every entry has the clip axis first)."""
    return {k: v[rank()::world_size()] for k, v in batch.items()}


def _summed(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    vals = all_reduce_sum(torch.stack([d[k].detach() for k in d]))
    return dict(zip(d, vals.unbind()))


def train_step(cfg: str, batch: Dict[str, np.ndarray],
               state: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """One ``engine.Trainer`` step (DDP) on this rank's clips, the class
    head's fixed dropout off: the losses summed over the ranks (aux
    included), this rank's matcher assignment, the gradients after DDP's
    reduction, the global norm and the parameters after the update."""
    return trained(cfg_from_dump(cfg), batch, state)[1]


def cpu_trainer(cfg, state: Optional[Dict[str, torch.Tensor]] = None):
    """A CPU ``engine.Trainer`` of ``cfg``'s model (its seeded init, or
    ``state``), the class head's fixed dropout off."""
    from ..engine import Trainer
    from ..models import build_model

    model = build_model(cfg, device="cpu")
    if state is not None:
        model.load_state_dict(state, strict=True)
    model.head_dropout.p = 0.0
    return Trainer(model, cfg, device="cpu")


def trained(cfg, batch: Dict[str, np.ndarray],
            state: Optional[Dict[str, torch.Tensor]] = None):
    """(trainer, ``train_step``'s result) on the CPU."""
    trainer = cpu_trainer(cfg, state)
    model = trainer.model
    share = {k: torch.as_tensor(v) for k, v in rank_share(batch).items()}
    total, losses, match = trainer.loss(share)
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    norm = trainer.optimizer.update()
    return trainer, {
        "losses": _summed({"total": total, **losses}),
        "match": (match.gt_idx, match.match_ok), "grads": grads,
        "grad_norm": norm,
        "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def accumulated_steps(cfg: str, batches) -> dict:
    """``engine.Trainer.step`` (DDP) over ``batches``, this rank's clips of
    each, the class head's fixed dropout off: the metrics of each step and
    the parameters after (with ``GRAD_ACCUM`` > 1 the window's earlier
    micro-batches run under ``no_sync``)."""
    trainer = cpu_trainer(cfg_from_dump(cfg))
    metrics = [trainer.step(rank_share(b)) for b in batches]
    return {"metrics": metrics,
            "params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}


def digest(params: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """Each tensor's bytes as a sha256, to hold ranks bit-equal cheaply."""
    return {k: hashlib.sha256(v.detach().contiguous().numpy().tobytes())
            .hexdigest() for k, v in params.items()}


def remat_steps(cfg: str, batches) -> dict:
    """``engine.Trainer.step`` (DDP) over ``batches``, this rank's clips of
    each, the class head's fixed dropout off (``GRAD_ACCUM`` 1): the
    metrics of each step, how many times the first decoder layer ran its
    forward (twice a step when ``GRADIENT_CHECKPOINTING`` recomputes it in
    the backward), the reduced float32 gradients of the first update
    (rank 0 only: they are large) and a digest of every rank's parameters
    after.  DDP, which does not search for unused parameters, raises in
    the second step's forward if the first left a trainable parameter
    without a gradient."""
    trainer = cpu_trainer(cfg_from_dump(cfg))
    model = trainer.model
    forwards = []
    model.transformer.decoder.layers[0].register_forward_pre_hook(
        lambda *_: forwards.append(1))
    metrics, grads = [], None
    for b in batches:
        metrics.append(trainer.step(rank_share(b)))
        if grads is None and rank() == 0:
            grads = {n: trainer.optimizer.last_grad(p).clone()
                     for n, p in model.named_parameters() if p.requires_grad}
    return {"metrics": metrics, "forwards": len(forwards), "grads": grads,
            "digest": digest(dict(model.named_parameters()))}


def criterion_losses(cfg: str, outputs: dict, targets: dict) -> dict:
    """The train criterion of ``cfg`` on this rank's clips of given
    outputs, its normalizers summed over the ranks; the losses summed
    over the ranks."""
    from ..losses import build_criterion_and_postprocessor, build_matcher

    cfg = cfg_from_dump(cfg)
    crit, _, _ = build_criterion_and_postprocessor(cfg, build_matcher(cfg))
    share = lambda tree: {  # noqa: E731
        k: ([share(a) for a in v] if k == "aux_outputs" else
            torch.as_tensor(v)[rank()::world_size()])
        for k, v in tree.items()}
    return _summed(crit(share(outputs), share(targets), reduce=all_reduce_sum))


def csn_batch_norm(x: np.ndarray, g: np.ndarray, weight: np.ndarray,
                   bias: np.ndarray) -> dict:
    """``CSNBatchNorm`` in ``train()`` on this rank's clips of x (NCDHW,
    float64 kept): the output, and the gradients for the cotangent g
    (x's own share; weight and bias summed over the ranks)."""
    from ..models.csn import CSNBatchNorm

    bn = CSNBatchNorm(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(weight))
        bn.bias.copy_(torch.as_tensor(bias))
    xs = torch.as_tensor(x[rank()::world_size()]).requires_grad_(True)
    y = bn(xs)
    y.backward(torch.as_tensor(g[rank()::world_size()]))
    return {"y": y.detach(), "dx": xs.grad,
            **_summed({"dweight": bn.weight.grad, "dbias": bn.bias.grad})}
