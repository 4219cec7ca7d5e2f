"""The train step, AVA and the tubes (counterpart of
``class_query_vad_tpu/engine/train.py``).

Reference semantics, as the JAX package keeps them:

* AdamW over all trainable parameters: betas (0.9, 0.999), eps 1e-8,
  weight decay 0.01, decoupled; the learning rate from
  ``CONFIG.TRAIN.LR`` (constant) or ``utils.lr_scheduler``;
* the optimized total is the weighted sum of the LAST decoder layer's four
  losses only (``weight_dict`` has no aux keys);
* gradients are SUMMED over ``GRAD_ACCUM`` micro-batches, then clipped
  once to the global norm ``CLIP_GRAD_NORM`` as optax does it
  (g * max_norm / |g| when |g| >= max_norm, no epsilon) and stepped once.

Master weights.  The JAX package keeps float32 parameters and computes in
bf16; here the modules hold their compute dtype (``build_model``), so the
optimizer keeps a float32 master copy of every parameter, adds the (bf16)
gradients into float32 sums, steps the masters and copies them back into
the modules.  AdamW on bf16 parameters would round away the 1e-4-sized
updates.

Several ranks (``parallel.initialize_distributed``).  ``Trainer`` wraps
the model in ``DistributedDataParallel`` whose comm hook SUMS each bucket
in float32 (the losses carry the global normalizers, ``losses.criterion``),
so the update is the JAX package's single step on the concatenated batch.
The micro-batches of an accumulation window run under ``no_sync()``;
their float32 sums are summed over the ranks once, at the update, with
the last micro-batch's (reduced by DDP during its backward).  The clip
takes the global norm after the reduction, so every rank steps the same
bits.  Frozen parameters stay out of DDP's buckets.  Every trainable
parameter of every YAML's model gets a gradient in every step, so DDP
runs without its search for unused parameters (an extra walk of the
autograd graph per step).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from .. import parallel
from ..losses import build_criterion_and_postprocessor, build_matcher
from ..utils.lr_scheduler import build_scheduler


def backbone_freeze_labels(model: nn.Module, cfg) -> Dict[str, str]:
    """{parameter name: "frozen" | "trainable"}, the reference's
    ``tune_point`` freezing (the JAX package's labels, train.py:37-101),
    active for a ``PRETRAINED`` backbone at TUNE_POINT > 0:

    * ViT (``BACKBONE_NAME`` "ViT"): ``patch_embed``, every norm of the
      trunk and the blocks with index <= TUNE_POINT;
    * CSN: the stem (``conv1``, ``bn1``) when TUNE_POINT > 1 and
      ``layer{n}`` when TUNE_POINT > n + 1;
    * any other backbone (VideoMamba) trains whole.

    CSN's running statistics are buffers, not parameters: the optimizer
    never sees them (JAX, which holds them in its param tree, labels them
    frozen always)."""
    mc = cfg.CONFIG.MODEL
    tune = int(mc.get("TUNE_POINT", 0))
    bb = mc.BACKBONE_NAME
    active = bool(mc.get("PRETRAINED", False)) and tune > 0

    def frozen(name: str) -> bool:
        keys = name.split(".")
        if not active or keys[:3] != ["backbone", "0", "body"]:
            return False
        rest = keys[3:-1]
        if not rest:
            return False
        if bb == "ViT":
            if rest[0] == "patch_embed" or any("norm" in k for k in rest):
                return True
            return rest[0] == "blocks" and int(rest[1]) <= tune
        if bb.startswith("CSN"):
            if rest[0] in ("conv1", "bn1"):
                return tune > 1
            if rest[0].startswith("layer"):
                return tune > int(rest[0][5:]) + 1
        return False

    return {name: "frozen" if frozen(name) else "trainable"
            for name, _ in model.named_parameters()}


class MasterAdamW:
    """Summed gradient accumulation, global-norm clip and AdamW on float32
    master weights (the JAX package's ``make_optimizer`` chain).

    ``update()`` after each micro-batch's backward: it moves the gradients
    (``.grad``, then set to None) into float32 sums and, every
    ``grad_accum``-th call, clips, steps and copies the masters back; it
    then returns the global norm of the summed gradients (before the clip),
    else None.  ``last_grad(p)`` is the clipped float32 gradient of the last
    update.

    ``reduce`` (set by ``Trainer`` under a process group) sums a flat
    float32 tensor over the ranks in place: at the update it sums the
    window's earlier micro-batches (run under DDP's ``no_sync``), whose
    gradients were not reduced."""

    def __init__(self, params: Iterable[nn.Parameter],
                 lr: float | Callable[[int], float], grad_accum: int = 1,
                 clip_norm: float = 1.0,
                 reduce: Optional[Callable[[torch.Tensor], None]] = None):
        self.reduce = reduce
        self.params = [p for p in params if p.requires_grad]
        self.masters = [p.detach().float().clone() for p in self.params]
        self._index = {id(p): i for i, p in enumerate(self.params)}
        self.acc = [None] * len(self.params)     # float32 summed gradients
        self.lr = lr if callable(lr) else (lambda step, v=float(lr): v)
        self.grad_accum, self.clip_norm = int(grad_accum), float(clip_norm)
        self.opt = torch.optim.AdamW(self.masters, lr=self.lr(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=0.01)
        self.micro = 0          # micro-batches seen
        self.steps = 0          # optimizer updates made

    def last_micro(self) -> bool:
        """Whether the next ``update()`` steps."""
        return (self.micro + 1) % self.grad_accum == 0

    @torch.no_grad()
    def _reduce_window(self) -> None:
        """Sum the float32 sums of this window's earlier micro-batches
        over the ranks (one flat all-reduce)."""
        flat = torch.cat([
            (a if a is not None else torch.zeros_like(m)).reshape(-1)
            for a, m in zip(self.acc, self.masters)])
        self.reduce(flat)
        for i, part in enumerate(flat.split([m.numel() for m in self.masters])):
            self.acc[i] = part.view_as(self.masters[i])

    @torch.no_grad()
    def update(self) -> Optional[torch.Tensor]:
        if (self.reduce is not None and self.grad_accum > 1
                and self.last_micro()):
            self._reduce_window()
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            if self.acc[i] is None:
                self.acc[i] = p.grad.float()
            else:
                self.acc[i].add_(p.grad)
            p.grad = None
        self.micro += 1
        if self.micro % self.grad_accum:
            return None
        grads = []
        for i, m in enumerate(self.masters):
            # optax steps every leaf, with a zero gradient where none came
            m.grad = self.acc[i] if self.acc[i] is not None else torch.zeros_like(m)
            grads.append(m.grad)
        self.acc = [None] * len(self.params)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.clip_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.clip_norm))
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.steps)
        self.opt.step()
        torch._foreach_copy_(self.params, self.masters)
        self.steps += 1
        return norm

    def state_dict(self) -> dict:
        """Everything a resumed run needs: the float32 masters, the inner
        AdamW's state, the sums of a half-done accumulation window and the
        counters (the learning rate is a function of ``steps``)."""
        return {"masters": [m.detach().clone() for m in self.masters],
                "adamw": self.opt.state_dict(),
                "acc": [a if a is None else a.clone() for a in self.acc],
                "micro": self.micro, "steps": self.steps}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["masters"]) != len(self.masters):
            raise ValueError(f"{len(state['masters'])} master tensors in the "
                             f"state, {len(self.masters)} here")
        for m, s in zip(self.masters, state["masters"]):
            m.copy_(s)
        self.opt.load_state_dict(state["adamw"])
        self.acc = [a if a is None else a.to(m.device)
                    for a, m in zip(state["acc"], self.masters)]
        self.micro, self.steps = int(state["micro"]), int(state["steps"])

    def last_grad(self, p: nn.Parameter) -> Optional[torch.Tensor]:
        """The clipped float32 gradient the last update applied to ``p``."""
        return self.masters[self._index[id(p)]].grad


def make_optimizer(params: Iterable[nn.Parameter],
                   lr: float | Callable[[int], float], grad_accum: int = 1,
                   clip_norm: float = 1.0, reduce=None) -> MasterAdamW:
    """lr may be a float (constant) or a schedule step -> lr."""
    return MasterAdamW(params, lr, grad_accum, clip_norm, reduce)


def _sum_hook(_, bucket):
    """DDP comm hook: the bucket SUMMED over the ranks (DDP's default
    averages), in float32 whatever the gradients' dtype."""
    buf = bucket.buffer()
    acc = buf if buf.dtype in (torch.float32, torch.float64) else buf.float()
    fut = dist.all_reduce(acc, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0].to(buf.dtype))


_TARGET_KEYS = ("boxes", "labels", "n_boxes", "frame_valid", "n_actors")


class Trainer:
    """Train steps of the port: forward in ``train()`` mode, the matcher
    and criterion of the config's dataset (AVA, UCF or JHMDB), backward
    (through the encoder's kernels' backward on the card, e.g. K1's, K3 and
    K4), then ``MasterAdamW``.  The counterpart of the JAX package's
    ``create_train_state`` + ``make_train_step``.

    ``device`` (CUDA by default) must hold ``model``; with no card and no
    ``device="cpu"`` it raises rather than train on the CPU.  Dropout and
    drop path draw from torch's default generators, which the constructor
    seeds with ``seed + rank`` (``torch.manual_seed``): their bits cannot
    equal the JAX package's.  Parameters frozen by
    ``backbone_freeze_labels`` get ``requires_grad=False``.

    Under a process group (``parallel.initialize_distributed``) the
    forward runs through ``self.net``, the model in
    ``DistributedDataParallel`` (see the module docstring); ``self.model``
    stays the bare module, which evaluation and checkpoints use.  Each
    rank's losses are then its share of the global batch's; ``step``
    returns them summed over the ranks."""

    def __init__(self, model: nn.Module, cfg, steps_per_epoch: int = 0,
                 device=None, seed: int = 0):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer: no CUDA device is available; pass "
                    "device='cpu' to train the plain PyTorch path on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"trainer on {self.device}")
        torch.manual_seed(seed + parallel.rank())
        self.model = model.train()
        (self.criterion, self.postprocess,
         self.weight_dict) = build_criterion_and_postprocessor(
            cfg, build_matcher(cfg))
        labels = backbone_freeze_labels(model, cfg)
        for name, p in model.named_parameters():
            if labels[name] == "frozen":
                p.requires_grad_(False)
        tc = cfg.CONFIG.TRAIN
        lr = float(tc.LR)
        if tc.get("LR_POLICY", "constant") != "constant" and steps_per_epoch > 0:
            lr = build_scheduler(cfg, steps_per_epoch)
        self.distributed = parallel.is_distributed()
        self.optimizer = make_optimizer(
            model.parameters(), lr, int(tc.GRAD_ACCUM),
            float(tc.get("CLIP_GRAD_NORM", 1.0)),
            reduce=dist.all_reduce if self.distributed else None)
        self.net = model
        if self.distributed:
            from torch.nn.parallel import DistributedDataParallel

            self.net = DistributedDataParallel(
                model, device_ids=([self.device.index]
                                   if self.device.type == "cuda" else None),
                broadcast_buffers=False)
            self.net.register_comm_hook(None, _sum_hook)
        self.last_match = None

    def loss(self, batch: Dict[str, torch.Tensor]):
        """(total, loss dict, MatchResult of every decoder layer) of one
        micro-batch; the batch's tensors must be on the trainer's device."""
        outputs = self.net(batch["pixels"], batch["mask"])
        targets = {k: batch[k] for k in _TARGET_KEYS if k in batch}
        losses, match = self.criterion(
            outputs, targets, return_match=True,
            reduce=parallel.all_reduce_sum if self.distributed else None)
        total = sum(losses[k] * w for k, w in self.weight_dict.items())
        return total, losses, match

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One micro-batch (numpy arrays or tensors: pixels [B, T, H, W, 3],
        mask [B, H, W] and the targets, AVA boxes [B, M, 4], labels [B, M,
        NC], n_boxes [B], or tube boxes [B, A, T, 4], labels [B, A, T],
        frame_valid [B, T], n_actors [B]):
        forward, backward and, every GRAD_ACCUM calls, the update.  Returns
        the total and the last layer's four losses (detached; summed over
        the ranks under a process group), plus ``grad_norm`` when it
        stepped."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        sync = not self.distributed or self.optimizer.last_micro()
        with contextlib.nullcontext() if sync else self.net.no_sync():
            total, losses, self.last_match = self.loss(batch)
            total.backward()
        metrics = {"total_loss": total.detach()}
        metrics.update({k: losses[k].detach() for k in self.weight_dict})
        if self.distributed:
            vals = torch.stack(list(metrics.values()))
            dist.all_reduce(vals)
            metrics = dict(zip(metrics, vals.unbind()))
        norm = self.optimizer.update()
        if norm is not None:
            metrics["grad_norm"] = norm
        return metrics
