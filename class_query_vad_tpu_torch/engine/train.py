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
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from ..losses import build_criterion_and_postprocessor, build_matcher
from ..utils.lr_scheduler import build_scheduler


def backbone_freeze_labels(model: nn.Module, cfg) -> Dict[str, str]:
    """{parameter name: "frozen" | "trainable"}, the reference's
    ``tune_point`` freezing (the JAX package's labels, train.py:37-101):
    for a pretrained ViT (``BACKBONE_NAME`` "ViT", ``PRETRAINED`` and
    TUNE_POINT > 0) ``patch_embed``, every norm of the trunk and the
    blocks with index <= TUNE_POINT; every other backbone freezes nothing
    (the port has no CSN, whose stages JAX freezes)."""
    mc = cfg.CONFIG.MODEL
    tune = int(mc.get("TUNE_POINT", 0))
    active = (mc.BACKBONE_NAME == "ViT" and bool(mc.get("PRETRAINED", False))
              and tune > 0)

    def frozen(name: str) -> bool:
        keys = name.split(".")
        if not active or keys[:3] != ["backbone", "0", "body"]:
            return False
        rest = keys[3:-1]
        if not rest:
            return False
        if rest[0] == "patch_embed" or any("norm" in k for k in rest):
            return True
        return rest[0] == "blocks" and int(rest[1]) <= tune

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
    update."""

    def __init__(self, params: Iterable[nn.Parameter],
                 lr: float | Callable[[int], float], grad_accum: int = 1,
                 clip_norm: float = 1.0):
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

    @torch.no_grad()
    def update(self) -> Optional[torch.Tensor]:
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

    def last_grad(self, p: nn.Parameter) -> Optional[torch.Tensor]:
        """The clipped float32 gradient the last update applied to ``p``."""
        return self.masters[self._index[id(p)]].grad


def make_optimizer(params: Iterable[nn.Parameter],
                   lr: float | Callable[[int], float], grad_accum: int = 1,
                   clip_norm: float = 1.0) -> MasterAdamW:
    """lr may be a float (constant) or a schedule step -> lr."""
    return MasterAdamW(params, lr, grad_accum, clip_norm)


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
    seeds with ``seed`` (``torch.manual_seed``): their bits cannot equal
    the JAX package's.  Parameters frozen by ``backbone_freeze_labels``
    get ``requires_grad=False``."""

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
        torch.manual_seed(seed)
        self.model = model.train()
        self.criterion, _, self.weight_dict = build_criterion_and_postprocessor(
            cfg, build_matcher(cfg))
        labels = backbone_freeze_labels(model, cfg)
        for name, p in model.named_parameters():
            if labels[name] == "frozen":
                p.requires_grad_(False)
        tc = cfg.CONFIG.TRAIN
        lr = float(tc.LR)
        if tc.get("LR_POLICY", "constant") != "constant" and steps_per_epoch > 0:
            lr = build_scheduler(cfg, steps_per_epoch)
        self.optimizer = make_optimizer(model.parameters(), lr,
                                        int(tc.GRAD_ACCUM),
                                        float(tc.get("CLIP_GRAD_NORM", 1.0)))
        self.last_match = None

    def loss(self, batch: Dict[str, torch.Tensor]):
        """(total, loss dict, MatchResult of every decoder layer) of one
        micro-batch; the batch's tensors must be on the trainer's device."""
        outputs = self.model(batch["pixels"], batch["mask"])
        targets = {k: batch[k] for k in _TARGET_KEYS if k in batch}
        losses, match = self.criterion(outputs, targets, return_match=True)
        total = sum(losses[k] * w for k, w in self.weight_dict.items())
        return total, losses, match

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One micro-batch (numpy arrays or tensors: pixels [B, T, H, W, 3],
        mask [B, H, W] and the targets, AVA boxes [B, M, 4], labels [B, M,
        NC], n_boxes [B], or tube boxes [B, A, T, 4], labels [B, A, T],
        frame_valid [B, T], n_actors [B]):
        forward, backward and, every GRAD_ACCUM calls, the update.  Returns
        the total and the last layer's four losses (detached), plus
        ``grad_norm`` when it stepped."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        total, losses, self.last_match = self.loss(batch)
        total.backward()
        metrics = {"total_loss": total.detach()}
        metrics.update({k: losses[k].detach() for k in self.weight_dict})
        norm = self.optimizer.update()
        if norm is not None:
            metrics["grad_norm"] = norm
        return metrics
