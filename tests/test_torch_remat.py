"""``CONFIG.GRADIENT_CHECKPOINTING`` in the PyTorch port, on the CPU: one
train step of a tiny model with it on and one with it off give the same
losses and gradients, dropout (and the ViT's drop path) on, from the same
seed.  The ViT blocks, the fast and the exact encoders' layers, the
decoder's layer pairs and CSN's bottlenecks are recomputed in the
backward (``torch.utils.checkpoint``, the RNG state replayed); so are
the Mamba family's VideoMamba blocks and SSM encoder layers.

No JAX oracle: the step itself is held to JAX by
``test_torch_train_step.py``, ``test_torch_exact_model.py`` and
``test_torch_csn.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from class_query_vad_tpu_torch.config import get_cfg_custom
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.models.detr import randomize_constants

from torch_parity import cut_cfg

CONFIGS = Path(__file__).resolve().parents[1] / "configuration"
MODELS = {
    "vit_fast_2d": ("AVA22_ViT-B_fast.yaml", ["CONFIG.MODEL.FAST_WINDOW",
                                              "2d"]),
    "vit_exact": ("AVA22_ViT-B.yaml", []),
    "csn50": ("AVA22_CSN50.yaml", []),
}
# the summation order of a recomputed layer can differ from the first
# forward's (a different kernel for a grad-enabled region): 1e-6 of the
# tensor's largest gradient
GRAD_TOL = 1e-6


def _cfg(name: str, remat: bool):
    yaml, opts = MODELS[name]
    cfg = cut_cfg(get_cfg_custom(str(CONFIGS / yaml), list(opts)),
                  enc_layers=2, dec_layers=2)
    c = cfg.CONFIG
    c.GRADIENT_CHECKPOINTING = remat
    c.MODEL.DROPOUT = 0.1
    c.ViT.DROP_PATH_RATE = 0.2
    return cfg


def _batch(nc: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True
    return {
        "pixels": rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32),
        "mask": mask,
        "boxes": rng.uniform(0.2, 0.7, (2, 4, 4)).astype(np.float32),
        "labels": (rng.random((2, 4, nc)) < 0.1).astype(np.float32),
        "n_boxes": np.array([3, 2], np.int32),
    }


def _remat_layers(model):
    """A layer of each container that can remat: the ViT's last block or
    CSN's last bottleneck (the YAMLs' TUNE_POINT 4 freezes CSN's first
    stages, which then keep no activations for the backward and are not
    recomputed), encoder layer 0, decoder layer pair 0."""
    body = model.backbone[0].body
    trunk = body.blocks[-1] if hasattr(body, "blocks") else body.layer4[-1]
    dec = model.transformer.decoder
    return {"trunk": trunk, "encoder": model.transformer.encoder.layers[0],
            "decoder loc": dec.layers[0], "decoder cls": dec.cls_layers[0]}


def _step(name: str, remat: bool):
    """One train step's losses and gradients, and how many times the first
    layer of each remat container ran its forward."""
    cfg = _cfg(name, remat)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    randomize_constants(model, torch.Generator().manual_seed(6))
    trainer = Trainer(model, cfg, device="cpu", seed=7)
    calls = dict.fromkeys(_remat_layers(model), 0)
    for k, layer in _remat_layers(model).items():
        layer.register_forward_pre_hook(
            lambda *_, k=k: calls.__setitem__(k, calls[k] + 1))
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg.CONFIG.DATA.NUM_CLASSES).items()}
    total, losses, _ = trainer.loss(batch)
    total.backward()
    return (model, {k: v.item() for k, v in losses.items()},
            {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}, calls)


@pytest.mark.parametrize("name", list(MODELS))
def test_gradient_checkpointing_keeps_losses_and_grads(name):
    model, l_off, g_off, calls_off = _step(name, False)
    remat_model, l_on, g_on, calls_on = _step(name, True)
    s = remat_model.spec
    assert s.gradient_checkpointing and not model.spec.gradient_checkpointing
    # each checkpointed layer runs again in the backward
    assert set(calls_off.values()) == {1} and set(calls_on.values()) == {2}
    assert l_on == l_off
    assert sorted(g_on) == sorted(g_off) and len(g_on) > 10
    for k, g in g_off.items():
        tol = GRAD_TOL * g.abs().max().item()
        assert (g_on[k] - g).abs().max().item() <= tol, k
    # the backbone's trunk, the encoder and the decoder remat
    flags = [m.remat for m in remat_model.modules() if hasattr(m, "remat")]
    assert len(flags) == 3 and all(flags)


def test_dropout_is_live_in_the_remat_step():
    """The comparison above is not vacuous: with another trainer seed the
    dropout masks, and so the losses, change."""
    cfg = _cfg("vit_fast_2d", True)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg.CONFIG.DATA.NUM_CLASSES).items()}
    totals = []
    for seed in (7, 8):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(5))
        randomize_constants(model, torch.Generator().manual_seed(6))
        with torch.no_grad():
            totals.append(Trainer(model, cfg, device="cpu",
                                  seed=seed).loss(batch)[0].item())
    assert totals[0] != totals[1]


def test_mamba_family_train_forward_with_remat():
    """VideoMamba + the exact encoder with GRADIENT_CHECKPOINTING: its
    train() forward runs, and the backward recomputes each VideoMamba block
    (the whole family's remat against JAX and off vs on is
    tests/test_torch_mamba_train.py)."""
    cfg = cut_cfg(get_cfg_custom(str(CONFIGS
                                     / "AVA22_ViT-B-train-mamba.yaml")),
                  enc_layers=1, dec_layers=1, queries=2)
    cfg.CONFIG.GRADIENT_CHECKPOINTING = True
    model = build_model(cfg, device="cpu", input_hw=(64, 64))
    pixels = torch.zeros((1, 8, 64, 64, 3))
    mask = torch.zeros((1, 64, 64), dtype=torch.bool)
    with torch.no_grad():
        assert model(pixels, mask)["pred_boxes"].shape == (1, 2, 4)
    body = model.backbone[0].body
    assert body.remat and model.transformer.encoder.remat
    calls = []
    body.layers[0].register_forward_pre_hook(lambda *_: calls.append(1))
    out = model.train()(pixels, mask)
    assert out["pred_boxes"].shape == (1, 2, 4) and len(calls) == 1
    out["pred_boxes"].sum().backward()
    assert len(calls) == 2
    assert body.layers[0].mixer.x_proj.weight.grad is not None
