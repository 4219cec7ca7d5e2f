"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, it never falls back silently to the CPU, its kernel wrapper
takes only CPU tensors to the plain version, and every configuration
builds.  The kernel-vs-plain checks
on a card are in tests/test_torch_cuda.py."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from class_query_vad_tpu.config import get_cfg_custom as jax_get_cfg_custom
from class_query_vad_tpu.models.spec import spec_from_cfg as jax_spec_from_cfg
from class_query_vad_tpu_torch.config import get_cfg_custom, get_cfg_defaults
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.losses import (
    build_criterion_and_postprocessor,
    build_matcher,
    postprocess_ava,
    postprocess_frames,
)
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.models.deform_encoder import MSDeformAttn3D
from class_query_vad_tpu_torch.models.detr import randomize_constants
from class_query_vad_tpu_torch.models.fast_encoder import FastDeformAttn3D
from class_query_vad_tpu_torch.models.spec import spec_from_cfg
from class_query_vad_tpu_torch.ops.blend2d import (
    blend2d,
    blend2d_bwd_dcomps,
    blend2d_bwd_dvol,
)
from class_query_vad_tpu_torch.ops.fast_deform_cuda import fused_blend2d
from class_query_vad_tpu_torch.ops.fused_ffn import fused_ffn, fused_ffn_kernel
from class_query_vad_tpu_torch.ops.vit_attention import (
    flash_attention_qkv,
    vit_attention,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "class_query_vad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "class_query_vad_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"


@pytest.mark.parametrize("name", sorted(p.name for p in (PORT / "ops").glob("*.py")))
def test_kernel_path_has_no_try(name):
    """No ``try`` around the build or the launch, in any module of ops/:
    on the card a wrapper launches its kernel or raises."""
    tree = ast.parse((PORT / "ops" / name).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    vol = torch.empty((1, 2, 1, 3, 4, 256), device="meta")
    fused = torch.empty((1, 1, 3, 4, 3 * 2 * 64), device="meta")
    before = fused_blend2d.launches
    with pytest.raises(ValueError):
        fused_blend2d(vol, fused, 8, 1.0)
    assert fused_blend2d.launches == before


def test_attention_and_ffn_wrappers_reject_non_cpu_non_cuda_tensors():
    qkv = torch.empty((1, 16, 3 * 64), device="meta")
    ffn = [torch.empty(s, device="meta")
           for s in ((8, 256), (256, 64), (64,), (64, 256), (256,))]
    before = (vit_attention.launches, fused_ffn_kernel.launches)
    with pytest.raises(ValueError):
        flash_attention_qkv(qkv, 1, 0.125)
    with pytest.raises(ValueError):
        fused_ffn(*ffn)
    with pytest.raises(ValueError):      # one CPU, four meta tensors
        fused_ffn(torch.zeros((8, 256)), *ffn[1:])
    assert (vit_attention.launches, fused_ffn_kernel.launches) == before


def test_attention_and_ffn_wrappers_take_cpu_tensors_to_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((1, 20, 3 * 128), generator=g, requires_grad=True)
    ffn = [torch.randn(s, generator=g, requires_grad=True)
           for s in ((8, 256), (256, 64), (64,), (64, 256), (256,))]
    before = (vit_attention.launches, fused_ffn_kernel.launches)
    flash_attention_qkv(qkv, 2, 0.125).sum().backward()
    fused_ffn(*ffn, "gelu_exact").sum().backward()
    assert qkv.grad is not None and all(x.grad is not None for x in ffn)
    assert (vit_attention.launches, fused_ffn_kernel.launches) == before


def _meta_comps(shape=(1, 2, 1, 3, 4)):
    vol = torch.empty(shape + (256,), device="meta")
    comps = [torch.empty(shape + (64,), device="meta") for _ in range(3)]
    g = torch.empty((shape[0],) + shape[2:] + (256,), device="meta")
    return vol, comps, g


def test_blend_wrappers_reject_non_cpu_non_cuda_tensors():
    vol, (dx, dy, a), g = _meta_comps()
    counters = (blend2d, blend2d_bwd_dvol, blend2d_bwd_dcomps)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError):
        blend2d(vol, dx, dy, a, 8)
    with pytest.raises(ValueError):
        blend2d_bwd_dvol(dx, dy, a, g, vol.dtype, 8)
    with pytest.raises(ValueError):
        blend2d_bwd_dcomps(vol, dx, dy, a, g, 8)
    with pytest.raises(ValueError):      # one CPU, one meta tensor
        blend2d(torch.zeros(vol.shape), dx, dy, a, 8)
    assert [c.launches for c in counters] == before


def test_blend_wrappers_take_cpu_tensors_to_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    vol = torch.randn((1, 2, 1, 3, 4, 256), generator=g)
    dx, dy, a = (torch.rand((1, 2, 1, 3, 4, 64), generator=g) for _ in range(3))
    counters = (fused_blend2d, blend2d, blend2d_bwd_dvol, blend2d_bwd_dcomps)
    before = [c.launches for c in counters]
    xs = [x.clone().requires_grad_() for x in (vol, dx, dy, a)]
    blend2d(*xs, 8).sum().backward()
    f = torch.randn((1, 1, 3, 4, 3 * 2 * 64), generator=g, requires_grad=True)
    fused_blend2d(xs[0], f, 8, 1.0).sum().backward()
    assert all(x.grad is not None for x in xs) and f.grad is not None
    assert [c.launches for c in counters] == before


def _tiny_cfg():
    cfg = get_cfg_defaults()
    c = cfg.CONFIG
    c.DATA.NUM_CLASSES = 5
    c.DATA.TEMP_LEN = 8
    c.MODEL.TEMP_LEN = 8
    c.MODEL.SINGLE_FRAME = True
    c.MODEL.ENCODER_TYPE = "fast_attention"
    c.MODEL.FAST_WINDOW = "2d"
    c.MODEL.ENC_LAYERS = 1
    c.MODEL.DEC_LAYERS = 1
    c.MODEL.DIM_FEEDFORWARD = 32
    c.MODEL.QUERY_NUM = 2
    c.ViT.DEPTH = 1
    return cfg


def test_build_model_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_tiny_cfg())
    model = build_model(_tiny_cfg(), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_build_model_is_seeded_and_casts_per_part():
    cfg = _tiny_cfg()
    cfg.CONFIG.MODEL.FAST_DTYPE = "bfloat16"
    cfg.CONFIG.MODEL.DECODER_DTYPE = "bfloat16"
    a = build_model(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(3))
    b = build_model(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    dt = {k: v.dtype for k, v in a.state_dict().items()}
    assert dt["backbone.0.body.blocks.0.attn.qkv.weight"] == torch.bfloat16
    assert dt["transformer.encoder.layers.0.linear1.weight"] == torch.bfloat16
    assert dt["transformer.decoder.layers.0.linear1.weight"] == torch.bfloat16
    # float32 islands: box refinement MLPs, class queries, heads, embeds
    for k in ("transformer.decoder.bbox_embed.layers.0.weight",
              "transformer.decoder.ref_point_head.layers.0.weight",
              "transformer.decoder.class_queries.weight",
              "transformer.level_embed", "refpoint_embed.weight",
              "class_embed_b.weight"):
        assert dt[k] == torch.float32, k
    # JAX initialisers where they shape the forward
    sd = a.state_dict()
    assert not sd["transformer.encoder.layers.0.self_attn.window_offsets.weight"].any()
    assert not sd["transformer.encoder.layers.0.self_attn.window_weights.weight"].any()
    assert sd["transformer.encoder.layers.0.self_attn.window_offsets.bias"].abs().max() == 8


def test_trainer_needs_a_card_or_an_explicit_cpu(monkeypatch):
    model = build_model(_tiny_cfg(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, _tiny_cfg())
    trainer = Trainer(model, _tiny_cfg(), device="cpu")
    assert trainer.model.training and trainer.device.type == "cpu"


def test_unported_training_options_raise():
    # GRADIENT_CHECKPOINTING is ported (step 8a, tests/test_torch_remat.py):
    # eval and train forwards run with it
    cfg = _tiny_cfg()
    cfg.CONFIG.GRADIENT_CHECKPOINTING = True
    model = build_model(cfg, device="cpu")
    pixels = torch.zeros((1, 8, 64, 64, 3))
    mask = torch.zeros((1, 64, 64), dtype=torch.bool)
    with torch.no_grad():
        model(pixels, mask)
        assert model.train()(pixels, mask)["pred_boxes"].shape == (1, 2, 4)
    # the tube datasets' matchers and criteria are ported (step 11)
    for name in ("ava", "ucf", "jhmdb"):
        cfg = _tiny_cfg()
        cfg.CONFIG.DATA.DATASET_NAME = name
        crit, post, weights = build_criterion_and_postprocessor(
            cfg, build_matcher(cfg))
        assert callable(crit) and sorted(weights) == [
            "loss_bbox", "loss_ce", "loss_ce_b", "loss_giou"]
        assert post is (postprocess_ava if name == "ava" else postprocess_frames)
    cfg.CONFIG.DATA.DATASET_NAME = "kinetics"
    with pytest.raises(ValueError, match="unknown dataset"):
        build_matcher(cfg)


def test_randomize_constants_gives_nonzero_class_logits():
    """At the JAX init the class logits are the feature mean of a
    unit-scale, zero-bias LayerNorm output, identically 0; a card-vs-CPU
    check with random weights redraws those constants first."""
    model = build_model(_tiny_cfg(), device="cpu")
    g = torch.Generator().manual_seed(1)
    pixels = torch.randn((1, 8, 64, 64, 3), generator=g)
    mask = torch.zeros((1, 64, 64), dtype=torch.bool)
    with torch.inference_mode():
        before = model(pixels, mask)["pred_logits"]
    randomize_constants(model, torch.Generator().manual_seed(2))
    with torch.inference_mode():
        after = model(pixels, mask)["pred_logits"]
    assert before.abs().max() < 1e-5
    assert after.abs().max() > 1e-3


def test_unported_modes_raise():
    # the 3d resample window is ported (K6-K9): it builds, with three
    # offset components and not on the fused K1 route
    attn = FastDeformAttn3D(window="3d", cross_level="resample")
    assert attn.nc == 3 and not attn.fused_route and not attn.native
    # FAST_RADIUS > 1 is ported (the general blend): it builds, and never
    # takes K1's fused route, which is radius 1 only
    attn = FastDeformAttn3D(radius=2, window="2d", cross_level="resample")
    assert attn.nc == 2 and not attn.fused_route and attn.radius == 2
    # the exact encoder is ported (step 12): it builds; an unknown
    # encoder type raises as in JAX
    cfg = _tiny_cfg()
    cfg.CONFIG.MODEL.ENCODER_TYPE = "attention"
    attn = build_model(cfg, device="cpu").transformer.encoder.layers[0].self_attn
    assert isinstance(attn, MSDeformAttn3D)
    cfg.CONFIG.MODEL.ENCODER_TYPE = "dense"
    with pytest.raises(ValueError, match="ENCODER_TYPE"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("window", ["2d", "3d"])
def test_native_mode_guards_raise_value_error_as_jax(window):
    """The JAX package raises ValueError for the native mode with radius
    != 1 (fast_encoder.py:217-218) and for levels of unequal T (:219-226)."""
    with pytest.raises(ValueError, match="radius=1"):
        FastDeformAttn3D(radius=2, window=window, cross_level="native")
    attn = FastDeformAttn3D(256, 2, 8, 8, window=window, cross_level="native")
    src = torch.zeros((1, 2 * 4 * 6 + 1 * 2 * 3, 256))
    with pytest.raises(ValueError, match="equal T"):
        attn(src, src, ((2, 4, 6), (1, 2, 3)), None)


@pytest.mark.parametrize("yaml", ["AVA22_ViT-B_fast.yaml", "AVA22_ViT-B.yaml",
                                  "AVA22_ViT-B_fast_native.yaml",
                                  "UCF_ViT-B_fast.yaml", "UCF_ViT-B.yaml",
                                  "JHMDB_ViT-B.yaml", "JHMDB_ViT-B_fast.yaml",
                                  "AVA22_ViT-B-train-mamba.yaml",
                                  "AVA22_train-mamba_VSS.yaml"])
def test_config_copy_reads_yaml_like_the_jax_package(yaml):
    path = str(REPO / "configuration" / yaml)
    assert get_cfg_custom(path) == jax_get_cfg_custom(path)
    assert (dataclasses.asdict(spec_from_cfg(get_cfg_custom(path)))
            == dataclasses.asdict(jax_spec_from_cfg(jax_get_cfg_custom(path))))


def _tiny_vss(**kw):
    from unittest import mock

    from class_query_vad_tpu_torch.models import videomamba

    from torch_parity import TINY_VIDEOMAMBA, VSS_YAML, tiny_vss_cfg

    with mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA):
        return build_model(tiny_vss_cfg(get_cfg_custom(VSS_YAML)),
                           input_hw=(64, 128), **kw)


def test_vss_build_model_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tiny_vss()
    model = _tiny_vss(device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_mamba_family_trains():
    """The VSS model serves in eval() and, since step 19, runs its train()
    forward and backward on the CPU (K5's plain forward and backward): a
    finite loss, a gradient for every parameter."""
    model = _tiny_vss(device="cpu")
    pixels = torch.randn((1, 8, 64, 128, 3), generator=torch.Generator().manual_seed(0))
    mask = torch.zeros((1, 64, 128), dtype=torch.bool)
    with torch.no_grad():
        out = model(pixels, mask)
    assert out["pred_boxes"].shape == (1, 4, 4)
    out = model.train()(pixels, mask)
    loss = out["pred_boxes"].sum() + out["pred_logits"].sum()
    loss.backward()
    assert torch.isfinite(loss)
    # every parameter but the actorness head, which this loss does not read
    missing = [k for k, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
    assert missing == ["class_embed_b.weight", "class_embed_b.bias"]


def test_videomamba_with_the_exact_encoder_trains():
    """AVA22_ViT-B-train-mamba.yaml: VideoMamba with the exact deformable
    encoder builds and serves since step 12 and trains since step 19: a
    ``Trainer`` step on the CPU moves its VideoMamba's parameters."""
    from class_query_vad_tpu_torch.engine import Trainer

    cfg = get_cfg_custom(str(REPO / "configuration" /
                             "AVA22_ViT-B-train-mamba.yaml"))
    assert spec_from_cfg(cfg).is_mamba
    assert spec_from_cfg(cfg).encoder_type == "attention"
    _cut(cfg)
    cfg.CONFIG.TRAIN.GRAD_ACCUM = 1
    model = build_model(cfg, device="cpu", input_hw=(64, 64))
    pixels = torch.zeros((1, 8, 64, 64, 3))
    mask = torch.zeros((1, 64, 64), dtype=torch.bool)
    with torch.no_grad():
        out = model(pixels, mask)
        assert out["pred_boxes"].shape == (1, 2, 4)
    mixer = model.backbone[0].body.layers[0].mixer
    before = mixer.A_b_log.detach().clone()
    trainer = Trainer(model, cfg, device="cpu")
    nc = cfg.CONFIG.DATA.NUM_CLASSES
    m = int(cfg.CONFIG.DATA.MAX_BOXES)
    metrics = trainer.step({
        "pixels": pixels, "mask": mask,
        "boxes": torch.full((1, m, 4), 0.5), "labels": torch.zeros((1, m, nc)),
        "n_boxes": torch.tensor([1], dtype=torch.int32)})
    assert torch.isfinite(metrics["total_loss"]) and "grad_norm" in metrics
    assert not torch.equal(mixer.A_b_log, before)


def _cut(cfg):
    """A YAML's configuration at a tiny depth: ViT depth 1, one encoder and
    one decoder layer, d_ffn 32, 2 queries, 8 frames."""
    c = cfg.CONFIG
    c.DATA.TEMP_LEN, c.MODEL.TEMP_LEN = 8, 8
    c.ViT.DEPTH = 1
    c.MODEL.ENC_LAYERS, c.MODEL.DEC_LAYERS = 1, 1
    c.MODEL.DIM_FEEDFORWARD, c.MODEL.QUERY_NUM = 32, 2
    return cfg


YAMLS = sorted(p.name for p in (REPO / "configuration").glob("*.yaml"))


@pytest.mark.parametrize("yaml", YAMLS)
def test_every_non_csn_yaml_builds_and_serves_on_the_cpu(yaml):
    """Every configuration builds and serves at a tiny depth (CSN's blocks
    stay the YAML's).  The two CSN YAMLs are cases here since they build
    (ROADMAP step 13); the name is the one the other cases had before."""
    cfg = _cut(get_cfg_custom(str(REPO / "configuration" / yaml)))
    model = build_model(cfg, device="cpu", input_hw=(64, 64))
    with torch.no_grad():
        out = model(torch.zeros((1, 8, 64, 64, 3)),
                    torch.zeros((1, 64, 64), dtype=torch.bool))
    nc = cfg.CONFIG.DATA.NUM_CLASSES
    lead = (1, 2) if cfg.CONFIG.MODEL.SINGLE_FRAME else (1, 8, 2)
    assert out["pred_logits"].shape == lead + (nc,)
    assert all(bool(torch.isfinite(out[k]).all())
               for k in ("pred_logits", "pred_boxes", "pred_logits_b"))


@pytest.mark.parametrize("yaml", YAMLS)
def test_every_yaml_gives_every_trainable_parameter_a_gradient(yaml):
    """``engine.Trainer`` wraps the model in DDP without its search for
    unused parameters, which holds only while a train step's loss reaches
    every trainable parameter: for each configuration at a tiny depth,
    one ``Trainer.loss`` and its backward on the CPU leave a gradient on
    every parameter that ``requires_grad`` (the frozen ones, out of DDP's
    buckets, get none)."""
    import numpy as np

    from torch_parity import tube_targets

    cfg = _cut(get_cfg_custom(str(REPO / "configuration" / yaml)))
    model = build_model(cfg, device="cpu", input_hw=(64, 64))
    trainer = Trainer(model, cfg, device="cpu")
    nc = cfg.CONFIG.DATA.NUM_CLASSES
    rng = np.random.default_rng(0)
    batch = {"pixels": rng.normal(size=(1, 8, 64, 64, 3)).astype(np.float32),
             "mask": np.zeros((1, 64, 64), bool)}
    if cfg.CONFIG.MODEL.SINGLE_FRAME:
        labels = np.zeros((1, 2, nc), np.float32)
        labels[0, :, :2] = 1.0
        batch.update(boxes=rng.uniform(0.3, 0.6, (1, 2, 4)).astype(np.float32),
                     labels=labels, n_boxes=np.array([2], np.int32))
    else:
        batch.update(tube_targets(0, 1, 8, num_classes=nc, front_pad=(1,),
                                  end_pad=(0,), n_actors=(2,)))
    total, _, _ = trainer.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    total.backward()
    missing = [k for k, p in model.named_parameters()
               if p.requires_grad and p.grad is None]
    assert not missing
    assert any(p.grad is not None for p in model.parameters())


def test_videomamba_rejects_another_clip_size():
    model = _tiny_vss(device="cpu")
    with pytest.raises(ValueError, match="input_hw"):
        model(torch.zeros((1, 8, 64, 64, 3)),
              torch.zeros((1, 64, 64), dtype=torch.bool))
