"""The port's tune-point freezing labels against the JAX package's
(``engine/train.py`` ``backbone_freeze_labels`` in both), on the CPU.

The JAX labels of a model's flax param tree are mapped onto the port's
parameter names as ``params_from_jax`` maps the params: a frozen leaf
becomes ones, a trainable one zeros, and every layout rule keeps that
constant.  Covered: the tiny ViT model of ``tests/test_torch_model.py`` and
the tiny VSS (VideoMamba) model of ``tests/test_torch_mamba.py``, with
``PRETRAINED`` true and false and ``TUNE_POINT`` 0 and 4, and a tiny
``AVA22_CSN50`` (CSN-50 whole) at ``TUNE_POINT`` 0 to 5.  JAX applies the
ViT rules only when ``BACKBONE_NAME`` is "ViT" and CSN's for "CSN-*"; a
VideoMamba trunk trains whole.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from class_query_vad_tpu.config import get_cfg_custom as jax_cfg_custom
from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.engine.train import (
    backbone_freeze_labels as jax_freeze_labels,
)
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu.models import videomamba as j_vm
from class_query_vad_tpu_torch.config import get_cfg_custom, get_cfg_defaults
from class_query_vad_tpu_torch.engine import backbone_freeze_labels
from class_query_vad_tpu_torch.models import build_model, videomamba
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import (
    CONFIG_DIR,
    TINY_VIDEOMAMBA,
    VSS_YAML,
    cut_cfg,
    tiny_cfg,
    tiny_vss_cfg,
)

CSN_YAML = str(CONFIG_DIR / "AVA22_CSN50.yaml")

MODELS = {
    "vit": (lambda: tiny_cfg(jax_cfg_defaults(), eff_slice=True),
            lambda: tiny_cfg(get_cfg_defaults(), eff_slice=True), (64, 64)),
    "vss": (lambda: tiny_vss_cfg(jax_cfg_custom(VSS_YAML)),
            lambda: tiny_vss_cfg(get_cfg_custom(VSS_YAML)), (64, 128)),
    "csn": (lambda: cut_cfg(jax_cfg_custom(CSN_YAML), enc_layers=1,
                            dec_layers=1),
            lambda: cut_cfg(get_cfg_custom(CSN_YAML), enc_layers=1,
                            dec_layers=1), (64, 64)),
}


def _tiny_spec():
    return (mock.patch.dict(j_vm.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA),
            mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, TINY_VIDEOMAMBA))


@functools.lru_cache(maxsize=None)
def _models(kind: str):
    """The flax param shapes (``jax.eval_shape`` of init: no eager init)
    and the port model, on the CPU."""
    jax_cfg, port_cfg, (h, w) = MODELS[kind]
    pixels = jnp.zeros((2, 8, h, w, 3), jnp.float32)
    mask = jnp.zeros((2, h, w), bool)
    jpatch, tpatch = _tiny_spec()
    with jpatch, tpatch:
        jm = jax_build_model(jax_cfg())
        shapes = jax.eval_shape(lambda k: jm.init(k, pixels, mask, True),
                                jax.random.PRNGKey(0))
        model = build_model(port_cfg(), device="cpu", input_hw=(h, w))
    return shapes, model


@pytest.mark.parametrize("tune", [0, 4])
@pytest.mark.parametrize("pretrained", [True, False])
@pytest.mark.parametrize("kind", ["vit", "vss"])
def test_freeze_labels_match_jax(kind, pretrained, tune):
    frozen = _labels_match_jax(kind, pretrained, tune)
    # only a pretrained ViT at a positive tune point freezes anything
    assert (frozen > 0) == (kind == "vit" and pretrained and tune > 0)


@pytest.mark.parametrize("tune", range(6))
def test_csn_freeze_labels_match_jax(tune):
    """CSN (a tiny ``AVA22_CSN50``, PRETRAINED as the YAML): the stem when
    TUNE_POINT > 1, ``layer{n}`` when TUNE_POINT > n + 1."""
    frozen = _labels_match_jax("csn", True, tune)
    assert (frozen > 0) == (tune > 1)


def _labels_match_jax(kind, pretrained, tune) -> int:
    shapes, model = _models(kind)
    jax_cfg, port_cfg, _ = MODELS[kind]
    cfgs = [port_cfg(), jax_cfg()]
    for cfg in cfgs:
        cfg.CONFIG.MODEL.PRETRAINED = pretrained
        cfg.CONFIG.MODEL.TUNE_POINT = tune
    labels = jax_freeze_labels(shapes, cfgs[1])
    want = params_from_jax(jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, lab == "frozen", np.float32),
        labels, shapes))
    got = backbone_freeze_labels(model, cfgs[0])
    # the class layer's one ConvBlock, registered three times, is named
    # once by named_parameters and three times by params_from_jax
    assert set(got) <= set(want)
    assert {k: v == "frozen" for k, v in got.items()} == {
        k: bool(want[k].any()) for k in got}
    # JAX labels the batch norms' running statistics frozen always; here
    # they are buffers, which no optimizer sees
    stats = {k for k in want if k.endswith(("running_mean", "running_var"))}
    assert stats.isdisjoint(got) and all(want[k].all() for k in stats)
    assert stats == {k for k, _ in model.named_buffers()
                     if k.endswith(("running_mean", "running_var"))}
    return sum(v == "frozen" for v in got.values())
