"""``MODEL.FAST_USE_PALLAS: false`` in the port, on the CPU.

The JAX package reads the key and, when it is false, takes its XLA-oracle
blend instead of the Pallas kernels (fast_encoder.py:172).  The port keeps
every route of the fast encoder and takes each one's plain version on any
device, the backward included: the wrappers get ``kernels=False``.  Here:

* a tiny model with the key false matches the JAX model with the same key
  within the whole-model tolerance of ``tests/test_torch_model.py``, and
  its encoder hands ``kernels=False`` to the blend;
* on every route (2d fused, 2d components, 3d resample, native 2d and 3d)
  the switch reaches the wrapper, and with the wrappers told that their
  tensors lie on the card and every launch made to fail, a forward and a
  backward still run, on the plain versions, and give what the default
  model gives on the CPU.
"""

import functools
import inspect
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.models import build_model, fast_encoder
from class_query_vad_tpu_torch.models.detr import randomize_constants
from class_query_vad_tpu_torch.ops import (
    blend2d,
    blend3d,
    fast_deform_cuda,
    native_blend,
)
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import jit_opt0, n, random_params, t, tiny_cfg

WRAPPERS = ("fused_blend2d", "blend2d", "blend3d", "native_blend")
ROUTES = {   # name: (FAST_WINDOW, FAST_CROSS_LEVEL, NUM_ENC_N_POINTS, wrapper)
    "2d-fused": ("2d", "resample", 8, "fused_blend2d"),
    "2d-components": ("2d", "resample", 4, "blend2d"),
    "3d": ("3d", "resample", 8, "blend3d"),
    "native-2d": ("2d", "native", 8, "native_blend"),
    "native-3d": ("3d", "native", 8, "native_blend"),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pixels = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True                       # second clip padded right
    return pixels, mask


def _spies():
    """Patches recording every call of the encoder's blend wrappers."""
    return {name: mock.patch.object(fast_encoder, name,
                                    wraps=getattr(fast_encoder, name))
            for name in WRAPPERS}


def _kernels_flags(name, spy):
    """The ``kernels`` argument of every recorded call of wrapper ``name``,
    passed by position or keyword."""
    sig = inspect.signature(getattr(fast_encoder, name))
    return [sig.bind(*c.args, **c.kwargs).arguments.get("kernels", True)
            for c in spy.call_args_list]


@functools.lru_cache(maxsize=None)
def _jax_out():
    pixels, mask = _inputs()
    cfg = tiny_cfg(jax_cfg_defaults(), eff_slice=True)
    cfg.CONFIG.MODEL.FAST_USE_PALLAS = False
    jm = jax_build_model(cfg)
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask))
    out = jit_opt0(lambda p, x, m: jm.apply(p, x, m, True),
                   params, jnp.asarray(pixels), jnp.asarray(mask))
    return params, out


def test_tiny_model_without_kernels_matches_jax():
    params, out_j = _jax_out()
    pixels, mask = _inputs()
    cfg = tiny_cfg(get_cfg_defaults(), eff_slice=True)
    cfg.CONFIG.MODEL.FAST_USE_PALLAS = False
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    spies = _spies()
    with spies["fused_blend2d"] as spy, torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    assert spy.call_count == 2 * 4                  # layers x query grids
    assert _kernels_flags("fused_blend2d", spy) == [False] * 8
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), atol=2e-4,
                                   rtol=2e-4, err_msg=k)


def _route_model(route, use_pallas):
    window, cross, points, _ = ROUTES[route]
    cfg = tiny_cfg(get_cfg_defaults(), eff_slice=True)
    c = cfg.CONFIG.MODEL
    c.FAST_WINDOW, c.FAST_CROSS_LEVEL, c.NUM_ENC_N_POINTS = window, cross, points
    c.FAST_USE_PALLAS = use_pallas
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    randomize_constants(model, torch.Generator().manual_seed(2))
    return model


def _forward_backward(model):
    pixels, mask = _inputs(3)
    out = model(t(pixels), t(mask))
    loss = out["pred_logits"].square().sum() + out["pred_boxes"].sum()
    loss.backward()
    return ([out[k].detach() for k in ("pred_logits", "pred_boxes")],
            {k: p.grad for k, p in model.named_parameters()})


def _no_card_launch(*args, **kwargs):
    raise AssertionError("a kernel was launched with FAST_USE_PALLAS false")


@pytest.mark.parametrize("route", list(ROUTES))
def test_switch_takes_the_plain_route_on_every_device(route, monkeypatch):
    want_out, want_grads = _forward_backward(_route_model(route, True))
    model = _route_model(route, False)
    assert all(m.use_kernels is False for m in model.modules()
               if isinstance(m, fast_encoder.FastDeformAttn3D))
    # every wrapper believes its tensors lie on one card, and no kernel may
    # launch: only the plain versions can run
    for mod in (fast_deform_cuda, blend2d, blend3d, native_blend):
        monkeypatch.setattr(mod, "device_of", lambda *xs: "cuda")
        monkeypatch.setattr(mod, "launch", _no_card_launch)
    spies = _spies()
    wrapper = ROUTES[route][3]
    with spies[wrapper] as spy:
        got_out, got_grads = _forward_backward(model)
    assert spy.call_count == 2 * 4
    assert _kernels_flags(wrapper, spy) == [False] * 8
    for got, want in zip(got_out, want_out):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        if want_grads[k] is None:
            assert g is None, k
        else:
            torch.testing.assert_close(g, want_grads[k], rtol=0, atol=0,
                                       msg=k)
