"""The tube datasets (UCF101-24, JHMDB51-21) in the PyTorch port against
the JAX package, on the CPU in float32: the batched box ops,
``frame_valid_gt``, the per-frame matchers (the same assignments, with
loader-padded actor slots and padded frames), ``criterion_frames`` given
the same outputs (the sequential pairing, the front-pad-shifted focal
weights, JHMDB's valid-frame mask and ``valid_len``, aux layers),
``postprocess_frames``; tiny eval forwards of the four tube YAMLs; one
tiny ``UCF_ViT-B.yaml`` train step against ``jax.value_and_grad``, and the
same step on two gloo ranks (``engine.Trainer`` in DDP, one clip each;
with the criteria's normalizers summed over the ranks, ``criterion_frames``
of a UCF and a JHMDB case as well).

Inputs and params come from numpy with a seed; params cross over by
``params_from_jax``.  One JAX jit per model, shared (``functools.
lru_cache``), compiled without LLVM's optimisation passes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from class_query_vad_tpu.config import get_cfg_custom as jax_cfg_custom
from class_query_vad_tpu.losses import (
    build_criterion_and_postprocessor as jax_build_criterion,
    build_matcher as jax_build_matcher,
)
from class_query_vad_tpu.losses.criterion import (
    postprocess_frames as jax_postprocess_frames,
)
from class_query_vad_tpu.losses.matcher import frame_valid_gt as jax_frame_valid_gt
from class_query_vad_tpu.models import build_model as jax_build_model
from class_query_vad_tpu.utils import box_ops as jax_box_ops
from class_query_vad_tpu_torch.config import get_cfg_custom
from class_query_vad_tpu_torch.engine import Trainer
from class_query_vad_tpu_torch.losses import (
    build_criterion_and_postprocessor,
    build_matcher,
    frame_valid_gt,
    postprocess_frames,
)
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.parallel.launch import start_ranks
from class_query_vad_tpu_torch.utils import box_ops
from class_query_vad_tpu_torch.utils.weights import params_from_jax

from torch_parity import CONFIG_DIR, cut_cfg, n, random_params, t, tube_targets

TUBE_YAMLS = ("UCF_ViT-B.yaml", "UCF_ViT-B_fast.yaml", "JHMDB_ViT-B.yaml",
              "JHMDB_ViT-B_fast.yaml")
# float32 on both sides, other summation orders (as tests/test_torch_model.py)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
# the losses of one set of outputs: the same float32 formulas, reduced in
# other orders
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfg(get_cfg, yaml, **kw):
    return cut_cfg(get_cfg(str(CONFIG_DIR / yaml)), **kw)


def _xyxy(rng, shape):
    lo = rng.uniform(0.0, 0.5, shape + (2,))
    return np.concatenate([lo, lo + rng.uniform(0.05, 0.5, shape + (2,))],
                          -1).astype(np.float32)


def test_batched_box_ops_match_jax():
    rng = np.random.default_rng(0)
    b1, b2 = _xyxy(rng, (3, 5)), _xyxy(rng, (3, 4))
    iou_j, union_j = jax_box_ops.batched_box_iou(jnp.asarray(b1), jnp.asarray(b2))
    iou_t, union_t = box_ops.batched_box_iou(t(b1), t(b2))
    np.testing.assert_allclose(n(iou_t), np.asarray(iou_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(union_t), np.asarray(union_j), rtol=1e-6)
    g_j = jax_box_ops.batched_generalized_box_iou(jnp.asarray(b1), jnp.asarray(b2))
    g_t = box_ops.batched_generalized_box_iou(t(b1), t(b2))
    assert g_t.shape == (3, 5, 4)
    np.testing.assert_allclose(n(g_t), np.asarray(g_j), rtol=1e-6, atol=1e-7)


def test_frame_valid_gt_matches_jax():
    targets = tube_targets(1, 2, 8, a_slots=3)
    boxes = targets["boxes"].copy()
    boxes[0, 2, 3] = [0.4, 0.0, 0.0, 0.0]      # cx alone: still empty
    boxes[1, 2, 5] = [0.0, 0.3, 0.0, 0.0]      # cy set: live
    got = frame_valid_gt(t(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_frame_valid_gt(boxes)))
    assert not got[0, 2, 3] and got[1, 2, 5]


def _outputs(seed, b, t_len, nq, nc, aux=2):
    rng = np.random.default_rng(seed)

    def layer():
        cxcy = rng.uniform(0.2, 0.8, (b, t_len, nq, 2))
        wh = rng.uniform(0.1, 0.5, (b, t_len, nq, 2))
        return {"pred_logits": rng.normal(size=(b, t_len, nq, nc)),
                "pred_boxes": np.concatenate([cxcy, wh], -1),
                "pred_logits_b": 2.0 * rng.normal(size=(b, t_len, nq, 3))}

    out = {k: v.astype(np.float32) for k, v in layer().items()}
    out["aux_outputs"] = [{k: v.astype(np.float32) for k, v in layer().items()}
                          for _ in range(aux)]
    return out


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, fn) for v in x]
    return fn(x)


# (yaml, B, T, A, NQ, front pads, end pads, n_actors)
CASES = {
    "ucf": ("UCF_ViT-B.yaml", 2, 8, 3, 5, (2, 0), (0, 1), (3, 2)),
    "ucf_more_gts": ("UCF_ViT-B.yaml", 2, 6, 4, 3, (0, 3), (1, 0), (4, 4)),
    "jhmdb": ("JHMDB_ViT-B.yaml", 2, 8, 1, 5, (2, 1), (1, 0), (1, 1)),
    "jhmdb_slots": ("JHMDB_ViT-B.yaml", 2, 6, 2, 4, (0, 2), (2, 0), (2, 1)),
}


def _case(key, alpha=0.1):
    yaml, b, t_len, a, nq, fp, ep, na = CASES[key]
    cfgs = [_cfg(g, yaml) for g in (jax_cfg_custom, get_cfg_custom)]
    for c in cfgs:
        c.CONFIG.MODEL.LABEL_SMOOTHING_ALPHA = alpha
    nc = cfgs[0].CONFIG.DATA.NUM_CLASSES
    targets = tube_targets(10 + len(key), b, t_len, a, nc, fp, ep, na)
    outputs = _outputs(20 + len(key), b, t_len, nq, nc)
    return cfgs, targets, outputs


@pytest.mark.parametrize("key", sorted(CASES))
def test_match_frames_matches_jax(key):
    (cfg_j, cfg_t), targets, outputs = _case(key)
    m_j = jax_build_matcher(cfg_j)(_tree(outputs, jnp.asarray),
                                   _tree(targets, jnp.asarray))
    m_t = build_matcher(cfg_t)(_tree(outputs, t), _tree(targets, t))
    ok = np.asarray(m_j.match_ok)
    np.testing.assert_array_equal(m_t.match_ok.numpy(), ok)
    np.testing.assert_array_equal(m_t.gt_idx.numpy()[ok],
                                  np.asarray(m_j.gt_idx)[ok])
    # padded frames and dead gts match nothing; live gts are all taken
    # where queries suffice
    live = (np.ones(ok.shape[:2] + (CASES[key][3],), bool)
            if key.startswith("jhmdb") else
            np.asarray(jax_frame_valid_gt(np.swapaxes(targets["boxes"], 1, 2))))
    live = (live & targets["frame_valid"][:, :, None]
            & (np.arange(live.shape[-1]) < targets["n_actors"][:, None])[:, None])
    assert not ok[~targets["frame_valid"]].any()
    np.testing.assert_array_equal(ok.sum(-1), np.minimum(live.sum(-1), ok.shape[-1]))


@pytest.mark.parametrize("key", sorted(CASES))
@pytest.mark.parametrize("alpha", [0.0, 0.1])
def test_criterion_frames_matches_jax(key, alpha):
    (cfg_j, cfg_t), targets, outputs = _case(key, alpha)
    crit_j, _, wd = jax_build_criterion(cfg_j, jax_build_matcher(cfg_j))
    crit_t, post, wd_t = build_criterion_and_postprocessor(
        cfg_t, build_matcher(cfg_t))
    assert post is postprocess_frames and wd_t == dict(wd)
    want = crit_j(_tree(outputs, jnp.asarray), _tree(targets, jnp.asarray))
    got, match = crit_t(_tree(outputs, t), _tree(targets, t),
                        return_match=True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                   err_msg=k, **LOSS_TOL)
    assert match.match_ok.shape == (3,) + outputs["pred_logits"].shape[:3]


def test_criterion_frames_pairs_in_slot_order_and_shifts_the_weights():
    """The reference quirks, on a case where they change the losses: the
    matcher's permutation is not the pairing, and the 10x weights land at
    frame f - front_pad."""
    (cfg_j, cfg_t), targets, outputs = _case("ucf")
    crit_t, _, _ = build_criterion_and_postprocessor(cfg_t, build_matcher(cfg_t))
    _, match = crit_t(_tree(outputs, t), _tree(targets, t), return_match=True)
    ok = match.match_ok[-1]
    gt = match.gt_idx[-1]
    rank_order = [gt[b, f][ok[b, f]].tolist()
                  for b in range(ok.shape[0]) for f in range(ok.shape[1])]
    # at least one frame where the matcher's columns are not in slot order
    assert any(r != sorted(r) for r in rank_order)
    assert targets["frame_valid"][0, :2].sum() == 0     # clip 0 front-padded


def test_postprocess_frames_matches_jax():
    outputs = _outputs(3, 2, 4, 5, 21, aux=0)
    sizes = np.array([[240, 320], [256, 256]], np.int32)
    got = postprocess_frames(_tree(outputs, t), t(sizes))
    want = jax_postprocess_frames(_tree(outputs, jnp.asarray), jnp.asarray(sizes))
    for g, w, shape in zip(got, want, ((2, 4, 5, 21), (2, 4, 5, 4),
                                       (2, 4, 5, 1))):
        assert g.shape == shape
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-5, atol=1e-6)


def _apply_jitted(jm, params, pixels, mask):
    args = (params, jnp.asarray(pixels), jnp.asarray(mask))
    return jax.jit(lambda p, x, m: jm.apply(p, x, m, True)).lower(
        *args).compile({"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _eval_world(yaml: str):
    seed = TUBE_YAMLS.index(yaml)
    rng = np.random.default_rng(30 + seed)
    pixels = rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, 40:] = True                          # second clip padded below
    jm = jax_build_model(_cfg(jax_cfg_custom, yaml))
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           jnp.asarray(pixels), jnp.asarray(mask),
                           seed=40 + seed)
    out_j = _apply_jitted(jm, params, pixels, mask)
    model = build_model(_cfg(get_cfg_custom, yaml), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        out_t = model(t(pixels), t(mask))
    return out_j, out_t


@pytest.mark.parametrize("yaml", TUBE_YAMLS)
def test_tiny_tube_model_matches_jax(yaml):
    out_j, out_t = _eval_world(yaml)
    nc = 24 if yaml.startswith("UCF") else 21
    assert out_t["pred_logits"].shape == (2, 8, 3, nc)
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        np.testing.assert_allclose(n(out_t[k]), n(out_j[k]), err_msg=k,
                                   **MODEL_TOL)
    assert len(out_t["aux_outputs"]) == len(out_j["aux_outputs"]) == 1
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        np.testing.assert_allclose(n(out_t["aux_outputs"][0][k]),
                                   n(out_j["aux_outputs"][0][k]),
                                   err_msg="aux " + k, **MODEL_TOL)
    scores, boxes, actor = postprocess_frames(out_t, torch.tensor([[64, 64],
                                                                   [40, 64]]))
    assert scores.shape == (2, 8, 3, nc) and boxes.shape == (2, 8, 3, 4)
    assert all(bool(torch.isfinite(x).all()) for x in (scores, boxes, actor))


UCF = "UCF_ViT-B.yaml"


def _train_cfg(get_cfg):
    cfg = _cfg(get_cfg, UCF)
    cfg.CONFIG.MODEL.DROPOUT = 0.0
    cfg.CONFIG.ViT.DROP_PATH_RATE = 0.0
    return cfg


def _train_batch():
    rng = np.random.default_rng(5)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, :, 48:] = True
    return {"pixels": rng.normal(size=(2, 8, 64, 64, 3)).astype(np.float32),
            "mask": mask, **tube_targets(6, 2, 8, a_slots=2, num_classes=24)}


@functools.lru_cache(maxsize=None)
def _jax_train_step():
    """The JAX package's train-step loss (engine/train.py:194-202) on a tube
    batch, its value_and_grad and the matcher's assignment per layer."""
    cfg = _train_cfg(jax_cfg_custom)
    jm = jax_build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in _train_batch().items()}
    params = random_params(lambda k, x, m: jm.init(k, x, m, True),
                           batch["pixels"], batch["mask"], seed=8)
    matcher = jax_build_matcher(cfg)
    crit, _, wd = jax_build_criterion(cfg, matcher)
    targets = {k: batch[k] for k in ("boxes", "labels", "frame_valid",
                                     "n_actors")}

    def loss_fn(p):
        out = jm.apply(p, batch["pixels"], batch["mask"], True)
        losses = crit(out, targets)
        total = sum(losses[k] * w for k, w in wd.items())
        match = [matcher(o, targets) for o in list(out["aux_outputs"]) + [out]]
        return total, (losses, match)

    (total, (losses, match)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile(
        {"xla_backend_optimization_level": 0})(params)
    return params, float(total), losses, match, grads


def test_tiny_ucf_train_step_matches_jax():
    params, total_j, losses_j, match_j, grads_j = _jax_train_step()
    cfg = _train_cfg(get_cfg_custom)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    model.head_dropout.p = 0.0     # the class head's fixed 0.5: see JAX's
    trainer = Trainer(model, cfg, device="cpu")
    total, losses, match = trainer.loss({k: t(v) for k, v in
                                         _train_batch().items()})
    # as tests/test_torch_train_step.py: float32 through the ViT, the
    # encoder and the decoder layers, summed in other orders
    np.testing.assert_allclose(float(total.detach()), total_j, rtol=1e-4)
    assert sorted(losses) == sorted(losses_j)
    for k in losses_j:
        np.testing.assert_allclose(n(losses[k]), n(losses_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for layer, mj in enumerate(match_j):
        ok = np.asarray(mj.match_ok)
        assert ok.any()
        np.testing.assert_array_equal(match.match_ok[layer].numpy(), ok)
        np.testing.assert_array_equal(match.gt_idx[layer].numpy()[ok],
                                      np.asarray(mj.gt_idx)[ok])
    total.backward()
    want = params_from_jax(grads_j)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p.grad), n(want[name]), rtol=1e-3,
                                   atol=5e-4, err_msg=name)
    assert trainer.optimizer.update() is not None


def test_two_rank_ddp_step_matches_jax():
    """The UCF train step on two gloo ranks, clip r on rank r (front-padded
    and end-padded, 2 and 1 actors): the summed losses and every gradient
    after DDP's summing hook are JAX's step on both clips, within
    ``test_tiny_ucf_train_step_matches_jax``'s tolerances, and bit-equal on
    the two ranks, as are the parameters after the update.  In the same
    processes ``criterion_frames`` of the "ucf" and "jhmdb" cases (JHMDB's
    valid_len mean, UCF's B x T) summed over the ranks equals JAX's on the
    whole batch."""
    cfg = _train_cfg(get_cfg_custom)
    cases = {key: _case(key) for key in ("ucf", "jhmdb")}
    params, total_j, losses_j, match_j, grads_j = _jax_train_step()
    jobs = [("class_query_vad_tpu_torch.parallel.jobs:train_step",
             {"cfg": cfg.dump(), "batch": _train_batch(),
              "state": params_from_jax(params)})]
    jobs += [("class_query_vad_tpu_torch.parallel.jobs:criterion_losses",
              {"cfg": cfgs[1].dump(), "outputs": outputs, "targets": targets})
             for cfgs, targets, outputs in cases.values()]
    ranks = start_ranks(2, jobs)
    want_crit = []
    for cfgs, targets, outputs in cases.values():
        crit_j, _, _ = jax_build_criterion(cfgs[0], jax_build_matcher(cfgs[0]))
        want_crit.append(crit_j(_tree(outputs, jnp.asarray),
                                _tree(targets, jnp.asarray)))
    want = params_from_jax(grads_j)
    got = ranks.join()
    step = [r[0] for r in got]
    np.testing.assert_allclose(float(step[0]["losses"]["total"]), total_j,
                               rtol=1e-4)
    for k in losses_j:
        np.testing.assert_allclose(n(step[0]["losses"][k]), n(losses_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for r, res in enumerate(step):
        gt_idx, match_ok = res["match"]
        for layer, mj in enumerate(match_j):
            ok = np.asarray(mj.match_ok)[r]
            np.testing.assert_array_equal(match_ok[layer, 0].numpy(), ok)
            np.testing.assert_array_equal(gt_idx[layer, 0].numpy()[ok],
                                          np.asarray(mj.gt_idx)[r][ok])
    assert step[0]["grad_norm"] is not None
    for name, g in step[0]["grads"].items():
        assert torch.equal(g, step[1]["grads"][name]), name
        assert torch.equal(step[0]["params"][name], step[1]["params"][name])
        np.testing.assert_allclose(n(g), n(want[name]), rtol=1e-3,
                                   atol=5e-4, err_msg=name)
    for i, (key, want_l) in enumerate(zip(cases, want_crit)):
        assert sorted(got[0][i + 1]) == sorted(want_l), key
        for k in want_l:
            np.testing.assert_allclose(n(got[0][i + 1][k]),
                                       np.asarray(want_l[k]),
                                       err_msg=f"{key} {k}", **LOSS_TOL)
