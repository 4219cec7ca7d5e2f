"""The pieces of the port's train step against the JAX package's, on the
CPU in float32: the host LSAP, the AVA matcher and criterion, the
optimizer, the LR schedules; and the train-mode behaviour of dropout, drop
path, ViT checkpointing and the encoder's components route.  The whole
tiny train step is in tests/test_torch_train_step.py.

Inputs come from numpy with a seed.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsap

from class_query_vad_tpu.config import get_cfg_defaults as jax_cfg_defaults
from class_query_vad_tpu.engine.train import make_optimizer as jax_make_optimizer
from class_query_vad_tpu.losses import (
    criterion_ava as jax_criterion_ava,
    match_ava as jax_match_ava,
)
from class_query_vad_tpu.ops.lsap import batched_linear_sum_assignment
from class_query_vad_tpu.utils.lr_scheduler import build_scheduler as jax_sched
from class_query_vad_tpu_torch.config import get_cfg_defaults
from class_query_vad_tpu_torch.engine import make_optimizer
from class_query_vad_tpu_torch.losses import criterion_ava, match_ava
from class_query_vad_tpu_torch.models import build_model
from class_query_vad_tpu_torch.models.common import DropPath
from class_query_vad_tpu_torch.models.fast_encoder import FastDeformAttn3D
from class_query_vad_tpu_torch.models.spec import ViTSpec
from class_query_vad_tpu_torch.models.vit import ViT
from class_query_vad_tpu_torch.ops.lsap import linear_sum_assignment
from class_query_vad_tpu_torch.utils.lr_scheduler import build_scheduler

from torch_parity import n, t, train_batch, train_cfg

# --------------------------------------------------------------------------
# (d) LSAP
# --------------------------------------------------------------------------

_jax_lsap = jax.jit(batched_linear_sum_assignment)


def _lsap_cases():
    rng = np.random.default_rng(0)
    rect = rng.random((4, 15, 32)).astype(np.float32)
    ties = rng.integers(0, 3, (4, 15, 32)).astype(np.float32)
    tall = rng.random((4, 9, 5)).astype(np.float32)
    tall_ties = rng.integers(0, 2, (4, 9, 5)).astype(np.float32)
    return [
        ("rectangular", rect, [32, 32, 32, 32], [15, 15, 15, 15]),
        ("masked-columns", rect, [3, 1, 17, 0], [15, 15, 15, 15]),
        ("ties", ties, [3, 8, 32, 15], [15, 15, 15, 15]),
        ("tall-masked-rows", tall, [5, 2, 5, 4], [9, 4, 1, 9]),
        ("tall-ties", tall_ties, [5, 3, 5, 1], [9, 9, 6, 9]),
    ]


@pytest.mark.parametrize("name,cost,cols,rows", _lsap_cases(),
                         ids=[c[0] for c in _lsap_cases()])
def test_lsap_matches_jax_solver_and_scipy(name, cost, cols, rows):
    cols, rows = np.asarray(cols, np.int32), np.asarray(rows, np.int32)
    col4row, valid = linear_sum_assignment(cost, cols, rows)
    want_c, want_v = _jax_lsap(jnp.asarray(cost), jnp.asarray(cols),
                               jnp.asarray(rows))
    np.testing.assert_array_equal(col4row, np.asarray(want_c))
    np.testing.assert_array_equal(valid, np.asarray(want_v))
    for b in range(cost.shape[0]):
        sub = cost[b, :rows[b], :cols[b]]
        r, c = scipy_lsap(sub)
        ours = [(i, col4row[b, i]) for i in range(rows[b]) if valid[b, i]]
        assert len(ours) == len(r) == min(sub.shape)
        # optimal up to the float32 duals' resolution: next to PAD_COST
        # (1e4) one ulp is ~1e-3, and both solvers carry those duals
        np.testing.assert_allclose(sum(sub[i, j] for i, j in ours),
                                   sub[r, c].sum(), rtol=0, atol=2e-3)


# --------------------------------------------------------------------------
# (e) matcher and criterion
# --------------------------------------------------------------------------

B, NQ, NC, M = 2, 5, 7, 6
COSTS = (4.0, 5.0, 2.0)          # the defaults' COST_CLASS, _BBOX, _GIOU


def _outputs_targets(seed):
    rng = np.random.default_rng(seed)

    def layer():
        return {
            "pred_logits": rng.normal(size=(B, NQ, NC)).astype(np.float32),
            "pred_boxes": (1 / (1 + np.exp(-rng.normal(size=(B, NQ, 4)))))
            .astype(np.float32),
            "pred_logits_b": rng.normal(size=(B, NQ, 3)).astype(np.float32),
        }

    out = layer()
    out["aux_outputs"] = [layer(), layer()]
    targets = {
        "boxes": rng.uniform(0.2, 0.7, (B, M, 4)).astype(np.float32),
        "labels": (rng.random((B, M, NC)) < 0.3).astype(np.float32),
        "n_boxes": np.array([3, 1], np.int32),
    }
    return out, targets


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, fn) for v in x]
    return fn(x)


def test_match_ava_matches_jax():
    out, targets = _outputs_targets(1)
    j = jax.jit(lambda o, tg: jax_match_ava(o, tg, *COSTS))(
        _tree(out, jnp.asarray), _tree(targets, jnp.asarray))
    got = match_ava(_tree(out, t), _tree(targets, t), *COSTS)
    ok = np.asarray(j.match_ok)
    np.testing.assert_array_equal(got.match_ok.numpy(), ok)
    np.testing.assert_array_equal(got.gt_idx.numpy()[ok], np.asarray(j.gt_idx)[ok])
    assert got.match_ok.sum(-1).tolist() == [3, 1]


# float32 on both sides: sums in other orders (focal terms, log-softmax)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("evaluation", [False, True])
def test_criterion_ava_matches_jax(evaluation):
    out, targets = _outputs_targets(2)
    kw = dict(num_classes=NC, weight=10.0, eos_coef=0.1,
              label_smoothing_alpha=0.1, evaluation=evaluation)
    want = jax.jit(lambda o, tg: jax_criterion_ava(
        o, tg, lambda a, b: jax_match_ava(a, b, *COSTS), **kw))(
        _tree(out, jnp.asarray), _tree(targets, jnp.asarray))
    got, match = criterion_ava(
        _tree(out, t), _tree(targets, t),
        lambda a, b: match_ava(a, b, *COSTS), return_match=True, **kw)
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), err_msg=k, **LOSS_TOL)
    assert match.gt_idx.shape == (3, B, NQ)


# --------------------------------------------------------------------------
# (f) optimizer, (g) LR schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 3])
def test_optimizer_trajectory_matches_optax(accum):
    """6 updates of summed accumulation + clip + AdamW: the port's
    ``MasterAdamW`` against the JAX package's optax chain.  One parameter
    is bf16 (its float32 master must follow optax's float32 parameter; the
    bf16 gradients are bf16 values on both sides)."""
    rng = np.random.default_rng(accum)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    init["c"] = np.asarray(jnp.asarray(init["c"], jnp.bfloat16), np.float32)
    grads = []
    for _ in range(6 * accum):
        g = {k: (3 * rng.normal(size=s)).astype(np.float32)
             for k, s in shapes.items()}
        g["c"] = np.asarray(jnp.asarray(g["c"], jnp.bfloat16), np.float32)
        grads.append(g)
    lr = 1e-3

    tx = jax_make_optimizer(lr, grad_accum=accum, clip_norm=1.0)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)

    ps = {k: torch.nn.Parameter(t(v)) for k, v in init.items()}
    ps["c"] = torch.nn.Parameter(ps["c"].data.bfloat16())
    opt = make_optimizer(ps.values(), lr, grad_accum=accum, clip_norm=1.0)
    norms = []
    for g in grads:
        for k, p in ps.items():
            p.grad = t(g[k]).to(p.dtype)
        norms.append(opt.update())
    assert opt.steps == 6 and sum(x is not None for x in norms) == 6
    masters = dict(zip(ps, opt.masters))
    for k in shapes:
        # float32 on both sides, a few ulps of |p| ~ 3 after 6 updates
        np.testing.assert_allclose(n(masters[k]), np.asarray(params[k]),
                                   atol=3e-6, err_msg=k)
    assert ps["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(n(ps["c"]), n(masters["c"].bfloat16()))


@pytest.mark.parametrize("policy", ["constant", "cosine", "linear", "step",
                                    "multistep"])
def test_lr_schedule_matches_optax(policy):
    cfgs = []
    for get in (get_cfg_defaults, jax_cfg_defaults):
        cfg = get()
        tc = cfg.CONFIG.TRAIN
        tc.LR = "1e-3"                     # as YAML 1.1 reads a bare 1e-3
        tc.LR_POLICY, tc.NUM_EPOCHS, tc.WARMUP_EPOCHS = policy, 6, 1
        tc.MIN_LR, tc.DECAY_EPOCHS, tc.DECAY_RATE = 1e-5, 2, 0.5
        tc.LR_MILESTONE = [2, 4]
        cfgs.append(cfg)
    ours, theirs = build_scheduler(cfgs[0], 10), jax_sched(cfgs[1], 10)
    for step in (0, 1, 5, 9, 10, 11, 19, 20, 21, 30, 39, 40, 41, 45, 59, 60,
                 61, 75):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(step))


# --------------------------------------------------------------------------
# (i) train-mode behaviour; freezing; the components route
# --------------------------------------------------------------------------

def _port_model(cfg, seed=1):
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    randomize_constants(model, torch.Generator().manual_seed(seed + 1))
    return model


def test_train_mode_at_zero_rates_equals_eval_mode():
    cfg = train_cfg(get_cfg_defaults)
    model = _port_model(cfg)
    model.head_dropout.p = 0.0          # the class head's fixed 0.5
    x, m = t(train_batch()["pixels"]), t(train_batch()["mask"])
    with torch.no_grad():
        ev = model.eval()(x, m)
        tr = model.train()(x, m)
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        torch.testing.assert_close(tr[k], ev[k], rtol=0, atol=0)


def test_drop_path_drops_whole_samples():
    dp = DropPath(0.5).train()
    x = torch.ones((64, 3, 5))
    torch.manual_seed(0)
    y = dp(x)
    per_sample = y.reshape(64, -1)
    assert set(per_sample.min(1).values.tolist()) <= {0.0, 2.0}
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    assert 10 < int((per_sample[:, 0] == 0).sum()) < 54
    assert torch.equal(dp.eval()(x), x)


def test_dropout_is_active_only_in_train_mode():
    cfg = train_cfg(get_cfg_defaults)
    cfg.CONFIG.MODEL.DROPOUT = 0.3
    cfg.CONFIG.ViT.DROP_PATH_RATE = 0.3
    model = _port_model(cfg)
    x, m = t(train_batch()["pixels"]), t(train_batch()["mask"])
    with torch.no_grad():
        a, b = model.eval()(x, m), model.eval()(x, m)
        torch.manual_seed(0)
        c = model.train()(x, m)
    torch.testing.assert_close(a["pred_boxes"], b["pred_boxes"], rtol=0, atol=0)
    assert not torch.allclose(a["pred_boxes"], c["pred_boxes"])


def test_vit_checkpointing_keeps_values_and_grads():
    """Per-block checkpointing recomputes each block in the backward and
    replays its drop-path draws: same values, same gradients."""
    vs = ViTSpec(embed_dim=96, depth=2, num_heads=4, pretrain_img_size=64,
                 num_frames=8, drop_path_rate=0.2)
    x = t(np.random.default_rng(4).standard_normal((2, 8, 64, 64, 3))
          .astype(np.float32))
    res = []
    for remat in (False, True):
        torch.manual_seed(0)
        vit = ViT(replace(vs, use_checkpoint=remat)).train()
        torch.manual_seed(3)
        out = vit(x, out_frame_range=(1, 3))
        out.square().sum().backward()
        res.append((out, {k: p.grad for k, p in vit.named_parameters()}))
    (o0, g0), (o1, g1) = res
    torch.testing.assert_close(o1, o0, rtol=0, atol=0)
    assert not torch.equal(o0, vit.eval()(x, out_frame_range=(1, 3)))
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6, msg=k)


def test_components_route_matches_jax():
    """The encoder's components route (4 points: no fused-head kernel in
    either package) against the JAX encoder, values and input gradient."""
    from class_query_vad_tpu.models.fast_encoder import (
        FastDeformableEncoder as JEncoder,
    )
    from class_query_vad_tpu_torch.models.fast_encoder import (
        FastDeformableEncoder,
    )
    from torch_parity import load_from_flax, random_params

    rng = np.random.default_rng(12)
    grids = [(1, 4, 6), (1, 2, 3)]
    srcs = [rng.standard_normal((2, *g, 256)).astype(np.float32) for g in grids]
    poses = [rng.standard_normal((2, *g, 256)).astype(np.float32) for g in grids]
    jm = JEncoder(1, 256, 64, 2, 8, 4, 1, "2d", "resample")
    args = [[jnp.asarray(a) for a in x] for x in (srcs, poses)]
    params = random_params(lambda k, *a: jm.init(k, *a, None, True), *args,
                           seed=12)

    def loss(p, s0):
        out = jm.apply(p, [s0] + args[0][1:], args[1], None, True)
        return sum((o ** 2).sum() for o in out), out

    (_, want), dsrc = jax.jit(jax.value_and_grad(loss, 1, has_aux=True))(
        params, args[0][0])
    tm = FastDeformableEncoder(1, 256, 64, 2, 8, 4, 1, "2d", "resample").eval()
    assert not tm.layers[0].self_attn.fused_route
    load_from_flax(tm, params, ("transformer", "encoder"), "transformer.encoder.")
    s0 = t(srcs[0]).requires_grad_()
    got = tm([s0] + [t(a) for a in srcs[1:]], [t(a) for a in poses], None)
    sum((o ** 2).sum() for o in got).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(n(s0.grad), n(dsrc), atol=2e-3, rtol=2e-3)


def test_components_route_equals_fused_route():
    """With NUM_ENC_N_POINTS not a multiple of 8 the encoder takes the
    components route (tanh, softmax and stacks in torch, the blend through
    K2's ``blend2d``); at 8 points both routes compute the same function,
    values and gradients."""
    assert not FastDeformAttn3D(n_points=4).fused_route
    rng = np.random.default_rng(9)
    attn = FastDeformAttn3D(256, 2, 8, 8)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(t(rng.normal(size=p.shape).astype(np.float32)) * 0.1)
    shapes = ((1, 4, 6), (1, 2, 3))
    src = t(rng.normal(size=(2, 30, 256)).astype(np.float32))
    pos = t(rng.normal(size=(2, 30, 256)).astype(np.float32))
    outs = []
    for fused in (True, False):
        attn.fused_route = fused
        attn.zero_grad()
        x = src.clone().requires_grad_()
        out = attn(x, pos, shapes, None)
        out.square().sum().backward()
        outs.append((out, x.grad, attn.window_offsets.weight.grad.clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_serving_then_training_shares_the_alignment_cache():
    """The level-alignment matrices cached while serving under
    ``inference_mode`` must be usable by autograd afterwards."""
    from class_query_vad_tpu_torch.ops.fast_deform import align_level

    feat = torch.randn((1, 1, 6, 10, 4))
    with torch.inference_mode():
        align_level(feat, (3, 5))
    x = feat.clone().requires_grad_()
    align_level(x, (3, 5)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()

