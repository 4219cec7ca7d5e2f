"""The whole slice held to the JAX package on a synthetic JHMDB51-21
world (``torch_parity.jhmdb_world``: a tiny exact-encoder model on 32-pixel
frames), in process: JAX's ``run_validation`` on JAX's loader with the
params of JAX's ``load_pretrained_params`` of a reference-layout ``.pth``,
against the port's on its own loader with the same file.  Detection rows
within 2e-4 (scores, actorness) and 2e-4 x the frame's width (boxes, in
pixels), GT rows equal, and the port's evaluator on JAX's txt files gives
JAX's mAP and video mAP exactly.  One JAX model compile (LLVM's
optimisation passes off, as the other model tests build theirs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from numpy.testing import assert_equal

from torch_parity import JHMDB_YAML, jhmdb_world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return jhmdb_world(tmp_path_factory.mktemp("jhmdb"))


def _rows(path):
    out = []
    for line in open(path):
        key, vals = line.split(" [")
        out.append((key, [float(v) for v in vals.rstrip("]\n").split(",")]))
    return out


def test_slice_against_jax(world, tmp_path):
    import jax
    import jax.numpy as jnp

    from class_query_vad_tpu.config import get_cfg_custom as jax_cfg
    from class_query_vad_tpu.datasets import build_dataloader as jax_loader
    from class_query_vad_tpu.engine import load_pretrained_params as jax_load
    from class_query_vad_tpu.engine import run_validation as jax_run
    from class_query_vad_tpu.evaluates import STDetectionEvaluaterJHMDB
    from class_query_vad_tpu.losses import (
        build_criterion_and_postprocessor as jax_post,
    )
    from class_query_vad_tpu.losses import build_matcher as jax_matcher
    from class_query_vad_tpu.models import build_model as jax_model
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.datasets import build_dataloader
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_pretrained_params,
    )
    from class_query_vad_tpu_torch.engine.evaluate import run_validation
    from class_query_vad_tpu_torch.evaluates import (
        STDetectionEvaluaterJHMDB as PortJHMDB,
    )
    from class_query_vad_tpu_torch.losses import (
        build_criterion_and_postprocessor,
        build_matcher,
    )
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    yaml = tmp_path / "config.yaml"
    results = {}
    for side in ("jax", "port"):
        yaml.write_text(JHMDB_YAML.format(root=world, epochs=1, res=f"slice_{side}"))
        results[side] = (jax_cfg if side == "jax" else get_cfg_custom)(str(yaml))
    jcfg, tcfg = results["jax"], results["port"]

    src = build_model(tcfg, torch.float32, "cpu",
                      torch.Generator().manual_seed(5))
    randomize_constants(src, torch.Generator().manual_seed(6))
    pth = tmp_path / "ref.pth"
    torch.save({"model": {f"module.{k}": v for k, v in
                          src.state_dict().items()}}, pth)

    # the JAX package: its loader, its loader of .pth files, one compile
    params = jax.tree_util.tree_map(jnp.asarray, jax_load(jcfg, str(pth)))
    model = jax_model(jcfg, dtype=jnp.float32)
    # a loader of its own: the datasets count the samples they load
    first = next(iter(jax_loader(jcfg, "val", num_workers=1)))[0]
    loader = jax_loader(jcfg, "val", num_workers=1)
    args = (params, jnp.asarray(first["pixels"]), jnp.asarray(first["mask"]))
    fwd = jax.jit(lambda p, px, mk: model.apply(p, px, mk, True)).lower(
        *args).compile({"xla_backend_optimization_level": 0})
    _, post, _ = jax_post(jcfg, jax_matcher(jcfg))
    want = jax_run(jcfg, model, params, post, loader, forward_fn=fwd)

    # the port: its loader, its loader of .pth files
    dst = build_model(tcfg, torch.float32, "cpu")
    assert load_pretrained_params(tcfg, str(pth), dst) == []
    _, tpost, _ = build_criterion_and_postprocessor(tcfg, build_matcher(tcfg))
    got = run_validation(tcfg, dst, tpost,
                         build_dataloader(tcfg, "val", num_workers=1))

    jdir, tdir = world / "slice_jax", world / "slice_port"
    assert _rows(tdir / "GT_0.txt") == _rows(jdir / "GT_0.txt")
    det_t, det_j = _rows(tdir / "0.txt"), _rows(jdir / "0.txt")
    assert [k for k, _ in det_t] == [k for k, _ in det_j]
    a = np.array([v for _, v in det_t])
    b = np.array([v for _, v in det_j])
    width = 42.0                                # the resized frames' width
    np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=2e-4 * width)
    np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=2e-4)
    assert 0.0 <= got["mAP"] <= 1.0 and 0.0 <= got["v_mAP"] <= 1.0

    # the port's evaluator on the JAX package's files
    res = []
    for cls in (STDetectionEvaluaterJHMDB, PortJHMDB):
        ev = cls(tiou_thresholds=[0.5], class_num=21, query_num=5)
        ev.load_GT_from_path([str(jdir / "GT_0.txt")])
        ev.load_detection_from_path([str(jdir / "0.txt")])
        res.append(ev.evaluate())
    assert_equal(res[1], res[0])
    assert res[1][0][0] == want["mAP"] and res[1][2][0] == want["v_mAP"]
