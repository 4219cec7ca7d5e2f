"""Evaluation CLI of the PyTorch port (the flags of the repo root's
``evaluate.py``, plus ``--device``):

    python -m class_query_vad_tpu_torch.evaluate --config-file <yaml> \\
        --pretrained_path <ckpt> [--split N] [--debug] [--amp] \\
        [--root_data_path DIR] [--num_workers N] [--device cuda|cpu] \\
        [--profile DIR] [--flops]

Builds the model and the val loader, loads the checkpoint (a reference
``.pth`` or a port checkpoint), runs ``engine.run_validation`` with the
criterion and prints the JSON metrics line (mAP, v_mAP for the tubes, the
eval loss, seconds).  The model runs on the card; with no card it raises
unless ``--device cpu`` is given.  ``--profile DIR`` writes a
``torch.profiler`` trace of the eval loop into DIR; ``--flops`` prints the
model's dense-product and convolution FLOPs on the first batch.

One process per GPU under ``torchrun`` (NCCL; gloo with ``--device
cpu``), as the JAX package runs one per host:

    torchrun --nproc_per_node N -m class_query_vad_tpu_torch.evaluate ...

Each rank evaluates its share of the val set (``host_id=rank``,
``num_hosts=world``) and writes its txt files; after a barrier rank 0
merges them and prints the metrics line.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import time


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """The flags the two CLIs share."""
    parser.add_argument("--config-file",
                        default="./configuration/AVA22_ViT-B_fast.yaml")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--amp", action="store_true",
                        help="bf16 backbone compute")
    parser.add_argument("--split", default=0, type=int)
    parser.add_argument("--pretrained_path", default="")
    parser.add_argument("--root_data_path", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no silent fallback")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate video action detection models (PyTorch port).")
    add_common_args(parser)
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the eval "
                             "loop into DIR")
    parser.add_argument("--flops", action="store_true",
                        help="print the model's FLOPs (dense products and "
                             "convolutions) on the first batch")
    return parser.parse_args(argv)


def setup_cfg(args):
    """The root ``evaluate.py``'s ``setup_cfg`` on the port's config."""
    from class_query_vad_tpu_torch.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(args.config_file)
    now = datetime.datetime.now()
    study, run = now.strftime("%Y-%m-%d"), now.strftime("%H-%M")
    if args.root_data_path:
        cfg.CONFIG.DATA.DATA_PATH = args.root_data_path
        cfg.CONFIG.DATA.LABEL_PATH = os.path.join(
            args.root_data_path, cfg.CONFIG.DATA.LABEL_PATH
        )
    cfg.CONFIG.LOG.RES_DIR = cfg.CONFIG.LOG.RES_DIR.format(study, run)
    cfg.CONFIG.LOG.EXP_NAME = cfg.CONFIG.LOG.EXP_NAME.format(study, run)
    if args.debug:
        cfg.CONFIG.LOG.RES_DIR = f"debug_{study}-{run}/res/"
        cfg.CONFIG.LOG.EXP_NAME = f"debug_{study}-{run}"
    if cfg.CONFIG.DATA.DATASET_NAME == "jhmdb":
        cfg.CONFIG.DATA.SPLIT = args.split
    cfg.CONFIG.MODEL.PRETRAINED_PATH = args.pretrained_path
    cfg.CONFIG.EVAL_ONLY = True
    return cfg


def resolve_device(name: str):
    """``name`` as this rank's torch device, after joining the process
    group when ``torchrun`` started several (``parallel.
    initialize_distributed``); a CUDA device with no card raises."""
    from class_query_vad_tpu_torch.parallel import initialize_distributed

    return initialize_distributed(name)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from class_query_vad_tpu_torch.datasets import build_dataloader
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_pretrained_params,
    )
    from class_query_vad_tpu_torch.engine.evaluate import run_validation
    from class_query_vad_tpu_torch.losses import (
        build_criterion_and_postprocessor,
        build_matcher,
    )
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.parallel import (
        destroy,
        rank,
        sync_hosts,
        world_size,
    )
    from class_query_vad_tpu_torch.utils.misc import param_count

    cfg = setup_cfg(args)
    dev = resolve_device(args.device)
    loader = build_dataloader(cfg, "val", host_id=rank(),
                              num_hosts=world_size(),
                              num_workers=args.num_workers)
    amp = args.amp or cfg.CONFIG.AMP
    dtype = torch.bfloat16 if amp else torch.float32
    model = build_model(cfg, dtype=dtype, device=dev, input_hw=loader.canvas)
    criterion, postprocess, _ = build_criterion_and_postprocessor(
        cfg, build_matcher(cfg))

    if cfg.CONFIG.MODEL.PRETRAINED_PATH:
        load_pretrained_params(cfg, cfg.CONFIG.MODEL.PRETRAINED_PATH, model)
    else:
        print("WARNING: no --pretrained_path; evaluating a random init")
    print("Number of parameters in the model: %6.2fM"
          % (param_count(model) / 1e6))

    if args.flops:
        from class_query_vad_tpu_torch.utils.flops import model_cost

        first = next(iter(loader))[0]
        cost = model_cost(model, torch.as_tensor(first["pixels"]).to(dev),
                          torch.as_tensor(first["mask"]).to(dev))
        print("Model cost analysis: %.2f GFLOPs; bytes accessed %s"
              % (cost["flops"] / 1e9, cost["note"]))

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from class_query_vad_tpu_torch.utils.profiling import trace

        profile_ctx = trace(args.profile)
    t0 = time.time()
    with profile_ctx:
        result = run_validation(cfg, model, postprocess, loader,
                                rank=rank(), world_size=world_size(),
                                barrier=sync_hosts, criterion=criterion,
                                transfer_dtype=dtype if amp else None)
    if result is not None:
        line = {"mAP": result["mAP"], "time": time.time() - t0}
        if "v_mAP" in result:
            line["v_mAP"] = result["v_mAP"]
        if "eval_losses" in result:
            line["eval_loss"] = result["eval_losses"]["total_loss"]
        print(json.dumps(line))
    destroy()
    return result


if __name__ == "__main__":
    main()
