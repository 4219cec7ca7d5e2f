"""Evaluation CLI of the PyTorch port (the flags of the repo root's
``evaluate.py``, plus ``--device``):

    python -m class_query_vad_tpu_torch.evaluate --config-file <yaml> \\
        --pretrained_path <ckpt> [--split N] [--debug] [--amp] \\
        [--root_data_path DIR] [--num_workers N] [--device cuda|cpu]

Builds the model and the val loader, loads the checkpoint (a reference
``.pth`` or a port checkpoint), runs ``engine.run_validation`` with the
criterion and prints the JSON metrics line (mAP, v_mAP for the tubes, the
eval loss, seconds).  The model runs on the card; with no card it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
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
                        help="not ported yet (ROADMAP.md Queue 1 step 17)")
    parser.add_argument("--flops", action="store_true",
                        help="not ported yet (ROADMAP.md Queue 1 step 17)")
    args = parser.parse_args(argv)
    if args.profile or args.flops:
        parser.error("--profile and --flops wait for the port of "
                     "utils/profiling.py and utils/flops.py (ROADMAP.md "
                     "Queue 1 step 17)")
    return args


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
    """``name`` as a torch device; a CUDA device with no card raises."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available; pass "
            f"--device cpu to run the plain PyTorch path on the CPU")
    return dev


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
    from class_query_vad_tpu_torch.utils.misc import param_count

    cfg = setup_cfg(args)
    dev = resolve_device(args.device)
    loader = build_dataloader(cfg, "val", num_workers=args.num_workers)
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

    t0 = time.time()
    result = run_validation(cfg, model, postprocess, loader,
                            criterion=criterion,
                            transfer_dtype=dtype if amp else None)
    if result is not None:
        line = {"mAP": result["mAP"], "time": time.time() - t0}
        if "v_mAP" in result:
            line["v_mAP"] = result["v_mAP"]
        if "eval_losses" in result:
            line["eval_loss"] = result["eval_losses"]["total_loss"]
        print(json.dumps(line))
    return result


if __name__ == "__main__":
    main()
