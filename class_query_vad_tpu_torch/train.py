"""Training CLI of the PyTorch port (the flags of the repo root's
``train.py``, plus ``--device``):

    python -m class_query_vad_tpu_torch.train --config-file <yaml> \\
        [--pretrained_path <ckpt>] [--resume <ckpt_epoch_NN.pt>] [--debug] \\
        [--amp] [--split N] [--root_data_path DIR] [--num_workers N] \\
        [--device cuda|cpu]

The epoch loop of the root ``train.py``: the initial weights from
``PRETRAINED_PATH`` or, with ``LOAD_DETR``, a stage-1 transformer from
``PRETRAIN_TRANSFORMER_DIR``; ``--resume`` restores the model, the
optimizer, the RNG streams, the epoch counter and the best mAP; per epoch
``Trainer.step`` over the train loader, a log line every ``DISPLAY_FREQ``
steps, and every ``EVAL_FREQ`` epochs ``run_validation`` with the
criterion and a checkpoint (every eval epoch, as the reference saves).
The model runs on the card, or with ``--device cpu`` on the CPU.

One process per GPU under ``torchrun`` (NCCL; gloo with ``--device
cpu``), as the JAX package runs one per host:

    torchrun --nproc_per_node N -m class_query_vad_tpu_torch.train ...

Each rank loads its share of the data (``host_id=rank``,
``num_hosts=world``); ``engine.Trainer`` sums the gradients over the
ranks, so a step is the single step on the ranks' concatenated batches.
Every rank takes the same number of steps per epoch, the least of the
ranks' ``len(train_loader)`` (one all-reduce per epoch: the loaders can
give ranks one batch more or less, and a collective step on one rank
alone would hang the others).  Only rank 0 writes logs, metrics and
checkpoints; a checkpoint holds every rank's torch / CUDA RNG streams,
and ``--resume`` gives each rank its own.
"""

from __future__ import annotations

import argparse
import time

from class_query_vad_tpu_torch.evaluate import (
    add_common_args,
    resolve_device,
    setup_cfg,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train video action detection models (PyTorch port).")
    add_common_args(parser)
    parser.add_argument("--resume", default="",
                        help="a ckpt_epoch_NN.pt to resume from (model, "
                             "optimizer, RNG streams, epoch counter)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from class_query_vad_tpu_torch.datasets import build_dataloader
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        load_detr_weights,
        load_pretrained_params,
        save_checkpoint,
    )
    from class_query_vad_tpu_torch.engine.evaluate import run_validation
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.parallel import (
        destroy,
        rank,
        sync_hosts,
        world_size,
    )
    from class_query_vad_tpu_torch.utils.logging import (
        MetricsLogger,
        build_log_dir,
        print_log,
    )
    from class_query_vad_tpu_torch.utils.misc import param_count

    cfg = setup_cfg(args)
    cfg.CONFIG.EVAL_ONLY = False
    dev = resolve_device(args.device)
    amp = args.amp or cfg.CONFIG.AMP
    dtype = torch.bfloat16 if amp else torch.float32

    r, world = rank(), world_size()
    # log dir + stdout tee (reference utils/utils.py:185-192) and metric
    # sinks (jsonl always; wandb / tensorboard per config, train.py:84-105),
    # on rank 0
    log_path = build_log_dir(cfg) if r == 0 else None
    logger = MetricsLogger(
        cfg, rank=r,
        use_wandb=bool(cfg.CONFIG.LOG.get("USE_WANDB", False)),
        use_tensorboard=bool(cfg.CONFIG.LOG.get("USE_TENSORBOARD", False)),
    )
    train_loader = build_dataloader(cfg, "train", host_id=r, num_hosts=world,
                                    num_workers=args.num_workers)
    val_loader = build_dataloader(cfg, "val", host_id=r, num_hosts=world,
                                  num_workers=args.num_workers)
    steps = len(train_loader)
    if world > 1:
        n = torch.tensor([steps], device=dev)
        torch.distributed.all_reduce(n, op=torch.distributed.ReduceOp.MIN)
        steps = int(n)

    model = build_model(cfg, dtype=dtype, device=dev,
                        input_hw=train_loader.canvas)
    mc = cfg.CONFIG.MODEL
    if mc.PRETRAINED_PATH:
        load_pretrained_params(cfg, mc.PRETRAINED_PATH, model)
    elif mc.get("LOAD_DETR", False) and mc.get("PRETRAIN_TRANSFORMER_DIR", ""):
        load_detr_weights(model, mc.PRETRAIN_TRANSFORMER_DIR, cfg)
    trainer = Trainer(model.train(), cfg, steps_per_epoch=steps, device=dev)
    print_log(log_path,
              "Number of parameters: %6.2fM" % (param_count(model) / 1e6))

    start_epoch, best_map = 0, 0.0
    if args.resume:
        meta = load_checkpoint(args.resume, trainer)
        start_epoch = int(meta["epoch"]) + 1
        best_map = float(meta["accuracy"])
        print_log(log_path, f"Resumed from {args.resume}: epoch "
                            f"{start_epoch}, best mAP {best_map:.4f}")

    tc = cfg.CONFIG.TRAIN
    for epoch in range(start_epoch, tc.NUM_EPOCHS):
        train_loader.set_epoch(epoch)
        model.train()
        t0 = time.time()
        total_loss, n_steps = 0.0, 0
        window = []
        for batch, _ in train_loader:
            if n_steps == steps:
                break
            # the losses stay on the device until a log line reads them
            window.append(trainer.step(batch))
            n_steps += 1
            if n_steps % cfg.CONFIG.LOG.DISPLAY_FREQ:
                continue
            # every rank empties its window (the metrics are the ranks'
            # sums, so they agree); rank 0 alone logs
            window = [{k: float(v) for k, v in m.items()} for m in window]
            total_loss += sum(m["total_loss"] for m in window)
            last = window[-1]
            window = []
            if r == 0:
                print_log(
                    log_path,
                    f"Epoch [{epoch}] Step [{n_steps}] "
                    f"loss: {last['total_loss']:.4f} "
                    f"({(time.time() - t0) / n_steps:.3f}s/step)"
                )
                # per-key train losses (reference wandb.log, train.py:170-175)
                logger.log({"epoch": epoch, "step": n_steps,
                            **{f"train/{k}": v for k, v in last.items()}})
        total_loss += sum(float(m["total_loss"]) for m in window)
        if r == 0:
            print_log(log_path, f"Epoch {epoch}: mean loss "
                                f"{total_loss / max(n_steps, 1):.4f} "
                                f"in {time.time() - t0:.1f}s")

        if (epoch + 1) % tc.EVAL_FREQ == 0:
            model.eval()
            result = run_validation(
                cfg, model, trainer.postprocess, val_loader,
                rank=r, world_size=world, barrier=sync_hosts,
                criterion=trainer.criterion,
                transfer_dtype=dtype if amp else None,
            )
            if r == 0:
                best_map = max(best_map, result["mAP"])
                line = {"epoch": epoch, "mAP": result["mAP"],
                        "best_mAP": best_map}
                if "v_mAP" in result:
                    line["v_mAP"] = result["v_mAP"]
                if "eval_losses" in result:
                    line.update({f"eval/{k}": v
                                 for k, v in result["eval_losses"].items()})
                logger.log(line)
            # every eval epoch, as the reference saves (train.py:99-103);
            # every rank calls it (its RNG streams go to rank 0's file,
            # which alone reads the accuracy)
            path = save_checkpoint(cfg, trainer, epoch, accuracy=(
                result["mAP"] if r == 0 else 0.0))
            if r == 0:
                print_log(log_path, f"Saved checkpoint {path}")
    destroy()
    return best_map


if __name__ == "__main__":
    main()
