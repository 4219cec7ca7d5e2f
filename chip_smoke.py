#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``class_query_vad_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

1. Device and build: the card's name and power limit (nvidia-smi), TF32
   off for the parity phases, every CUDA kernel (K1-K6, K8-K14 and K5's
   backward) built from ``csrc/`` (one nvcc per source, started together)
   with ptxas's register report; K10 and K11 share one source, and K6's
   serves K7.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's four level shapes, in float32 and bf16, with kernel / plain
   timings and the card's lower bound for the same work: K1 (fused blend)
   at the eval batch B=2; K2 (blend from components), K3 (its dvol) and K4
   (its d components) at B=1 and B=2 with offsets on exact ties, at P = 8
   and at the components route's P = 4, and K1's autograd (grads of vol
   and the head lanes) against autograd through the plain composite;
   timings at the train batch B=1 (K2-K4 at both P).  Beside each, the
   time of the ``F.grid_sample`` composition of the same function (K1:
   after the torch front end; K3 / K4: its autograd with respect to vol /
   the components), the library yardstick no path of the port calls;
   K1-K4 per grid and per layer, and K1's whole backward per layer, beside
   their times before their redesign (``EARLIER_MS``,
   ``EARLIER_GRID_MS``).
3. The eval path at full width: ``AVA22_ViT-B_fast`` (ViT-B, 6+6 layers,
   D=256, 80 classes, 15 queries) in bf16 with seeded random weights
   serves 3 requests of [2, 16, 256, 320, 3] clips through forward +
   ``postprocess_ava``; the launch counts show K1 ran 24 times per
   forward; median ms/batch over timed iterations; device ms per stage
   (CUDA events), torch.profiler's top device rows and the card's busy
   share of the median.
4. The same full-width model in float32 on the card (kernels) and on the
   CPU (plain versions), B=1, same weights and input: all three heads must
   agree.
5. The train path at full width: the bf16 model in ``train()`` mode and
   ``engine.Trainer`` from the same YAML take 1 + 6 steps of the batch
   bench.py times (B=1, 16x256x320, 32 gt slots, 3 live boxes): finite
   losses, a finite non-zero gradient norm, the parameters moving, non-zero
   gradients into every encoder layer's value/offset/weight projections,
   and 24 launches each of K1, K3 and K4 per step; median ms/step, clips/s,
   peak memory, stage shares, the host LSAP's ms.  Then the encoder's
   components route (NUM_ENC_N_POINTS 4) takes 2 steps: 24 launches each of
   K2, K3 and K4 per step.
6. One float32 train step of the full-width model (its ViT at
   ``MAIN_TRAIN_CPU_VIT_DEPTH``, 2, of 12 blocks for the CPU's time) on the
   card and on the CPU, same weights and batch, dropout off: the same matcher assignment,
   the loss and every parameter's gradient agree.  Both forwards run
   first; the few activations that the two put on two sides of a kink (a
   ReLU's 0, a max pool's argmax, a blend tap's hat) get their gradient
   zeroed on both sides, their share bounded (``KinkSides``).
7. K5 (the selective scan) against its plain version on the card at the
   VSS path's shapes, with their real strides (the backbone's [B=2,
   KD=384, L=5121, N=16] in bf16 with a float32 delta and all float32; the
   encoder's [2, 1024, 320, 4, G=4] float32) and an awkward one (L=37,
   KD=96, G=2), with and without D, delta_bias and the softplus; device
   times (one call = K5's three CUDA kernels: chunk summaries, carries,
   rescan) beside the card's lower bound, the plain version and the
   earlier, sequential version's time.
8. The VSS eval path at full width: ``AVA22_train-mamba_VSS`` (VideoMamba-
   tiny, 24 blocks; VSS encoder, 6 layers; 6 decoder layer pairs) in bf16
   with seeded random weights serves 3 requests of [2, 16, 256, 320, 3]
   through forward + ``postprocess_ava``; the launch counts show K5 ran 96
   times per forward (48 backbone and 48 encoder scans); median ms/batch,
   peak memory, device ms per stage, the profiler's busy share.
9. The same VSS model in float32 on the card (K5) and on the CPU (plain
   scan), B=1, VideoMamba at ``MAMBA_FWD_CPU_DEPTH`` (6) of its 24
   blocks: all three heads must agree.
10. K10 and K11 (the native cross-level blend, 2d and 3d windows) against
   their plain version on the card: the native mode's four query grids,
   each over the four levels at their own resolution, at B=2 with T=2
   (K10) and T=8 (K11), and an awkward 12x20 grid with a finer level, in
   float32 and bf16; device times, the card's lower bound from this run's
   data, the earlier versions' times (before K11, then K10, shared their
   value rows across a tile of queries), and the time of the ``F.grid_sample``
   composition of the same function (the library yardstick; no path of
   the port calls it).
11. ``AVA22_ViT-B_fast_native`` (native mode, 2d window, centre-frame
   slice) at full width in bf16 serves 3 requests: 24 K10 launches per
   forward and no K1 or K2; median ms/batch, stage events, busy share.
12. The same native model in float32 on the card (K10) and on the CPU
   (plain version), B=1: all three heads must agree.
13. Its ``FAST_WINDOW: 3d`` variant (no slice: the encoder runs over all 8
   backbone frames): 3 bf16 requests with 24 K11 launches per forward,
   then the float32 card-vs-CPU check, at ``NATIVE_3D_CPU_LAYERS`` (1)
   encoder layer (the CPU's plain 3d blend takes minutes at 6).
14. K6 (the 27-tap (x, y, t) blend of the resample mode's 3d window; the
   same CUDA kernel serves the TPU's K7), K8 (its d vol) and K9 (its d
   components) against their plain versions, offsets on exact ties
   included: K6 at the four query grids over the four aligned levels, B=2,
   T=8, and at a 128x160 grid in K7's regime; K8 / K9 at B=1; float32 and
   bf16; device times per grid and per encoder layer, the bound from this
   run's data, the plain version, the grid_sample composition (trilinear;
   its autograd for K8 / K9) and the times of their versions before the
   redesign that gave a block an 8x8 tile and one head, its value window
   (K6, K9) or its halo's components and masses (K8) in shared memory.
15. ``AVA22_ViT-B_fast`` with ``FAST_WINDOW: 3d`` (the resample mode's 3d
   window: no slice, all 8 backbone frames, the common-grid decode) at full
   width in bf16 serves 3 requests: 24 K6 launches per forward and no K1
   or K2; median ms/batch, peak memory, stage events, busy share.
16. The same 3d model in float32 on the card (K6) and on the CPU (plain
   version), B=1, at ``RESAMPLE_3D_CPU_LAYERS`` (2) of the YAML's 6
   encoder layers: all three heads must agree.
17. Its train path: 1 + 4 full-width bf16 B=1 steps through ``Trainer``,
   24 launches each of K6, K8 and K9 per step and of no other kernel;
   median ms/step, peak memory, stage shares, busy share.
18. One float32 train step of the 3d model on the card and on the CPU, at
   1 of the YAML's 6 encoder layers (``RESAMPLE_3D_TRAIN_CPU_LAYERS``; 4
   launches each of K6, K8, K9): the same assignment, loss and gradients,
   as in phase 6.
19. K12 (the ViT's softmax attention from fused qkv) against its plain
   version at one ViT-B block of the main path (B=2, N=2560, 12 x 64), an
   awkward shape (B=1, N=1001) and a long one (B=1, N=4096), float32 and
   bf16; its registers, shared memory and CTAs per SM; bf16 device time
   beside the bound, the plain version, ``F.scaled_dot_product_attention``
   and its first version's time; one backward through
   ``flash_attention_qkv`` at B=1.
20. K13 (the fused FFN) against its plain version at the encoder FFN's
   shapes under the 2d and 3d windows (27,200 and 108,800 tokens, 256 ->
   2048, relu) and the ViT MLP's (5,120 tokens, 768 -> 3072, exact GELU)
   and at an awkward token count, each with all three activations, float32
   and bf16; registers, shared memory and CTAs per SM; bf16 device times
   beside the bound, the plain version, the ``F.linear`` composition and
   its first version's time.
21. K12 and K13 on a full-width ``AVA22_ViT-B_fast`` model's own tensors
   (one request): ViT block 0's qkv against that block's attention module,
   encoder layer 0's FFN tokens against its ``linear2(relu(linear1(x)))``,
   in bf16 and float32.
22. K12's entry point, ``scripts/bench_vit_attn.py``'s ``main``, once.
   K12 and K13 lie on no model path (as in the JAX package): every model
   phase above checks that they launch 0 times.
23. ``AVA22_ViT-B_fast`` with ``FAST_RADIUS 2`` (the general-radius blend,
   plain PyTorch) in the 2d and the 3d window: one timed bf16 request at
   full width with no kernel launched, then float32 card vs CPU (at 1 of
   the 6 encoder layers in either window).
24. ``AVA22_ViT-B_fast_native`` trains: 1 + 1 full-width bf16 B=1 steps
   through ``Trainer`` in the 2d and the 3d window (24 K10 or K11 launches
   per step and no other kernel: the backward is the plain version's
   VJP), ms/step, peak memory, stage shares (no profiled step: its trace
   takes minutes); then one float32 native-2d train step card vs CPU at
   cut depth (``NATIVE_TRAIN_CPU_LAYERS``).
25. ``AVA22_ViT-B`` (the exact deformable encoder, ``ENCODER_TYPE:
   attention``: its sampler plain PyTorch, as in JAX, no kernel) at full
   width serves 3 bf16 requests of [2, 16, 256, 320, 3] (the encoder in
   float32) with no kernel launched: ms/batch, peak memory, stage events,
   busy share; then the float32 heads card vs CPU at B=1,
   ``EXACT_FWD_CPU_LAYERS`` (2) of 6 layers.
26. Its train path: 1 + 2 full-width bf16 B=1 steps (no kernel), non-zero
   gradients into every encoder layer's value / offset / weight
   projections; then one float32 train step card vs CPU at
   ``EXACT_TRAIN_CPU_LAYERS`` of 6 layers, the sampler's trilinear floors
   matched by ``KinkSides``.
27. K1, K3 and K4 against their plain versions at the tube-fast configs'
   grids (``TUBE_GRIDS``: UCF 56x56 .. 7x7 at T=16, JHMDB 64x64 .. 8x8 at
   T=20, B=1), float32 and bf16, K3 / K4 with offsets on ties; bf16 device
   time per grid and layer beside the bound.
28. ``UCF_ViT-B_fast`` (3 fast layers over all 16 token frames, tube
   mode) at B=1, 32x224x224: 3 requests through ``postprocess_frames``,
   12 K1 launches per forward; 1 + 4 train steps on a tube batch (2
   actor slots, empty boxes, 2 front-padded frames), 12 each of K1, K3,
   K4 per step and no other kernel.
29. ``UCF_ViT-B`` (32x224x224) and ``JHMDB_ViT-B`` (40x256x256, 108,800
   encoder tokens): the exact encoder over every frame, 3 layers; one
   timed request each and 1 + 1 train steps, no kernel; then UCF's
   float32 forward card vs CPU at ``UCF_EXACT_FWD_CPU_LAYERS`` (1) of its
   3 layers and ``UCF_EXACT_FWD_CPU_DEC_LAYERS`` (1) of its 3 decoder
   layer pairs, and its train step at
   ``UCF_EXACT_TRAIN_CPU_LAYERS`` and ``UCF_EXACT_TRAIN_CPU_DEC_LAYERS``.
30. ``AVA22_ViT-B-train-mamba`` (VideoMamba-tiny with the exact encoder,
   one level) serves 3 bf16 B=2 requests, 48 K5 launches per forward;
   then the float32 heads card vs CPU at B=1, VideoMamba at
   ``MAMBA_FWD_CPU_DEPTH`` (6) blocks and 2 encoder layers.
31. The eval loop as ``python -m class_query_vad_tpu_torch.evaluate`` runs
   it, on ``AVA22_ViT-B_fast`` at full width in bf16: a ``SyntheticClips``
   AVA dataset (items shaped as the datasets' ``__getitem__``, nothing
   decoded) packed by the port's ``DataLoader`` into 4 batches of B=2 on a
   256x320 canvas; the seeded weights through ``save_checkpoint`` ->
   ``load_pretrained_params`` into a fresh model (bit for bit); then
   ``run_validation`` with the criterion and bf16 pixel shipping: 24 K1
   launches per batch and no other kernel, the detection rows equal to
   phase 3's ``serve`` + ``postprocess_ava`` on the same batches, finite
   eval losses, an mAP in [0, 1]; the loop's ms/batch with and without
   the criterion (interleaved rounds: median, min, max) beside phase 3's,
   the card's idle share over the loop (the trace held to its 24 K1
   launches per batch), the save / load seconds.
32. The tube loop: ``UCF_ViT-B_fast`` over 2 batches of B=1, 32x224x224,
   through ``buffer_frames`` and the UCF evaluator: 12 K1 launches per
   batch, a finite video mAP.
33. The train CLI's loop: ``AVA22_ViT-B_fast`` bf16, B=1, GRAD_ACCUM 1,
   dropout on: 3 uninterrupted ``Trainer.step``s against 2 steps,
   ``save_checkpoint``, ``load_checkpoint`` into a fresh model and trainer
   and 1 step: masters, AdamW state and RNG streams restored exactly, the
   third step's loss within 1e-4, 24 launches each of K1, K3, K4 per step.
34. ``AVA22_CSN152`` (ir-CSN-152, 50 bottlenecks, cuDNN convolutions and
   plain batch norms; ``input_proj``; the exact encoder over CSN's four
   levels of unequal T, 24,640 tokens per clip, with the common-grid
   decode) serves 3 bf16 requests of [2, 32, 256, 320, 3] with no hand
   kernel launched (none in JAX either): ms/batch, stage events (CSN,
   input_proj, encoder, decoder), busy share; the CSN trunk's forward
   timed in NCDHW and in ``channels_last_3d``; then ``AVA22_CSN50``'s
   float32 heads card vs CPU at B=1, ``EXACT_FWD_CPU_LAYERS`` (2) of 6
   encoder layers.
35. CSN-152 trains: 1 + 2 full-width bf16 B=1 steps (batch statistics,
   the running statistics unchanged, no kernel), ms/step, peak memory,
   stage shares, busy share; then one float32 CSN-50 train step card vs
   CPU at ``CSN_TRAIN_CPU_LAYERS`` (1) encoder layer, ``KinkSides``
   hooked on CSN's ReLUs and max pool (where they take a gradient: the
   YAML's TUNE_POINT freezes the first stages).
36. ``CONFIG.GRADIENT_CHECKPOINTING`` off and on for the main path,
   ``AVA22_ViT-B``, ``AVA22_CSN152`` and the Mamba family
   (``AVA22_train-mamba_VSS``, ``AVA22_ViT-B-train-mamba``, GRAD_ACCUM 1):
   1 + 1 full-width bf16 B=1 steps each way on one built model (ms/step,
   peak memory, launches per step: K1 48 under remat, its recompute in
   each fast encoder layer's, K3 and K4 24; K5 192 / 96 and its backward
   96 / 48 under remat, 96 / 48 each without), then one float32 step each
   way with dropout on: the loss and every gradient within ``REMAT_TOL``
   (1e-5) x max.
37. On-device preprocessing (``datasets.device_preprocess``, the JAX
   bench's ``--device-preprocess`` route): the eval graph's uint8 resize
   of [2, 16, 400, 500, 3] frames to 256x320 on the card equal bit for bit
   to the CPU's (and to ``native_decode``'s where it builds: printed), its
   float32 output within 1e-6; the main path through ``run_validation``
   from uint8 frames (shipped raw, the graph in ``forward_fn``) against
   phase 31's route (float32 clips, bf16 shipping) on the same 4 batches,
   interleaved (ms/batch, bytes shipped per batch, busy share, 24 K1
   launches per batch); the train graph card vs CPU, then one main-path
   train step on its pixels (24 each of K1, K3, K4).
38. K5's backward (``csrc/selective_scan_bwd.cu``) against its plain
   version (``selective_scan_bwd_reference``) on the card at the train
   path's scans (B=1: the backbone's [1, 384, 5121, 16] bf16 with its
   strides, the encoder's [1, 1024, 320, 4, G=4] float32), ``K5_AWKWARD``
   and the flag sets of phase 7: every gradient within ``K5_TOL`` x
   max|ref| (dA, dD, d delta_bias, sums over L: ``K5_SUM_TOL``); at the two
   train shapes two calls on the same inputs equal bit for bit, the
   profiler's device rows of one call (a memset and one CUDA kernel; at
   most three) and its scratch bytes printed; device times beside
   the bound (``k5_bwd_work``) and the plain version.
39. The Mamba family trains at full width: ``AVA22_train-mamba_VSS`` and
   ``AVA22_ViT-B-train-mamba`` in bf16, 1 + 3 B=1 steps each of bench.py's
   train batch (GRAD_ACCUM 1): finite losses, the parameters moving,
   gradients into every VideoMamba block's A and encoder layer, 96 (VSS;
   48 VideoMamba + exact) launches each of K5 and its backward per step,
   FrozenBatchNorm's running statistics unmoved; ms/step, peak memory,
   stage shares, busy share.
40. One float32 ``AVA22_train-mamba_VSS`` train step card vs CPU at
   ``MAMBA_TRAIN_CPU_DEPTH`` (2) of VideoMamba's 24 blocks over the full
   5121-token sequence, 2 of the VSS encoder's 6 layers and 1 of its 6
   decoder layer pairs: 20 launches each of K5 and its backward on the
   card, phase 6's tolerances, ``KinkSides`` hooked on the 4x temporal
   max-pool and the ReLUs.
41. The main path trained under ``torch.distributed`` at world 1 over
   NCCL (``parallel.initialize_distributed`` with a local address and a
   free port; ``engine.Trainer`` in ``DistributedDataParallel`` with its
   summing comm hook): the first step's loss and the float32 masters after
   AdamW equal an unwrapped ``Trainer``'s on the same seed and batch, bit
   for bit (a sum over one rank is the identity); ``DDP_STEPS`` timed
   steps interleaved with the unwrapped trainer's, ms/step beside its and
   phase 5's, 24 launches each of K1, K3, K4 per step, the NCCL kernels
   of one profiled step; ``DDP_LOOP_BATCHES`` of
   phase 31's eval-loop batches through ``run_validation`` with
   ``barrier=sync_hosts``, their txt files byte-equal to the unwrapped
   loop's; one float32 ``AVA22_CSN50`` train step (loss and backward) with
   sync-BN on (in DDP under the group) and off (before the group came
   up): the loss and every gradient bit for bit (the statistics are sums
   then a division either way; one rank's sum is the identity).
42. ``--profile`` / ``--flops``: ``utils.profiling.trace`` around one
   main-path forward writes a Chrome trace whose kernel rows hold K1's 24
   launches; ``utils.flops.count_flops`` of the main path at 1x16x256x320
   on the card, in GFLOP, equal to phase 4's count of the same model on
   the CPU (the plain versions hidden from the counter, as the kernels).
43. K14, the row gather of the repo root's ``scripts/probe_gather.py``
   (``csrc/row_gather.cu``), against ``row_gather_ref`` bit for bit at
   the probe's shape (S=40960, D=32, G=435,200, bf16) and at D=128
   float32, int32 and int64 indices, with wrapped and out-of-range ones
   among them (NaN rows); at the probe's shape its device time beside the
   bound (``k14_work``), the plain version and ``index_select``.  Then
   the port's timers as their CLIs run them: ``scripts.probe_gather``'s
   ``main`` at its full shape (``PROBE_ITERS``; K14 exact against
   ``index_select``, its launches counted), ``scripts.
   bench_selective_scan quick`` (K5 and its backward launched) and
   ``scripts.bench_model_stages`` on the main path (K1 alone launched).

Each phase's seconds are printed on a line of their own (``[seconds]``).
The float32 card-vs-CPU train checks of phases 18, 24, 26 and 29 run the
ViT at ``CPU_TRAIN_VIT_DEPTH`` (1) of its 12 blocks, for the CPU's time.

Every phase raises on failure (exit code != 0).  The last two lines are a
JSON object of per-kernel numbers and ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configuration", "AVA22_ViT-B_fast.yaml")
VSS_CONFIG = os.path.join(REPO, "configuration", "AVA22_train-mamba_VSS.yaml")
NATIVE_CONFIG = os.path.join(REPO, "configuration",
                             "AVA22_ViT-B_fast_native.yaml")

# Device memory bandwidth (bytes/s), float32 CUDA-core peak and dense bf16
# tensor-core peak (FLOP/s) by card name (NVIDIA data sheets, dense); the
# bound of a kernel is the larger of its bytes over the first and its
# operations over the peak of the units it runs on (K12's and K13's
# products: the tensor cores).
_CARDS = [
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100", 3.35e12, 67e12, 989e12),          # SXM
    ("H200", 4.8e12, 67e12, 989e12),
]

# K1 at the main path's four query-level shapes (one encoder layer)
K1_LEVELS = [(64, 80), (32, 40), (16, 20), (8, 10)]
K1_B, K1_J, K1_T, K1_C, K1_KP = 2, 4, 2, 256, 64
# fp32: kernel and plain version differ only in summation order
K1_TOL = {torch.float32: 1e-5,
          # bf16: offsets and weights are rounded to bf16 on both sides, but
          # tanh/exp from two math libraries can land either side of a bf16
          # rounding boundary
          torch.bfloat16: 1e-2}
# in-model check (phase 4), relative to max|CPU output| per head: float32
# on both sides, summed in other orders (cuDNN/cuBLAS vs CPU kernels)
# through 12 ViT blocks, 6 encoder and 6 decoder layers
MODEL_TOL = 2e-3


def check(ok: bool, what: str) -> None:
    """Fail the run (an ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(what)


@contextlib.contextmanager
def phase_seconds(label: str):
    """Print the seconds the block took, on a line of its own."""
    t0 = time.perf_counter()
    yield
    print(f"[seconds] {label}: {time.perf_counter() - t0:.1f} s", flush=True)


def card_info():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return line.splitlines()[0]


def card_rates(name: str):
    """(bytes/s, float32 FLOP/s, bf16 tensor-core FLOP/s) of the card."""
    for key, *rates in _CARDS:
        if key in name:
            return rates
    raise RuntimeError(f"no memory/FLOP rates recorded for card {name!r}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_device_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` (one kernel launch) back to
    back on the stream, without the host's wrapper time between calls: the
    host queues all ``iters`` calls behind a device-side sleep, so the CUDA
    events around them see only the card (kernels and the card's own gap
    between launches).  The sleep grows until it outlasts the queueing.
    CUDA events, not torch.profiler's kernel rows: the profiler's trace has
    come back without a kernel's rows on this card."""
    fn()
    torch.cuda.synchronize()
    cycles = 10 ** 7                         # ~5 ms at the H100's clock
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        queued_in_time = not start.query()   # the sleep still ran
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(stop) / iters
        cycles *= 4
    raise RuntimeError("the host could not queue the timed launches within "
                       "the device-side sleep")


def k1_work(h: int, w: int, itemsize: int, b: int = K1_B, t: int = K1_T):
    """(bytes, operations) K1 must spend on one launch at B = ``b``, T =
    ``t``: vol and the head lanes read once, the float32 output written
    once; per (query, level): 9 taps x C multiply-adds of the blend + ~45
    ops per point for tanh, exp, hats and tap masses."""
    q = b * t * h * w
    vol = b * K1_J * t * h * w * K1_C * itemsize
    fused = q * 3 * K1_J * K1_KP * itemsize
    out = q * K1_C * 4
    ops = q * K1_J * (9 * K1_C * 2 + 45 * K1_KP)
    return vol + fused + out, ops


def k1_inputs(rng, b, h, w, dtype, dev, t: int = K1_T):
    """K1's vol and raw head lanes at one level shape (``t`` frames, J =
    ``K1_J``): the logits unshifted, so that the kernel's own global max
    does work."""
    vol = torch.from_numpy(rng.standard_normal(
        (b, K1_J, t, h, w, K1_C), np.float32)).to(dev, dtype)
    fused = torch.from_numpy(2.0 * rng.standard_normal(
        (b, t, h, w, 3 * K1_J * K1_KP), np.float32)).to(dev, dtype)
    return vol, fused


def phase_kernels(dev, bw, peak):
    from class_query_vad_tpu_torch.ops.fast_deform_cuda import (
        fused_blend2d, fused_blend2d_reference, fused_components)

    rng = np.random.default_rng(0)
    max_err = 0.0
    ms = plain_ms = bound_ms = library_ms = 0.0
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for h, w in K1_LEVELS:
            vol, fused = k1_inputs(rng, K1_B, h, w, dtype, dev)
            out_k = fused_blend2d(vol, fused, 8, 1.0)
            out_p = fused_blend2d_reference(vol, fused, 8, 1.0)
            torch.cuda.synchronize()
            check(out_k.shape == (K1_B, K1_T, h, w, K1_C),
                  f"K1 output shape {tuple(out_k.shape)}")
            check(bool(torch.isfinite(out_k).all()), "K1 output not finite")
            err = (out_k - out_p).abs().max().item()
            scale = out_p.abs().max().item()
            ok = err <= K1_TOL[dtype] * scale
            print(f"K1 {str(dtype)[6:]:8s} {h:3d}x{w:<3d}: max|err| {err:.3e} "
                  f"= {err / scale:.2e} x max|out| (tol {K1_TOL[dtype]:.0e})"
                  f" {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 disagrees with its plain version at {h}x{w} {dtype}")
            max_err = max(max_err, err)
            if dtype == torch.bfloat16:             # the main path's dtype
                call = lambda: fused_blend2d(vol, fused, 8, 1.0)
                t_k = kernel_device_ms(call)
                t_call = cuda_ms(call, 50)
                t_p = cuda_ms(
                    lambda: fused_blend2d_reference(vol, fused, 8, 1.0), 5, 1)
                # the library yardstick: the torch front end, then the
                # grid_sample composition of the blend
                lib = lambda: blend_grid_sample(
                    vol, *fused_components(fused, K1_J), 8)
                check_library(lib(), out_p, "K1")
                t_l = cuda_ms(lib, 5, 1)
                nbytes, ops = k1_work(h, w, 2)
                t_b = max(nbytes / bw, ops / peak) * 1e3
                bound_by["bytes" if nbytes / bw >= ops / peak
                         else "operations"] += t_b
                print(f"K1 bf16     {h:3d}x{w:<3d}: kernel {t_k:.4f} ms "
                      f"(device, queued{earlier_at('K1', (h, w))}; {t_call:.4f} ms "
                      f"per back-to-back call with the wrapper), plain "
                      f"{t_p:.4f} ms, library "
                      f"{t_l:.4f} ms, bound {t_b:.4f} ms "
                      f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) -> "
                      f"{nbytes / t_k / 1e6:.0f} GB/s")
                ms, plain_ms, bound_ms = ms + t_k, plain_ms + t_p, bound_ms + t_b
                library_ms += t_l
    print(f"K1 per encoder layer (4 launches, bf16): kernel {ms:.4f} ms "
          f"(earlier version {EARLIER_MS['K1']:.4f} ms), "
          f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (the kernel runs at {bound_ms / ms:.1%} of the "
          f"bound's speed)")
    return {
        "name": "fused_blend2d", "route": "cuda",
        "source": "class_query_vad_tpu_torch/csrc/fused_blend2d.cu",
        "replaces": "class_query_vad_tpu/ops/fast_deform_pallas.py:1413",
        "launches": None, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": max(bound_by, key=bound_by.get), "library_ms": library_ms,
    }


# K2-K4 and K1's autograd: the train step's batch B=1 (timed) and B=2
TRAIN_B = 1
# K2: float32 summation order only; K3/K4 outputs in bf16 are rounded after
# sums in another order (one bf16 ulp, 2^-8); K1's gradients in bf16 also
# pass bf16 roundings of the recomputed offsets and weights
BLEND_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
K1_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def blend_inputs(rng, b, h, w, dtype, dev, nc: int = 2, t: int = K1_T,
                 points: int = K1_KP // 8):
    """vol, dx, dy, (dt,) a at one level shape (``nc`` offset components,
    ``t`` frames, ``points`` per head); a third of the offsets exactly on
    -1, 0 or 1 (the tie points of hat'); G float32."""
    shape = (b, K1_J, t, h, w, 8 * points)
    vol = rng.standard_normal((b, K1_J, t, h, w, K1_C), np.float32)
    offs = []
    for _ in range(nc):
        x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        pick = rng.random(shape) < 1 / 3
        x[pick] = rng.integers(-1, 2, shape)[pick]
        offs.append(x)
    a = rng.uniform(0.0, 0.3, shape).astype(np.float32)
    g = rng.standard_normal((b, t, h, w, K1_C), np.float32)
    comps = [torch.from_numpy(x).to(dev, dtype) for x in (vol, *offs, a)]
    return comps, torch.from_numpy(g).to(dev)


def blend_work(kernel: str, b: int, h: int, w: int, itemsize: int,
               points: int = K1_KP // 8, t: int = K1_T):
    """(bytes, operations) one launch of K2, K3 or K4 must spend at
    ``points`` per head and ``t`` frames: each input read once, each output
    written once; per (query, level): 9 taps x C multiply-adds (K2, K3:
    the blend; K4: the per-head dots) + ~12 ops per tap and point for hats
    and masses (~30 in K4 with hat')."""
    kp = 8 * points
    q = b * t * h * w
    vol = b * K1_J * t * h * w * K1_C * itemsize
    comps = 3 * q * K1_J * kp * itemsize
    g32 = q * K1_C * 4
    per_point = 30 if kernel == "K4" else 12
    ops = q * K1_J * (9 * K1_C * 2 + 9 * kp * per_point)
    nbytes = {"K2": vol + comps + g32,          # out is float32 like G
              "K3": g32 + comps + vol,          # dvol like vol
              "K4": g32 + vol + comps + comps}[kernel]
    return nbytes, ops


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def blend_grid_sample(vol, dx, dy, a, nh: int = 8, dt=None):
    """The same function as K2 (K6 with ``dt``) composed from
    ``F.grid_sample``: the hat-weighted radius-1 window at offsets |d| <= 1
    with zero borders is bilinear (trilinear) sampling at q + d with zero
    padding, and on an aligned level the native mode's map is the identity
    (base q, phase 0), so this is ``native_grid_sample`` over vol's levels.
    Float32; the library yardstick of K1-K4 and K6-K9 (the backward
    kernels' is its autograd).  No path of the port calls it."""
    return native_grid_sample(list(vol.unbind(1)), dx, dy, a, nh, dt)


def check_library(got, want, what: str) -> float:
    """The grid_sample composition agrees with the plain version."""
    rel = rel_err(got, want)[1]
    check(rel <= LIBRARY_TOL, f"the grid_sample composition of {what} "
                              f"disagrees with the plain version: {rel:.2e}")
    return rel


def library_grad(fn, leaves, wrt, g):
    """A call computing the gradient of ``fn(*leaves)`` for the cotangent g
    with respect to the leaves at ``wrt`` only, through autograd (the
    forward taken once, outside the timed call)."""
    xs = [x.detach().requires_grad_(i in wrt) for i, x in enumerate(leaves)]
    out = fn(*xs)
    return lambda: torch.autograd.grad(out, [xs[i] for i in wrt], g,
                                       retain_graph=True)


# K2-K4's points per head: the main path's (the train step's K3 and K4)
# and the components route's (NUM_ENC_N_POINTS 4: K2, K3, K4); each
# kernel's JSON entry reports the points its launches run at
BLEND_POINTS = (8, 4)
LAUNCH_POINTS = {"K2": 4, "K3": 8, "K4": 8}
# (dtype, B, P) of phase 2's K2-K4 checks; bf16 at B = TRAIN_B is timed
BLEND_CASES = [(torch.float32, TRAIN_B, 8), (torch.float32, 2, 8),
               (torch.bfloat16, TRAIN_B, 8), (torch.bfloat16, 2, 8),
               (torch.float32, TRAIN_B, 4), (torch.bfloat16, TRAIN_B, 4)]


def phase_blend_kernels(dev, bw, peak):
    """K2, K3, K4 and K1's autograd against their plain versions; timings
    of the bf16 train shapes (B=1, one encoder layer = 4 levels) at P = 8
    and at the components route's P = 4."""
    from class_query_vad_tpu_torch.ops.blend2d import (
        blend2d,
        blend2d_bwd_dcomps,
        blend2d_bwd_dcomps_reference,
        blend2d_bwd_dvol,
        blend2d_bwd_dvol_reference,
        blend2d_reference,
    )
    from class_query_vad_tpu_torch.ops.fast_deform_cuda import (
        fused_blend2d,
        fused_components,
    )

    rng = np.random.default_rng(1)
    err = {k: 0.0 for k in ("K2", "K3", "K4")}
    num = {(k, p): {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                    "bound_by": {"bytes": 0.0, "operations": 0.0}}
           for k in err for p in BLEND_POINTS}
    k1_bwd_ms = 0.0
    for dtype, b, points in BLEND_CASES:
        for h, w in K1_LEVELS:
            (vol, dx, dy, a), g = blend_inputs(rng, b, h, w, dtype, dev,
                                               points=points)
            calls = {
                "K2": (lambda: blend2d(vol, dx, dy, a, 8),
                       lambda: blend2d_reference(vol, dx, dy, a, 8)),
                "K3": (lambda: blend2d_bwd_dvol(dx, dy, a, g, dtype, 8),
                       lambda: blend2d_bwd_dvol_reference(dx, dy, a, g,
                                                          dtype, 8)),
                "K4": (lambda: blend2d_bwd_dcomps(vol, dx, dy, a, g, 8),
                       lambda: blend2d_bwd_dcomps_reference(vol, dx, dy,
                                                            a, g, 8)),
            }
            if dtype == torch.bfloat16 and b == TRAIN_B:
                # the grid_sample composition (K2) and its autograd
                # with respect to vol (K3) or the components (K4);
                # the forward and d vol checked against the plain
                # versions (d components not: grid_sample's
                # subgradients at the ties are not XLA's)
                lib2 = lambda: blend_grid_sample(vol, dx, dy, a, 8)
                check_library(lib2(), calls["K2"][1](), "K2")
                library = {
                    "K2": lib2,
                    "K3": library_grad(blend_grid_sample,
                                       (vol, dx, dy, a), (0,), g),
                    "K4": library_grad(blend_grid_sample,
                                       (vol, dx, dy, a), (1, 2, 3), g),
                }
                e3 = rel_err(library["K3"]()[0], calls["K3"][1]())[1]
                check(e3 <= BLEND_TOL[dtype], f"the grid_sample "
                      f"composition's d vol disagrees with K3's plain "
                      f"version: {e3:.2e}")
            for k, (kern, plain) in calls.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if k != "K4":
                    got, want = (got,), (want,)
                for x in got:
                    check(bool(torch.isfinite(x).all()), f"{k} not finite")
                e = max(rel_err(x, y)[1] for x, y in zip(got, want))
                tol = 1e-5 if k == "K2" else BLEND_TOL[dtype]
                ok = e <= tol
                print(f"{k} {str(dtype)[6:]:8s} B={b} P={points} {h:3d}x"
                      f"{w:<3d}: max|err| = {e:.2e} x max|ref| (tol "
                      f"{tol:.0e}) {'ok' if ok else 'FAIL'}")
                check(ok, f"{k} disagrees with its plain version at "
                          f"B={b} P={points} {h}x{w} {dtype}")
                err[k] = max(err[k], max(rel_err(x, y)[0]
                                         for x, y in zip(got, want)))
                if dtype == torch.bfloat16 and b == TRAIN_B:
                    t_k = kernel_device_ms(kern)
                    t_p = cuda_ms(plain, 3, 1)
                    t_l = cuda_ms(library[k], 5, 1)
                    nbytes, ops = blend_work(k, b, h, w, 2, points)
                    t_b = max(nbytes / bw, ops / peak) * 1e3
                    n = num[(k, points)]
                    n["bound_by"]["bytes" if nbytes / bw >= ops / peak
                                  else "operations"] += t_b
                    n["ms"] += t_k
                    n["plain_ms"] += t_p
                    n["bound_ms"] += t_b
                    n["library_ms"] += t_l
                    print(f"{k} bf16     B={b} P={points} {h:3d}x{w:<3d}: "
                          f"kernel {t_k:.4f} ms (device, queued)"
                          f"{earlier_at(k, (h, w), points)}, plain "
                          f"{t_p:.4f} ms, library {t_l:.4f} ms, "
                          f"bound {t_b:.4f} ms ({nbytes / 1e6:.1f} MB) "
                          f"-> {nbytes / t_k / 1e6:.0f} GB/s")

            # K1's autograd against the plain composite: autograd
            # through the plain recompute of the offsets and weights,
            # fed the plain K3/K4 (XLA's tie rules; numpy's float32
            # normals include exact zeros, so offsets hit the ties)
            if points != K1_KP // 8:
                continue
            vol1 = vol.clone().requires_grad_()
            fused = torch.from_numpy(2.0 * rng.standard_normal(
                (b, K1_T, h, w, 3 * K1_J * K1_KP), np.float32)
            ).to(dev, dtype).requires_grad_()
            out = fused_blend2d(vol1, fused, 8, 1.0)
            grads = torch.autograd.grad(out, (vol1, fused), g,
                                        retain_graph=True)
            comps = fused_components(fused, K1_J)
            cd = [c.detach() for c in comps]
            ref = (blend2d_bwd_dvol_reference(*cd, g, dtype, 8),
                   torch.autograd.grad(comps, fused,
                                       blend2d_bwd_dcomps_reference(
                                           vol, *cd, g, 8))[0])
            for name, x, y in zip(("d vol", "d fused"), grads, ref):
                e = rel_err(x, y)[1]
                ok = bool(torch.isfinite(x).all()) and e <= K1_GRAD_TOL[dtype]
                print(f"K1 grad {name:7s} {str(dtype)[6:]:8s} B={b} "
                      f"{h:3d}x{w:<3d}: max|err| = {e:.2e} x max|ref| "
                      f"(tol {K1_GRAD_TOL[dtype]:.0e}) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"K1's gradient ({name}) disagrees with the "
                          f"plain composite at B={b} {h}x{w} {dtype}")
            if dtype == torch.bfloat16 and b == TRAIN_B:
                t = cuda_ms(lambda: torch.autograd.grad(
                    out, (vol1, fused), g, retain_graph=True), 20)
                k1_bwd_ms += t
                print(f"K1 backward bf16 B={b} {h:3d}x{w:<3d}: {t:.4f} ms "
                      f"per call (recompute + K3 + K4 + the recompute's "
                      f"backward; CUDA events)")
    print(f"K1 backward per encoder layer (bf16, B={TRAIN_B}, 4 levels): "
          f"{k1_bwd_ms:.4f} ms (with the first K3 and K4 "
          f"{EARLIER_MS['K1 backward']:.4f} ms), of which K3 "
          f"{num[('K3', 8)]['ms']:.4f} and K4 {num[('K4', 8)]['ms']:.4f} ms of kernel "
          f"device time")
    names = {"K2": ("blend2d", "blend2d.cu", 186),
             "K3": ("blend2d_bwd_dvol", "blend2d_bwd_dvol.cu", 786),
             "K4": ("blend2d_bwd_dcomps", "blend2d_bwd_dcomps.cu", 733)}
    entries = []
    for k, (name, src, line) in names.items():
        for points in BLEND_POINTS:
            n = num[(k, points)]
            key = earlier_key(k, points)
            earlier = (f" (earlier version {EARLIER_MS[key]:.4f} ms)"
                       if key in EARLIER_MS else "")
            print(f"{k} per encoder layer (4 launches, bf16, B={TRAIN_B}, "
                  f"P={points}): kernel {n['ms']:.4f} ms{earlier}, plain "
                  f"{n['plain_ms']:.4f} ms, library {n['library_ms']:.4f} ms, "
                  f"bound {n['bound_ms']:.4f} ms ({n['bound_ms'] / n['ms']:.1%} "
                  f"of the bound's speed)")
        times = {p: {x: num[(k, p)][x] for x in
                     ("ms", "plain_ms", "bound_ms", "library_ms")}
                 for p in BLEND_POINTS}
        n = num[(k, LAUNCH_POINTS[k])]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"class_query_vad_tpu_torch/csrc/{src}",
            "replaces": f"class_query_vad_tpu/ops/fast_deform_pallas.py:{line}",
            "launches": None, "max_abs_err": err[k], "ms": n["ms"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
            "bound_by": max(n["bound_by"], key=n["bound_by"].get),
            "library_ms": n["library_ms"], "points": LAUNCH_POINTS[k],
            "by_points": times,
        })
    return entries, k1_bwd_ms


def make_request(seed: int, b: int = 2, shape=(16, 256, 320)):
    """Synthetic clips [b, T, H, W, 3] (``shape`` = (T, H, W); AVA's
    16x256x320 by default) and pad masks [b, H, W] (clip i > 0 padded on
    the right by a seeded width)."""
    t, h, w = shape
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, t, h, w, 3), np.float32)
    mask = np.zeros((b, h, w), bool)
    for i in range(1, b):
        mask[i, :, w - int(rng.integers(16, 64)):] = True
    return pixels, mask


def clip_shape(cfg):
    """The (T, H, W) of a config's requests: AVA's bench clips (16 frames
    of 256x320), the tube datasets' square DATA.IMG_SIZE crops over
    DATA.TEMP_LEN frames (UCF 32x224x224, JHMDB 40x256x256)."""
    d = cfg.CONFIG.DATA
    if d.DATASET_NAME == "ava":
        return (d.TEMP_LEN, 256, 320)
    return (d.TEMP_LEN, d.IMG_SIZE, d.IMG_SIZE)


def serve(model, pixels, mask, dev):
    """Forward + the dataset's postprocessing (``postprocess_ava``, or
    ``postprocess_frames`` for the tubes) under inference mode."""
    from class_query_vad_tpu_torch.losses import (postprocess_ava,
                                                  postprocess_frames)

    x = torch.from_numpy(pixels).to(dev, non_blocking=True)
    m = torch.from_numpy(mask).to(dev, non_blocking=True)
    valid = ~m
    sizes = torch.stack([valid.any(2).sum(1), valid.any(1).sum(1)], dim=1)
    post = (postprocess_ava if model.spec.dataset_mode == "ava"
            else postprocess_frames)
    with torch.inference_mode():
        out = model(x, m)
        return out, post(out, sizes)


def trace_holds(device_rows, expected: dict) -> str:
    """How many of the port's kernel launches the profiler's device rows
    hold, against how many ran (by wrapper; wrapper ``x`` or ``x_fwd``
    launches ``x_kernel``): a trace that lost rows under-counts the card's
    busy time."""
    held = []
    for k, n in expected.items():
        sym = k.removesuffix("_fwd") + "_kernel"
        held.append(f"{k} {sum(e.count for e in device_rows if sym in e.key)}"
                    f"/{n}")
    return ", ".join(held)


def profiled_busy(fn, wall_ms: float, expected: dict, tag: str,
                  per: int = 1, unit: str = "forward", rows: int = 0) -> float:
    """Run ``fn()`` once under torch.profiler and print the card's busy ms
    per ``unit`` (the device rows' self time over ``per`` units), its
    share of ``wall_ms`` (the unprofiled median ms per ``unit``), and how
    many of ``expected``'s launches (by wrapper, over the whole run) the
    trace holds; ``rows``: the profiler's top rows to print first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    if rows:
        print(events.table(sort_by="self_cuda_time_total", row_limit=rows,
                           max_name_column_width=60))
    # device-side rows only (an aten op's "self CUDA" repeats its kernels'),
    # as the table's "Self CUDA time total" counts them
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / per
    print(f"{tag}device busy {busy:.2f} ms per {unit} (profiled) = "
          f"{busy / wall_ms:.1%} of the median {wall_ms:.2f} ms per {unit}; "
          f"idle share {1 - busy / wall_ms:.1%}; the profiler's own "
          f"'Activity Buffer Request' row is "
          f"{'in' if any(e.key == 'Activity Buffer Request' for e in device) else 'not in'}"
          f" the busy sum; the trace holds launches "
          f"{trace_holds(device, expected)}")
    return busy


def model_stages(model) -> dict:
    """The forward's stages by name: the backbone's (the ViT body and the
    whole backbone, or VideoMamba and ``mamba_proj``), the encoder, the
    decoder."""
    s, body = model.spec, model.backbone[0]
    if s.is_mamba:
        head = {f"VideoMamba ({len(body.body.layers)} blocks)": body.body,
                "mamba_proj": body.mamba_proj}
    elif not s.is_vit:
        n = sum(len(getattr(body.body, f"layer{i}")) for i in range(1, 5))
        head = {f"{s.backbone_name} ({n} bottlenecks)": body.body,
                "input_proj (4 levels, float32)": model.input_proj}
    else:
        head = {"ViT body": body.body, "backbone (ViT + FPN + poses)": body}
    kind = {"attention": "exact", "fast_attention": "fast"}.get(
        s.encoder_type, s.encoder_type.upper())
    return {**head,
            f"{kind} encoder ({s.enc_layers} layers)": model.transformer.encoder,
            f"decoder ({s.dec_layers} layer pairs)": model.transformer.decoder}


def stage_breakdown(model, pixels, mask, dev, wall_ms: float, iters: int = 5,
                    expected=None, tag: str = ""):
    """Mean device ms of the forward's stages (CUDA events from forward
    hooks), torch.profiler's top CUDA kernels over one forward, and the
    device's busy share of ``wall_ms`` (the unprofiled median ms/batch);
    ``expected``: the port's launches per forward, by kernel (K1's 24 by
    default)."""
    stages = model_stages(model)
    if expected is None:
        expected = {"fused_blend2d": 24}
    events = {k: [] for k in stages}
    handles = []
    for k, mod in stages.items():
        def pre(_m, _a, k=k):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[k].append([e, None])

        def post(_m, _a, _o, k=k):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[k][-1][1] = e
        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    total = []
    for _ in range(iters):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        serve(model, pixels, mask, dev)
        e.record()
        total.append((s, e))
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    fwd = statistics.mean(s.elapsed_time(e) for s, e in total)
    print(f"{tag}stage breakdown (device ms, mean of {iters}): forward + "
          f"postprocess {fwd:.2f}")
    for k, evs in events.items():
        ms = statistics.mean(a.elapsed_time(b) for a, b in evs)
        print(f"  {k:30s} {ms:8.2f} ms  {ms / fwd:6.1%}")
    profiled_busy(lambda: serve(model, pixels, mask, dev), wall_ms, expected,
                  tag, rows=20)


def phase_main_path(dev, counters):
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model

    cfg = get_cfg_custom(CONFIG)
    t0 = time.perf_counter()
    model = build_model(cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"build_model (bf16, seeded init on the host): "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params")
    requests = [make_request(seed) for seed in (1, 2, 3)]

    for c in counters:
        c.launches = 0
    for i, (pixels, mask) in enumerate(requests):
        out, (scores, boxes, actor) = serve(model, pixels, mask, dev)
        torch.cuda.synchronize()
        for name, x, shape in (("scores", scores, (2, 15, 80)),
                               ("boxes", boxes, (2, 15, 4)),
                               ("actorness", actor, (2, 15, 1))):
            check(tuple(x.shape) == shape, f"{name} shape {tuple(x.shape)}")
            check(bool(torch.isfinite(x).all()), f"{name} not finite")
        print(f"request {i}: scores {tuple(scores.shape)} boxes "
              f"{tuple(boxes.shape)} actorness {tuple(actor.shape)}, finite; "
              f"top score {scores.max().item():.4f}")
    launches = {c.__name__: c.launches for c in counters}
    print(f"kernel launches over {len(requests)} requests: {launches}")
    check(launches == {**{k: 0 for k in launches},
                       "fused_blend2d": 24 * len(requests)},
          f"eval launches {launches}, expected K1 alone, 24 per forward")

    pixels, mask = requests[0]
    for _ in range(2):
        serve(model, pixels, mask, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        serve(model, pixels, mask, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    print(f"full-width eval, B=2 bf16, forward + postprocess, host->device "
          f"copy included: median {med:.2f} ms/batch ({2e3 / med:.2f} "
          f"clips/s) over {len(times)} iterations; min {min(times):.2f}, "
          f"max {max(times):.2f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stage_breakdown(model, pixels, mask, dev, med)
    del model
    torch.cuda.empty_cache()
    return launches, med


def phase_in_model(dev, config: str = CONFIG, opts=(), tag: str = "",
                   tol: float = MODEL_TOL, flops=None):
    """The full-width model of ``config`` (with ``opts``) in float32, B=1,
    on a clip of the config's shape (``clip_shape``): the kernels on the
    card against the plain versions on the CPU, each head within ``tol``
    x max|CPU head|.  With ``flops`` (a dict) the CPU forward's FLOP count
    (``utils.flops``) lands in ``flops["cpu"]``."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    cfg = get_cfg_custom(config, ["CONFIG.MODEL.FAST_DTYPE", "float32",
                                  "CONFIG.MODEL.DECODER_DTYPE", "float32",
                                  *opts])
    m_cpu = build_model(cfg, torch.float32, "cpu",
                        torch.Generator().manual_seed(7))
    # non-constant LayerNorms, biases and offset/weight kernels, so that the
    # class logits are not identically 0 and every query of K1 differs
    randomize_constants(m_cpu, torch.Generator().manual_seed(8))
    m_gpu = build_model(cfg, torch.float32, dev)
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    pixels, mask = make_request(11, b=1, shape=clip_shape(cfg))
    out_g, _ = serve(m_gpu, pixels, mask, dev)
    torch.cuda.synchronize()
    torch.set_num_threads(os.cpu_count() or 1)
    from class_query_vad_tpu_torch.utils.flops import counting

    t0 = time.perf_counter()
    with (counting(m_cpu) if flops is not None
          else contextlib.nullcontext()) as counter:
        out_c, _ = serve(m_cpu, pixels, mask, "cpu")
    cpu_s = time.perf_counter() - t0
    if flops is not None:
        flops["cpu"] = int(counter.get_total_flops())
    print(f"{tag}CPU float32 forward (plain versions), "
          f"{cfg.CONFIG.MODEL.ENC_LAYERS} encoder layers: {cpu_s:.1f} s")
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        g, c = out_g[k].float().cpu(), out_c[k].float()
        err = (g - c).abs().max().item()
        scale = c.abs().max().item()
        ok = bool(torch.isfinite(g).all()) and err <= tol * scale
        print(f"{tag}in-model fp32 card vs CPU {k:14s}: max|err| {err:.3e} = "
              f"{err / scale:.2e} x max|ref| (tol {tol:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{tag}card and CPU disagree on {k}")
    return cpu_s


def train_batch(cfg, seed: int = 0, b: int = TRAIN_B):
    """AVA: the batch bench.py's train-step metric builds (bench.py:
    223-237): [b, T, 256, 320, 3] pixels, no padding, MAX_BOXES gt slots
    with boxes uniform in 0.2-0.7, 5 % multi-hot labels, 3 live boxes.
    The tubes: ``tube_targets`` on clips of the config's shape."""
    t, h, w = clip_shape(cfg)
    nc = cfg.CONFIG.DATA.NUM_CLASSES
    rng = np.random.default_rng(seed)
    pixels = rng.normal(size=(b, t, h, w, 3)).astype(np.float32)
    mask = np.zeros((b, h, w), bool)
    if cfg.CONFIG.DATA.DATASET_NAME != "ava":
        return {"pixels": pixels, "mask": mask,
                **tube_targets(rng, b, t, nc,
                               cfg.CONFIG.DATA.DATASET_NAME == "ucf")}
    m = int(cfg.CONFIG.DATA.MAX_BOXES)
    return {
        "pixels": pixels,
        "mask": mask,
        "boxes": np.clip(rng.uniform(0.2, 0.7, (b, m, 4)), 0.05, 0.95
                         ).astype(np.float32),
        "labels": (rng.uniform(size=(b, m, nc)) < 0.05).astype(np.float32),
        "n_boxes": np.full((b,), min(3, m), np.int32),
    }


# tube batches: 2 frames front-padded (the criterion's front-pad shift)
TUBE_FRONT_PAD = 2


def tube_targets(rng, b: int, t: int, nc: int, ucf: bool):
    """Tube targets as the loader packs them (boxes [b, 2, t, 4], labels
    [b, 2, t], frame_valid [b, t], n_actors [b]): the first
    ``TUBE_FRONT_PAD`` frames padded; UCF: actor slot 0 live from frame
    t/8 to 3t/4 with zero (empty) boxes elsewhere, slot 1 all empty, for
    the empty-box filter; JHMDB (no filter: every box of a live slot is a
    gt): slot 0 live in every frame, one actor."""
    boxes = np.zeros((b, 2, t, 4), np.float32)
    live = slice(t // 8, 3 * t // 4) if ucf else slice(0, t)
    n = live.stop - live.start
    cxcy = rng.uniform(0.3, 0.7, (b, 1, 2)) + np.linspace(0, 0.1, n)[:, None]
    boxes[:, 0, live, :2] = cxcy
    boxes[:, 0, live, 2:] = rng.uniform(0.15, 0.4, (b, 1, 2))
    labels = np.repeat(rng.integers(0, nc, (b, 2, 1)), t, axis=2)
    frame_valid = np.ones((b, t), bool)
    frame_valid[:, :TUBE_FRONT_PAD] = False
    return {"boxes": boxes, "labels": labels, "frame_valid": frame_valid,
            "n_actors": np.full((b,), 2 if ucf else 1, np.int32)}


def check_train_step(trainer, metrics, before):
    """The per-step checks of phase 5."""
    for k, v in metrics.items():
        check(bool(torch.isfinite(v).all()), f"{k} not finite: {v}")
    norm = metrics["grad_norm"].item()
    check(norm > 0, f"global gradient norm {norm}")
    opt = trainer.optimizer
    moved = sum(not torch.equal(x, m) for x, m in zip(before, opt.masters))
    check(moved >= 0.9 * len(before),
          f"only {moved} of {len(before)} parameter tensors moved")
    model = trainer.model
    grads = {}                 # the parameters that must get a gradient
    for i, layer in enumerate(model.transformer.encoder.layers):
        if not hasattr(layer, "self_attn"):       # the SSM / VSS encoder
            grads[f"encoder layer {i} compress"] = layer.compress.weight
            continue
        att = layer.self_attn
        heads = (("window_offsets", "window_weights")
                 if hasattr(att, "window_offsets")
                 else ("sampling_offsets", "attention_weights"))
        for name in ("value_proj",) + heads:
            grads[f"encoder layer {i} {name}"] = getattr(att, name).weight
    if model.spec.is_mamba:       # both scan directions, through K5's backward
        for i, blk in enumerate(model.backbone[0].body.layers):
            for name in ("A_log", "A_b_log", "D", "D_b"):
                grads[f"VideoMamba block {i} {name}"] = getattr(blk.mixer, name)
    for what, p in grads.items():
        g = opt.last_grad(p)
        check(g is not None and bool(g.abs().max() > 0), f"{what} got no gradient")
    return norm, moved


# median ms/step of each ``phase_train`` call, by its tag ("" the main path)
TRAIN_MS = {}

# launches per train step of the main path (K1 forward, K3 + K4 backward)
# and of its 3d resample window (K6 forward, K8 + K9 backward)
TRAIN_KERNELS = {"2d": ("fused_blend2d", "blend2d_bwd_dvol",
                        "blend2d_bwd_dcomps"),
                 "3d": ("blend3d_fwd", "blend3d_bwd_dvol",
                        "blend3d_bwd_dcomps")}


def phase_train(dev, counters, window: str = "2d", steps: int = 7,
                tag: str = "", config: str = CONFIG, kernels=None,
                profile_step: bool = True, per_step: int = 24, after=None,
                opts=()):
    """Full-width bf16 train steps of ``config`` (with ``FAST_WINDOW:
    window`` and ``opts``) through build_model + Trainer: ``per_step`` launches of each
    of ``kernels`` (``TRAIN_KERNELS[window]`` when None; () for a path
    with no kernel) per step and of no other kernel; the host LSAP's time
    on the main path; the stage breakdown (profiled unless
    ``profile_step`` is off); ``after(model)`` checks the model after the
    steps."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.losses.matcher import cost_matrix
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.ops.lsap import linear_sum_assignment

    cfg = get_cfg_custom(config, ["CONFIG.MODEL.FAST_WINDOW", window, *opts])
    model = build_model(cfg, dtype=torch.bfloat16)
    trainer = Trainer(model, cfg)
    tc = cfg.CONFIG.TRAIN
    print(f"{tag}trainer: LR {float(tc.LR)} ({tc.get('LR_POLICY', 'constant')}), "
          f"GRAD_ACCUM {tc.GRAD_ACCUM}, clip {tc.get('CLIP_GRAD_NORM', 1.0)}, "
          f"dropout {cfg.CONFIG.MODEL.DROPOUT}, drop path "
          f"{cfg.CONFIG.ViT.DROP_PATH_RATE}, ViT checkpointing "
          f"{cfg.CONFIG.ViT.USE_CHECKPOINT}")
    batch = train_batch(cfg)
    times, step_counts = [], []
    for c in counters:
        c.launches = 0
    for i in range(steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        before = [m.clone() for m in trainer.optimizer.masters]
        counts = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        norm, moved = check_train_step(trainer, metrics, before)
        step_launches = {c.__name__: c.launches - n
                         for c, n in zip(counters, counts)}
        step_counts.append(step_launches)
        if i:
            times.append(ms)
        print(f"{tag}train step {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms, "
              f"total {metrics['total_loss'].item():.5f} ("
              + ", ".join(f"{k} {metrics[k].item():.4f}"
                          for k in trainer.weight_dict)
              + f"), |g| {norm:.4f}, {moved}/{len(before)} tensors moved, "
              f"launches {step_launches}")
        del before
    launches = {c.__name__: c.launches for c in counters}
    kernels = TRAIN_KERNELS[window] if kernels is None else kernels
    check(all(d == {**{k: 0 for k in d}, **{k: per_step for k in kernels}}
              for d in step_counts),
          f"{tag}train launches per step {step_counts}, expected "
          f"{per_step} each of {', '.join(kernels) or 'no kernel'} and no "
          f"other kernel")
    med = statistics.median(times)
    TRAIN_MS[tag] = med
    print(f"{tag}full-width train, B={TRAIN_B} bf16, forward + matcher + criterion "
          f"+ backward + clip + AdamW, host->device copy included: median "
          f"{med:.2f} ms/step ({1e3 * TRAIN_B / med:.2f} clips/s) over "
          f"{len(times)} steps; min {min(times):.2f}, max {max(times):.2f}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches over the {len(step_counts)} steps {launches}")
    if after is not None:
        after(model)
    if window != "2d" or config != CONFIG:
        train_breakdown(trainer, batch, med, kernels, profile_step, per_step)
        del trainer, model
        torch.cuda.empty_cache()
        return launches

    # the host LSAP on this step's costs (6 decoder layers, one copy)
    x = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    with torch.no_grad():
        out = model(x["pixels"], x["mask"])
        layers = out["aux_outputs"] + [out]
        mc = cfg.CONFIG.MATCHER
        cost = cost_matrix(torch.stack([o["pred_boxes"] for o in layers]),
                           torch.stack([o["pred_logits_b"] for o in layers]),
                           x["boxes"], mc.COST_CLASS, mc.COST_BBOX,
                           mc.COST_GIOU)
        t0 = time.perf_counter()
        host = cost.cpu().numpy()
        copy_ms = (time.perf_counter() - t0) * 1e3
    lsap = []
    for _ in range(5):
        t0 = time.perf_counter()
        linear_sum_assignment(host, n_valid_cols=batch["n_boxes"])
        lsap.append((time.perf_counter() - t0) * 1e3)
    print(f"host LSAP (ops/lsap.py, numpy): {statistics.median(lsap):.2f} ms "
          f"per step for {host.shape[0]}x{host.shape[1]} costs of "
          f"{host.shape[2]}x{host.shape[3]} (median of 5); the device-to-host "
          f"copy {copy_ms:.2f} ms")
    train_breakdown(trainer, batch, med, kernels)
    del trainer, model, out
    torch.cuda.empty_cache()
    return launches


def train_breakdown(trainer, batch, wall_ms: float, kernels,
                    profile_step: bool = True, per_step: int = 24):
    """Device ms of one step's stages (CUDA events) and, with
    ``profile_step``, the card's busy share of the median ms/step
    (torch.profiler's device rows, which should hold ``per_step`` launches
    of each of ``kernels``)."""
    x = {k: torch.as_tensor(v).to(trainer.device) for k, v in batch.items()}
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    host = []
    marks[0].record()
    t0 = time.perf_counter()
    outputs = trainer.model(x["pixels"], x["mask"])
    marks[1].record()
    host.append(time.perf_counter())
    targets = {k: v for k, v in x.items() if k not in ("pixels", "mask")}
    losses = trainer.criterion(outputs, targets)
    total = sum(losses[k] * w for k, w in trainer.weight_dict.items())
    marks[2].record()
    host.append(time.perf_counter())
    total.backward()
    marks[3].record()
    host.append(time.perf_counter())
    trainer.optimizer.update()
    marks[4].record()
    host.append(time.perf_counter())
    torch.cuda.synchronize()
    spec = trainer.model.spec
    names = ("forward (train mode"
             + (", ViT checkpointed)" if spec.is_vit and not spec.is_mamba
                else ")"),
             "matcher + criterion (host LSAP)",
             f"backward ({', '.join(kernels[1:]) or 'plain VJP'})",
             "clip + AdamW + master copy")
    dev_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(4)]
    host_ms = [(b - a) * 1e3 for a, b in zip([t0] + host[:-1], host)]
    print(f"train stage breakdown (one step; CUDA events between the "
          f"stages, host clock of each call):")
    for name, d, h in zip(names, dev_ms, host_ms):
        print(f"  {name:40s} {d:8.2f} ms  {d / sum(dev_ms):6.1%}   host "
              f"{h:8.2f} ms")
    if not profile_step:
        print("  (no profiled step: the trace of the native mode's eager "
              "plain backward took minutes; busy share not measured)")
        return
    profiled_busy(lambda: trainer.step(batch), wall_ms,
                  {k: per_step for k in kernels}, "train step: ", unit="step",
                  rows=15)


def phase_components_route(dev, counters):
    """The encoder's components route (NUM_ENC_N_POINTS 4: no fused head
    kernel) at full width: K2 forward, K3 + K4 backward."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.models import build_model

    cfg = get_cfg_custom(CONFIG)
    cfg.CONFIG.MODEL.NUM_ENC_N_POINTS = 4
    model = build_model(cfg, dtype=torch.bfloat16)
    check(not model.transformer.encoder.layers[0].self_attn.fused_route,
          "NUM_ENC_N_POINTS 4 should take the components route")
    trainer = Trainer(model, cfg)
    batch = train_batch(cfg, seed=1)
    for c in counters:
        c.launches = 0
    for i in range(2):
        metrics = trainer.step(batch)
        for k, v in metrics.items():
            check(bool(torch.isfinite(v).all()), f"{k} not finite: {v}")
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"components route, 2 full-width bf16 train steps: total "
          f"{metrics['total_loss'].item():.5f}; launches {launches}")
    check(launches == {**{k: 0 for k in launches}, "blend2d": 48,
                       "blend2d_bwd_dvol": 48, "blend2d_bwd_dcomps": 48},
          f"components-route launches {launches}, expected 24 each of K2, "
          f"K3, K4 per step and no K1")
    del trainer, model
    torch.cuda.empty_cache()
    return launches


# phase 6: float32 on both sides through 12 ViT blocks, 6 + 6 layers and
# their backward, summed in other orders (cuBLAS / cuDNN vs CPU kernels)
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-2       # x max|grad| of each tensor ...
TRAIN_GRAD_FLOOR = 1e-5     # ... + this x the model's max|grad|: some
# gradients are zero up to rounding (a key bias shifts all of a query's
# logits alike) and their noise has no scale of its own
# the share of kinked activations (below) whose two sides may differ: the
# forwards agree to ~1e-6, so a share near that; a wrong forward moves far more
KINK_SHARE = 1e-4


def hat_codes(p: torch.Tensor, taps) -> torch.Tensor:
    """For float32 positions p, where each tap's hat argument fl(p - s)
    lies against the hat's kinks -1, 0, 1 (below, on or above each: 7
    codes per tap), packed over ``taps`` into one int16."""
    kinks = torch.tensor([-1.0, 0.0, 1.0])
    code = torch.zeros(p.shape, dtype=torch.int16)
    for s in taps:
        u = (p - s)[..., None]
        code = code * 7 + ((u > kinks).sum(-1) + (u >= kinks).sum(-1))
    return code


class KinkSides:
    """Which side of its kinks each kinked activation of a model lies on,
    and a gradient mask for the ones whose side differs between two runs.

    The step's function is piecewise smooth: a ReLU's derivative jumps at
    0, a max pool's where its window's argmax changes, the blend's hat
    taps where an offset crosses a whole pixel (radius * tanh(lane) in the
    resample mode; tanh(lane) plus the level's phase in the native one),
    and the exact encoder's trilinear weights where a sampling coordinate
    (loc * size - 0.5) crosses a whole pixel or the drop guard's -1.
    Where the card's and the CPU's forwards, which agree to rounding, put
    one element on two sides of such a jump, each side's gradient there is
    right for its own forward and they differ by the jump, not by rounding.
    The hat's arguments are compared as the blends compute them, rounded to
    float32, which puts an offset within an ulp of 0 on the kink of its -1
    tap.  ``watch`` hooks every ReLU input (the FFNs' and the MLP heads'
    hidden layers), the backbone's max pool, every fast encoder layer's
    head lanes and every exact encoder layer's sampling locations,
    CSN's ReLUs and max pool (where their outputs take a gradient) and
    VideoMamba's 4x temporal max-pool;
    ``match`` marks the elements whose sides differ, and the hooks then
    zero the gradient there, on both sides alike, before it flows on.
    """

    def __init__(self):
        self.sides, self.kinds, self.masks, self.numel = [], [], [], 0
        self.active = False         # the hooks zero the masked gradients

    def watch(self, model):
        from class_query_vad_tpu_torch.models.backbone import MaxPool2x
        from class_query_vad_tpu_torch.models.common import MLP
        from class_query_vad_tpu_torch.models.csn import CSN, CSNBottleneck
        from class_query_vad_tpu_torch.models.deform_encoder import (
            MSDeformAttn3D)
        from class_query_vad_tpu_torch.models.fast_encoder import (
            FastDeformAttn3D)
        from class_query_vad_tpu_torch.models.videomamba import (
            TemporalMaxPool)

        for name, mod in model.named_modules():
            if isinstance(mod, MSDeformAttn3D):
                mod.register_forward_pre_hook(self._exact_shapes)
                mod.sampling_locations.register_forward_hook(
                    lambda _m, _i, out: self._keep(
                        out, self._floor_sides(out), "trilinear floors"))
            elif isinstance(mod, FastDeformAttn3D):
                mod.register_forward_pre_hook(self._shapes)
                mod.head_lanes.register_forward_hook(
                    lambda _m, _i, out, a=mod: self._keep(
                        out, self._lane_sides(a, out), "head lanes"))
            elif isinstance(mod, MaxPool2x):
                mod.register_forward_hook(self._argmax)
            elif isinstance(mod, TemporalMaxPool):
                mod.register_forward_hook(self._temporal_argmax)
            elif isinstance(mod, (CSN, CSNBottleneck)):
                # one ReLU module per block, called three times
                mod.relu.register_forward_hook(self._relu)
                if isinstance(mod, CSN):
                    mod.maxpool.register_forward_hook(self._pool_argmax)
            elif isinstance(mod, MLP):
                for layer in mod.layers[:-1]:
                    layer.register_forward_hook(self._relu)
            elif name.endswith(("linear1", "linear1_")):
                mod.register_forward_hook(self._relu)

    def _shapes(self, _mod, args):
        self.level_shapes = args[2]

    def _exact_shapes(self, _mod, args):
        self.level_shapes = args[3]

    def _floor_sides(self, loc):
        """Per sampling coordinate [B, Q, H, L, P, 3] (x, y, t), the floor
        of loc * size - 0.5 as the sampler computes it (clamped to [-2,
        size]: farther out every side is alike) and the side of the drop
        guard's -1."""
        size = torch.tensor([[w, h, t] for t, h, w in self.level_shapes],
                            dtype=torch.float32)[:, None, :]  # [L, 1, 3]
        p = loc.detach().float().cpu() * size - 0.5
        fl = torch.minimum(torch.floor(p).clamp(min=-2.0), size)
        return (fl * 2 + (p > -1.0)).to(torch.int16)

    def _relu(self, _mod, _inp, out):
        self._keep(out, (out.detach() > 0).cpu(), "ReLU")

    def _argmax(self, _mod, inp, out):
        b, t, h, w, c = inp[0].shape
        win = inp[0].detach()[:, :, :h // 2 * 2, :w // 2 * 2].reshape(
            b, t, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 6, 3, 5)
        self._keep(out, win.reshape(*out.shape, 4).argmax(-1).to(
            torch.int8).cpu(), "max pool")

    def _temporal_argmax(self, _mod, inp, out):
        """VideoMamba's VALID 4x max-pool over T: each window's argmax (the
        first maximum, which takes the gradient)."""
        b, t, h, w, c = inp[0].shape
        win = inp[0].detach()[:, :t // 4 * 4].reshape(b, t // 4, 4, h, w, c)
        self._keep(out, win.argmax(2).to(torch.int8).cpu(), "temporal max pool")

    def _pool_argmax(self, mod, inp, out):
        """CSN's max pool (NCDHW): each window's argmax where its max is
        positive (an all-zero window of ReLU outputs passes no gradient
        back through the ReLU, whichever element it picks)."""
        _, idx = F.max_pool3d(inp[0].detach(), mod.kernel_size, mod.stride,
                              mod.padding, return_indices=True)
        self._keep(out, torch.where(out.detach() > 0, idx, -1).to(
            torch.int32).cpu(), "max pool")

    def _keep(self, out, side, kind):
        if not out.requires_grad:      # a frozen stage: no gradient to mask
            return
        i = len(self.sides)
        self.sides.append(side)
        self.kinds.append(kind)
        self.numel += side.numel()
        out.register_hook(lambda g: g.masked_fill(
            self.masks[i].to(g.device), 0) if self.active else g)

    def _lane_sides(self, attn, lanes):
        """Per offset lane, where each of its taps' hat arguments lies
        against the hat's kinks (0 on the weight lanes)."""
        from class_query_vad_tpu_torch.ops.fast_deform import native_phase

        nl, nc = attn.n_levels, attn.nc
        kp = attn.n_heads * attn.n_points
        x = torch.tanh(lanes.detach().float().cpu()[..., :nl * nc * kp])
        side = torch.zeros(lanes.shape, dtype=torch.int16)
        if not attn.native:
            r = attn.radius
            side[..., :nl * nc * kp] = hat_codes(r * x, range(-r, r + 1))
            return side
        start = 0
        for t, h, w in self.level_shapes:         # each query grid
            rows = slice(start, start + t * h * w)
            start += t * h * w
            q = x[:, rows].reshape(x.shape[0], t, h, w, -1)
            s = torch.zeros(q.shape, dtype=torch.int16)
            for j, (_, hv, wv) in enumerate(self.level_shapes):
                for k in range(nc):               # x, y[, t] components
                    jk = slice((nc * j + k) * kp, (nc * j + k + 1) * kp)
                    if k == 2:                    # frames: taps -1, 0, 1
                        s[..., jk] = hat_codes(q[..., jk], (-1, 0, 1))
                        continue
                    ph = torch.from_numpy(native_phase(
                        *((w, wv) if k == 0 else (h, hv)))[1])
                    ph = ph[:, None] if k == 0 else ph[:, None, None]
                    s[..., jk] = hat_codes(q[..., jk] + ph, (-1, 0, 1, 2))
            side[:, rows, :nl * nc * kp] = s.reshape(x.shape[0], t * h * w,
                                                     -1)
        return side

    def match(self, other: "KinkSides") -> dict:
        """Mask, in both, the elements whose sides differ; their count per
        kind of kink."""
        if [x.shape for x in self.sides] != [x.shape for x in other.sides]:
            raise RuntimeError("the two runs hooked different activations")
        self.masks = [a != b for a, b in zip(self.sides, other.sides)]
        other.masks = self.masks
        counts = dict.fromkeys(self.kinds, 0)
        for kind, m in zip(self.kinds, self.masks):
            counts[kind] += int(m.sum())
        return counts


def grad_distances(g_g, g_c):
    """Per parameter tensor, (max|card - CPU| / its limit, name, max|err|,
    limit), farthest first."""
    floor = TRAIN_GRAD_FLOOR * max(g.abs().max().item() for g in g_c.values())
    rows = []
    for k, gc in g_c.items():
        lim = TRAIN_GRAD_TOL * gc.abs().max().item() + floor
        err = (g_g[k] - gc).abs().max().item()
        rows.append((err / lim, k, err, lim))
    return sorted(rows, reverse=True)


def phase_train_card_vs_cpu(dev, opts=(), tag: str = "", counters=(),
                            expected=None, config: str = CONFIG,
                            unmatched_too: bool = False):
    """One float32 train step of ``config`` (with ``opts``) on the card and
    on the CPU, same weights and batch, dropout off; on the card the
    ``counters`` must move by ``expected`` launches.  With
    ``unmatched_too`` both sides also run the backward without the kink
    matching, whose farthest gradient is printed and not checked."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    cfg = get_cfg_custom(config, ["CONFIG.MODEL.FAST_DTYPE", "float32",
                                  "CONFIG.MODEL.DECODER_DTYPE", "float32",
                                  *opts])
    cfg.CONFIG.MODEL.DROPOUT = 0.0
    cfg.CONFIG.ViT.DROP_PATH_RATE = 0.0
    m_cpu = build_model(cfg, torch.float32, "cpu",
                        torch.Generator().manual_seed(7))
    randomize_constants(m_cpu, torch.Generator().manual_seed(8))
    m_gpu = build_model(cfg, torch.float32, dev)
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    batch = train_batch(cfg, seed=2)
    # both forwards first, then both backwards with the kink sides matched
    fwd, secs = {}, {}
    counts = [c.launches for c in counters]
    for name, model, d in (("card", m_gpu, dev), ("CPU", m_cpu, "cpu")):
        model.head_dropout.p = 0.0           # the class head's fixed 0.5
        sides = KinkSides()
        sides.watch(model)
        trainer = Trainer(model, cfg, device=d)
        t0 = time.perf_counter()
        fwd[name] = (*trainer.loss(
            {k: torch.as_tensor(v).to(d) for k, v in batch.items()}), sides)
        secs[name] = time.perf_counter() - t0
    masked = fwd["card"][3].match(fwd["CPU"][3])
    share = sum(masked.values()) / fwd["CPU"][3].numel
    print(f"{tag}activations whose card and CPU sides of a kink differ: "
          f"{masked} of {fwd['CPU'][3].numel} ({share:.1e}, limit "
          f"{KINK_SHARE:.0e}); their gradients are zeroed on both sides")
    check(share <= KINK_SHARE, f"{tag}the card's and the CPU's forwards "
                               f"differ in {share:.1e} of the kink sides")
    res = {}
    for name, model in (("card", m_gpu), ("CPU", m_cpu)):
        total, losses, match, sides = fwd[name]
        t0 = time.perf_counter()
        sides.active = True
        total.backward(retain_graph=unmatched_too)
        if name == "card":
            torch.cuda.synchronize()
            moved = {c.__name__: c.launches - n
                     for c, n in zip(counters, counts)}
            check(expected is None or moved == expected,
                  f"{tag}card train step launches {moved}, expected "
                  f"{expected}")
        print(f"{tag}{name} float32 train step (loss + backward), "
              f"{cfg.CONFIG.MODEL.ENC_LAYERS} encoder layers: "
              f"{secs[name] + time.perf_counter() - t0:.1f} s")
        res[name] = (total.item(), {k: v.item() for k, v in losses.items()},
                     match, {k: p.grad.float().cpu()
                             for k, p in model.named_parameters()
                             if p.requires_grad})
    (t_g, l_g, m_g, g_g), (t_c, l_c, m_c, g_c) = res["card"], res["CPU"]
    if unmatched_too:
        plain = {}
        for name, model in (("card", m_gpu), ("CPU", m_cpu)):
            model.zero_grad(set_to_none=True)
            fwd[name][3].active = False
            fwd[name][0].backward()
            plain[name] = {k: p.grad.float().cpu()
                           for k, p in model.named_parameters()
                           if p.requires_grad}
        far = grad_distances(plain["card"], plain["CPU"])[0]
        print(f"{tag}without the kink matching (not checked), the farthest "
              f"gradient would be {far[1]} at {far[0]:.1%} of its limit")
    ok = m_c.match_ok
    same = (torch.equal(ok, m_g.match_ok.cpu())
            and torch.equal(m_c.gt_idx[ok], m_g.gt_idx.cpu()[ok]))
    print(f"{tag}matcher assignment (last layer; query -> gt slot, -1 = none): "
          f"card {torch.where(m_g.match_ok, m_g.gt_idx, -1)[-1].tolist()}, "
          f"CPU {torch.where(ok, m_c.gt_idx, -1)[-1].tolist()} -> "
          f"{'same' if same else 'DIFFERENT'} over all "
          f"{m_c.gt_idx.shape[0]} layers")
    check(same, f"{tag}card and CPU matchers disagree")
    e = abs(t_g - t_c) / abs(t_c)
    print(f"{tag}train loss card {t_g:.7f} vs CPU {t_c:.7f}: rel err {e:.2e} "
          f"(tol {TRAIN_LOSS_TOL:.0e}); losses {l_g}")
    check(e <= TRAIN_LOSS_TOL, f"{tag}card and CPU train losses disagree")
    for k, gg in g_g.items():
        check(bool(torch.isfinite(gg).all()), f"card gradient of {k} not finite")
    rows = grad_distances(g_g, g_c)
    for ratio, k, err, lim in rows:
        check(ratio <= 1, f"{tag}card and CPU gradients of {k} disagree: "
                          f"max|err| {err:.3e} > {lim:.3e}")
    print(f"{tag}gradients of all {len(g_c)} parameter tensors agree (tol "
          f"{TRAIN_GRAD_TOL:.0e} x max|grad| + {TRAIN_GRAD_FLOOR:.0e} x the "
          f"model's max|grad|); closest to its limit: {rows[0][1]} at "
          f"{rows[0][0]:.1%} of it")


# K5 at the VSS path's shapes (B, KD, L, N, G): the backbone's scans (24
# BiMamba blocks x 2 directions per forward) and the encoder's (6 layers x
# 2 time directions x 4 frames), and an awkward shape
K5_BACKBONE = (2, 384, 5121, 16, 1)
K5_ENCODER = (2, 1024, 320, 4, 4)
K5_AWKWARD = (1, 96, 37, 8, 2)
K5_PER_FORWARD = {K5_BACKBONE: 48, K5_ENCODER: 48}
# float32: the same arithmetic in other orders (fused multiply-adds, the
# state sum split over threads); the recurrence carries a last-bit
# difference over ~1 / (1 - exp(delta A)) steps (~1000 at the dt init).
# bf16: y is rounded to bf16 on both sides (one ulp, 2^-8 of |y|)
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SFU_RATE = 132 * 16 * 1.98e9     # H100 SXM: exps per second (16/clk/SM)
# the times of K1's, K2's, K3's, K4's, K5's, K6's, K8's, K9's, K10's and
# K11's versions before their redesign (K5 sequential over L; the others a
# warp per query or output gathering every tap or rebuilding every mass),
# bf16, printed beside this run's (NVIDIA H100 80GB HBM3, 700 W, the last
# call of chip_smoke.py with those sources; K1's and K2's from the first
# call of ``compare_k1_k2``): K5 per scan shape and per VSS forward,
# K1 / K2 (P = 8 and 4) / K3 / K4 / K6 / K8 / K9 / K10 / K11 per encoder
# layer, K6 in K7's regime at its one grid, and K1's whole backward per
# encoder layer (the recompute's eager ops, K3, K4) beside the first K3
# and K4
EARLIER_MS = {K5_BACKBONE: 0.4360, K5_ENCODER: 0.0354, "K5": 22.626,
              "K10": 0.1592, "K11": 1.5505, "K6": 0.7099, "K8": 1.1192,
              "K9": 0.6466, "K7 regime": 1.0617, "K3": 0.1076, "K4": 0.0996,
              "K1 backward": 4.9334, "K1": 0.1111, "K2": 0.0642,
              "K2 P=4": 0.0602}
# K1's, K2's, K3's, K4's, K9's and K10's first versions per query grid
# (64x80 .. 8x10), bf16: the mean of two turns each in one call of
# ``class_query_vad_tpu_torch.scripts.compare_k1_k2`` (K1, K2),
# ``compare_k3_k4`` (K3, K4) or ``compare_k9_k10`` (K9, K10) against those
# sources (NVIDIA H100 80GB HBM3, 700 W)
EARLIER_GRID_MS = {"K1": (0.0683, 0.0198, 0.0130, 0.0101),
                   "K2": (0.0322, 0.0126, 0.0104, 0.0090),
                   "K2 P=4": (0.0292, 0.0118, 0.0104, 0.0088),
                   "K3": (0.0712, 0.0218, 0.0092, 0.0063),
                   "K4": (0.0655, 0.0186, 0.0090, 0.0083),
                   "K9": (0.4504, 0.1243, 0.0438, 0.0279),
                   "K10": (0.0930, 0.0307, 0.0185, 0.0169)}


def earlier_key(k: str, points: int = K1_KP // 8) -> str:
    """The ``EARLIER_MS`` / ``EARLIER_GRID_MS`` key of kernel ``k`` at
    ``points`` per head (the main path's 8 unsuffixed)."""
    return k if points == K1_KP // 8 else f"{k} P={points}"


def earlier_at(k: str, grid, points: int = K1_KP // 8) -> str:
    """`` (earlier version x ms)`` for kernel ``k`` at one of the four
    query grids, where it is known."""
    k = earlier_key(k, points)
    if k not in EARLIER_GRID_MS or tuple(grid) not in K1_LEVELS:
        return ""
    return (f" (earlier version "
            f"{EARLIER_GRID_MS[k][K1_LEVELS.index(tuple(grid))]:.4f} ms)")


def k5_work(b, kd, length, ns, g, itemsize):
    """(bytes, operations, exps) one K5 launch must spend: u, delta (float32),
    B, C read once and y written once; per (b, d, l): delta + bias,
    softplus (~6), delta * u, D * u + y; per state: delta * A, exp, the
    update (multiply-add + multiply) and C * h (multiply-add)."""
    steps = b * kd * length
    nbytes = (steps * (2 * itemsize + 4)
              + 2 * b * g * ns * length * itemsize)
    return nbytes, steps * (10 + 7 * ns), steps * ns


def scan_inputs(rng, shape, dtype, dev):
    """Inputs of one K5 launch laid out as the VSS path hands them over:
    the backbone's u [B, KD, L] contiguous (the conv's output), delta a
    transposed view of [B, L, KD] and B, C views of the x_proj output
    [B, L, R + 2N]; the encoder's delta contiguous and B, C slices of
    [B, K, R + 2N, L].  delta ~ N(0, 0.5) plus the dt init's bias, A and D
    at the init (A = -(1..N), D = 1)."""
    b, kd, length, ns, g = shape
    f = lambda *sz: torch.from_numpy(
        rng.standard_normal(sz).astype(np.float32)).to(dev)
    u = f(b, kd, length).to(dtype)
    if g == 1:
        delta = (0.5 * f(b, length, kd)).transpose(1, 2)
        dbl = f(b, length, 12 + 2 * ns).to(dtype)
        bm = dbl[..., 12:12 + ns].transpose(1, 2)[:, None]
        cm = dbl[..., 12 + ns:].transpose(1, 2)[:, None]
    else:
        delta = 0.5 * f(b, kd, length)
        dbl = f(b, g, 8 + 2 * ns, length).to(dtype)
        bm, cm = dbl[:, :, 8:8 + ns], dbl[:, :, 8 + ns:]
    a = -torch.arange(1.0, ns + 1, device=dev).repeat(kd, 1)
    dt = torch.exp(torch.from_numpy(rng.uniform(
        np.log(1e-3), np.log(0.1), kd).astype(np.float32))).to(dev)
    bias = dt + torch.log(-torch.expm1(-dt))
    return u, delta, a, bm, cm, torch.ones(kd, device=dev), bias


def phase_scan_kernel(dev, bw, peak):
    from class_query_vad_tpu_torch.ops.selective_scan import (
        selective_scan, selective_scan_reference)

    rng = np.random.default_rng(5)
    max_err = 0.0
    per_shape = {}
    cases = [(K5_BACKBONE, torch.bfloat16, "all"), (K5_BACKBONE, torch.float32, "all"),
             (K5_ENCODER, torch.float32, "all"), (K5_ENCODER, torch.float32, "none"),
             (K5_AWKWARD, torch.float32, "all"), (K5_AWKWARD, torch.float32, "none"),
             (K5_AWKWARD, torch.float32, "softplus"),
             (K5_AWKWARD, torch.bfloat16, "skip+bias")]
    for shape, dtype, flags in cases:
        u, delta, a, bm, cm, d, bias = scan_inputs(rng, shape, dtype, dev)
        kw = dict(D=d, delta_bias=bias, delta_softplus=True)
        if flags == "none":
            kw, delta = dict(D=None, delta_bias=None, delta_softplus=False), delta.abs()
        elif flags == "softplus":
            kw = dict(D=None, delta_bias=None, delta_softplus=True)
        elif flags == "skip+bias":
            kw, delta = dict(D=d, delta_bias=bias.abs(), delta_softplus=False), delta.abs()
        with torch.inference_mode():
            got, last = selective_scan(u, delta, a, bm, cm, return_last_state=True, **kw)
            want, last_p = selective_scan_reference(u, delta, a, bm, cm,
                                                    return_last_state=True, **kw)
        torch.cuda.synchronize()
        check(got.dtype == u.dtype and got.shape == u.shape,
              f"K5 output {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "K5 output not finite")
        err, rel = rel_err(got, want)
        _, rel_last = rel_err(last, last_p)
        ok = max(rel, rel_last) <= K5_TOL[dtype]
        print(f"K5 {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):16s} "
              f"{flags:9s}: max|err| = {rel:.2e} x max|y|, last state "
              f"{rel_last:.2e} (tol {K5_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"K5 disagrees with its plain version at {shape} {dtype} {flags}")
        max_err = max(max_err, err)
        main_dtype = torch.bfloat16 if shape == K5_BACKBONE else torch.float32
        if shape in K5_PER_FORWARD and dtype == main_dtype and flags == "all":
            call = lambda: selective_scan(u, delta, a, bm, cm, **kw)
            with torch.inference_mode():
                t_k = kernel_device_ms(call)
                t_p = cuda_ms(lambda: selective_scan_reference(
                    u, delta, a, bm, cm, **kw), 2, 1)
            nbytes, ops, exps = k5_work(*shape, u.element_size())
            t_b = max(nbytes / bw, ops / peak) * 1e3
            per_shape[shape] = (t_k, t_p, t_b,
                                "bytes" if nbytes / bw >= ops / peak else "operations")
            print(f"K5 {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):16s}: "
                  f"kernel {t_k:.4f} ms (device, queued; three CUDA kernels, "
                  f"earlier version {EARLIER_MS[shape]:.4f} ms), plain {t_p:.2f} ms, "
                  f"bound {t_b:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.3f} GFLOP; the {exps / 1e6:.1f} M exps alone "
                  f"{exps / SFU_RATE * 1e3:.4f} ms at the SFU rate) -> kernel at "
                  f"{t_b / t_k:.1%} of the bound's speed")
    ms = sum(n * per_shape[s][0] for s, n in K5_PER_FORWARD.items())
    plain_ms = sum(n * per_shape[s][1] for s, n in K5_PER_FORWARD.items())
    bound_ms = sum(n * per_shape[s][2] for s, n in K5_PER_FORWARD.items())
    bound_by = {}
    for s_, n_ in K5_PER_FORWARD.items():
        bound_by[per_shape[s_][3]] = bound_by.get(per_shape[s_][3], 0.0) + n_ * per_shape[s_][2]
    print(f"K5 per VSS forward (48 backbone + 48 encoder launches): kernel "
          f"{ms:.3f} ms (earlier version {EARLIER_MS['K5']:.3f} ms), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms")
    return {
        "name": "selective_scan", "route": "cuda",
        "source": "class_query_vad_tpu_torch/csrc/selective_scan.cu",
        "replaces": "class_query_vad_tpu/ops/selective_scan_pallas.py:37",
        "launches": None, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": max(bound_by, key=bound_by.get), "library_ms": None,
    }


# K5's backward at the train path's scans (B=1): per VSS train step the
# backbone's 48 and the encoder's 48, as in the forward
K5_TRAIN_BACKBONE = (1, 384, 5121, 16, 1)
K5_TRAIN_ENCODER = (1, 1024, 320, 4, 4)
K5_BWD_PER_STEP = {K5_TRAIN_BACKBONE: 48, K5_TRAIN_ENCODER: 48}
# K5's backward before its redesign (five CUDA kernels per call) per train
# scan and per VSS train step, from a whole call of this script with those
# sources (NVIDIA H100 80GB HBM3, 700 W)
EARLIER_MS.update({("bwd", K5_TRAIN_BACKBONE): 0.3520, ("bwd", K5_TRAIN_ENCODER): 0.0391,
                   "K5 backward": 18.771})
# dA, dD and d delta_bias sum B x L terms (5121 at the backbone) in other
# orders: 1e-3 of their max; every other gradient K5_TOL
K5_SUM_TOL = 1e-3
K5_GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "d delta_bias")


def k5_bwd_work(b, kd, length, ns, g, itemsize):
    """(bytes, operations, exps) one call of K5's backward must spend: u,
    delta (float32), dy, B, C read once, du, ddelta (float32), dB, dC
    written once (the carries, A, D, the bias and their gradients are
    ~1/L of that); per (b, d, l): the softplus and its sigmoid (~12); per
    state: exp(delta A) once (the state's recurrence and the adjoint's
    share it), the state's update (2), the adjoint (2) and the terms of
    du, ddelta, dB, dC and dA (~12)."""
    steps = b * kd * length
    nbytes = steps * (3 * itemsize + 8) + 4 * b * g * ns * length * itemsize
    return nbytes, steps * (12 + 16 * ns), steps * ns


def device_ops(fn, tries: int = 3) -> dict:
    """{name: count} of the profiler's device rows (kernels and memsets) in
    one call of ``fn``, after a warm-up call; a trace that comes back
    without device rows (it has on this card) is taken again, up to
    ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.key != "Activity Buffer Request"}
        if rows:
            break
    return rows


def phase_scan_bwd_kernel(dev, bw, peak):
    """Phase 38: K5's backward against its plain version at the train
    path's shapes and strides, ``K5_AWKWARD`` and phase 7's flag sets, dy
    random in y's dtype; device times beside the bound and the plain
    version's.  Returns the kernel's entry of the JSON line (launches
    filled in by phase 39)."""
    from class_query_vad_tpu_torch.ops.selective_scan import (
        _bwd_scratch, scan_carries, scan_chunk, selective_scan_bwd,
        selective_scan_bwd_reference)

    rng = np.random.default_rng(15)
    max_err = 0.0
    per_shape = {}
    cases = [(K5_TRAIN_BACKBONE, torch.bfloat16, "all"),
             (K5_TRAIN_ENCODER, torch.float32, "all"),
             (K5_TRAIN_ENCODER, torch.float32, "none"),
             (K5_AWKWARD, torch.float32, "all"), (K5_AWKWARD, torch.float32, "none"),
             (K5_AWKWARD, torch.float32, "softplus"),
             (K5_AWKWARD, torch.bfloat16, "skip+bias")]
    for shape, dtype, flags in cases:
        u, delta, a, bm, cm, d, bias = scan_inputs(rng, shape, dtype, dev)
        kw = dict(D=d, delta_bias=bias, delta_softplus=True)
        if flags == "none":
            kw, delta = dict(D=None, delta_bias=None, delta_softplus=False), delta.abs()
        elif flags == "softplus":
            kw = dict(D=None, delta_bias=None, delta_softplus=True)
        elif flags == "skip+bias":
            kw, delta = dict(D=d, delta_bias=bias.abs(), delta_softplus=False), delta.abs()
        dy = torch.from_numpy(rng.standard_normal(u.shape).astype(np.float32)
                              ).to(dev).to(dtype)
        carries = scan_carries(u, delta, a, bm, cm, **kw)
        got = selective_scan_bwd(u, delta, a, bm, cm, dy, carries=carries, **kw)
        want = selective_scan_bwd_reference(u, delta, a, bm, cm, dy, **kw)
        torch.cuda.synchronize()
        rels = []
        for name, x, r in zip(K5_GRADS, got, want):
            check((x is None) == (r is None), f"K5 backward {name}: None mismatch")
            if x is None:
                continue
            check(x.dtype == r.dtype and x.shape == r.shape,
                  f"K5 backward {name} {x.dtype} {tuple(x.shape)}")
            check(bool(torch.isfinite(x).all()), f"K5 backward {name} not finite")
            err, rel = rel_err(x, r)
            tol = K5_SUM_TOL if name in ("dA", "dD", "d delta_bias") else K5_TOL[dtype]
            rels.append(f"{name} {rel:.1e}")
            check(rel <= tol, f"K5 backward {name} disagrees with its plain "
                              f"version at {shape} {dtype} {flags}: {rel:.2e} "
                              f"x max|ref| > {tol:.0e}")
            max_err = max(max_err, err)
        print(f"K5 backward {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):16s} "
              f"{flags:9s}: max|err| x max|ref|: {', '.join(rels)} (tol "
              f"{K5_TOL[dtype]:.0e}, sums over L {K5_SUM_TOL:.0e}) ok")
        main_dtype = torch.bfloat16 if shape == K5_TRAIN_BACKBONE else torch.float32
        if shape in K5_BWD_PER_STEP and dtype == main_dtype and flags == "all":
            call = lambda: selective_scan_bwd(u, delta, a, bm, cm, dy,
                                              carries=carries, **kw)
            again = call()
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again) if x is not None),
                  f"K5 backward: two calls at {shape} differ")
            rows = device_ops(call)
            kernels = {k: n for k, n in rows.items() if "memset" not in k.lower()}
            memsets = sum(rows.values()) - sum(kernels.values())
            b_, kd_, l_, n_, g_ = shape
            scratch = 4 * _bwd_scratch(b_, kd_, l_, g_, n_, scan_chunk(b_, kd_, l_, g_))
            print(f"K5 backward {'x'.join(map(str, shape))}: two calls equal bit "
                  f"for bit; one call's device rows: {sum(kernels.values())} CUDA "
                  f"kernel(s) {sorted(k.split('::', 1)[-1].split('(')[0] for k in kernels)} "
                  f"and {memsets} memset(s); scratch "
                  f"{scratch / 1e6:.2f} MB")
            check(sum(rows.values()) <= 3,
                  f"K5 backward: {sum(rows.values())} device operations per call")
            t_k = kernel_device_ms(call)
            t_p = cuda_ms(lambda: selective_scan_bwd_reference(
                u, delta, a, bm, cm, dy, **kw), 2, 1)
            nbytes, ops, exps = k5_bwd_work(*shape, u.element_size())
            t_b = max(nbytes / bw, ops / peak) * 1e3
            per_shape[shape] = (t_k, t_p, t_b,
                                "bytes" if nbytes / bw >= ops / peak else "operations")
            print(f"K5 backward {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):16s}: "
                  f"kernel {t_k:.4f} ms (device, queued; a memset and one CUDA "
                  f"kernel; the five-kernel version {EARLIER_MS[('bwd', shape)]:.4f} ms), "
                  f"plain {t_p:.2f} ms, bound {t_b:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP; the "
                  f"{exps / 1e6:.1f} M exps alone {exps / SFU_RATE * 1e3:.4f} ms "
                  f"at the SFU rate) -> kernel at {t_b / t_k:.1%} of the "
                  f"bound's speed")
    total = lambda i: sum(n * per_shape[s][i] for s, n in K5_BWD_PER_STEP.items())
    bound_by = {}
    for s_, n_ in K5_BWD_PER_STEP.items():
        bound_by[per_shape[s_][3]] = bound_by.get(per_shape[s_][3], 0.0) + n_ * per_shape[s_][2]
    print(f"K5 backward per VSS train step (48 backbone + 48 encoder "
          f"launches): kernel {total(0):.3f} ms (the five-kernel version's "
          f"{EARLIER_MS['K5 backward']:.3f} ms), plain {total(1):.1f} ms, "
          f"bound {total(2):.4f} ms")
    return {
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "class_query_vad_tpu_torch/csrc/selective_scan_bwd.cu",
        "replaces": "class_query_vad_tpu/ops/selective_scan_pallas.py:200",
        "launches": None, "max_abs_err": max_err, "ms": total(0),
        "plain_ms": total(1), "bound_ms": total(2),
        "bound_by": max(bound_by, key=bound_by.get), "library_ms": None,
    }


def phase_vss_main_path(dev, counters):
    """The VSS eval path at full width in bf16: 3 requests, 96 K5 launches
    per forward, timings."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    cfg = get_cfg_custom(VSS_CONFIG)
    t0 = time.perf_counter()
    model = build_model(cfg, dtype=torch.bfloat16)
    randomize_constants(model, torch.Generator().manual_seed(4))
    torch.cuda.synchronize()
    print(f"VSS build_model (bf16, seeded init on the host): "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params")
    requests = [make_request(seed) for seed in (4, 5, 6)]
    for c in counters:
        c.launches = 0
    for i, (pixels, mask) in enumerate(requests):
        out, (scores, boxes, actor) = serve(model, pixels, mask, dev)
        torch.cuda.synchronize()
        for name, x, shape in (("scores", scores, (2, 15, 80)),
                               ("boxes", boxes, (2, 15, 4)),
                               ("actorness", actor, (2, 15, 1))):
            check(tuple(x.shape) == shape, f"VSS {name} shape {tuple(x.shape)}")
            check(bool(torch.isfinite(x).all()), f"VSS {name} not finite")
        print(f"VSS request {i}: scores {tuple(scores.shape)} boxes "
              f"{tuple(boxes.shape)} actorness {tuple(actor.shape)}, finite; "
              f"top score {scores.max().item():.4f}")
    launches = {c.__name__: c.launches for c in counters}
    print(f"VSS kernel launches over {len(requests)} requests: {launches}")
    check(launches == {**{k: 0 for k in launches},
                       "selective_scan": 96 * len(requests)},
          f"VSS eval launches {launches}, expected K5 alone, 96 per forward")

    pixels, mask = requests[0]
    for _ in range(2):
        serve(model, pixels, mask, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        serve(model, pixels, mask, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    print(f"full-width VSS eval, B=2 bf16, forward + postprocess, host->device "
          f"copy included: median {med:.2f} ms/batch ({2e3 / med:.2f} "
          f"clips/s) over {len(times)} iterations; min {min(times):.2f}, "
          f"max {max(times):.2f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stage_breakdown(model, pixels, mask, dev, med, 3,
                    {"selective_scan": 96}, "VSS ")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_vss_card_vs_cpu(dev):
    """The VSS model in float32, B=1, VideoMamba at
    ``MAMBA_FWD_CPU_DEPTH`` blocks: K5 on the card, the plain scan on the
    CPU, same weights and input."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    cfg = get_cfg_custom(VSS_CONFIG)
    with videomamba_depth(MAMBA_FWD_CPU_DEPTH):
        m_cpu = build_model(cfg, torch.float32, "cpu",
                            torch.Generator().manual_seed(9))
        m_gpu = build_model(cfg, torch.float32, dev)
    randomize_constants(m_cpu, torch.Generator().manual_seed(10))
    m_gpu.load_state_dict(m_cpu.state_dict(), strict=True)
    pixels, mask = make_request(12, b=1)
    out_g, _ = serve(m_gpu, pixels, mask, dev)
    torch.cuda.synchronize()
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    out_c, _ = serve(m_cpu, pixels, mask, "cpu")
    print(f"VSS CPU float32 forward (plain scan), {MAMBA_FWD_CPU_DEPTH} of "
          f"VideoMamba's 24 blocks: {time.perf_counter() - t0:.1f} s")
    for k in ("pred_logits", "pred_boxes", "pred_logits_b"):
        g, c = out_g[k].float().cpu(), out_c[k].float()
        err = (g - c).abs().max().item()
        scale = c.abs().max().item()
        ok = bool(torch.isfinite(g).all()) and err <= VSS_MODEL_TOL * scale
        print(f"VSS fp32 card vs CPU {k:14s}: max|err| {err:.3e} = "
              f"{err / scale:.2e} x max|ref| (tol {VSS_MODEL_TOL:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"VSS card and CPU disagree on {k}")


# phase 9: float32 on both sides; bidirectional 5121-step scans and 6
# encoder layers summed in other orders (cuBLAS / cuDNN and K5's fused
# multiply-adds vs the CPU's kernels and the plain loop)
VSS_MODEL_TOL = 2e-3
# the float32 card-vs-CPU forwards of the Mamba family (phases 9 and 30)
# run ``MAMBA_FWD_CPU_DEPTH`` of VideoMamba's 24 blocks (every block until
# phases 38-40 came: the plain scans' 5121-step loops set the
# CPU's time, 22.4 s for VSS and 22.6 s for VideoMamba + exact, the
# latter's exact encoder at 6 layers, now ``EXACT_FWD_CPU_LAYERS``)
MAMBA_FWD_CPU_DEPTH = 6


@contextlib.contextmanager
def videomamba_depth(depth: int):
    """Build VideoMamba-tiny with ``depth`` of its 24 blocks (its widths
    and sequence whole) inside the block, for a card-vs-CPU check."""
    from unittest import mock

    from class_query_vad_tpu_torch.models import videomamba

    spec = dict(videomamba.VIDEOMAMBA_SPECS["videomamba_tiny"], depth=depth)
    with mock.patch.dict(videomamba.VIDEOMAMBA_SPECS, {"videomamba_tiny": spec}):
        yield


# K10 / K11 at the native mode's shapes: four query grids per encoder layer,
# each over the four FPN levels at their own resolution, B=2; the 2d window
# runs on the centre-frame slice's 2 frames, the 3d window on all 8
NATIVE_GRIDS = K1_LEVELS
NATIVE_T = {"K10": 2, "K11": 8}
# what each kernel's block does (the kernels line names it); one kernel,
# templated on the temporal taps
NATIVE_DESIGN = {
    k: f"8x8 query tile x 32 channels x one frame per block: value windows "
       f"of {n} frame{'s' * (n > 1)} in shared memory (cp.async, "
       f"double-buffered over levels), a [tap][query] mass table of "
       f"{16 * n} taps, finer levels gathered"
    for k, n in (("K10", 1), ("K11", 3))}
# an awkward grid: 12x20 queries (not a multiple of 8), levels at ratios 1,
# 2 and 4 and one finer level (24x40), T=3
NATIVE_AWKWARD = ((12, 20), [(12, 20), (6, 10), (3, 5), (24, 40)], 3)
# float32: the same taps summed in another order; bf16: both sides read the
# same bf16 values and offsets and sum in float32 (no rounding of the
# masses), so only the order differs there too, and a kernel that rounded
# the masses to bf16 would fail
NATIVE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
# the grid_sample composition against the plain version (float32)
LIBRARY_TOL = 1e-4


def native_inputs(rng, b, t, grid, vshapes, nc, dtype, dev):
    """Value levels as views of one flat token stream [B, N, C] (as the
    encoder's ``split_levels`` hands them over: dense past the batch axis),
    offsets dx, dy, (dt) in (-1, 1) with a fifth of them exactly on the tie
    points -1, -0.5, 0, 0.5, 1 (tanh saturates at 1 in bf16), weights a in
    [0, 0.3), each [B, J, T, H, W, 64]."""
    jl, (h, w) = len(vshapes), grid
    n = sum(t * hv * wv for hv, wv in vshapes)
    flat = torch.from_numpy(rng.standard_normal(
        (b, n, K1_C), np.float32)).to(dev, dtype)
    values, start = [], 0
    for hv, wv in vshapes:
        values.append(flat[:, start:start + t * hv * wv].reshape(
            b, t, hv, wv, K1_C))
        start += t * hv * wv
    shape = (b, jl, t, h, w, K1_KP)
    comps = []
    for _ in range(nc):
        x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        pick = rng.random(shape) < 0.2
        x[pick] = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], shape)[pick]
        comps.append(x)
    comps.append(rng.uniform(0.0, 0.3, shape).astype(np.float32))
    return values, [torch.from_numpy(x).to(dev, dtype) for x in comps]


def native_work(values, comps, itemsize: int, nh: int = 8):
    """(bytes, operations) one launch of K10 / K11 must spend on these
    inputs: every value level, the components and the tables read once,
    the float32 output written once; per (query, level, head, point) the
    hats and the tap masses (3 ops a hat, 2 a mass term), and per (query,
    level, head) tap that is in range and carries mass in that head, C/nh
    multiply-adds.  The taps are counted from this run's data."""
    from class_query_vad_tpu_torch.ops.blend2d import hat
    from class_query_vad_tpu_torch.ops.fast_deform import native_tables_on

    dx, dy, a = comps[0], comps[1], comps[-1]
    dt = comps[2] if len(comps) == 4 else None
    b, jl, t, h, w, kp = dx.shape
    tt = 1 if dt is None else 3
    base, phi = native_tables_on(h, w, tuple(v.shape[2:4] for v in values),
                                 dx.device)
    s4 = torch.arange(-1, 3, device=dx.device, dtype=torch.float32)
    s3 = torch.arange(-1, 2, device=dx.device, dtype=torch.float32)
    head_taps = 0
    for j, v in enumerate(values):
        hv, wv = v.shape[2:4]
        by, bx = base[j, 2:2 + h].long(), base[j, 2 + h:].long()
        u = dx[:, j].float() + phi[j, h:][None, None, None, :, None]
        vv = dy[:, j].float() + phi[j, :h][None, None, :, None, None]
        hx = hat(u[..., None] - s4)                         # [.., kp, 4]
        hy = hat(vv[..., None] - s4)
        at = a[:, j].float()[..., None]                     # [.., kp, 1]
        if dt is not None:
            at = at * hat(dt[:, j].float()[..., None] - s3)  # [.., kp, 3]
        m = (at[..., :, None, None] * hy[..., None, :, None]
             * hx[..., None, None, :])                     # [.., kp, tt, 4, 4]
        live = (m.reshape(b, t, h, w, nh, kp // nh, tt, 4, 4).sum(5)
                != 0)                                      # [b,t,h,w,nh,tt,4,4]
        ok_y = ((by[:, None] + s4.long() >= 0)
                & (by[:, None] + s4.long() < hv))           # [h, 4]
        ok_x = ((bx[:, None] + s4.long() >= 0)
                & (bx[:, None] + s4.long() < wv))           # [w, 4]
        tq = torch.arange(t, device=dx.device)[:, None] + (
            s3.long() if dt is not None else torch.zeros(1, dtype=torch.long,
                                                         device=dx.device))
        ok_t = (tq >= 0) & (tq < t)                         # [t, tt]
        ok = (ok_t[None, :, None, None, None, :, None, None]
              & ok_y[None, None, :, None, None, None, :, None]
              & ok_x[None, None, None, :, None, None, None, :])
        head_taps += int((live & ok).sum())
    nbytes = (sum(v.numel() for v in values) * itemsize
              + sum(x.numel() for x in comps) * itemsize
              + base.numel() * 4 + phi.numel() * 4 + b * t * h * w * K1_C * 4)
    ops = head_taps * (K1_C // nh) * 2 + b * jl * t * h * w * kp * (
        3 * (8 + (3 if dt is not None else 0)) + 2 * 16 * tt)
    return nbytes, ops


def native_grid_sample(values, dx, dy, a, nh: int = 8, dt=None):
    """The same function as K10 / K11 composed from ``F.grid_sample``
    (bilinear, or trilinear with ``dt``; align_corners=False; zero padding)
    per level and a weighted sum over the points, in float32: the library
    yardstick.  No path of the port calls it."""
    import torch.nn.functional as F

    from class_query_vad_tpu_torch.ops.fast_deform import native_tables_on

    b, jl, t, h, w, kp = dx.shape
    p = kp // nh
    out = 0
    for j, v in enumerate(values):
        hv, wv, c = v.shape[2], v.shape[3], v.shape[4]
        d = c // nh
        base, phi = native_tables_on(h, w, ((hv, wv),), dx.device)
        py = base[0, 2:2 + h].float() + phi[0, :h]
        px = base[0, 2 + h:].float() + phi[0, h:]
        gx = (2 * (dx[:, j].float() + px[None, None, None, :, None]) + 1) / wv - 1
        gy = (2 * (dy[:, j].float() + py[None, None, :, None, None]) + 1) / hv - 1
        wgt = a[:, j].float().reshape(b, t, h, w, nh, p)
        if dt is None:
            inp = v.float().reshape(b * t, hv, wv, nh, d).permute(
                0, 3, 4, 1, 2).reshape(b * t * nh, d, hv, wv)
            grid = torch.stack([gx, gy], -1).reshape(b, t, h, w, nh, p, 2
                                                     ).permute(0, 1, 4, 2, 3, 5, 6)
            s = F.grid_sample(inp, grid.reshape(b * t * nh, h * w, p, 2),
                              mode="bilinear", padding_mode="zeros",
                              align_corners=False)       # [b*t*nh, d, h*w, p]
            wg = wgt.permute(0, 1, 4, 2, 3, 5).reshape(b * t * nh, 1, h * w, p)
            o = (s * wg).sum(-1).reshape(b, t, nh, d, h, w)
            out = out + o.permute(0, 1, 4, 5, 2, 3).reshape(b, t, h, w, c)
        else:
            tq = torch.arange(t, device=dx.device, dtype=torch.float32)
            gt = (2 * (dt[:, j].float() + tq[None, :, None, None, None]) + 1) / t - 1
            inp = v.float().reshape(b, t, hv, wv, nh, d).permute(
                0, 4, 5, 1, 2, 3).reshape(b * nh, d, t, hv, wv)
            grid = torch.stack([gx, gy, gt], -1).reshape(
                b, t, h, w, nh, p, 3).permute(0, 4, 1, 2, 3, 5, 6)
            s = F.grid_sample(inp, grid.reshape(b * nh, t, h * w, p, 3),
                              mode="bilinear", padding_mode="zeros",
                              align_corners=False)    # [b*nh, d, t, h*w, p]
            wg = wgt.permute(0, 4, 1, 2, 3, 5).reshape(b * nh, 1, t, h * w, p)
            o = (s * wg).sum(-1).reshape(b, nh, d, t, h, w)
            out = out + o.permute(0, 3, 4, 5, 1, 2).reshape(b, t, h, w, c)
    return out


def phase_native_kernels(dev, bw, peak):
    """K10 and K11 against their plain version at the native mode's shapes
    and an awkward one; per-layer times (bf16) beside the bound and the
    grid_sample composition."""
    from class_query_vad_tpu_torch.ops.native_blend import (
        native_blend2d, native_blend3d, native_blend_reference)

    rng = np.random.default_rng(13)
    vshapes = list(NATIVE_GRIDS)
    entries = []
    for k, fn, src_line in (("K10", native_blend2d, 274),
                            ("K11", native_blend3d, 342)):
        nc = 2 if k == "K10" else 3
        cases = [(g, vshapes, NATIVE_T[k]) for g in NATIVE_GRIDS]
        cases.append(NATIVE_AWKWARD)
        num = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "bound_by": {"bytes": 0.0, "operations": 0.0}}
        max_err = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            for grid, vs, t in cases:
                values, comps = native_inputs(rng, 2, t, grid, vs, nc, dtype,
                                              dev)
                dx, dy, a = comps[0], comps[1], comps[-1]
                dt = comps[2] if nc == 3 else None
                kern = lambda: fn(values, *comps)
                plain = lambda: native_blend_reference(values, dx, dy, a, 8, dt)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                      f"{k} output {tuple(got.shape)} not finite or misshaped")
                err, rel = rel_err(got, want)
                ok = rel <= NATIVE_TOL[dtype]
                what = (f"{k} {str(dtype)[6:]:8s} B=2 T={t} {grid[0]:3d}x"
                        f"{grid[1]:<3d} over {len(vs)} native levels "
                        f"{'x'.join(f'{hv}x{wv}' for hv, wv in vs)}")
                print(f"{what}: max|err| {err:.3e} = {rel:.2e} x max|ref| "
                      f"(tol {NATIVE_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
                check(ok, f"{k} disagrees with its plain version: {what}")
                max_err = max(max_err, err)
                if dtype != torch.bfloat16 or grid not in NATIVE_GRIDS:
                    continue
                lib = lambda: native_grid_sample(values, dx, dy, a, 8, dt)
                _, rel_lib = rel_err(lib(), want)
                check(rel_lib <= LIBRARY_TOL,
                      f"the grid_sample composition disagrees: {rel_lib:.2e}")
                t_k = kernel_device_ms(kern)
                t_p = cuda_ms(plain, 2, 1)
                t_l = cuda_ms(lib, 5, 1)
                nbytes, ops = native_work(values, comps, 2)
                t_b = max(nbytes / bw, ops / peak) * 1e3
                num["bound_by"]["bytes" if nbytes / bw >= ops / peak
                                else "operations"] += t_b
                for key, x in (("ms", t_k), ("plain_ms", t_p),
                               ("bound_ms", t_b), ("library_ms", t_l)):
                    num[key] += x
                print(f"{k} bf16     B=2 T={t} {grid[0]:3d}x{grid[1]:<3d}: kernel "
                      f"{t_k:.4f} ms (device, queued){earlier_at(k, grid)}, "
                      f"plain {t_p:.3f} ms, "
                      f"grid_sample composition {t_l:.3f} ms (matches the "
                      f"plain version to {rel_lib:.1e}), bound {t_b:.4f} ms "
                      f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) -> "
                      f"{nbytes / t_k / 1e6:.0f} GB/s, "
                      f"{t_b / t_k:.1%} of the bound's speed")
        print(f"{k} per encoder layer (4 launches, bf16, B=2, T="
              f"{NATIVE_T[k]}): kernel {num['ms']:.4f} ms (earlier version "
              f"{EARLIER_MS[k]:.4f} ms), plain "
              f"{num['plain_ms']:.3f} ms, grid_sample composition "
              f"{num['library_ms']:.3f} ms, bound {num['bound_ms']:.4f} ms "
              f"({num['bound_ms'] / num['ms']:.1%} of the bound's speed)")
        entries.append({
            "name": fn.__name__, "route": "cuda",
            "source": "class_query_vad_tpu_torch/csrc/native_blend.cu",
            "replaces": f"class_query_vad_tpu/ops/fast_deform_pallas.py:{src_line}",
            "launches": None, "max_abs_err": max_err, "ms": num["ms"],
            "plain_ms": num["plain_ms"], "bound_ms": num["bound_ms"],
            "bound_by": max(num["bound_by"], key=num["bound_by"].get),
            "library_ms": num["library_ms"], "design": NATIVE_DESIGN[k],
        })
    return entries


# K6 (serving K7), K8 and K9 at the 3d resample window's shapes: the four
# query grids of one encoder layer, each over the four aligned levels and
# all 8 backbone frames; K6 at the eval batch B=2, K8 / K9 at the train
# batch B=1.  K7's regime: a 128x160 grid at T=8, past K6's VMEM estimate
# on the TPU (``v2_vmem_mb``), where the JAX package takes K7.
B3_T = 8
B3_K7_GRID = (128, 160)
# K6: both sides sum the same values in float32, in bf16 too (the masses
# are not rounded to bf16), so only the order differs; K8 / K9 write bf16
# after sums in another order (one bf16 ulp, 2^-8)
B3_TOL = {"K6": {torch.float32: 1e-5, torch.bfloat16: 1e-5},
          "K8": BLEND_TOL, "K9": BLEND_TOL}
# what each kernel's block does (the kernels line names it)
B3_DESIGN = {
    "K6": "8x8 query tile x one head x 4 frames (2 at small grids) per "
          "block: value windows of 6 frames in shared memory (cp.async, "
          "double-buffered over levels), each window row blended into every "
          "frame it reaches, masses in registers shared by shuffles",
    "K8": "8x8 output tile x one head per block: G window and the halo's "
          "components in shared memory (cp.async), each tap mass built once "
          "into a [level][neighbour][output] table, every level's d vol from "
          "one G load per neighbour",
    "K9": "8x8 query tile x one head x 4 frames (2 at small grids) per "
          "block, as K6: G tile and value windows of 6 frames in shared "
          "memory (cp.async, double-buffered over levels), each window row "
          "dotted with the G of every frame it reaches, a reduce-scatter "
          "over the query's 4 lanes, then each (query, frame) lane's points",
}


def v2_vmem_mb(t, h, w, c, kp, vol_bytes=2, comp_bytes=2):
    """The JAX package's ``_v2_vmem_mb`` (fast_deform_pallas.py:140): K6's
    double-buffered VMEM working set per batch element on the TPU, in MB;
    past 96 MB its ``_blend`` takes K7."""
    vp = 3 * (h + 2) * (w + 2) * c * vol_bytes
    comps = 4 * h * w * kp * comp_bytes
    out = h * w * c * 4
    return (2 * (vp + comps) + 2 * out) / 2 ** 20


def blend3d_work(kernel: str, vol, comps, nh: int = 8):
    """(bytes, operations) one launch of K6, K8 or K9 must spend on these
    inputs: each input read once, each output written once (K6 writes a
    float32 output, K8 dvol like vol, K9 four arrays like the components,
    K8 / K9 read a float32 G); per (query, level, head) tap that is in
    range and live in that head, C/nh multiply-adds (K6: the blend; K8:
    its transpose; K9: the per-head dot), a tap being live where a point of
    the head gives it mass (K6, K8) or where a point's hat or hat' there is
    non-zero (K9); per (query, level, point) ~93 operations for the hats
    and the 27 tap masses (K6, K8) or ~250 for the hats, hat's and the four
    gradients over 27 taps (K9).  The taps are counted from this run's
    data."""
    from class_query_vad_tpu_torch.ops.blend2d import hat

    dx, dy, dt, a = comps
    b, jl, t, h, w, kp = dx.shape
    dev = dx.device
    s3 = torch.arange(-1, 2, device=dev, dtype=torch.float32)
    pos = [torch.arange(n, device=dev)[:, None] + s3.long() for n in (t, h, w)]
    ok_t, ok_y, ok_x = ((p >= 0) & (p < n) for p, n in zip(pos, (t, h, w)))
    in_range = (ok_t[:, None, None, :, None, None]
                & ok_y[None, :, None, None, :, None]
                & ok_x[None, None, :, None, None, :]).reshape(t, h, w, 27)
    live = 0
    for j in range(jl):
        def axis(u):
            d = u[:, j].float()[..., None] - s3             # [.., kp, 3]
            return hat(d) if kernel != "K9" else (d.abs() <= 1).float()
        ht, hy, hx = axis(dt), axis(dy), axis(dx)
        m = (a[:, j].float()[..., None, None, None] * ht[..., :, None, None]
             * hy[..., None, :, None] * hx[..., None, None, :])
        head = m.reshape(b, t, h, w, nh, kp // nh, 27).sum(5) != 0
        live += int((head & in_range[None, :, :, :, None, :]).sum())
    points = b * jl * t * h * w * kp
    g32 = b * t * h * w * K1_C * 4
    vbytes = vol.numel() * vol.element_size()
    cbytes = sum(x.numel() * x.element_size() for x in comps)
    nbytes = {"K6": vbytes + cbytes + g32,        # out is float32 like G
              "K8": g32 + cbytes + vbytes,
              "K9": g32 + vbytes + cbytes + cbytes}[kernel]
    ops = live * (K1_C // nh) * 2 + points * (250 if kernel == "K9" else 93)
    return nbytes, ops


def phase_blend3d_kernels(dev, bw, peak):
    """K6 (at the main path's four query grids and in K7's regime), K8 and
    K9 against their plain versions, offsets on exact ties included; per
    layer times (bf16) beside the bound, the plain version and the
    grid_sample composition (its autograd for K8 / K9)."""
    from class_query_vad_tpu_torch.ops.blend3d import (
        blend3d_bwd_dcomps,
        blend3d_bwd_dcomps_reference,
        blend3d_bwd_dvol,
        blend3d_bwd_dvol_reference,
        blend3d_fwd,
        blend3d_reference,
    )

    mb = v2_vmem_mb(B3_T, *B3_K7_GRID, K1_C, K1_KP)
    check(mb > 96.0, f"{B3_K7_GRID} is not in K7's regime ({mb:.1f} MB)")
    rng = np.random.default_rng(15)
    keys = ("K6", "K8", "K9", "K7 regime")
    err = {k: 0.0 for k in keys}
    num = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "bound_by": {"bytes": 0.0, "operations": 0.0}} for k in keys}
    cases = [("K6", 2, hw) for hw in K1_LEVELS]
    cases += [("K8/K9", TRAIN_B, hw) for hw in K1_LEVELS]
    cases.append(("K7 regime", 1, B3_K7_GRID))
    for dtype in (torch.float32, torch.bfloat16):
        for which, b, (h, w) in cases:
            (vol, dx, dy, dt, a), g = blend_inputs(rng, b, h, w, dtype, dev,
                                                   nc=3, t=B3_T)
            comps = (dx, dy, dt, a)
            calls = {}
            if which != "K8/K9":
                calls[which] = (lambda: blend3d_fwd(vol, *comps, 8),
                                lambda: blend3d_reference(vol, *comps, 8))
            else:
                calls["K8"] = (
                    lambda: blend3d_bwd_dvol(*comps, g, dtype, 8),
                    lambda: blend3d_bwd_dvol_reference(*comps, g, dtype, 8))
                calls["K9"] = (
                    lambda: blend3d_bwd_dcomps(vol, *comps, g, 8),
                    lambda: blend3d_bwd_dcomps_reference(vol, *comps, g, 8))
            timed = dtype == torch.bfloat16
            if timed:
                # the grid_sample composition (K6) and its autograd with
                # respect to vol (K8) or the components (K9); the forward
                # and d vol checked against the plain versions
                fwd_lib = lambda: blend_grid_sample(vol, dx, dy, a, 8, dt)
                leaves = (vol, dx, dy, a, dt)
                fn = lambda v, x, y, aa, tt: blend_grid_sample(v, x, y, aa, 8,
                                                               tt)
                library = {"K6": fwd_lib, "K7 regime": fwd_lib,
                           "K8": library_grad(fn, leaves, (0,), g),
                           "K9": library_grad(fn, leaves, (1, 2, 3, 4), g)}
            for k, (kern, plain) in calls.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if k != "K9":
                    got, want = (got,), (want,)
                for x, y in zip(got, want):
                    check(x.shape == y.shape and x.dtype == y.dtype
                          and bool(torch.isfinite(x).all()),
                          f"{k} output {tuple(x.shape)} {x.dtype} not finite "
                          f"or misshaped")
                e = max(rel_err(x, y)[1] for x, y in zip(got, want))
                tol = B3_TOL.get(k, B3_TOL["K6"])[dtype]
                ok = e <= tol
                what = (f"{k} {str(dtype)[6:]:8s} B={b} T={B3_T} "
                        f"{h:3d}x{w:<3d}")
                print(f"{what}: max|err| = {e:.2e} x max|ref| (tol {tol:.0e}) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{k} disagrees with its plain version: {what}")
                err[k] = max(err[k], max(rel_err(x, y)[0]
                                         for x, y in zip(got, want)))
                if not timed:
                    continue
                if k in ("K6", "K7 regime"):
                    rel_lib = check_library(library[k](), want[0], k)
                elif k == "K8":
                    rel_lib = rel_err(library[k]()[0], want[0])[1]
                    check(rel_lib <= BLEND_TOL[dtype], f"the grid_sample "
                          f"composition's d vol disagrees with K8's plain "
                          f"version: {rel_lib:.2e}")
                else:
                    rel_lib = None      # grid_sample's subgradients at ties
                t_k = kernel_device_ms(kern)
                t_p = cuda_ms(plain, 2, 1)
                t_l = cuda_ms(library[k], 3, 1)
                nbytes, ops = blend3d_work("K6" if k == "K7 regime" else k,
                                           vol, comps)
                t_b = max(nbytes / bw, ops / peak) * 1e3
                n = num[k]
                n["bound_by"]["bytes" if nbytes / bw >= ops / peak
                              else "operations"] += t_b
                for key, x in (("ms", t_k), ("plain_ms", t_p),
                               ("bound_ms", t_b), ("library_ms", t_l)):
                    n[key] += x
                print(f"{k} bf16     B={b} T={B3_T} {h:3d}x{w:<3d}: kernel "
                      f"{t_k:.4f} ms (device, queued){earlier_at(k, (h, w))}, "
                      f"plain {t_p:.3f} ms, "
                      f"grid_sample composition {t_l:.3f} ms ("
                      + (f"vs the plain version {rel_lib:.1e}"
                         if rel_lib is not None else "not compared: its "
                         "subgradients at the ties are not XLA's")
                      + f"), bound {t_b:.4f} ms "
                      f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) -> "
                      f"{nbytes / t_k / 1e6:.0f} GB/s, {t_b / t_k:.1%} of "
                      f"the bound's speed")
            del vol, dx, dy, dt, a, g, comps, calls
            if timed:
                del library, fwd_lib, leaves
            torch.cuda.empty_cache()
    k7 = num["K7 regime"]
    print(f"K7's regime ({B3_K7_GRID[0]}x{B3_K7_GRID[1]}, T={B3_T}, bf16: "
          f"{v2_vmem_mb(B3_T, *B3_K7_GRID, K1_C, K1_KP):.1f} MB of VMEM for "
          f"the TPU's K6 > 96 MB; at 64x80 "
          f"{v2_vmem_mb(B3_T, 64, 80, K1_C, K1_KP):.1f} MB) through "
          f"csrc/blend3d.cu: kernel {k7['ms']:.4f} ms (earlier version "
          f"{EARLIER_MS['K7 regime']:.4f} ms), plain "
          f"{k7['plain_ms']:.3f} ms, grid_sample composition "
          f"{k7['library_ms']:.3f} ms, bound {k7['bound_ms']:.4f} ms")
    names = {"K6": ("blend3d_fwd", "blend3d.cu", 96, 2),
             "K8": ("blend3d_bwd_dvol", "blend3d_bwd_dvol.cu", 1118, TRAIN_B),
             "K9": ("blend3d_bwd_dcomps", "blend3d_bwd_dcomps.cu", 1053,
                    TRAIN_B)}
    entries = []
    for k, (name, src, line, b) in names.items():
        n = num[k]
        earlier = (f" (earlier version {EARLIER_MS[k]:.4f} ms)"
                   if k in EARLIER_MS else "")
        print(f"{k} per encoder layer (4 launches, bf16, B={b}, T={B3_T}): "
              f"kernel {n['ms']:.4f} ms{earlier}, plain {n['plain_ms']:.3f} ms, "
              f"grid_sample composition {n['library_ms']:.3f} ms, bound "
              f"{n['bound_ms']:.4f} ms ({n['bound_ms'] / n['ms']:.1%} of the "
              f"bound's speed)")
        entry = {
            "name": name, "route": "cuda",
            "source": f"class_query_vad_tpu_torch/csrc/{src}",
            "replaces": f"class_query_vad_tpu/ops/fast_deform_pallas.py:{line}",
            "launches": None, "max_abs_err": err[k], "ms": n["ms"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
            "bound_by": max(n["bound_by"], key=n["bound_by"].get),
            "library_ms": n["library_ms"], "design": B3_DESIGN[k],
        }
        if k == "K6":
            # the same kernel in K7's regime (the JAX package's
            # fast_deform_pallas.py:54, past K6's VMEM estimate)
            entry.update({
                "k7_replaces": "class_query_vad_tpu/ops/fast_deform_pallas.py:54",
                "k7_grid": list(B3_K7_GRID), "k7_max_abs_err": err["K7 regime"],
                "k7_ms": k7["ms"], "k7_plain_ms": k7["plain_ms"],
                "k7_bound_ms": k7["bound_ms"],
                "k7_bound_by": max(k7["bound_by"], key=k7["bound_by"].get),
                "k7_library_ms": k7["library_ms"]})
        entries.append(entry)
    return entries


def phase_serve(dev, counters, config: str, tag: str, seeds, opts=(),
                expected=None, b: int = 2, iters: int = 10, probe=None):
    """``config`` (with ``opts``) at full width in bf16 (the backbone; the
    encoder and decoder in the YAML's dtypes), with random offset / weight
    kernels (every query samples its own locations), on clips of the
    config's shape at batch ``b``: one request per seed through forward and
    the dataset's postprocessing, finite scores of the expected shapes,
    ``expected`` launches per forward of each kernel and of no other one;
    the median ms/batch of ``iters`` timed requests, peak memory, stage
    events and the card's busy share; then ``probe(model, pixels, mask)``
    if given.  Returns the launches and the median."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    cfg = get_cfg_custom(config, list(opts))
    model = build_model(cfg, dtype=torch.bfloat16)
    randomize_constants(model, torch.Generator().manual_seed(14))
    s = model.spec
    attn = model.transformer.encoder.layers[0].self_attn
    route = (f", cross level {s.fast_cross_level}, window {s.fast_window}, "
             f"{attn.nc} offset components, fused K1 route "
             f"{attn.fused_route}" if s.encoder_type == "fast_attention"
             else "")
    print(f"--- {tag}: {os.path.basename(config)}, {s.encoder_type} "
          f"encoder{route}")
    shape = clip_shape(cfg)
    lead = (b, s.num_queries) if s.dataset_mode == "ava" else (
        b, s.model_temp_len, s.num_queries)
    expected = expected or {}
    requests = [make_request(seed, b, shape) for seed in seeds]
    for c in counters:
        c.launches = 0
    for i, (pixels, mask) in enumerate(requests):
        out, (scores, boxes, actor) = serve(model, pixels, mask, dev)
        torch.cuda.synchronize()
        for name, x, width in (("scores", scores, s.num_classes),
                               ("boxes", boxes, 4), ("actorness", actor, 1)):
            check(tuple(x.shape) == lead + (width,),
                  f"{tag} {name} shape {tuple(x.shape)}")
            check(bool(torch.isfinite(x).all()), f"{tag} {name} not finite")
        print(f"{tag} request {i}: scores {tuple(scores.shape)}, finite; top "
              f"score {scores.max().item():.4f}")
    launches = {c.__name__: c.launches for c in counters}
    print(f"{tag} kernel launches over {len(requests)} requests: {launches}")
    check(launches == {**{k: 0 for k in launches},
                       **{k: n * len(requests) for k, n in expected.items()}},
          f"{tag} eval launches {launches}, expected {expected or 'none'} per "
          f"forward and no other kernel")

    pixels, mask = requests[0]
    for _ in range(2):
        serve(model, pixels, mask, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        serve(model, pixels, mask, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    print(f"full-width eval {tag} ({os.path.basename(config)}), B={b} "
          f"{'x'.join(map(str, shape))} bf16, forward + postprocess, "
          f"host->device copy included: median {med:.2f} ms/batch "
          f"({1e3 * b / med:.2f} clips/s) over {len(times)} iterations; min "
          f"{min(times):.2f}, max {max(times):.2f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stage_breakdown(model, pixels, mask, dev, med, min(iters, 5), expected,
                    f"{tag} ")
    if probe is not None:
        probe(model, pixels, mask)
    del model
    torch.cuda.empty_cache()
    return launches, med


def phase_eval_variant(dev, counters, config: str, window: str, kernel: str,
                       tag: str, seeds):
    """``config`` with ``FAST_WINDOW: window`` served (``phase_serve``):
    24 launches per forward of ``kernel`` and of no other kernel."""
    return phase_serve(dev, counters, config, tag, seeds,
                       ["CONFIG.MODEL.FAST_WINDOW", window], {kernel: 24})[0]


# phase 13's card-vs-CPU check runs at 1 of the YAML's 6 encoder layers:
# on the CPU the plain 3d blend over 8 frames is the slow part (the CPU
# forward took 113.7 s at 6 layers on the 8 host cores beside an H100,
# 10.8 s at 2)
NATIVE_3D_CPU_LAYERS = 1
# phase 16's likewise at 2 of the 6 (its plain 3d blend is phase 13's
# kind of work; 6 until phases 41-42 came)
RESAMPLE_3D_CPU_LAYERS = 2


# the 3d resample window's train path: 1 + 4 steps
RESAMPLE_3D_TRAIN_STEPS = 5
# its float32 train step card vs CPU: 1 of the YAML's 6 encoder layers, for
# the script's time limit (the CPU's step took 153.7 s at 6 layers on the 8
# host cores beside an H100, 29.3 s at 2 with 2 ViT blocks; the later
# phases need that time)
RESAMPLE_3D_TRAIN_CPU_LAYERS = 1


# ---- K12 (ViT attention), K13 (fused FFN): no model path calls them, as in
# the JAX package; their entry points are the ops and the bench script

# K12 at one ViT-B attention block of the main path (B=2, N = 8 x 16 x 20
# tokens, 12 heads x 64), an awkward shape (B=1, N not a multiple of 16)
# and a long one (B=1, N = 4096: a 16-frame 256x512 clip, 8 x 16 x 32
# tokens, past the 3296 tokens of K12's first version)
K12_SHAPE = (2, 2560, 12)
K12_AWKWARD = (1, 1001, 12)
K12_LONG = (1, 4096, 12)
K12_SCALE = 64 ** -0.5
# against the plain version: float32 in another summation order; bf16: p
# and the output rounded to bf16 after scores summed in another order (one
# bf16 ulp, 2^-8)
K12_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# against the port ViT's own attention (its einsum order): float32 as
# above; bf16: the ViT rounds q * scale, the scores, e, the row sum and p
# to bf16 where K12 keeps them float32 (four roundings of 2^-9 relative,
# and a score's own rounding, |s| 2^-9, becomes relative error of p)
K12_MODEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
# the times of K12's and K13's first CUDA versions (wmma, before their
# wgmma redesign; NVIDIA H100 80GB HBM3, 700 W), bf16, printed beside this
# run's: K12 per ViT-B block, K13 at its three shapes
FIRST_VERSION_MS = {"K12": 1.7409, "encoder 2d": 1.3227, "encoder 3d": 4.2382,
                    "ViT MLP": 1.5816}


def k12_work(b: int, n: int, heads: int, itemsize: int):
    """(bytes, operations): qkv read once and the output written once; the
    two products, 4 B H N^2 D (the N^2 exponentials ride on the SFUs)."""
    c = heads * 64
    return b * n * 4 * c * itemsize, 4 * b * heads * n * n * 64


def print_kernel_info(name: str, tag: str, *args: int) -> None:
    """Registers, shared memory per CTA and CTAs per SM of a kernel
    variant, as the card runs it."""
    from class_query_vad_tpu_torch.ops.cuda_build import kernel_info

    info = kernel_info(name, *args)
    print(f"{tag}: {info['registers']} registers, {info['smem_bytes']} B "
          f"shared memory per CTA, {info['ctas_per_sm']} CTA(s) per SM")


def phase_vit_attention(dev, bw, bf16_peak):
    """K12 against its plain version at the ViT-B block shape, an awkward
    one and a long one, float32 and bf16; bf16 device times beside the
    bound, the plain version, ``F.scaled_dot_product_attention`` (the
    library yardstick) and its first version's time; one backward through
    ``flash_attention_qkv`` at B=1 against autograd of the einsum
    reference."""
    from class_query_vad_tpu_torch.ops.vit_attention import (
        attention_from_qkv_ref, flash_attention_plain, flash_attention_qkv,
        vit_attention)
    from class_query_vad_tpu_torch.scripts.bench_vit_attn import (
        sdpa_attention)

    g = torch.Generator().manual_seed(19)
    entry = {"name": "vit_attention", "route": "cuda",
             "source": "class_query_vad_tpu_torch/csrc/vit_attention.cu",
             "replaces": "class_query_vad_tpu/ops/vit_attention.py:36",
             "launches": None, "max_abs_err": 0.0}
    print_kernel_info("vit_attention", "K12 bf16", 1)
    print_kernel_info("vit_attention", "K12 float32", 0)
    for b, n, heads in (K12_SHAPE, K12_AWKWARD, K12_LONG):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((b, n, 3 * heads * 64), generator=g).to(dev, dtype)
            out = vit_attention(qkv, heads, K12_SCALE)
            torch.cuda.synchronize()
            check(out.shape == (b, n, heads * 64) and out.dtype == dtype,
                  f"K12 output {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()), "K12 output not finite")
            plain = flash_attention_plain(qkv, heads, K12_SCALE)
            err, rel = rel_err(out, plain)
            ok = rel <= K12_TOL[dtype]
            print(f"K12 {str(dtype)[6:]:8s} B={b} N={n} H={heads}: max|err| "
                  f"{err:.3e} = {rel:.2e} x max|out| (tol "
                  f"{K12_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K12 disagrees with its plain version at B={b} N={n} "
                      f"{dtype}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if (b, n, heads) == K12_AWKWARD or dtype != torch.bfloat16:
                continue
            t_k = kernel_device_ms(lambda: vit_attention(qkv, heads, K12_SCALE))
            if (b, n, heads) == K12_LONG:
                nbytes, ops = k12_work(b, n, heads, 2)
                t_b = max(nbytes / bw, ops / bf16_peak) * 1e3
                entry.update(k12_4096_ms=t_k, k12_4096_bound_ms=t_b)
                print(f"K12 bf16 B={b}, N={n}, {heads} x 64: kernel "
                      f"{t_k:.4f} ms, bound {t_b:.4f} ms -> "
                      f"{ops / t_k / 1e9:.1f} TFLOP/s")
                continue
            t_p = cuda_ms(lambda: flash_attention_plain(qkv, heads, K12_SCALE),
                          5, 1)
            lib = lambda: sdpa_attention(qkv, K12_SCALE, heads)
            lib_rel = rel_err(lib(), plain)[1]
            check(lib_rel <= K12_MODEL_TOL[dtype],
                  f"scaled_dot_product_attention disagrees with K12's plain "
                  f"version: {lib_rel:.2e}")
            t_l = kernel_device_ms(lib)
            nbytes, ops = k12_work(b, n, heads, 2)
            t_b = max(nbytes / bw, ops / bf16_peak) * 1e3
            entry.update(ms=t_k, plain_ms=t_p, bound_ms=t_b,
                         bound_by="bytes" if nbytes / bw >= ops / bf16_peak
                         else "operations", library_ms=t_l)
            print(f"K12 bf16 one ViT-B block (B={b}, N={n}, {heads} x 64): "
                  f"kernel {t_k:.4f} ms (first version "
                  f"{FIRST_VERSION_MS['K12']:.4f} ms), "
                  f"plain {t_p:.4f} ms, "
                  f"scaled_dot_product_attention {t_l:.4f} ms (rel err "
                  f"{lib_rel:.2e} vs the plain version), bound {t_b:.4f} ms "
                  f"({entry['bound_by']}: {nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.1f} GFLOP at {bf16_peak / 1e12:.0f} TFLOP/s "
                  f"bf16) -> {ops / t_k / 1e9:.1f} TFLOP/s, "
                  f"{t_b / t_k:.1%} of the bound's speed")
    # the training path's gradient: autograd through the einsum reference.
    # The loss cot . out + |out|^2 / 2 makes the cotangent (cot + out) carry
    # K12's own output, so a wrong forward moves the gradient too; that
    # output's float32 error (<= 1e-6 x max|out|, above) bounds the tol
    b, n, heads = 1, K12_SHAPE[1], K12_SHAPE[2]
    qkv = torch.randn((b, n, 3 * heads * 64), generator=g).to(dev)
    cot = torch.randn((b, n, heads * 64), generator=g).to(dev)
    grads = []
    before = vit_attention.launches
    for fn in (flash_attention_qkv, attention_from_qkv_ref):
        x = qkv.clone().requires_grad_()
        out = fn(x, heads, K12_SCALE)
        ((out * cot).sum() + 0.5 * (out * out).sum()).backward()
        grads.append(x.grad)
    torch.cuda.synchronize()
    check(vit_attention.launches == before + 1,
          "flash_attention_qkv did not launch K12 once")
    err, rel = rel_err(*grads)
    print(f"K12 autograd (B=1, float32): the gradient of cot . out + "
          f"|out|^2 / 2 through flash_attention_qkv vs autograd of "
          f"attention_from_qkv_ref: max|err| {err:.3e} = {rel:.2e} x "
          f"max|grad| (tol 2e-06)")
    check(rel <= 2e-6, "flash_attention_qkv's gradient disagrees")
    return entry


# K13 at the port's FFN shapes: the main path's encoder FFN (B=2, the
# 2-frame slice: 2 x 2 x (64x80 + 32x40 + 16x20 + 8x10) tokens), the same
# under FAST_WINDOW 3d (8 frames), the ViT-B MLP (B=2 x 8 x 16 x 20 tokens,
# 768 -> 3072, exact GELU); and an awkward token count, not a multiple of
# any tile
K13_SHAPES = {"encoder 2d": (27200, 256, 2048, "relu"),
              "encoder 3d": (108800, 256, 2048, "relu"),
              "ViT MLP": (5120, 768, 3072, "gelu_exact")}
K13_AWKWARD_N = 1037
# against the plain version: float32 in another summation order; bf16: the
# hidden units and the output rounded to bf16 after sums in another order
K13_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# against the model's own Linear pair in bf16: ``F.linear`` adds the bias
# before rounding, K13 (the flax Dense chain) after: up to one more bf16
# rounding of every hidden unit and output (2^-8 relative each)
K13_MODEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def k13_work(n: int, c: int, f: int, itemsize: int):
    """(bytes, operations): x, the weights and biases read once, the output
    written once; 4 N C F multiply-add operations."""
    return (2 * n * c + 2 * c * f + c + f) * itemsize, 4 * n * c * f


def ffn_inputs(g, n, c, f, dtype, dev):
    """x [n, c], w1 [c, f], b1, w2 [f, c], b2 in ``dtype``, the weights at
    the Linear init's scale (a bf16 model's weights are bf16: the timed
    call then casts nothing, as the library composition does not)."""
    x = torch.randn((n, c), generator=g).to(dev, dtype)
    w1 = (torch.randn((c, f), generator=g) / c ** 0.5).to(dev, dtype)
    b1 = (0.1 * torch.randn((f,), generator=g)).to(dev, dtype)
    w2 = (torch.randn((f, c), generator=g) / f ** 0.5).to(dev, dtype)
    b2 = (0.1 * torch.randn((c,), generator=g)).to(dev, dtype)
    return x, w1, b1, w2, b2


def ffn_library(x, w1, b1, w2, b2, activation: str):
    """The ``F.linear`` / activation / ``F.linear`` composition in x's dtype
    (cuBLAS, bias in the epilogue): the library yardstick of K13, which no
    path of the port routes through K13.  Returns a call."""
    import torch.nn.functional as F

    dt = x.dtype
    w1t, w2t = w1.t().contiguous().to(dt), w2.t().contiguous().to(dt)
    b1, b2 = b1.to(dt), b2.to(dt)
    act = {"relu": F.relu, "gelu_exact": F.gelu,
           "gelu_tanh": lambda h: F.gelu(h, approximate="tanh")}[activation]
    return lambda: F.linear(act(F.linear(x, w1t, b1)), w2t, b2)


def phase_fused_ffn(dev, bw, bf16_peak):
    """K13 against its plain version at the port's three FFN shapes and at
    an awkward token count, each with all three activations, float32 and
    bf16; bf16 device times (with each shape's own activation) beside the
    bound, the plain version, the cuBLAS composition and the first
    version's time."""
    from class_query_vad_tpu_torch.ops.fused_ffn import (
        ACTIVATIONS, fused_ffn_kernel, fused_ffn_plain)

    g = torch.Generator().manual_seed(22)
    entry = {"name": "fused_ffn", "route": "cuda",
             "source": "class_query_vad_tpu_torch/csrc/fused_ffn.cu",
             "replaces": "class_query_vad_tpu/ops/fused_ffn.py:74",
             "launches": None, "max_abs_err": 0.0}
    # every activation at each shape; timed with the shape's own
    cases = [(tag, n, c, f, act, act == own)
             for tag, (n, c, f, own) in K13_SHAPES.items()
             for act in ACTIVATIONS]
    cases += [("awkward", K13_AWKWARD_N, c, f, act, False)
              for c, f in ((256, 2048), (768, 3072)) for act in ACTIVATIONS]
    for c in (256, 768):
        print_kernel_info("fused_ffn", f"K13 bf16 C={c}", 1, c)
        print_kernel_info("fused_ffn", f"K13 float32 C={c}", 0, c)
    for tag, n, c, f, act, timed in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = ffn_inputs(g, n, c, f, dtype, dev)
            out = fused_ffn_kernel(*args, act)
            torch.cuda.synchronize()
            check(out.shape == (n, c) and out.dtype == dtype,
                  f"K13 output {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()), "K13 output not finite")
            plain = fused_ffn_plain(*args, act)
            err, rel = rel_err(out, plain)
            ok = rel <= K13_TOL[dtype]
            print(f"K13 {str(dtype)[6:]:8s} {tag:10s} N={n} {c}->{f} {act}: "
                  f"max|err| {err:.3e} = {rel:.2e} x max|out| (tol "
                  f"{K13_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K13 disagrees with its plain version: {tag} {act} "
                      f"{dtype}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if not timed or dtype != torch.bfloat16:
                continue
            t_k = kernel_device_ms(lambda: fused_ffn_kernel(*args, act))
            t_p = cuda_ms(lambda: fused_ffn_plain(*args, act), 5, 1)
            lib = ffn_library(*args, act)
            lib_rel = rel_err(lib(), plain)[1]
            check(lib_rel <= K13_MODEL_TOL[dtype],
                  f"the F.linear composition disagrees with K13's plain "
                  f"version: {lib_rel:.2e}")
            t_l = kernel_device_ms(lib)
            nbytes, ops = k13_work(n, c, f, 2)
            t_b = max(nbytes / bw, ops / bf16_peak) * 1e3
            by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
            print(f"K13 bf16 {tag} (N={n}, {c}->{f}->{c}, {act}): kernel "
                  f"{t_k:.4f} ms (first version {FIRST_VERSION_MS[tag]:.4f} "
                  f"ms), plain "
                  f"{t_p:.4f} ms, F.linear composition "
                  f"{t_l:.4f} ms (rel err {lib_rel:.2e}), bound {t_b:.4f} ms "
                  f"({by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP) -> "
                  f"{ops / t_k / 1e9:.1f} TFLOP/s, {t_b / t_k:.1%} of the "
                  f"bound's speed")
            if tag == "encoder 2d":               # the main path's FFN
                entry.update(ms=t_k, plain_ms=t_p, bound_ms=t_b, bound_by=by,
                             library_ms=t_l)
            else:
                key = "k13_3d" if tag == "encoder 3d" else "k13_vit_mlp"
                entry.update({f"{key}_ms": t_k, f"{key}_plain_ms": t_p,
                              f"{key}_bound_ms": t_b,
                              f"{key}_library_ms": t_l})
    return entry


def phase_model_attention_ffn(dev):
    """K12 and K13 on the full-width ``AVA22_ViT-B_fast`` model's own
    tensors: the qkv of ViT block 0 and encoder layer 0's FFN input tokens
    from one request, against that block's attention module and that
    layer's ``linear2(relu(linear1(x)))``, in bf16 (the model's dtype) and
    float32 (float32 copies of the modules on the same inputs)."""
    import copy

    import torch.nn.functional as F

    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants
    from class_query_vad_tpu_torch.ops.fused_ffn import fused_ffn_kernel
    from class_query_vad_tpu_torch.ops.vit_attention import vit_attention

    model = build_model(get_cfg_custom(CONFIG), dtype=torch.bfloat16)
    randomize_constants(model, torch.Generator().manual_seed(20))
    attn = model.backbone[0].body.blocks[0].attn
    layer = model.transformer.encoder.layers[0]
    seen = {}
    hooks = [attn.register_forward_pre_hook(
                 lambda m, a: seen.setdefault("vit", a[0].detach())),
             layer.linear1.register_forward_pre_hook(
                 lambda m, a: seen.setdefault("ffn", a[0].detach()))]
    pixels, mask = make_request(40)
    serve(model, pixels, mask, dev)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    heads, scale = attn.num_heads, (attn.dim // attn.num_heads) ** -0.5
    x = seen["vit"]
    print(f"ViT block 0's input {tuple(x.shape)}, encoder layer 0's FFN "
          f"input {tuple(seen['ffn'].shape)} (one request, B=2)")
    for dtype in (torch.bfloat16, torch.float32):
        mod = (attn if attn.qkv.weight.dtype == dtype
               else copy.deepcopy(attn).to(dtype))
        bias = torch.cat([mod.q_bias, torch.zeros_like(mod.v_bias), mod.v_bias])
        with torch.inference_mode():
            xd = x.to(dtype)
            qkv = F.linear(xd, mod.qkv.weight, bias)
            got = mod.proj(vit_attention(qkv, heads, scale))
            want = mod(xd)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        ok = rel <= K12_MODEL_TOL[dtype]
        print(f"K12 in the model, {str(dtype)[6:]}: proj(K12(qkv of ViT "
              f"block 0)) vs the block's own attention: max|err| {err:.3e} "
              f"= {rel:.2e} x max|ref| (tol {K12_MODEL_TOL[dtype]:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"K12 disagrees with the ViT's attention in {dtype}")
    tokens = seen["ffn"].reshape(-1, seen["ffn"].shape[-1])
    for dtype in (torch.bfloat16, torch.float32):
        lay = (layer if layer.linear1.weight.dtype == dtype
               else copy.deepcopy(layer).to(dtype))
        with torch.inference_mode():
            xd = tokens.to(dtype)
            got = fused_ffn_kernel(xd, lay.linear1.weight.t(), lay.linear1.bias,
                                   lay.linear2.weight.t(), lay.linear2.bias,
                                   "relu")
            want = lay.linear2(F.relu(lay.linear1(xd)))
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        ok = rel <= K13_MODEL_TOL[dtype]
        print(f"K13 in the model, {str(dtype)[6:]}: encoder layer 0's FFN on "
              f"its {tokens.shape[0]} input tokens vs linear2(relu(linear1(x)))"
              f": max|err| {err:.3e} = {rel:.2e} x max|ref| (tol "
              f"{K13_MODEL_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"K13 disagrees with the encoder's FFN in {dtype}")
    del model
    torch.cuda.empty_cache()


def phase_bench_entry():
    """The K12 bench entry point's ``main``, once; returns its launches of
    K12 and its numbers."""
    from class_query_vad_tpu_torch.ops.vit_attention import vit_attention
    from class_query_vad_tpu_torch.scripts import bench_vit_attn

    vit_attention.launches = 0
    res = bench_vit_attn.main()
    check(res["rel_err"] <= K12_MODEL_TOL[torch.bfloat16]
          and res["grad_rel_err"] <= K12_MODEL_TOL[torch.bfloat16],
          f"bench_vit_attn's checks failed: {res}")
    print(f"bench_vit_attn.main: {vit_attention.launches} K12 launches")
    return vit_attention.launches


# ---- FAST_RADIUS 2 (the general-radius blend, plain PyTorch: no kernel)
RADIUS2_OPTS = {w: ["CONFIG.MODEL.FAST_RADIUS", 2, "CONFIG.MODEL.FAST_WINDOW", w]
                for w in ("2d", "3d")}
# the card-vs-CPU checks' encoder depth, cut from the YAML's 6 for the
# CPU's time: the plain blend takes (2R+1)^3 = 125 shifts per level under
# the 3d window
RADIUS2_CPU_LAYERS = {"2d": 1, "3d": 1}


def phase_radius2(dev, counters, window: str):
    """``AVA22_ViT-B_fast`` with ``FAST_RADIUS 2`` at full width in bf16:
    one warm-up and one timed request (ms/batch), no launch of any kernel
    (the general blend takes precedence over K1, K2 and K6); then the
    float32 card-vs-CPU check at ``RADIUS2_CPU_LAYERS``."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    tag = f"radius-2 {window}"
    model = build_model(get_cfg_custom(CONFIG, RADIUS2_OPTS[window]),
                        dtype=torch.bfloat16)
    randomize_constants(model, torch.Generator().manual_seed(24))
    attn = model.transformer.encoder.layers[0].self_attn
    check(attn.radius == 2 and not attn.fused_route,
          f"{tag}: the encoder is not on the general route")
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for seed in (41, 42):
        pixels, mask = make_request(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, (scores, boxes, actor) = serve(model, pixels, mask, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for name, x, shape in (("scores", scores, (2, 15, 80)),
                               ("boxes", boxes, (2, 15, 4)),
                               ("actorness", actor, (2, 15, 1))):
            check(tuple(x.shape) == shape, f"{tag} {name} shape {tuple(x.shape)}")
            check(bool(torch.isfinite(x).all()), f"{tag} {name} not finite")
    launches = {c.__name__: c.launches for c in counters}
    print(f"{tag}: full-width eval, B=2 bf16, forward + postprocess: "
          f"{times[1]:.2f} ms/batch (the second request; the first "
          f"{times[0]:.2f} ms), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
          f"launches {launches}")
    check(not any(launches.values()),
          f"{tag}: kernel launches {launches}, expected none (radius 2 "
          f"takes the general blend)")
    del model
    torch.cuda.empty_cache()
    layers = RADIUS2_CPU_LAYERS[window]
    cpu_s = phase_in_model(
        dev, CONFIG, RADIUS2_OPTS[window] + ["CONFIG.MODEL.ENC_LAYERS", layers],
        tag=f"{tag} ")
    print(f"{tag} card-vs-CPU check at {layers} of the YAML's 6 encoder "
          f"layers; its CPU forward {cpu_s:.1f} s")
    return times[1]


# ---- the native train step at full width (B=1 bf16) and card vs CPU: 1 +
# 1 steps (1 + 4 until phases 38-40 came: its backward is the
# plain version's VJP, 2.0-2.7 / 5.4-7.3 s per 2d / 3d step)
NATIVE_TRAIN_STEPS = 2
# the float32 native-2d train step's card-vs-CPU check: 1 of the YAML's 6
# encoder layers, for the CPU's time (its step took 9.2-23.0 s at 2 layers
# on the 8 host cores beside an H100: the backward recomputes the plain
# native blend per level; 2 layers until phases 38-40 came)
NATIVE_TRAIN_CPU_LAYERS = 1


# ---- the exact deformable encoder and the tube configs (phases 25-30)
EXACT_CONFIG = os.path.join(REPO, "configuration", "AVA22_ViT-B.yaml")
MAMBA_EXACT_CONFIG = os.path.join(REPO, "configuration",
                                  "AVA22_ViT-B-train-mamba.yaml")
TUBE_CONFIGS = {k: os.path.join(REPO, "configuration", f"{k}.yaml")
                for k in ("UCF_ViT-B_fast", "UCF_ViT-B", "JHMDB_ViT-B")}
# K1, K3 and K4 at the tube-fast configs' query grids (one encoder layer:
# four grids, each over the four aligned levels), B=1 over every token
# frame: UCF_ViT-B_fast (32 frames of 224x224: 16 token frames) and
# JHMDB_ViT-B_fast (40 of 256x256: 20)
TUBE_GRIDS = {"UCF": (16, ((56, 56), (28, 28), (14, 14), (7, 7))),
              "JHMDB": (20, ((64, 64), (32, 32), (16, 16), (8, 8)))}
# the exact paths' train steps (1 warm-up + timed; 1 + 4 and 1 + 2 until
# phases 38-40 came)
EXACT_TRAIN_STEPS = 3
TUBE_EXACT_TRAIN_STEPS = 2
# the float32 card-vs-CPU train checks' encoder depth, cut from the YAML's
# 6 (AVA22_ViT-B) and 3 (UCF_ViT-B) for the CPU's time: the plain sampler's
# corner weights and their backward over 54,400 / 66,640 tokens per layer;
# UCF's decoder (3 layer pairs over 32 frames) cut to 1 pair (2 until
# phases 34-37 came); and the float32 forward checks' (phases 25, 29)
EXACT_TRAIN_CPU_LAYERS = 1
UCF_EXACT_TRAIN_CPU_LAYERS = 1
UCF_EXACT_TRAIN_CPU_DEC_LAYERS = 1
EXACT_FWD_CPU_LAYERS = 2
UCF_EXACT_FWD_CPU_LAYERS = 1          # 2 until phases 38-40 came
# UCF's float32 checks cut in decoder layer pairs when phases 34-37 came:
# the decoder over 32 frames sets their CPU time (its forward took 20.8,
# 20.4 and 18.3 s at 3, 2 and 1 encoder layers; the train step 49.7-53.0 s
# at 2 pairs); the forward's cut from 2 pairs to 1 when phases 38-40 came
UCF_EXACT_FWD_CPU_DEC_LAYERS = 1
# the ViT depth of the card-vs-CPU train checks of phases 18, 24, 26 and 29,
# cut from 12 blocks for the CPU's time (the whole script must end well
# inside its 1200 s; it took 853-927 s on an H100 before); phase 6, the main
# path's, keeps 2 (``MAIN_TRAIN_CPU_VIT_DEPTH``; 4 until phases 38-40).  The
# blocks left are the same code at the same width, the FPN and everything
# after it unchanged
CPU_TRAIN_VIT_DEPTH = 1
CPU_TRAIN_VIT = ["CONFIG.ViT.DEPTH", CPU_TRAIN_VIT_DEPTH]
MAIN_TRAIN_CPU_VIT_DEPTH = 2


def phase_tube_grid_kernels(dev, bw, peak):
    """K1, K3 and K4 against their plain versions at ``TUBE_GRIDS``, in
    float32 and bf16, K3 / K4 with offsets on exact ties; bf16 device time
    per grid and per encoder layer beside the bound (``k1_work``,
    ``blend_work`` at these shapes).  Returns {config: {kernel: {"ms",
    "bound_ms", "by_grid"}}} and the largest error per kernel."""
    from class_query_vad_tpu_torch.ops.blend2d import (
        blend2d_bwd_dcomps,
        blend2d_bwd_dcomps_reference,
        blend2d_bwd_dvol,
        blend2d_bwd_dvol_reference,
    )
    from class_query_vad_tpu_torch.ops.fast_deform_cuda import (
        fused_blend2d, fused_blend2d_reference)

    rng = np.random.default_rng(25)
    out, max_err = {}, {"K1": 0.0, "K3": 0.0, "K4": 0.0}
    for name, (t, grids) in TUBE_GRIDS.items():
        out[name] = {k: {"ms": 0.0, "bound_ms": 0.0, "by_grid": {}}
                     for k in max_err}
        for dtype in (torch.float32, torch.bfloat16):
            for h, w in grids:
                vol, fused = k1_inputs(rng, 1, h, w, dtype, dev, t)
                (vol2, dx, dy, a), g = blend_inputs(rng, 1, h, w, dtype, dev,
                                                    t=t)
                calls = {
                    "K1": (lambda: fused_blend2d(vol, fused, 8, 1.0),
                           lambda: fused_blend2d_reference(vol, fused, 8, 1.0),
                           K1_TOL[dtype]),
                    "K3": (lambda: blend2d_bwd_dvol(dx, dy, a, g, dtype, 8),
                           lambda: blend2d_bwd_dvol_reference(dx, dy, a, g,
                                                              dtype, 8),
                           BLEND_TOL[dtype]),
                    "K4": (lambda: blend2d_bwd_dcomps(vol2, dx, dy, a, g, 8),
                           lambda: blend2d_bwd_dcomps_reference(
                               vol2, dx, dy, a, g, 8), BLEND_TOL[dtype]),
                }
                for k, (kern, plain, tol) in calls.items():
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    if k != "K4":
                        got, want = (got,), (want,)
                    ok = all(bool(torch.isfinite(x).all()) for x in got)
                    e = max(rel_err(x, y)[1] for x, y in zip(got, want))
                    ok = ok and e <= tol
                    print(f"{name} {k} {str(dtype)[6:]:8s} T={t} {h:2d}x"
                          f"{w:<2d}: max|err| = {e:.2e} x max|ref| (tol "
                          f"{tol:.0e}) {'ok' if ok else 'FAIL'}")
                    check(ok, f"{k} disagrees with its plain version at the "
                              f"{name} grid {h}x{w}, T={t}, {dtype}")
                    max_err[k] = max(max_err[k], max(
                        rel_err(x, y)[0] for x, y in zip(got, want)))
                    if dtype != torch.bfloat16:
                        continue
                    t_k = kernel_device_ms(kern)
                    nbytes, ops = (k1_work(h, w, 2, 1, t) if k == "K1"
                                   else blend_work(k, 1, h, w, 2, t=t))
                    t_b = max(nbytes / bw, ops / peak) * 1e3
                    n = out[name][k]
                    n["ms"] += t_k
                    n["bound_ms"] += t_b
                    n["by_grid"][f"{h}x{w}"] = [round(t_k, 5), round(t_b, 5)]
                    print(f"{name} {k} bf16     T={t} {h:2d}x{w:<2d}: kernel "
                          f"{t_k:.4f} ms (device, queued), bound {t_b:.4f} "
                          f"ms ({nbytes / 1e6:.1f} MB) -> "
                          f"{t_b / t_k:.1%} of the bound's speed")
        for k, n in out[name].items():
            print(f"{name} {k} per encoder layer (4 launches, bf16, B=1, "
                  f"T={t}): kernel {n['ms']:.4f} ms, bound {n['bound_ms']:.4f}"
                  f" ms ({n['bound_ms'] / n['ms']:.1%} of the bound's speed)")
    return out, max_err


def phase_exact_and_tubes(dev, counters, bw, peak):
    """Phases 25-30: AVA22_ViT-B (the exact encoder) served and trained,
    card vs CPU; K1, K3, K4 at the tube grids; UCF_ViT-B_fast served and
    trained (K1, K3, K4); UCF_ViT-B and JHMDB_ViT-B (the exact encoder over
    every frame) served and trained, UCF card vs CPU; VideoMamba with the
    exact encoder served (K5), card vs CPU.  Returns the tube grids'
    kernel times and the new paths' launches."""
    zero = {c.__name__: 0 for c in counters}
    # 25: no hand kernel on the exact ViT path, as in the JAX package
    with phase_seconds("phase 25 (AVA22_ViT-B served, card vs CPU)"):
        phase_serve(dev, counters, EXACT_CONFIG, "exact", (51, 52, 53))
        cpu_s = phase_in_model(
            dev, EXACT_CONFIG, ["CONFIG.MODEL.ENC_LAYERS",
                                EXACT_FWD_CPU_LAYERS], tag="exact ")
    print(f"exact card-vs-CPU forward at {EXACT_FWD_CPU_LAYERS} of the "
          f"YAML's 6 encoder layers; its CPU forward {cpu_s:.1f} s")
    with phase_seconds("phase 26 (its train path, card vs CPU)"):
        phase_train(dev, counters, steps=EXACT_TRAIN_STEPS, tag="exact ",
                    config=EXACT_CONFIG, kernels=())
        phase_train_card_vs_cpu(
            dev, ["CONFIG.MODEL.ENC_LAYERS", EXACT_TRAIN_CPU_LAYERS,
                  *CPU_TRAIN_VIT], "exact ", counters, zero, EXACT_CONFIG)
    with phase_seconds("phase 27 (K1, K3, K4 at the tube grids)"):
        tube, tube_err = phase_tube_grid_kernels(dev, bw, peak)
    # 28: 3 encoder layers x 4 query grids
    with phase_seconds("phase 28 (UCF_ViT-B_fast served and trained)"):
        ucf_eval, _ = phase_serve(
            dev, counters, TUBE_CONFIGS["UCF_ViT-B_fast"], "UCF fast",
            (61, 62, 63), expected={"fused_blend2d": 12}, b=1)
        ucf_train = phase_train(dev, counters, steps=5, tag="UCF fast ",
                                config=TUBE_CONFIGS["UCF_ViT-B_fast"],
                                per_step=12)
    # 29: the exact encoder over every frame, 3 layers
    with phase_seconds("phase 29 (UCF_ViT-B, JHMDB_ViT-B; UCF card vs CPU)"):
        for key, seed in (("UCF_ViT-B", 71), ("JHMDB_ViT-B", 73)):
            phase_serve(dev, counters, TUBE_CONFIGS[key], f"{key} exact",
                        (seed,), b=1, iters=3)
            phase_train(dev, counters, steps=TUBE_EXACT_TRAIN_STEPS,
                        tag=f"{key} exact ", config=TUBE_CONFIGS[key],
                        kernels=())
        cpu_s = phase_in_model(
            dev, TUBE_CONFIGS["UCF_ViT-B"], [
                "CONFIG.MODEL.ENC_LAYERS", UCF_EXACT_FWD_CPU_LAYERS,
                "CONFIG.MODEL.DEC_LAYERS", UCF_EXACT_FWD_CPU_DEC_LAYERS],
            tag="UCF exact ")
        print(f"UCF exact card-vs-CPU forward at {UCF_EXACT_FWD_CPU_LAYERS} "
              f"of the YAML's 3 encoder layers, {UCF_EXACT_FWD_CPU_DEC_LAYERS}"
              f" of its 3 decoder layer pairs; its CPU forward "
              f"{cpu_s:.1f} s")
        phase_train_card_vs_cpu(
            dev, ["CONFIG.MODEL.ENC_LAYERS", UCF_EXACT_TRAIN_CPU_LAYERS,
                  "CONFIG.MODEL.DEC_LAYERS", UCF_EXACT_TRAIN_CPU_DEC_LAYERS,
                  *CPU_TRAIN_VIT], "UCF exact ", counters, zero,
            TUBE_CONFIGS["UCF_ViT-B"])
    # 30: VideoMamba (48 K5 scans) + the exact encoder, eval
    with phase_seconds("phase 30 (AVA22_ViT-B-train-mamba, card vs CPU)"):
        mamba, _ = phase_serve(dev, counters, MAMBA_EXACT_CONFIG,
                               "VideoMamba + exact", (81, 82, 83),
                               expected={"selective_scan": 48})
        with videomamba_depth(MAMBA_FWD_CPU_DEPTH):
            phase_in_model(dev, MAMBA_EXACT_CONFIG,
                           ["CONFIG.MODEL.ENC_LAYERS", EXACT_FWD_CPU_LAYERS],
                           tag="VideoMamba + exact ", tol=VSS_MODEL_TOL)
    print(f"VideoMamba + exact card-vs-CPU forward at {MAMBA_FWD_CPU_DEPTH} "
          f"of VideoMamba's 24 blocks and {EXACT_FWD_CPU_LAYERS} of the "
          f"YAML's 6 encoder layers")
    launches = {
        "UCF_ViT-B_fast eval, 3 requests": ucf_eval,
        "UCF_ViT-B_fast train, 5 steps": ucf_train,
        "AVA22_ViT-B-train-mamba eval, 3 requests": mamba,
    }
    return tube, tube_err, launches


# ---- the eval loop, checkpoints and the train CLI's loop (phases 31-33)
# phase 31: the AVA eval loop over 4 batches of B=2 clips of 16x256x320 (the
# second clip of each pair 288 wide, padded on the canvas); phase 32: the
# UCF loop over 2 batches of B=1, 32x224x224
LOOP_BATCHES = 4
LOOP_CANVAS = (256, 320)
LOOP_WIDTHS = (320, 288)
TUBE_LOOP_BATCHES = 2
TUBE_LOOP_CANVAS = (224, 224)
# phase 31's timing rounds, each one loop with the criterion and one
# without, interleaved
LOOP_REPS = 6
# phase 33: 2 steps, a checkpoint, 1 step of a resumed trainer, against 3
# uninterrupted steps
RESUME_STEPS = 3


class SyntheticClips:
    """An in-memory dataset of ``n`` items shaped as the port's datasets'
    ``__getitem__(index, rng)`` returns them, with nothing decoded (the
    card's machine has no PIL): a normalized clip [T, h, w, 3] float32 and
    its target.  AVA: keyframe boxes (the keyframe index, then normalized
    cxcywh), ``raw_boxes`` in pixels, 80-class multi-hot labels, ``size``.
    UCF: tube targets over the clip's frames (one actor, live inside the
    clip, background frames label ``NUM_CLASSES``), front / end pads.
    Every item is drawn from ``seed`` once, in the constructor, so that the
    loop does not time the drawing."""

    def __init__(self, cfg, n: int, seed: int, widths):
        d = cfg.CONFIG.DATA
        t, nc, h = d.TEMP_LEN, d.NUM_CLASSES, int(d.CANVAS[0])
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            w = widths[i % len(widths)]
            clip = rng.standard_normal((t, h, w, 3), np.float32)
            if d.DATASET_NAME == "ava":
                self.items.append((clip, self._ava(rng, i, t, h, w, nc)))
            else:
                self.items.append((clip, self._tube(rng, i, t, h, w, nc)))

    @staticmethod
    def _ava(rng, i, t, h, w, nc):
        n = 2 + i % 3
        xy = rng.uniform(0.05, 0.45, (n, 2))
        xyxy = np.concatenate([xy, xy + rng.uniform(0.2, 0.5, (n, 2))], 1)
        xyxy = (np.minimum(xyxy, 1.0) * [w, h, w, h]).astype(np.float32)
        cxcywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                                 xyxy[:, 2:] - xyxy[:, :2]], 1) / [w, h, w, h]
        labels = (rng.random((n, nc)) < 0.05).astype(np.float32)
        labels[np.arange(n), rng.integers(0, nc, n)] = 1.0
        p_t = t // 2
        return {"image_id": [f"vid{i:03d}_{902 + i:04d}", p_t],
                "boxes": np.concatenate([np.full((n, 1), p_t), cxcywh],
                                        1).astype(np.float32),
                "raw_boxes": np.concatenate(
                    [np.full((n, 1), i), np.full((n, 1), p_t), xyxy],
                    1).astype(np.float32),
                "labels": labels, "orig_size": np.array([h, w]),
                "size": np.array([h, w])}

    @staticmethod
    def _tube(rng, i, t, h, w, nc):
        fp, ep = (2, 0) if i % 2 == 0 else (0, 3)
        frames = i * t + np.arange(1, t + 1)
        xy = rng.uniform(0.1, 0.4, 2) * [w, h] + np.cumsum(
            rng.normal(0, 1.0, (t, 2)), 0)
        xyxy = np.concatenate([xy, xy + [0.3 * w, 0.4 * h]], 1)
        label = int(rng.integers(0, nc))
        labels = np.full(t, label, np.int64)
        labels[:fp] = nc
        labels[t - ep:] = nc
        cxcywh = np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                                 xyxy[:, 2:] - xyxy[:, :2]], 1) / [w, h, w, h]
        return {"image_id": [f"Cls_v_{i:04d}"],
                "boxes": np.concatenate([frames[:, None], cxcywh],
                                        1).astype(np.float32),
                "raw_boxes": np.concatenate(
                    [np.full((t, 1), i), frames[:, None], xyxy],
                    1).astype(np.float32),
                "labels": labels, "front_pad": fp, "end_pad": ep,
                "orig_size": np.array([h, w]), "size": np.array([h, w])}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index, rng=None):
        clip, target = self.items[index]
        return clip, dict(target)


def write_labelmap(path: str) -> str:
    """An AVA-style pbtxt label map: 60 of the 80 class ids, as AVA v2.2
    evaluates (the evaluator's whitelist at ``NUM_CLASSES`` 80)."""
    ids = [i for i in range(1, 81) if i % 4]
    with open(path, "w") as f:
        f.writelines(f'item {{\n  name: "action {i}"\n  id: {i}\n}}\n'
                     for i in ids)
    return path


def loop_cfg(config: str, tmp: str, canvas, batch: int):
    from class_query_vad_tpu_torch.config import get_cfg_custom

    cfg = get_cfg_custom(config)
    cfg.CONFIG.DATA.CANVAS = list(canvas)
    cfg.CONFIG.VAL.BATCH_SIZE = batch
    cfg.CONFIG.LOG.BASE_PATH = tmp
    cfg.CONFIG.LOG.EXP_NAME = "loop"
    cfg.CONFIG.LOG.RES_DIR = "res"
    return cfg


def timed_loop(runs: dict, n_batches: int, tag: str, expected: dict,
               reps: int = 3):
    """Wall ms/batch of each of ``runs`` (name -> one whole
    ``run_validation``), the variants interleaved over ``reps`` rounds
    (every other round in reverse order): median, min and max of each.
    Then one profiled run of the first variant: the card's busy share of
    its median, the trace held to ``expected`` launches over the run."""
    walls = {k: [] for k in runs}
    for r in range(reps):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[k]()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3 / n_batches)
    meds = {}
    for k, w in walls.items():
        meds[k] = statistics.median(w)
        print(f"{tag}, {k}: median {meds[k]:.2f} ms/batch over {reps} runs "
              f"of {n_batches} batches (min {min(w):.2f}, max {max(w):.2f}; "
              f"all {[round(x, 2) for x in w]})")
    first = next(iter(runs))
    busy = profiled_busy(runs[first], meds[first], expected,
                         f"{tag}, {first}: ", per=n_batches, unit="batch")
    return meds, busy


def phase_eval_loop(dev, counters, main_ms: float):
    """Phase 31: ``AVA22_ViT-B_fast`` at full width in bf16 through the
    port's eval loop: a ``SyntheticClips`` AVA dataset packed by the port's
    ``DataLoader`` (4 batches of B=2 on a 256x320 canvas), the weights
    through ``save_checkpoint`` -> ``load_pretrained_params`` into a fresh
    model (the state_dict equal bit for bit), then ``run_validation`` with
    the criterion and bf16 pixel shipping: 24 K1 launches per batch and no
    other kernel, the buffered detection rows equal to ``serve`` +
    ``postprocess_ava`` (phase 3's path) on the same batches, finite eval
    losses, an mAP in [0, 1]; the loop's ms/batch beside phase 3's and the
    card's idle share over the loop."""
    import tempfile

    from class_query_vad_tpu_torch.datasets import DataLoader
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_pretrained_params, save_checkpoint)
    from class_query_vad_tpu_torch.engine.evaluate import (
        EvalBuffers, buffer_ava, run_validation)
    from class_query_vad_tpu_torch.evaluates import STDetectionEvaluaterAVA
    from class_query_vad_tpu_torch.losses import (
        build_criterion_and_postprocessor, build_matcher)
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    with tempfile.TemporaryDirectory() as tmp:
        cfg = loop_cfg(CONFIG, tmp, LOOP_CANVAS, 2)
        cfg.CONFIG.DATA.LABEL_PATH = write_labelmap(
            os.path.join(tmp, "labelmap.pbtxt"))
        loader = DataLoader(SyntheticClips(cfg, 2 * LOOP_BATCHES, 31,
                                           LOOP_WIDTHS), 2, cfg, num_workers=4)
        src = build_model(cfg, dtype=torch.bfloat16)
        randomize_constants(src, torch.Generator().manual_seed(31))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(cfg, src, 0)
        save_s = time.perf_counter() - t0
        model = build_model(cfg, dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(32))
        t0 = time.perf_counter()
        load_pretrained_params(cfg, path, model)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = src.state_dict()
        same = all(torch.equal(v, want[k])
                   for k, v in model.state_dict().items())
        print(f"eval loop: save_checkpoint of the bf16 model "
              f"({os.path.getsize(path) / 2**20:.1f} MiB) {save_s:.2f} s, "
              f"load_pretrained_params into a fresh model {load_s:.2f} s; "
              f"state_dict {'equal' if same else 'DIFFERENT'} bit for bit")
        check(same, "the checkpoint's weights differ after the round trip")
        del src
        criterion, post, _ = build_criterion_and_postprocessor(
            cfg, build_matcher(cfg))

        def run():
            return run_validation(cfg, model, post, loader,
                                  criterion=criterion,
                                  transfer_dtype=torch.bfloat16)

        for c in counters:
            c.launches = 0
        res = run()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        print(f"eval loop launches over {LOOP_BATCHES} batches: {launches}")
        check(launches == {**{k: 0 for k in launches},
                           "fused_blend2d": 24 * LOOP_BATCHES},
              f"eval loop launches {launches}, expected K1 alone, 24 per "
              f"batch")
        losses = res["eval_losses"]
        print(f"eval loop: mAP {res['mAP']:.6f}, eval losses "
              f"{ {k: round(v, 5) for k, v in losses.items()} }")
        check(0.0 <= res["mAP"] <= 1.0, f"mAP {res['mAP']}")
        check(all(np.isfinite(v) for v in losses.values()),
              f"eval losses not finite: {losses}")
        with open(os.path.join(tmp, "res", "0.txt")) as f:
            loop_rows = f.readlines()
        buffers = EvalBuffers()
        for batch, meta in loader:
            _, outs = serve(model, batch["pixels"], batch["mask"], dev)
            buffer_ava(buffers, *(x.float().cpu().numpy() for x in outs), meta)
        same = buffers.det_lines == loop_rows
        print(f"eval loop: {len(loop_rows)} detection rows "
              f"{'equal' if same else 'DIFFERENT'} to serve + postprocess_ava"
              f" on the same batches")
        check(same, "the eval loop's detection rows differ from phase 3's "
                    "path")
        meds, busy = timed_loop(
            {"with the criterion": run,
             "without": lambda: run_validation(
                 cfg, model, post, loader, transfer_dtype=torch.bfloat16)},
            LOOP_BATCHES, "AVA eval loop (B=2, bf16 shipping, txt protocol, "
            "AVA evaluator)", {"fused_blend2d": 24 * LOOP_BATCHES},
            LOOP_REPS)
        med = meds["with the criterion"]
        t0 = time.perf_counter()
        ev = STDetectionEvaluaterAVA(cfg.CONFIG.DATA.LABEL_PATH, [0.5], 80)
        ev.load_GT_from_path([os.path.join(tmp, "res", "GT_0.txt")])
        ev.load_detection_from_path([os.path.join(tmp, "res", "0.txt")])
        ev.evaluate()
        ev_ms = (time.perf_counter() - t0) * 1e3 / LOOP_BATCHES
        print(f"eval loop {med:.2f} ms/batch against phase 3's forward + "
              f"postprocess {main_ms:.2f} ms/batch ({med / main_ms:.2f}x); "
              f"without the criterion {meds['without']:.2f} ms/batch; "
              f"the AVA evaluator (txt files -> mAP) {ev_ms:.2f} ms per batch "
              f"of the run")
    del model
    torch.cuda.empty_cache()
    return launches, med, busy, save_s, load_s


def phase_tube_loop(dev, counters):
    """Phase 32: ``UCF_ViT-B_fast`` at full width in bf16 through the eval
    loop over 2 batches of B=1 (32x224x224): ``buffer_frames`` and the UCF
    evaluator, 12 K1 launches per batch, a finite video mAP."""
    import tempfile

    from class_query_vad_tpu_torch.datasets import DataLoader
    from class_query_vad_tpu_torch.engine.evaluate import run_validation
    from class_query_vad_tpu_torch.losses import (
        build_criterion_and_postprocessor, build_matcher)
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    with tempfile.TemporaryDirectory() as tmp:
        cfg = loop_cfg(TUBE_CONFIGS["UCF_ViT-B_fast"], tmp, TUBE_LOOP_CANVAS,
                       1)
        loader = DataLoader(SyntheticClips(cfg, TUBE_LOOP_BATCHES, 32,
                                           TUBE_LOOP_CANVAS[1:]),
                            1, cfg, num_workers=2)
        model = build_model(cfg, dtype=torch.bfloat16)
        randomize_constants(model, torch.Generator().manual_seed(33))
        criterion, post, _ = build_criterion_and_postprocessor(
            cfg, build_matcher(cfg))

        def run():
            return run_validation(cfg, model, post, loader,
                                  criterion=criterion,
                                  transfer_dtype=torch.bfloat16)

        for c in counters:
            c.launches = 0
        res = run()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        print(f"UCF loop launches over {TUBE_LOOP_BATCHES} batches: "
              f"{launches}; frame mAP {res['mAP']:.6f}, video mAP "
              f"{res['v_mAP']:.6f}, eval loss "
              f"{res['eval_losses']['total_loss']:.5f}")
        check(launches == {**{k: 0 for k in launches},
                           "fused_blend2d": 12 * TUBE_LOOP_BATCHES},
              f"UCF loop launches {launches}, expected K1 alone, 12 per "
              f"batch")
        check(np.isfinite(res["v_mAP"]) and 0.0 <= res["v_mAP"] <= 1.0,
              f"video mAP {res['v_mAP']}")
        check(np.isfinite(res["eval_losses"]["total_loss"]),
              "UCF eval loss not finite")
        meds, _ = timed_loop({"with the criterion": run}, TUBE_LOOP_BATCHES,
                             "UCF eval loop (B=1)",
                             {"fused_blend2d": 12 * TUBE_LOOP_BATCHES}, 2)
        med = meds["with the criterion"]
    del model
    torch.cuda.empty_cache()
    return launches, med


def _masters_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.optimizer.masters,
                                                 b.optimizer.masters))


def _kernels_repeat(dev) -> dict:
    """Whether K3 and K4 give the same bits twice on the same inputs (the
    main path's level shapes, B=1, bf16)."""
    from class_query_vad_tpu_torch.ops.blend2d import (blend2d_bwd_dcomps,
                                                       blend2d_bwd_dvol)

    rng = np.random.default_rng(33)
    same = {"blend2d_bwd_dvol": True, "blend2d_bwd_dcomps": True}
    for h, w in K1_LEVELS:
        (vol, dx, dy, a), g = blend_inputs(rng, 1, h, w, torch.bfloat16, dev)
        for name, fn in (
                ("blend2d_bwd_dvol",
                 lambda: (blend2d_bwd_dvol(dx, dy, a, g, torch.bfloat16, 8),)),
                ("blend2d_bwd_dcomps",
                 lambda: blend2d_bwd_dcomps(vol, dx, dy, a, g, 8))):
            x, y = fn(), fn()
            same[name] &= all(torch.equal(p, q) for p, q in zip(x, y))
    return same


def phase_train_resume(dev, counters):
    """Phase 33: the train CLI's loop at full width: ``AVA22_ViT-B_fast``
    in bf16, B=1, GRAD_ACCUM 1, dropout and drop path on.  3 uninterrupted
    ``Trainer.step``s against 2 steps, ``save_checkpoint``, a fresh model
    and trainer (another init) restored by ``load_checkpoint`` and 1 more
    step: the masters, AdamW's state and the RNG streams restored exactly,
    the third step's loss within ``TRAIN_LOSS_TOL`` relative, 24 launches
    each of K1, K3 and K4 per step and of no other kernel; whether the two
    runs' first two steps gave the same bits (and, if not, whether K3 / K4
    repeat their bits), and the third step's parameters within phase 6's
    gradient tolerance of the update."""
    import tempfile

    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.engine.checkpoint import (
        load_checkpoint, save_checkpoint)
    from class_query_vad_tpu_torch.models import build_model

    cfg = get_cfg_custom(CONFIG)
    cfg.CONFIG.TRAIN.GRAD_ACCUM = 1
    check(cfg.CONFIG.MODEL.DROPOUT > 0 and cfg.CONFIG.ViT.DROP_PATH_RATE > 0,
          "phase 33 needs dropout and drop path on")
    batches = [train_batch(cfg, seed=40 + i) for i in range(RESUME_STEPS)]

    def trainer(seed: int):
        return Trainer(build_model(cfg, dtype=torch.bfloat16,
                                   generator=torch.Generator().manual_seed(seed)),
                       cfg)

    step_counts, losses = [], {"uninterrupted": [], "resumed": []}

    def step(t, batch, run):
        counts = [c.launches for c in counters]
        m = t.step(batch)
        torch.cuda.synchronize()
        step_counts.append({c.__name__: c.launches - n
                            for c, n in zip(counters, counts)})
        losses[run].append(m["total_loss"].item())

    with tempfile.TemporaryDirectory() as tmp:
        cfg.CONFIG.LOG.BASE_PATH = tmp
        cfg.CONFIG.LOG.EXP_NAME = "resume"
        u = trainer(33)
        for b in batches[:-1]:
            step(u, b, "uninterrupted")
        u_prev = [m.clone() for m in u.optimizer.masters]
        step(u, batches[-1], "uninterrupted")
        r = trainer(33)
        for b in batches[:-1]:
            step(r, b, "resumed")
        deterministic = all(torch.equal(x, y) for x, y in
                            zip(r.optimizer.masters, u_prev))
        torch.cuda.synchronize()
        rng_at_save = (torch.get_rng_state(), torch.cuda.get_rng_state_all())
        t0 = time.perf_counter()
        path = save_checkpoint(cfg, r, 1)
        save_s = time.perf_counter() - t0
        q = trainer(34)                # another init, the RNG reseeded
        t0 = time.perf_counter()
        meta = load_checkpoint(path, q)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path) / 2**20
    rng_same = (torch.equal(torch.get_rng_state(), rng_at_save[0])
                and all(torch.equal(x, y) for x, y in
                        zip(torch.cuda.get_rng_state_all(), rng_at_save[1])))
    so, sr = q.optimizer.opt.state_dict(), r.optimizer.opt.state_dict()
    opt_same = (q.optimizer.steps == r.optimizer.steps
                and q.optimizer.micro == r.optimizer.micro
                and all(torch.equal(so["state"][i][k], v)
                        for i, st in sr["state"].items()
                        for k, v in st.items()))
    restored = _masters_equal(q, r) and opt_same and rng_same
    print(f"resume: checkpoint of the trainer ({size:.1f} MiB: bf16 model, "
          f"float32 masters, AdamW moments) saved in {save_s:.2f} s, loaded "
          f"into a fresh model and trainer in {load_s:.2f} s (epoch "
          f"{meta['epoch']}); masters, AdamW state, counters and RNG "
          f"streams {'restored exactly' if restored else 'DIFFERENT'}")
    check(restored, f"resume did not restore the state (masters "
                    f"{_masters_equal(q, r)}, optimizer {opt_same}, RNG "
                    f"{rng_same})")
    del r
    step(q, batches[-1], "resumed")
    check(all(d == {**{k: 0 for k in d}, **{k: 24 for k in TRAIN_KERNELS["2d"]}}
              for d in step_counts),
          f"resume launches per step {step_counts}, expected 24 each of "
          f"K1, K3, K4 and no other kernel")
    lu, lr = losses["uninterrupted"], losses["resumed"]
    e = abs(lr[-1] - lu[-1]) / abs(lu[-1])
    print(f"resume: losses uninterrupted {lu}, resumed {lr}; third step rel "
          f"err {e:.2e} (tol {TRAIN_LOSS_TOL:.0e}); the two runs' first "
          f"{RESUME_STEPS - 1} steps {'bit-identical' if deterministic else 'NOT bit-identical'}")
    check(e <= TRAIN_LOSS_TOL, "the resumed step's loss disagrees")
    if not deterministic:
        print(f"resume: K3 / K4 repeat their bits on the same inputs: "
              f"{_kernels_repeat(dev)} (the rest of the backward is "
              f"PyTorch's, whose scatter-adds use atomics)")
    # the third step's parameters: within TRAIN_GRAD_TOL of each tensor's
    # update (+ the floor), bit for bit where the runs were
    worst, exact = (0.0, ""), True
    upd_max = max((a - b).abs().max().item()
                  for a, b in zip(u.optimizer.masters, u_prev))
    names = [n for n, p in q.model.named_parameters() if p.requires_grad]
    for name, a, b, p in zip(names, q.optimizer.masters, u.optimizer.masters,
                             u_prev):
        exact &= torch.equal(a, b)
        lim = (TRAIN_GRAD_TOL * (b - p).abs().max().item()
               + TRAIN_GRAD_FLOOR * upd_max)
        err = (a - b).abs().max().item()
        if lim > 0 and err / lim > worst[0]:
            worst = (err / lim, name)
        check(err <= lim or err == 0, f"resumed parameter {name} differs by "
                                      f"{err:.3e} > {lim:.3e}")
    print(f"resume: parameters after the third step "
          f"{'equal bit for bit' if exact else 'within tolerance'}; closest "
          f"to its limit: {worst[1] or '-'} at {worst[0]:.1%}")
    if deterministic:
        check(exact, "the resumed run's parameters differ from a "
                     "deterministic uninterrupted run's")
    del q, u
    torch.cuda.empty_cache()
    launches = {k: sum(d[k] for d in step_counts) for k in step_counts[0]}
    return launches, save_s, load_s


# ---- CSN, gradient checkpointing and on-device preprocessing (phases
# 34-37)
CSN_CONFIGS = {k: os.path.join(REPO, "configuration", f"AVA22_{k}.yaml")
               for k in ("CSN50", "CSN152")}
CSN_TRAIN_STEPS = 3                   # 1 + 4 until phases 38-40 came
# the float32 card-vs-CPU checks of CSN-50 (its 16 bottlenecks whole): the
# forward at EXACT_FWD_CPU_LAYERS (2) of the YAML's 6 encoder layers, as
# phase 25 cuts AVA22_ViT-B; the train step at 1 encoder layer and the
# YAML's 6 decoder layer pairs (its TUNE_POINT 4 freezes the stem, layer1
# and layer2, so the backward stops at layer3)
CSN_TRAIN_CPU_LAYERS = 1
# phase 36: 1 + 1 bf16 train steps with GRADIENT_CHECKPOINTING off and on
# (1 + 2 until phases 38-40 came), and one float32 step each way: loss and
# gradients within REMAT_TOL x max
REMAT_STEPS = 2
REMAT_TOL = 1e-5
# the Mamba YAMLs accumulate 64 / 128 micro-batches; one step per update
# here, as the other paths' YAMLs
MAMBA_OPTS = ("CONFIG.TRAIN.GRAD_ACCUM", 1)
REMAT_CONFIGS = {"AVA22_ViT-B_fast (main path)": (CONFIG, ()),
                 "AVA22_ViT-B": (EXACT_CONFIG, ()),
                 "AVA22_CSN152": (CSN_CONFIGS["CSN152"], ()),
                 "AVA22_train-mamba_VSS": (VSS_CONFIG, MAMBA_OPTS),
                 "AVA22_ViT-B-train-mamba": (MAMBA_EXACT_CONFIG, MAMBA_OPTS)}
# launches per step with GRADIENT_CHECKPOINTING off and on: K1 runs again
# in each fast encoder layer's recompute, K5 in each VideoMamba block's
# and SSM encoder layer's; the backward kernels run once either way
REMAT_LAUNCHES = {
    "AVA22_ViT-B_fast (main path)": {
        r: {"fused_blend2d": 48 if r else 24, "blend2d_bwd_dvol": 24,
            "blend2d_bwd_dcomps": 24} for r in (False, True)},
    "AVA22_train-mamba_VSS": {
        r: {"selective_scan": 192 if r else 96, "selective_scan_bwd": 96}
        for r in (False, True)},
    "AVA22_ViT-B-train-mamba": {
        r: {"selective_scan": 96 if r else 48, "selective_scan_bwd": 48}
        for r in (False, True)},
}
# phase 37: decoded frames of 400x500 (the JAX bench's --device-preprocess
# size: a short side of 256 and the centre crop give 256x320)
PREP_RAW_HW = (400, 500)
PREP_BATCHES = 4
PREP_REPS = 3
PREP_TOL = 1e-6
PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]], np.float32)


def csn_probe(dev):
    """For ``phase_serve``: the exact encoder's tokens per clip (CSN's four
    levels after ``input_proj``), and the device ms of the CSN trunk's bf16
    forward with its convolutions in NCDHW and in ``channels_last_3d``
    (weights and activations), timed in turns (A B B A)."""
    def probe(model, pixels, mask):
        body = model.backbone[0].body
        shapes = []
        hook = model.input_proj.register_forward_hook(
            lambda _m, _i, out: shapes.extend(tuple(x.shape[1:4])
                                              for x in out))
        serve(model, pixels[:1], mask[:1], dev)
        hook.remove()
        tokens = sum(t * h * w for t, h, w in shapes)
        print(f"CSN levels (T, H, W) after input_proj {shapes}: {tokens} "
              f"exact-encoder tokens per clip")
        x = torch.from_numpy(pixels).to(dev)
        ms = {torch.contiguous_format: [], torch.channels_last_3d: []}
        with torch.inference_mode():
            for fmt in (torch.contiguous_format, torch.channels_last_3d,
                        torch.channels_last_3d, torch.contiguous_format):
                body.to(memory_format=fmt)
                body.memory_format = fmt
                ms[fmt].append(cuda_ms(lambda: body(x), 5))
        body.to(memory_format=torch.contiguous_format)
        del body.memory_format
        a, b = (statistics.mean(v) for v in ms.values())
        print(f"CSN trunk bf16 forward, B={x.shape[0]} "
              f"{'x'.join(map(str, x.shape[1:4]))}: NCDHW {a:.2f} ms, "
              f"channels_last_3d {b:.2f} ms (device, means of 2 turns of 5; "
              f"all {[round(v, 3) for v in sum(ms.values(), [])]}) -> "
              f"channels_last_3d {a / b:.2f}x")
    return probe


def stats_unchanged(model):
    """After ``Trainer.step``s: the running statistics of every batch norm
    (CSN's; the VSS blocks' FrozenBatchNorm, in inference form in
    ``train()`` too) still at their init (mean 0, variance 1)."""
    norms = [m for m in model.modules() if hasattr(m, "running_mean")]
    same = all(bool((m.running_mean == 0).all() and (m.running_var == 1).all())
               for m in norms)
    print(f"running statistics of {len(norms)} batch norms "
          f"{'unchanged' if same else 'CHANGED'} by the train steps")
    check(bool(norms) and same, "a train step moved running statistics")


def phase_csn(dev, counters):
    """Phases 34-35: ``AVA22_CSN152`` served (B=2, 32x256x320, bf16; no
    hand kernel, as in JAX) with the trunk's memory-format timing, the
    float32 forward of ``AVA22_CSN50`` card vs CPU; CSN-152 trained (1 + 4
    bf16 B=1 steps, its running statistics unchanged) and one float32
    CSN-50 train step card vs CPU.  Returns the launches."""
    zero = {c.__name__: 0 for c in counters}
    with phase_seconds("phase 34 (AVA22_CSN152 served, CSN-50 card vs CPU)"):
        served, _ = phase_serve(dev, counters, CSN_CONFIGS["CSN152"],
                                "CSN-152", (91, 92, 93), probe=csn_probe(dev))
        cpu_s = phase_in_model(
            dev, CSN_CONFIGS["CSN50"], ["CONFIG.MODEL.ENC_LAYERS",
                                        EXACT_FWD_CPU_LAYERS], tag="CSN-50 ")
    print(f"CSN-50 card-vs-CPU forward at {EXACT_FWD_CPU_LAYERS} of the "
          f"YAML's 6 encoder layers; its CPU forward {cpu_s:.1f} s")
    with phase_seconds("phase 35 (AVA22_CSN152 trained, CSN-50 card vs CPU)"):
        trained = phase_train(dev, counters, steps=CSN_TRAIN_STEPS,
                              tag="CSN-152 ", config=CSN_CONFIGS["CSN152"],
                              kernels=(), after=stats_unchanged)
        phase_train_card_vs_cpu(
            dev, ["CONFIG.MODEL.ENC_LAYERS", CSN_TRAIN_CPU_LAYERS],
            "CSN-50 ", counters, zero, CSN_CONFIGS["CSN50"])
    return {"AVA22_CSN152 eval, 3 requests": served,
            f"AVA22_CSN152 train, {CSN_TRAIN_STEPS} steps": trained}


def set_gradient_checkpointing(model, on: bool) -> None:
    """``CONFIG.GRADIENT_CHECKPOINTING`` switched on a built model, as
    ``build_model`` sets it from the config: every container that remats
    (the encoder, the decoder, CSN's trunk, the ViT) follows it; a ViT
    also remats on its own ``USE_CHECKPOINT``."""
    from class_query_vad_tpu_torch.models.vit import ViT

    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = on or (isinstance(m, ViT) and m.spec.use_checkpoint)


def remat_steps(counters, trainer, batch, remat: bool):
    """``REMAT_STEPS`` bf16 ``Trainer.step``s with ``GRADIENT_CHECKPOINTING``
    ``remat``: (median ms/step after the first, peak GiB from the second
    step on, launches per step)."""
    set_gradient_checkpointing(trainer.model, remat)
    times, per_step = [], []
    for i in range(REMAT_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        counts = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
              f"remat={remat}: a loss is not finite")
        per_step.append({c.__name__: c.launches - n
                         for c, n in zip(counters, counts)})
    peak = torch.cuda.max_memory_allocated() / 2**30
    return statistics.median(times), peak, per_step


def remat_grads(trainer, batch, remat: bool):
    """One train step's loss and gradients (no update) with
    ``GRADIENT_CHECKPOINTING`` ``remat``, dropout and drop path on, the
    RNG seeded alike (the recompute replays its state)."""
    model = trainer.model
    set_gradient_checkpointing(model, remat)
    torch.manual_seed(5)
    total, _, _ = trainer.loss(batch)
    total.backward()
    grads = {k: p.grad.float().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return total.item(), grads


def phase_remat(dev, counters):
    """Phase 36: ``CONFIG.GRADIENT_CHECKPOINTING`` off and on for the main
    path, ``AVA22_ViT-B``, ``AVA22_CSN152`` and the Mamba family
    (``REMAT_CONFIGS``), switched on one built model
    (``set_gradient_checkpointing``, held to the build's own flags):
    full-width bf16 train steps (ms/step, peak GiB, launches per step: under
    remat K1 runs again in the recompute of each fast encoder layer, K3 and
    K4 do not; K5 in each VideoMamba block's and SSM encoder layer's,
    ``REMAT_LAUNCHES``), then one float32 step each way, dropout on: the same loss
    and gradients within ``REMAT_TOL`` x max.  Returns the launches under
    remat."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    out = {}
    for name, (config, opts) in REMAT_CONFIGS.items():
        cfg = get_cfg_custom(config, list(opts))
        trainer = Trainer(build_model(cfg, dtype=torch.bfloat16), cfg)
        built = [m.remat for m in trainer.model.modules()
                 if hasattr(m, "remat")]
        set_gradient_checkpointing(trainer.model, False)
        check(built == [m.remat for m in trainer.model.modules()
                        if hasattr(m, "remat")],
              f"remat {name}: the switch differs from build_model's flags")
        batch = train_batch(cfg)
        res = {remat: remat_steps(counters, trainer, batch, remat)
               for remat in (False, True)}
        del trainer
        torch.cuda.empty_cache()
        for remat, (ms, peak, per_step) in res.items():
            nonzero = [{k: v for k, v in d.items() if v} for d in per_step]
            print(f"remat {name}, GRADIENT_CHECKPOINTING {remat}: median "
                  f"{ms:.2f} ms/step over {REMAT_STEPS - 1} steps, peak "
                  f"{peak:.2f} GiB; launches per step {nonzero}")
        for remat, (_, _, per_step) in res.items():
            want = REMAT_LAUNCHES.get(name, {}).get(remat, {})
            check(all(d == {**{k: 0 for k in d}, **want} for d in per_step),
                  f"remat {name} ({remat}): launches per step {per_step}, "
                  f"expected {want or 'none'}")
        cfg = get_cfg_custom(config, ["CONFIG.MODEL.FAST_DTYPE", "float32",
                                      "CONFIG.MODEL.DECODER_DTYPE",
                                      "float32", *opts])
        model = build_model(cfg, torch.float32, dev,
                            torch.Generator().manual_seed(7))
        randomize_constants(model, torch.Generator().manual_seed(8))
        trainer = Trainer(model, cfg)
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in train_batch(cfg, seed=3).items()}
        (l0, g0), (l1, g1) = (remat_grads(trainer, batch, r)
                              for r in (False, True))
        del trainer, model
        torch.cuda.empty_cache()
        e = abs(l1 - l0) / abs(l0)
        check(e <= REMAT_TOL, f"remat {name}: loss {l1} against {l0}")
        check(sorted(g0) == sorted(g1), f"remat {name}: other parameters "
                                        f"got gradients")
        floor = TRAIN_GRAD_FLOOR * max(g.abs().max().item()
                                       for g in g0.values())
        worst = max(((g1[k] - g).abs().max().item()
                     / (REMAT_TOL * g.abs().max().item() + floor), k)
                    for k, g in g0.items())
        print(f"remat {name}: float32 step, dropout on: loss {l0:.7f} off, "
              f"{l1:.7f} on (rel {e:.1e}); gradients of {len(g0)} tensors, "
              f"the farthest {worst[1]} at {worst[0]:.1%} of {REMAT_TOL:.0e}"
              f" x its max + {TRAIN_GRAD_FLOOR:.0e} x the model's")
        check(worst[0] <= 1, f"remat {name}: gradients of {worst[1]} differ")
        out[f"{name} train with remat, {REMAT_STEPS} steps"] = {
            k: sum(d[k] for d in res[True][2]) for k in res[True][2][0]}
    return out


MAMBA_TRAIN_STEPS = 4
# phase 40: VideoMamba cut to 2 of its 24 blocks (the full 5121-token
# sequence), the VSS encoder to 2 of its 6 layers, the decoder to 1 of its
# 6 layer pairs, for the CPU's time (the plain scans' backward)
MAMBA_TRAIN_CPU_DEPTH = 2
MAMBA_TRAIN_CPU_LAYERS = 2
MAMBA_TRAIN_CPU_DEC_LAYERS = 1


def phase_mamba_train(dev, counters):
    """Phase 39: ``AVA22_train-mamba_VSS`` and ``AVA22_ViT-B-train-mamba``
    train at full width in bf16 (``phase_train``): K5 and its backward 96
    (48) times each per step.  Returns the launches of both runs."""
    out = {}
    for name, config, per_step in (
            ("AVA22_train-mamba_VSS", VSS_CONFIG, 96),
            ("AVA22_ViT-B-train-mamba", MAMBA_EXACT_CONFIG, 48)):
        tag = "VSS " if config == VSS_CONFIG else "VideoMamba + exact "
        out[f"{name} train, {MAMBA_TRAIN_STEPS} steps"] = phase_train(
            dev, counters, steps=MAMBA_TRAIN_STEPS, tag=tag, config=config,
            kernels=("selective_scan", "selective_scan_bwd"),
            per_step=per_step, opts=MAMBA_OPTS,
            after=stats_unchanged if config == VSS_CONFIG else None)
    return out


def phase_mamba_card_vs_cpu(dev, counters):
    """Phase 40: one float32 ``AVA22_train-mamba_VSS`` train step card vs
    CPU at a cut depth (``MAMBA_TRAIN_CPU_*``; VideoMamba's widths and
    sequence whole), ``phase_train_card_vs_cpu``'s checks: K5 and its
    backward 2 x 2 backbone + 2 x 2 x 4 encoder times each on the card."""
    scans = 2 * MAMBA_TRAIN_CPU_DEPTH + 2 * 4 * MAMBA_TRAIN_CPU_LAYERS
    with videomamba_depth(MAMBA_TRAIN_CPU_DEPTH):
        phase_train_card_vs_cpu(
            dev, ["CONFIG.MODEL.ENC_LAYERS", MAMBA_TRAIN_CPU_LAYERS,
                  "CONFIG.MODEL.DEC_LAYERS", MAMBA_TRAIN_CPU_DEC_LAYERS,
                  *MAMBA_OPTS], "VSS ", counters,
            {**{c.__name__: 0 for c in counters},
             "selective_scan": scans, "selective_scan_bwd": scans},
            VSS_CONFIG)


def phase_device_preprocess(dev, counters, loop_ms: float):
    """Phase 37: on-device preprocessing (``datasets.device_preprocess``),
    the JAX bench's ``--device-preprocess`` route.  The eval graph's uint8
    resize of [2, 16, 400, 500, 3] frames on the card against the same
    function on the CPU (and ``native_decode``'s resize where it builds),
    bit for bit, its normalized output within ``PREP_TOL``; the main path
    served through ``run_validation`` from uint8 frames (``transfer_dtype
    None``, the graph in ``forward_fn``) against phase 31's route (float32
    clips, bf16 shipping) on the same batches, interleaved: ms/batch,
    bytes shipped, 24 K1 launches per batch; the train graph card vs CPU,
    then feeding one main-path train step (24 each of K1, K3, K4).
    Returns the launches."""
    import tempfile

    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.datasets import DataLoader, native_decode
    from class_query_vad_tpu_torch.datasets.device_preprocess import (
        draw_train_params, make_eval_preprocess, make_train_preprocess,
        pil_resize_bicubic, resized_dims)
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.engine.evaluate import run_validation
    from class_query_vad_tpu_torch.losses import (
        build_criterion_and_postprocessor, build_matcher)
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.models.detr import randomize_constants

    img = int(get_cfg_custom(CONFIG).CONFIG.DATA.IMG_SIZE)
    rng = np.random.default_rng(37)
    raw = [rng.integers(0, 256, (2, 16) + PREP_RAW_HW + (3,), np.uint8)
           for _ in range(PREP_BATCHES)]
    nw, nh = resized_dims(img, PREP_RAW_HW[1], PREP_RAW_HW[0])
    card = pil_resize_bicubic(torch.from_numpy(raw[0]).to(dev), (nh, nw))
    t0 = time.perf_counter()
    host = pil_resize_bicubic(torch.from_numpy(raw[0][:1]), (nh, nw))
    cpu_s = time.perf_counter() - t0
    card = card.cpu()
    same = torch.equal(card[:1], host)
    print(f"device preprocessing: uint8 resize {PREP_RAW_HW} -> {(nh, nw)} "
          f"of 16 frames, card {'equal' if same else 'DIFFERENT'} bit for "
          f"bit to the CPU ({cpu_s:.1f} s there)")
    check(same, "the card's uint8 resize differs from the CPU's")
    built = native_decode.available()
    if built:
        ref = np.stack([native_decode.resize(f, nw, nh) for f in raw[0][0]])
        same = np.array_equal(ref, card[0].numpy())
        check(same, "the card's uint8 resize differs from native_decode's")
    print(f"device preprocessing: native_decode "
          f"{'built; its resize ' + ('equal bit for bit' if same else 'DIFFERENT') if built else 'did not build (no g++, libjpeg or libpng): no check against it'}")
    f32, out_hw = make_eval_preprocess(img, PREP_RAW_HW)
    err = (f32(torch.from_numpy(raw[0]).to(dev)).cpu()
           - f32(torch.from_numpy(raw[0][:1]))).abs()[:1].max().item()
    print(f"device preprocessing: eval graph's float32 output card vs CPU "
          f"max|err| {err:.1e} (tol {PREP_TOL:.0e}), out {out_hw}")
    check(err <= PREP_TOL and out_hw == LOOP_CANVAS,
          "the eval graph differs between card and CPU")

    pre, _ = make_eval_preprocess(img, PREP_RAW_HW, torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = loop_cfg(CONFIG, tmp, LOOP_CANVAS, 2)
        cfg.CONFIG.DATA.LABEL_PATH = write_labelmap(
            os.path.join(tmp, "labelmap.pbtxt"))
        floats = list(DataLoader(SyntheticClips(cfg, 2 * PREP_BATCHES, 37,
                                                LOOP_WIDTHS[:1]), 2, cfg,
                                 num_workers=2))
        u8 = [({"pixels": r, "mask": b["mask"]}, meta)
              for r, (b, meta) in zip(raw, floats)]
        model = build_model(cfg, dtype=torch.bfloat16)
        randomize_constants(model, torch.Generator().manual_seed(37))
        _, post, _ = build_criterion_and_postprocessor(cfg, build_matcher(cfg))
        runs = {
            "uint8 frames, preprocessed on the card": lambda: run_validation(
                cfg, model, post, u8, transfer_dtype=None,
                forward_fn=lambda px, mk: model(pre(px), mk)),
            "float32 clips, bf16 shipping": lambda: run_validation(
                cfg, model, post, floats, transfer_dtype=torch.bfloat16),
        }
        for c in counters:
            c.launches = 0
        res = runs["uint8 frames, preprocessed on the card"]()
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        check(launches == {**{k: 0 for k in launches},
                           "fused_blend2d": 24 * PREP_BATCHES},
              f"preprocess loop launches {launches}, expected K1 alone, 24 "
              f"per batch")
        check(0.0 <= res["mAP"] <= 1.0, f"mAP {res['mAP']}")
        meds, _ = timed_loop(runs, PREP_BATCHES, "eval loop without the "
                             "criterion (B=2)", {"fused_blend2d":
                                                 24 * PREP_BATCHES},
                             PREP_REPS)
        u8_bytes = raw[0].nbytes
        bf16_bytes = floats[0][0]["pixels"].size * 2
        print(f"device preprocessing: {u8_bytes / 2**20:.2f} MiB of uint8 "
              f"frames shipped per batch against {bf16_bytes / 2**20:.2f} "
              f"MiB of bf16 pixels ({u8_bytes / bf16_bytes:.2f}x; float32 "
              f"{2 * bf16_bytes / 2**20:.2f} MiB); ms/batch "
              + ", ".join(f"{k} {v:.2f}" for k, v in meds.items())
              + f"; phase 31's loop with the criterion {loop_ms:.2f}")
        del model
    torch.cuda.empty_cache()

    tcfg = get_cfg_custom(CONFIG)
    trainer = Trainer(build_model(tcfg, dtype=torch.bfloat16), tcfg)
    params = draw_train_params(np.random.default_rng(38), img, PREP_RAW_HW,
                               0.4, 0.4, 0.1, PCA_EIGVAL, PCA_EIGVEC)
    frames = torch.from_numpy(raw[1][:1])
    t32, thw = make_train_preprocess(img, PREP_RAW_HW)
    err = (t32(frames.to(dev), params).cpu() - t32(frames, params)).abs()
    print(f"device preprocessing: train graph (flip {bool(params['flip'])}, "
          f"crop {params['crop_yx'].tolist()}, HSV {params['hsv_shift'].tolist()}"
          f") float32 card vs CPU max|err| {err.max().item():.1e}, out {thw}")
    check(err.max().item() <= PREP_TOL, "the train graph differs between "
                                        "card and CPU")
    tfn, _ = make_train_preprocess(img, PREP_RAW_HW, torch.bfloat16)
    batch = train_batch(tcfg, seed=38)
    batch["pixels"] = tfn(frames.to(dev), params)
    for c in counters:
        c.launches = 0
    metrics = trainer.step(batch)
    torch.cuda.synchronize()
    train = {c.__name__: c.launches for c in counters}
    print(f"device preprocessing: a main-path train step on the train "
          f"graph's pixels, total loss {metrics['total_loss'].item():.5f}, "
          f"launches {train}")
    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
          "the preprocessed train step's losses are not finite")
    check(train == {**{k: 0 for k in train},
                    **{k: 24 for k in TRAIN_KERNELS["2d"]}},
          f"preprocessed train step launches {train}")
    del trainer
    torch.cuda.empty_cache()
    return {f"uint8 eval loop, {PREP_BATCHES} batches": launches,
            "preprocessed train step": train}


# phase 41: DDP_STEPS timed steps, DDP_LOOP_BATCHES eval-loop batches
DDP_STEPS = 4
DDP_LOOP_BATCHES = 2


def phase_distributed(dev, counters):
    """Phase 41 (see the module docstring).  Returns the launches of the
    timed DDP steps and of the eval loop, by path."""
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from class_query_vad_tpu_torch import parallel
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.datasets import DataLoader
    from class_query_vad_tpu_torch.engine import Trainer, run_validation
    from class_query_vad_tpu_torch.losses import (
        build_criterion_and_postprocessor, build_matcher)
    from class_query_vad_tpu_torch.models import build_model

    # CSN-50's step without a process group (sync-BN off), before it comes up
    _, off = csn_step(dev)
    cfg = get_cfg_custom(CONFIG, ["CONFIG.MODEL.FAST_WINDOW", "2d"])
    batch = train_batch(cfg)
    plain = Trainer(build_model(cfg, dtype=torch.bfloat16), cfg)
    os.environ.update(MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(parallel.free_port()))
    rank_dev = parallel.initialize_distributed("cuda", rank=0, world=1)
    ddp = Trainer(build_model(cfg, dtype=torch.bfloat16), cfg)
    print(f"process group: backend {dist.get_backend()}, world "
          f"{parallel.world_size()}, rank {parallel.rank()} on {rank_dev}; "
          f"Trainer in {type(ddp.net).__name__}, the unwrapped one in "
          f"{type(plain.net).__name__}")
    check(dist.get_backend() == "nccl" and rank_dev == dev
          and ddp.distributed and not plain.distributed,
          "the DDP trainer is not on NCCL at world 1 on the card")
    metrics = []
    for tr in (plain, ddp):
        torch.manual_seed(0)          # the same dropout / drop path draws
        metrics.append(tr.step(batch))
    loss_eq = torch.equal(metrics[0]["total_loss"], metrics[1]["total_loss"])
    masters = list(zip(plain.optimizer.masters, ddp.optimizer.masters))
    same = sum(torch.equal(a, b) for a, b in masters)
    worst = max((a - b).abs().max().item() for a, b in masters)
    print(f"DDP (world 1, NCCL) vs unwrapped first step: total "
          f"{metrics[1]['total_loss'].item():.6f} vs "
          f"{metrics[0]['total_loss'].item():.6f} "
          f"({'equal' if loss_eq else 'DIFFERENT'} bit for bit); float32 "
          f"masters after AdamW equal in {same}/{len(masters)} tensors "
          f"(max |diff| {worst:.3e})")
    check(loss_eq and same == len(masters),
          "the DDP step differs from the unwrapped step at world 1")
    del masters

    # the two trainers' steps interleaved (every other round the DDP one
    # first), so that host drift hits both
    times = {"unwrapped": [], "DDP": []}
    step_counts = []
    for c in counters:
        c.launches = 0
    for i in range(DDP_STEPS):
        order = (("unwrapped", plain), ("DDP", ddp))
        for tag, tr in (order if i % 2 else order[::-1]):
            counts = [c.launches for c in counters]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.step(batch)
            torch.cuda.synchronize()
            times[tag].append((time.perf_counter() - t0) * 1e3)
            check(all(bool(torch.isfinite(v).all()) for v in m.values()),
                  f"{tag} step {i}: metrics not finite {m}")
            if tr is ddp:
                step_counts.append({c.__name__: c.launches - n
                                    for c, n in zip(counters, counts)})
    launches = {k: sum(d[k] for d in step_counts) for k in step_counts[0]}
    check(all(d == {**{k: 0 for k in d}, **{k: 24 for k in TRAIN_KERNELS["2d"]}}
              for d in step_counts),
          f"DDP train launches per step {step_counts}, expected 24 each of "
          f"K1, K3, K4 and no other kernel")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"DDP train (world 1, NCCL), B={TRAIN_B} bf16: median "
          f"{med['DDP']:.2f} ms/step against the unwrapped trainer's "
          f"{med['unwrapped']:.2f} in the same rounds "
          f"({med['DDP'] / med['unwrapped'] - 1:+.1%}; {DDP_STEPS} steps "
          f"each, interleaved: DDP {[round(x, 2) for x in times['DDP']]}, "
          f"unwrapped {[round(x, 2) for x in times['unwrapped']]}) and "
          f"phase 5's {TRAIN_MS['']:.2f}; DDP launches over its "
          f"{DDP_STEPS} steps {launches}")
    # where the DDP step's extra host time goes: the host ops whose self
    # time grew most against the unwrapped step's, one profiled step each
    profs = {}
    for tag, tr in (("unwrapped", plain), ("DDP", ddp)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.step(batch)
            torch.cuda.synchronize()
        profs[tag] = prof.key_averages()
    host = {tag: {e.key: (e.self_cpu_time_total / 1e3, e.count) for e in ev
                  if e.device_type == DeviceType.CPU}
            for tag, ev in profs.items()}
    grew = sorted(host["DDP"], key=lambda k: host["unwrapped"].get(
        k, (0, 0))[0] - host["DDP"][k][0])[:8]
    print("host self ms per profiled step, DDP against unwrapped (the 8 ops "
          "that grew most): " + "; ".join(
              f"{k} {host['DDP'][k][0]:.2f} ({host['DDP'][k][1]} calls) vs "
              f"{host['unwrapped'].get(k, (0, 0))[0]:.2f} "
              f"({host['unwrapped'].get(k, (0, 0))[1]})" for k in grew))
    del plain
    torch.cuda.empty_cache()
    rows = [e for e in profs["DDP"] if e.device_type == DeviceType.CUDA]
    nccl = [(e.key, e.count, round(e.self_device_time_total / 1e3, 3))
            for e in rows if "nccl" in e.key.lower()]
    copies = [(e.key, e.count, round(e.self_device_time_total / 1e3, 3))
              for e in rows if "memcpy" in e.key.lower()]
    print(f"NCCL kernels in one profiled DDP step (name, launches, device "
          f"ms): {nccl or 'none (at world 1 NCCL copies, no kernel)'}; "
          f"copies {copies}; {len(rows)} device rows")

    with tempfile.TemporaryDirectory() as tmp:
        lcfg = loop_cfg(CONFIG, tmp, LOOP_CANVAS, 2)
        lcfg.CONFIG.DATA.LABEL_PATH = write_labelmap(
            os.path.join(tmp, "labelmap.pbtxt"))
        loader = DataLoader(SyntheticClips(lcfg, 2 * DDP_LOOP_BATCHES, 31,
                                           LOOP_WIDTHS), 2, lcfg,
                            num_workers=4)
        model = ddp.model.eval()
        criterion, post, _ = build_criterion_and_postprocessor(
            lcfg, build_matcher(lcfg))
        files = {}
        for tag, kw in (("unwrapped", {}),
                        ("barrier", dict(rank=parallel.rank(),
                                         world_size=parallel.world_size(),
                                         barrier=parallel.sync_hosts))):
            lcfg.CONFIG.LOG.RES_DIR = tag
            for c in counters:
                c.launches = 0
            run_validation(lcfg, model, post, loader, criterion=criterion,
                           transfer_dtype=torch.bfloat16, **kw)
            torch.cuda.synchronize()
            files[tag] = {f: open(os.path.join(tmp, tag, f), "rb").read()
                          for f in ("0.txt", "GT_0.txt")}
        loop = {c.__name__: c.launches for c in counters}
        same = files["unwrapped"] == files["barrier"]
        print(f"eval loop over {DDP_LOOP_BATCHES} batches with barrier="
              f"sync_hosts: txt files "
              f"{'byte-equal' if same else 'DIFFERENT'} to the unwrapped "
              f"loop's ({len(files['barrier']['0.txt'])} bytes of "
              f"detections); launches {loop}")
        check(same, "the eval loop's txt files differ under the process "
                    "group")
        check(loop == {**{k: 0 for k in loop},
                       "fused_blend2d": 24 * DDP_LOOP_BATCHES},
              f"eval loop launches {loop}")
    del ddp, model
    torch.cuda.empty_cache()

    on, (l_on, g_on) = csn_step(dev)
    (l_off, g_off) = off
    exact = sum(torch.equal(g_on[n], g) for n, g in g_off.items())
    worst = max((g_on[n] - g).abs().max().item() for n, g in g_off.items())
    print(f"CSN-50 float32 train step, sync-BN on (DDP at world 1) vs off "
          f"(no process group): loss {l_on.item():.6f} vs {l_off.item():.6f}"
          f" ({'equal' if torch.equal(l_on, l_off) else 'DIFFERENT'} bit for "
          f"bit); gradients bit-equal in {exact}/{len(g_off)} tensors (max "
          f"|diff| {worst:.3e})")
    check(on and torch.equal(l_on, l_off) and sorted(g_on) == sorted(g_off)
          and exact == len(g_off), "sync-BN on and off disagree at world 1")
    del g_on, g_off, off
    torch.cuda.empty_cache()
    parallel.destroy()
    return {f"DDP train at world 1, {DDP_STEPS} steps": launches,
            f"eval loop with barrier=sync_hosts, {DDP_LOOP_BATCHES} batches":
                loop}


def csn_step(dev):
    """One float32 ``AVA22_CSN50`` train step's loss and backward (no
    update) through ``engine.Trainer``, in DDP when a process group is up:
    (whether it ran in DDP, (loss, {name: gradient})).  cuDNN
    deterministic, dropout seeded."""
    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.engine import Trainer
    from class_query_vad_tpu_torch.models import build_model

    cfg = get_cfg_custom(CSN_CONFIGS["CSN50"])
    trainer = Trainer(build_model(cfg, dtype=torch.float32), cfg)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in train_batch(cfg).items()}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.manual_seed(0)
    total, _, _ = trainer.loss(batch)
    total.backward()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    grads = {n: p.grad.detach().clone()
             for n, p in trainer.model.named_parameters() if p.grad is not None}
    ddp = trainer.distributed
    del trainer
    torch.cuda.empty_cache()
    return ddp, (total.detach(), grads)


def phase_profile_flops(dev, cpu_flops: int):
    """Phase 42 (see the module docstring)."""
    import glob
    import tempfile

    from class_query_vad_tpu_torch.config import get_cfg_custom
    from class_query_vad_tpu_torch.models import build_model
    from class_query_vad_tpu_torch.utils.flops import count_flops
    from class_query_vad_tpu_torch.utils.profiling import trace

    cfg = get_cfg_custom(CONFIG)
    t, h, w = clip_shape(cfg)
    cost = count_flops(cfg, t, h, w)
    print(f"count_flops of the main path at 1x{t}x{h}x{w} on the card (bf16): "
          f"{cost['flops'] / 1e9:.3f} GFLOP; on the CPU (phase 4, float32): "
          f"{cpu_flops / 1e9:.3f} GFLOP; bytes accessed {cost['note']}")
    check(cost["flops"] == cpu_flops,
          "the card's FLOP count differs from the CPU's")
    model = build_model(cfg, dtype=torch.bfloat16)
    pixels, mask = make_request(11, b=1, shape=(t, h, w))
    serve(model, pixels, mask, dev)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            serve(model, pixels, mask, dev)
        paths = glob.glob(os.path.join(tmp, "trace_*_rank0.json"))
        check(len(paths) == 1, f"trace wrote {paths}")
        with open(paths[0]) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(paths[0])
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = sum("fused_blend2d_kernel" in e.get("name", "") for e in kern)
    print(f"trace of one main-path forward: {size / 2**20:.2f} MiB, "
          f"{len(events)} events, {len(kern)} kernel rows, K1 "
          f"(fused_blend2d_kernel) {k1} launches (24 expected)")
    check(k1 == 24, "the trace does not name K1's 24 launches")
    del model
    torch.cuda.empty_cache()


# ---- K14 (``scripts/probe_gather.py``'s row gather) and the kernel and
# forward timers of ``class_query_vad_tpu_torch/scripts/`` (phase 43)
# (S, D, G, dtype): the probe's shape (the exact encoder's level 0, one
# head's depth, 54,400 queries x 8 points) and a wider float32 table
K14_CASES = ((40960, 32, 435_200, torch.bfloat16),
             (40960, 128, 435_200, torch.float32))
# wrapped and out-of-range indices written over the first few: 5 NaN rows
K14_EDGES = (-1, -40960, 40960, -40961, 2**31 - 1, -2**31, 40967, -5)
K14_NAN_ROWS = 5
PROBE_ITERS = 5
SCAN_BENCH_ITERS = 3
STAGE_BENCH_ITERS = 3


def k14_work(s: int, d: int, g: int, itemsize: int, index_itemsize: int = 4):
    """(bytes, operations) K14 must spend: the table, the indices and the
    output each cross HBM once; it does no arithmetic."""
    return s * d * itemsize + g * index_itemsize + g * d * itemsize, 0


def phase_gather_and_timers(dev, bw, counters):
    """Phase 43 (see the module docstring).  Returns K14's entry of the
    ``kernels`` line (its launches filled in by ``main``)."""
    from class_query_vad_tpu_torch.ops.row_gather import (row_gather,
                                                          row_gather_ref)
    from class_query_vad_tpu_torch.scripts import (bench_model_stages,
                                                   bench_selective_scan,
                                                   probe_gather)

    entry = {"name": "row_gather", "route": "cuda",
             "source": "class_query_vad_tpu_torch/csrc/row_gather.cu",
             "replaces": "scripts/probe_gather.py:72", "launches": None,
             "max_abs_err": 0.0}
    rng = np.random.default_rng(43)
    for s, d, g, dtype in K14_CASES:
        table = torch.from_numpy(rng.standard_normal((s, d), np.float32)).to(
            dev, dtype)
        inside = rng.integers(0, s, g).astype(np.int32)
        edges = inside.copy()
        edges[:len(K14_EDGES)] = K14_EDGES
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for index_dtype in (torch.int32, torch.int64):
            idx = torch.from_numpy(edges).to(dev, index_dtype)
            got = row_gather(table, idx)
            torch.cuda.synchronize()
            want = row_gather_ref(table, idx)
            same = torch.equal(got.view(bits), want.view(bits))
            nan_rows = int(torch.isnan(got.float()).all(-1).sum())
            ok = torch.isfinite(want)
            err = (got.float() - want.float())[ok].abs().max().item()
            print(f"K14 {str(dtype)[6:]} S={s} D={d} G={g} "
                  f"{str(index_dtype)[6:]} indices: bit for bit "
                  f"{'ok' if same else 'FAIL'}, {nan_rows} NaN rows "
                  f"(expected {K14_NAN_ROWS}), max|err| {err:.1e}")
            check(same and nan_rows == K14_NAN_ROWS,
                  f"K14 disagrees with row_gather_ref: {dtype} D={d} "
                  f"{index_dtype}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if (d, dtype) != (32, torch.bfloat16):
            continue
        # the probe's timed row: in-range indices (index_select takes no
        # other)
        idx = torch.from_numpy(inside).to(dev)
        t_k = kernel_device_ms(lambda: row_gather(table, idx))
        t_p = cuda_ms(lambda: row_gather_ref(table, idx), 5, 1)
        t_l = kernel_device_ms(lambda: torch.index_select(table, 0, idx))
        nbytes, _ = k14_work(s, d, g, 2)
        t_b = nbytes / bw * 1e3
        print(f"K14 bf16 S={s} D={d} G={g}: kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, index_select {t_l:.4f} ms, bound {t_b:.4f} ms "
              f"(bytes: {nbytes / 1e6:.1f} MB) -> {t_b / t_k:.1%} of the "
              f"bound's speed, {nbytes / t_k / 1e6:.0f} GB/s")
        entry.update(ms=t_k, plain_ms=t_p, bound_ms=t_b, bound_by="bytes",
                     library_ms=t_l)
    for c in counters:
        c.launches = 0
    recs = probe_gather.main(["--iters", str(PROBE_ITERS)])
    probe = {c.__name__: c.launches for c in counters}
    k14 = next(r for r in recs if r["probe"] == "K14 row_gather")
    check(k14["exact"], "probe_gather: K14 is not index_select bit for bit")
    check(len(recs) == 10 and all(r["ms"] > 0 for r in recs),
          f"probe_gather printed {len(recs)} measurements")
    # one exact check, one warm-up call and the timed ones
    check(probe == {**{k: 0 for k in probe}, "row_gather": PROBE_ITERS + 2},
          f"probe_gather launches {probe}")
    print(f"probe_gather.main: {probe['row_gather']} K14 launches; K14 "
          f"{k14['ms']:.4f} ms host-timed ({k14['share_of_bound']:.1%} of "
          f"the bound), index_select {k14['index_select_ms']:.4f} ms")
    entry.update(probe_launches=probe["row_gather"],
                 probe_host_ms=k14["ms"],
                 probe_index_select_host_ms=k14["index_select_ms"])
    for c in counters:
        c.launches = 0
    rows = bench_selective_scan.main(["quick", "--iters",
                                      str(SCAN_BENCH_ITERS)])
    scans = {c.__name__: c.launches for c in counters}
    check(len(rows) == 4 and all(
        v > 0 for r in rows for k, v in r.items() if k.endswith("_ms")),
        "bench_selective_scan quick: missing or non-positive times")
    check(scans["selective_scan"] > 0 and scans["selective_scan_bwd"] > 0,
          f"bench_selective_scan launched no K5 forward or backward: {scans}")
    print(f"bench_selective_scan quick: launches {scans}")
    for c in counters:
        c.launches = 0
    stages = bench_model_stages.main(["--iters", str(STAGE_BENCH_ITERS)])
    fwd = {c.__name__: c.launches for c in counters}
    check(all(stages[f"{k}_ms"] > 0 for k in ("full", "backbone", "encoder")),
          f"bench_model_stages: {stages}")
    check(fwd == {**{k: 0 for k in fwd}, "fused_blend2d": fwd["fused_blend2d"]}
          and fwd["fused_blend2d"] > 0 and fwd["fused_blend2d"] % 24 == 0,
          f"bench_model_stages launches {fwd}: K1 alone, 24 per encoder "
          f"call")
    print(f"bench_model_stages: launches {fwd}")
    torch.cuda.empty_cache()
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from class_query_vad_tpu_torch.ops import cuda_build
    from class_query_vad_tpu_torch.ops.blend2d import (
        blend2d,
        blend2d_bwd_dcomps,
        blend2d_bwd_dvol,
    )
    from class_query_vad_tpu_torch.ops.blend3d import (
        blend3d_bwd_dcomps,
        blend3d_bwd_dvol,
        blend3d_fwd,
    )
    from class_query_vad_tpu_torch.ops.fast_deform_cuda import fused_blend2d
    from class_query_vad_tpu_torch.ops.fused_ffn import fused_ffn_kernel
    from class_query_vad_tpu_torch.ops.native_blend import (
        native_blend2d,
        native_blend3d,
    )
    from class_query_vad_tpu_torch.ops.row_gather import row_gather
    from class_query_vad_tpu_torch.ops.selective_scan import (
        selective_scan,
        selective_scan_bwd,
    )
    from class_query_vad_tpu_torch.ops.vit_attention import vit_attention

    # K12, K13 and K14 are on no model path (as in the JAX package): every
    # phase below that drives a model checks that they launch 0 times
    counters = [fused_blend2d, blend2d, blend2d_bwd_dvol, blend2d_bwd_dcomps,
                selective_scan, selective_scan_bwd, native_blend2d,
                native_blend3d, blend3d_fwd, blend3d_bwd_dvol,
                blend3d_bwd_dcomps, vit_attention, fused_ffn_kernel,
                row_gather]
    dev = torch.device("cuda", 0)
    card = card_info()
    name = torch.cuda.get_device_name(0)
    bw, peak, bf16_peak = card_rates(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); bound rates "
          f"{bw / 1e12:.2f} TB/s, {peak / 1e12:.0f} TFLOP/s fp32, "
          f"{bf16_peak / 1e12:.0f} TFLOP/s dense bf16")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = cuda_build.build()
    print(f"built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for k, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  {k}: {line.strip()}")

    with phase_seconds("phase 2 (K1-K4 against their plain versions)"):
        kernels = [phase_kernels(dev, bw, peak)]
        blend, _ = phase_blend_kernels(dev, bw, peak)
        kernels += blend
    with phase_seconds("phase 3 (the main path served)"):
        main_eval, main_ms = phase_main_path(dev, counters)
    with phase_seconds("phase 4 (its float32 forward, card vs CPU)"):
        flops = {}
        phase_in_model(dev, flops=flops)
    with phase_seconds("phase 5 (its train path, the components route)"):
        launches = phase_train(dev, counters)
        comps = phase_components_route(dev, counters)
    # launches on the train path; K2 runs on the components route only
    for k in kernels:
        k["launches"] = (comps if k["name"] == "blend2d" else launches)[k["name"]]
    with phase_seconds("phase 6 (a float32 train step, card vs CPU)"):
        phase_train_card_vs_cpu(dev, ["CONFIG.ViT.DEPTH",
                                      MAIN_TRAIN_CPU_VIT_DEPTH])
    with phase_seconds("phase 7 (K5 against its plain version)"):
        kernels.append(phase_scan_kernel(dev, bw, peak))
    with phase_seconds("phase 8 (the VSS path served)"):
        vss = phase_vss_main_path(dev, counters)
    kernels[-1]["launches"] = vss["selective_scan"]
    with phase_seconds("phase 9 (its float32 forward, card vs CPU)"):
        phase_vss_card_vs_cpu(dev)
    with phase_seconds("phase 10 (K10, K11 against their plain version)"):
        native = phase_native_kernels(dev, bw, peak)
    # AVA22_ViT-B_fast_native as written (2d window: K10), then its 3d
    # variant (K11)
    with phase_seconds("phases 11-12 (native 2d served, card vs CPU)"):
        n2d = phase_eval_variant(dev, counters, NATIVE_CONFIG, "2d",
                                 "native_blend2d", "native-2d", (21, 22, 23))
        phase_in_model(dev, NATIVE_CONFIG, tag="native-2d ")
    with phase_seconds("phase 13 (native 3d served, card vs CPU)"):
        n3d = phase_eval_variant(dev, counters, NATIVE_CONFIG, "3d",
                                 "native_blend3d", "native-3d", (21, 22, 23))
        cpu_s = phase_in_model(
            dev, NATIVE_CONFIG, ["CONFIG.MODEL.FAST_WINDOW", "3d",
                                 "CONFIG.MODEL.ENC_LAYERS",
                                 NATIVE_3D_CPU_LAYERS], tag="native-3d ")
    print(f"native-3d card-vs-CPU check at {NATIVE_3D_CPU_LAYERS} encoder "
          f"layers, cut from the YAML's 6 for the CPU's time (tol "
          f"{MODEL_TOL:.0e} x max|ref|); its CPU forward {cpu_s:.1f} s")
    native[0]["launches"] = n2d["native_blend2d"]
    native[1]["launches"] = n3d["native_blend3d"]
    kernels += native
    # the 3d resample window: K6 (serving K7), K8, K9
    with phase_seconds("phase 14 (K6-K9 against their plain versions)"):
        blend3d = phase_blend3d_kernels(dev, bw, peak)
    with phase_seconds("phases 15-16 (resample 3d served, card vs CPU)"):
        phase_eval_variant(dev, counters, CONFIG, "3d", "blend3d_fwd",
                           "resample-3d", (31, 32, 33))
        phase_in_model(dev, CONFIG, ["CONFIG.MODEL.FAST_WINDOW", "3d",
                                     "CONFIG.MODEL.ENC_LAYERS",
                                     RESAMPLE_3D_CPU_LAYERS],
                       tag="resample-3d ")
    with phase_seconds("phase 17 (its train path)"):
        t3d = phase_train(dev, counters, "3d", RESAMPLE_3D_TRAIN_STEPS,
                          "resample-3d ")
    for k in blend3d:
        k["launches"] = t3d[k["name"]]
    with phase_seconds("phase 18 (its float32 train step, card vs CPU)"):
        phase_train_card_vs_cpu(
            dev, ["CONFIG.MODEL.FAST_WINDOW", "3d", "CONFIG.MODEL.ENC_LAYERS",
                  RESAMPLE_3D_TRAIN_CPU_LAYERS, *CPU_TRAIN_VIT],
            "resample-3d ", counters,
            {**{c.__name__: 0 for c in counters},
             **{k: 4 * RESAMPLE_3D_TRAIN_CPU_LAYERS
                for k in TRAIN_KERNELS["3d"]}})
    kernels += blend3d
    # K12 and K13 at the main path's shapes and on the model's own tensors,
    # then K12's bench entry point
    with phase_seconds("phases 19-22 (K12, K13, their entry point)"):
        k12 = phase_vit_attention(dev, bw, bf16_peak)
        k13 = phase_fused_ffn(dev, bw, bf16_peak)
        phase_model_attention_ffn(dev)
        bench = phase_bench_entry()
    for k, c in ((k12, vit_attention), (k13, fused_ffn_kernel)):
        # main-path launches (eval and train): 0, as in the JAX package
        k["launches"] = main_eval[c.__name__] + launches[c.__name__]
    k12["bench_launches"] = bench
    kernels += [k12, k13]
    # FAST_RADIUS 2 (the general blend) in both windows
    with phase_seconds("phase 23 (FAST_RADIUS 2 served, card vs CPU)"):
        for window in ("2d", "3d"):
            phase_radius2(dev, counters, window)
    # the native train step: 2d and 3d windows, then card vs CPU
    with phase_seconds("phase 24 (native train steps, card vs CPU)"):
        for window, kernel in (("2d", "native_blend2d"),
                               ("3d", "native_blend3d")):
            phase_train(dev, counters, window, NATIVE_TRAIN_STEPS,
                        f"native-{window} ", NATIVE_CONFIG, (kernel,),
                        profile_step=False)
        phase_train_card_vs_cpu(
            dev, ["CONFIG.MODEL.ENC_LAYERS", NATIVE_TRAIN_CPU_LAYERS,
                  *CPU_TRAIN_VIT], "native-2d ",
            counters, {**{c.__name__: 0 for c in counters},
                       "native_blend2d": 4 * NATIVE_TRAIN_CPU_LAYERS},
            NATIVE_CONFIG, unmatched_too=True)
    tube, tube_err, tube_launches = phase_exact_and_tubes(dev, counters, bw,
                                                         peak)
    # the eval loop, checkpoints and the train CLI's loop
    with phase_seconds("phase 31 (the AVA eval loop)"):
        ava_loop, loop_ms, loop_busy, save_s, load_s = phase_eval_loop(
            dev, counters, main_ms)
    with phase_seconds("phase 32 (the UCF eval loop)"):
        ucf_loop, ucf_loop_ms = phase_tube_loop(dev, counters)
    with phase_seconds("phase 33 (the train loop, checkpoint and resume)"):
        resume, rsave_s, rload_s = phase_train_resume(dev, counters)
    tube_launches.update({
        f"AVA eval loop, {LOOP_BATCHES} batches": ava_loop,
        f"UCF eval loop, {TUBE_LOOP_BATCHES} batches": ucf_loop,
        f"train loop with resume, {2 * RESUME_STEPS} steps": resume,
    })
    # CSN, GRADIENT_CHECKPOINTING and on-device preprocessing
    tube_launches.update(phase_csn(dev, counters))
    with phase_seconds("phase 36 (GRADIENT_CHECKPOINTING off and on)"):
        tube_launches.update(phase_remat(dev, counters))
    with phase_seconds("phase 37 (on-device preprocessing)"):
        tube_launches.update(phase_device_preprocess(dev, counters, loop_ms))
    # the Mamba family trains: K5's backward, then the two YAMLs' train
    # paths at full width, then a float32 step card vs CPU
    with phase_seconds("phase 38 (K5's backward against its plain version)"):
        k5_bwd = phase_scan_bwd_kernel(dev, bw, peak)
    with phase_seconds("phase 39 (the Mamba family trained)"):
        mamba_train = phase_mamba_train(dev, counters)
    k5_bwd["launches"] = mamba_train[
        f"AVA22_train-mamba_VSS train, {MAMBA_TRAIN_STEPS} steps"]["selective_scan_bwd"]
    tube_launches.update(mamba_train)
    kernels.append(k5_bwd)
    with phase_seconds("phase 40 (a float32 VSS train step, card vs CPU)"):
        phase_mamba_card_vs_cpu(dev, counters)
    with phase_seconds("phase 41 (the main path under torch.distributed)"):
        tube_launches.update(phase_distributed(dev, counters))
    with phase_seconds("phase 42 (--profile and --flops on the card)"):
        phase_profile_flops(dev, flops["cpu"])
    with phase_seconds("phase 43 (K14, probe_gather and the timers)"):
        k14 = phase_gather_and_timers(dev, bw, counters)
    # main-path launches (eval and train): 0, as K12's and K13's
    k14["launches"] = main_eval["row_gather"] + launches["row_gather"]
    kernels.append(k14)
    print(f"eval loop (phase 31) {loop_ms:.2f} ms/batch (busy {loop_busy:.2f}"
          f") vs phase 3 {main_ms:.2f}; UCF loop {ucf_loop_ms:.2f} ms/batch; "
          f"checkpoint save / load: model {save_s:.2f} / {load_s:.2f} s, "
          f"trainer {rsave_s:.2f} / {rload_s:.2f} s")
    for k in kernels:
        key = {"fused_blend2d": "K1", "blend2d_bwd_dvol": "K3",
               "blend2d_bwd_dcomps": "K4"}.get(k["name"])
        if key:
            k["tube_grids"] = {name: {**v[key], "max_abs_err": tube_err[key]}
                               for name, v in tube.items()}
        new_paths = {path: n[k["name"]] for path, n in tube_launches.items()
                     if n.get(k["name"])}
        if new_paths:
            k["launches_new_paths"] = new_paths
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
