#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 / sm_90a).

    python3 chip_smoke.py [--seed 0] [--batches 3] [--steps 3]

Phases, each of which raises (and so exits non-zero) on failure:
  1. device  — needs torch.cuda; prints the card's name and power limit
  2. build   — nvcc-builds every kernel library from csrc/ (flash-attention
               forward, flash-attention backward, fused dropout, fused MLP,
               attention probes), all at once; cuobjdump -sass of the Hopper
               kernels' instances (K1 bf16, the four probes, the bf16 dq and
               dk/dv kernels at d 64 and 128, and the fused MLP's bf16
               kernels: the forward's F1 and F2 products, stage H and the dx
               and dW products): each must issue HGMMA and UTMALDG and touch
               no local memory; the integer instructions of one Philox call
               and of a dropped element, per pipe, from the SASS of K1's,
               K2's and K3's d64 dropout instances
  3. kernels — each kernel against its plain PyTorch version on the card:
               the flash forward at SHAPES, bf16 and fp32, dropout 0 and 0.1;
               the dq and dk/dv kernels against autograd of the plain forward
               with the same seed, at SHAPES, both dtypes, dropout 0 and 0.1,
               bit-equal over two runs; the bf16 backward at its tile edges
               (N_q and N_k at 1, each tile size less one, itself and plus
               one, and past three tiles) at every head dim, dropout 0 and
               0.1;
               the fused dropout bit for bit, forward and backward, at
               DROPOUT_SHAPES in both dtypes; the fused MLP's forward against
               its plain version and its dx and dW kernels against autograd
               of it, at MLP_SHAPES, both dtypes, dropout 0 and 0.1, bit-equal
               over two runs, with the zero pattern of the unfused chain (K5)
               under the same seeds; the forward's h_r (F1) within 1 bf16
               ulp of stage H's at [4096, 1024 -> 4096 -> 1024]
     probes  — the four attention probes against their plain versions at
               PROBE_SHAPES (atol 1e-2 x the row's max|o| and rtol 1e-2, a
               tolerance that must fail the plain version without the last
               kv tile), the bound shift also against the fp32 softmax (atol
               1e-2), with exact launch counts; then the probe path, `python -m
               orbit2_tpu_torch.scripts.bench_attn2`'s run at (B8, N2048, H16,
               d64), with its exact launch counts
  4. slice   — the serving path (Evaluator.test) at interm_117m width
               (configs/interm_117m.yaml: embed 1024, depth 8, 16 heads, bf16,
               batch 8) on a synthetic dataset made from --seed; the kernels'
               launch counts over that run; the prediction against the same
               model on the plain attention, and in fp32 against the CPU
     fused   — the same Evaluator.test with every Mlp.use_fused set: launch
               counts (the fused MLP forward once per block and batch); the
               prediction against use_fused off, and in fp32 against the CPU;
               then one gradient of the fused eval-mode model (input and
               weights), which runs the dx and dW kernels, against use_fused
               off and, in fp32, against the CPU
  5. train   — the training path (Trainer.fit) at the same width: bf16
               compute, fp32 master parameters, bf16 Adam moments, dropout and
               drop-path 0.1, batch 8, 2 epochs x --steps steps; exact launch
               counts of all four kernels; finite losses and moved parameters;
               one seeded bf16 step on the kernels against the same step on
               the plain versions, and one seeded fp32 step on the card against
               the CPU
  5b. serve1b — the tiled 1B serving path at the full width of
               configs/interm_1b.yaml (embed 3072, depth 8, 24 heads, d 128,
               gelu tanh, bf16; its mesh cut to the card) on a synthetic
               252 x 504 -> 1,008 x 2,016 PRISM set made from --seed: the
               config's div 4 / overlap 3 tiles (66 x 132, 2,178 tokens),
               batch 16. K1 at the path's shapes (B16 and B1, N 2,178, H24,
               d128; B16 also with dropout 0.1) and K5 at the ensemble's
               [34,848, 3,072 | 12,288] against their plain versions;
               Evaluator.test over 2 batches in bf16 and with
               quant="w8a8", each with exactly depth x batches K1 launches
               and nothing else; one batch against the plain attention (the
               prediction at the bf16 tolerance, the trunk's output within
               relative Frobenius error 0.02) and the w8a8 prediction and
               trunk output against bf16 (<= 0.05); a bf16 test() after the
               w8a8 one reproduces the first's metrics; torch._int_mm on the
               card against the CPU (int32 equal) and w8a8_matmul (1 bf16
               ulp); stitched inference of field 0 in bf16, w8a8 and on the
               plain attention ([3, 1008, 2016], each tile's core its own
               prediction, depth x 16 K1 launches, the tiles' trunk outputs
               held as the batch's); an MC-dropout ensemble of 4 samples (K1
               with dropout and K5, exact launches; samples differ pairwise,
               the same seed repeats them bit for bit)
  5c. train1b — the tiled 1B training path: Trainer.fit on the same config
               and geometry (a synthetic train split of 4 fields, 64 tiles),
               batch 32 tiles, bf16 compute, fp32 masters, bf16 Adam moments,
               dropout and drop-path 0.1, the config's remat (full), from
               serve1b's weights, 2 epochs x 2 steps: exact launch counts
               (remat_launches), finite losses, moved parameters; one step
               at 4 tiles with remat full, dots and none under
               torch.use_deterministic_algorithms, its loss, every gradient
               and both generators' states bit for bit; K1, K2 and K3 at
               the path's shape (B32 and B4, N 2,178, H24, d128, dropout
               0.1) against their plain versions (at B32 on its first and
               last batch elements), K5 at [69,696, 3,072 | 12,288] bit for
               bit; the step's time by events, its kernel time by kind, peak
               memory, tiles/s and MFU (and the hardware's flops with the
               recomputation) against 989 TFLOP/s
  5d. resume1b — checkpoints, resume, validation and fine-tuning on the same
               config, tiles, batch and weights, the depth cut from 8 to 2
               (serve1b's first two Blocks; synthetic train and val
               splits of 5 fields; the val split's 80 tiles end in a partial
               batch): Trainer A fits 2 epochs x 2 steps with a checkpoint
               directory, keep_last_checkpoints 1 and validation after each
               epoch (only epoch_1 is left; finite val means over 80 tiles,
               K1 depth x 3 launches a validation and nothing else; the
               saves', writes' and validations' seconds, the bytes on disk
               against the reckoning, the free disk checked first);
               restore_checkpoint of epoch_1 equals A's parameters, mu, nu,
               count, lr and epoch bit for bit (timed, read and moved to the
               card); Trainer B resumes from the directory with async
               checkpoints and fits epochs 2 and 3: its history starts at
               epoch 2, and the epoch_2 written while epoch 3 trains equals
               B's state at its save (how long the host copy blocked, the
               write, its overlap with epoch 3); two resumes from epoch_1 at
               4 tiles under torch.use_deterministic_algorithms give the same
               losses bit for bit; `python -m orbit2_tpu_torch.finetune`'s
               main from epoch_1 on div 3 / overlap 2 tiles (86 x 172, 3,698
               tokens, batch 8) resizes pos_embed and drops nothing; exact
               launch counts of the phase (K1, K2, K3, K5) and of the
               fine-tune; K1, K2 and K3 at the fine-tune's shape (B8, N3698,
               H24, d128, dropout 0.1) against their plain versions on its
               first and last batch elements, K5 at its [29,584, 3,072 |
               12,288] bit for bit, and the validation's K1 without dropout
               at (B32, N2178, H24, d128) on its first and last batch
               elements (the 16-tile tail's shape is serve1b's)
  6. times   — kernel vs plain (CUDA events, median of 20 after warm-up, of 5
               for fp32 attention; K1,
               K2 and K3 also by the profiler's kernel time alone, beside SDPA
               and their two bounds, tensor cores and their dropout's Philox
               calls; K5 also by its kernel time alone beside F.dropout's,
               its bytes bound and its host time a call; the fused-MLP
               forward (F1 and F2) and the unfused chain's forward, K6b
               alone, K6c alone, the whole fused-MLP backward and the
               unfused chain's backward by the kernel time of every kernel a
               call launches, beside their events and their 1-, 2-, 3-, 4-
               and 5-product bounds), each kernel also against the one
               PyTorch call that computes its function where there is one
               (SDPA pinned to its flash backend, F.dropout), the fused MLP
               against the unfused bf16 chain and
               the first two probes against their bmm pair; the probes'
               decomposition of the flash forward at (B8, N2048, H16, d64);
               the train step at the slice geometry and at bench.py's 117M
               geometry (64 x 128 input, 2,048 tokens), and the serving step
               with and without the fused MLP, at the end also by the kernel
               time of every kernel a step launches; then the tiled 1B
               serving steps (bf16 and w8a8) by events and kernel time (by
               kind of kernel: the w8a8 step's quantization and rescale are
               its other kernels less the bf16 step's), their
               peak memory and the stitched field's wall time, K1's rows at
               (B16, N2178, H24, d128) with and without dropout beside SDPA,
               and the w8a8 route's parts (quantization, torch._int_mm,
               rescale) beside bf16 F.linear at the trunk's four products, on
               the line {"serving_1b": {...}}; then the 1B training path's
               K1, K2, K3 (B32, N 2,178, H24, d128, dropout 0.1) and K5 rows
               beside their plain versions (over the whole batch, four
               batch elements at a time), SDPA / F.dropout and their bounds,
               with the train step's numbers, on the line {"train_1b": {...}};
               then K1, K2, K3 and K5 at the fine-tune's shapes the same way
               (plain versions two batch elements at a time) and the
               validation's K1 at (B32, N2178) without dropout beside SDPA,
               with resume1b's numbers, on the line {"resume_1b": {...}}

  6b. forecast — configs/forecast.yaml at its own size (the
               rasp-theurey-2020 ResNet: 19 blocks of 128 channels,
               BatchNorm, dropout 0.1; ERA5 5.625 deg 32 x 64, history 3 x 6
               variables -> 2, pred_range 72, batch 32, bf16; its mesh cut
               to the card) on a synthetic grid made from --seed:
               Trainer.fit 2 epochs x 2 steps with validation (lat_rmse,
               lat_acc, lat_mse), exact K5 launches (2 sites a residual
               block, forward and backward), finite losses, moved parameters
               and BatchNorm statistics, the eval prediction reading them;
               Evaluator.test (lat_rmse, lat_acc; nothing launched); one
               seeded fp32 step with dropout on the card against the CPU
               (losses) and against the same step in fp64 (gradients: at
               most WITNESS_RATIO times the CPU fp32 step's distance); K5
               at [B 128 32, 64] bit for bit; the step by events and kernel
               time by kind, busy share, its conv flops; {"forecast": ...}
     hub     — `python -m orbit2_tpu_torch.finetune --arch vit|unet|resnet`
               on configs/interm_fine_tune.yaml's model (embed 256, depth 6,
               4 heads, d 64, decoder 4, dropout and drop-path 0.1, bf16),
               cut to a regional 64 x 128 -> 256 x 512 crop of DAYMET_2's 23
               -> 3 variables, batch 8 of 32, mesh to the card: 2 x 2 steps
               from drawn weights each (losses bayesian_tv, imagegradient,
               quantile), then Evaluator.test over 2 batches from the last
               epoch's checkpoint (w8a8 refused), exact launches; for the
               ViT (N 32,768 tokens) K1, K2 and K3 at (B8, N32768, H4, d64)
               with dropout 0.1 and K1 without it against their plain
               versions on the first and last (batch, head) pairs, the
               prediction (batch element 0) within relative Frobenius 0.02
               of the plain attention's (fp32 math, one head at a time);
               K5 bit for bit at the ViT's and
               the CNNs' shapes; each preset's step by events and kernel
               time, peak memory, its serving step; K1-K3's rows beside
               their plain versions (pair by pair), SDPA and bounds;
               {"hub": ...}
     climatebench — `python -m orbit2_tpu_torch.climatebench`'s run for
               resnet (28 blocks), unet and vit at MODEL_KWARGS, fp32, on
               synthetic forcings (4 variables at 32 x 64, history 10; two
               scenario runs and a historical run) made from --seed, one
               epoch each: finite NRMSE trio, exact K5 launches, the ViT's
               attention (head dim 32) on the plain path; K5 bit for bit at
               the ResNet's and the ViT's fp32 shapes; {"climatebench": ...}
     mesh    — the device mesh (orbit2_tpu_torch/parallel/): (a) `python -m
               orbit2_tpu_torch.train`'s main on configs/interm_1b.yaml as
               shipped (fsdp 8 x simple_ddp 4 x tensor_par 4) but for its
               depth, cut from 8 to 2 in (a) and (b), from serve1b's
               weights (an npz; the later Blocks' dropped on import): the
               scale-down brings the mesh to the one card, 2 steps of 32
               tiles, finite losses, exact launches; (b) the 1B model
               wrapped on a one-rank NCCL mesh
               (the Trainer's own, from the config, under a one-rank NCCL
               group: the tensor plan, FSDP2 per Block and at the root,
               DTensor parameters, AdamW on the shards) against the same 2
               steps unwrapped at BATCH_MESH tiles: losses and every
               parameter bit for bit, K1-K3 launches and K5's at each
               [rows, cols] exactly equal; each one's step by events,
               kernel time and peak memory; K1-K3 at (B8,
               N2178, H24, d128, dropout 0.1) on two batch elements and K5
               at [17,424, 3,072 | 12,288] against their plain versions,
               and their rows, K5 one a width; (c) two ranks on the one
               card over gloo (`python3 chip_smoke.py --mesh-worker RANK
               PORT DIR`) at interm_117m.yaml's width, depth 2, fp32, under
               fsdp 2 and under tensor 2, against one rank (MESH_REL), then
               test() on both meshes against the config at mesh 1 on rank
               0 (serve_meshes: the other rank idle; MESH_REL), run beside
               phase seqexpert's ranks; a rank that fails or dies fails the
               phase; {"mesh": ...}, printed after phase seqexpert
  servemesh — serving on a mesh, from serve1b's weights (the npz phase mesh
               reads): configs/interm_1b.yaml's model at full width and
               depth on serve1b's tiles (2 fields of 16 tiles, batch 16).
               One rank (this process, unwrapped): test() in bf16 and w8a8,
               the metrics over the rounds each mesh gathers, round 0's
               prediction and trunk, a stitched field; (b) `python -m
               orbit2_tpu_torch.evaluate` under a one-rank NCCL group set
               up from torchrun's variables: metrics, printed JSON and a
               batch's prediction bit-equal to the unwrapped Evaluator's;
               (a) two gloo ranks (`--servemesh-worker`) at fsdp 2 and two
               at tensor 2, at once: test() over 2 batches in bf16 and
               w8a8 (exact K1 launches, samples, metrics within
               SERVE_METRIC_REL), round 0's prediction gathered
               (PRED_BF16_TOL) and trunk (TRUNK_BF16_REL), the stitched
               field at tensor 2, an MC ensemble of 2
               (exact K1 / K5 launches by width, seeded, members differ);
               seconds, gloo seconds and peak a rank; then K1 at (B8,
               N2178, H24, d128) and (B16, N2178, H12, d128) and K5 at the
               ensemble's widths against their plain versions, and their
               rows; {"servemesh": ...}
  seqexpert — the seq and expert axes (`python3 chip_smoke.py
               --seqexpert-worker MODE RANK WORLD PORT DIR` ranks over gloo
               on the one card; a rank that fails or dies fails the phase):
               (a) Trainer.fit on configs/interm_1b.yaml's model at full
               width, depth 2 (64 x 128 crops, 2,048 tokens, batch 8,
               bf16, full remat) at seq 2 under gather, Ulysses and ring,
               on two ranks against one unwrapped rank: the trunk's
               first-step gradients at dropout 0 within SEQEXP_GRAD_REL,
               then 2 steps at dropout 0.1 (gather, Ulysses) or 0 (ring):
               losses and parameters within SEQEXP_REL, exact K1-K3 and K5
               launches, seconds, the collectives' seconds, peak memory a
               rank; (b)
               configs/interm_1b_moe.yaml at full width, depth 2, batch 8
               tiles, at expert 2 against one rank: the trunk's first-step
               gradients but the expert stacks' within SEQEXP_GRAD_REL,
               the dense parameters bit-equal on both ranks, then the
               trained model's test() at expert 2 against one rank within
               SERVE_METRIC_REL; (c) four
               ranks at interm_117m.yaml's width, depth 2, fp32: seq 2 x
               fsdp 2 under each impl, expert 2 x fsdp 2 and expert 2 x
               tensor 2 on an MoE variant, one step against one rank
               (MESH_REL), and test() on each against the config at mesh
               1 on rank 0 (serve_meshes), its four ranks running beside
               (a) and (b)'s two; then K1-K3 at the seq path's
               call shapes against their plain versions (gather: B8, N_q
               1,024, N_k 2,048, H24, d128; Ulysses: N 2,048, H12; a ring
               chunk: N 1,024, its two halves merged, K2/K3 fed the merged
               lse) and their rows, K5 at the path's widths;
               {"seqexpert": ...}
  pipeline — the stage axis (`python3 chip_smoke.py --pipeline-worker
               pipeline RANK 2 PORT DIR` ranks over gloo on the one card; a
               rank that fails or dies fails the phase): (a) Trainer.fit on
               configs/interm_1b_pp.yaml's model and schedule at full width
               (embed 3072, depth cut from 8 to 4, 2 stages, 8 microbatches
               of its 32-tile batch, interleave 2, full remat, bf16) on the
               1B tiles, its fsdp 4 and tensor 2 cut to 1, on two ranks: the
               first-step gradients at dropout 0 against one unpipelined
               rank's 2-step fit (the trunk's gathered over the stages, the
               embedding's on each stage) within SEQEXP_GRAD_REL, then 2 steps at
               dropout 0.1 under the interleaved schedule and 2 under GPipe:
               exact K1-K3 and K5 launches (K5 by width), finite losses, a
               step's seconds, its gloo and data-wait seconds and peak
               memory a rank beside one rank's, then the GPipe fit's model
               served at stage 2 under both schedules against one
               unpipelined rank (serve_meshes, SERVE_METRIC_REL); (b) (run
               in seqexpert's four-rank launch) interm_117m.yaml's width,
               depth 4, fp32, batch 8: stage 2 x fsdp 2 and stage 2 x
               tensor 2 under GPipe and interleaved (M 4), one step against
               one rank (MESH_REL), exact launches, and test() on each
               against one unpipelined rank; (c) K1-K3 at a microbatch's (B4, N2178, H24,
               d128, dropout 0.1) on two batch elements and K5 at [8,712,
               3,072 | 12,288] against their plain versions, and their rows;
               {"pipeline": ...}
  hubmesh  — the model hub on the mesh (`python3 chip_smoke.py
               --hubmesh-worker hubmesh RANK 2 PORT DIR`, two gloo ranks
               started with phase servemesh and waited for after phase
               seqexpert, beside both; a
               rank that fails or dies fails the phase): (a)
               configs/forecast.yaml's ResNet at its own size (19 blocks x
               128 channels, bf16, batch 32) through the train CLI's
               scale-down to fsdp 2, 2 steps on one unwrapped rank's global
               batches: at dropout 0 (the factory patched) the first-step
               gradients within SEQEXP_GRAD_REL of one rank's and the
               BatchNorm running averages bit-equal on both ranks; at the
               shipped 0.1 K5's launches by [rows, cols], finite losses, the
               data ranks' masks differing on one sample; (b) `finetune
               --arch unet | vit` at interm_fine_tune.yaml's width on the
               hub crop at fsdp 2 and the ViT at tensor 2: exact K1-K3 and K5
               launches, finite losses, test() in bf16 and, in fp32, against
               one rank within SERVE_METRIC_REL; step seconds, gloo seconds
               and peak memory a rank; (c) the train CLI on forecast.yaml under a one-rank NCCL
               group against the unwrapped fit, bit for bit; (d) K1-K3 at the
               ranks' attention shapes ((B4, N32768, H4, d64) at fsdp 2,
               (B8, N32768, H2, d64) at tensor 2; K1 also without dropout, as
               test() runs it) on their first and last (batch, head) pairs
               and K5 at every width the ranks launched it at against their
               plain versions, and their rows; {"hubmesh": ...}

  7. serve10b — configs/interm_10b.yaml served at full width and depth
               (embed 8192, depth 11, 32 heads, d 256, MLP 32,768, gelu
               tanh, bf16, 9,408,639,363 parameters; its mesh cut to the
               card) on a synthetic ERA5 1.0 deg test split (ERA5_2: 180 x 360
               -> 720 x 1,440, ERA5_1's 23 -> 3 variables; the config's 5.625
               deg grid cuts odd tiles): div 4 / overlap 3 tiles of 48 x 96
               (1,152 tokens), batch 16. The Evaluator built for bf16 alone
               (build seconds, host resident peak, card peak; no fp32 tensor
               kept), K1 at (B16, N1152, H32, d256) with and without dropout
               on its first and last batch elements and K5 bit for bit at
               [18,432, 8,192 | 32,768] against their plain versions;
               test() over 2 batches (exactly depth x batches K1 launches),
               the trunk on the kernels within 0.02 of the plain attention's,
               the stitched 720 x 1,440 field (depth x 16 K1 launches), an MC
               ensemble of 2 samples (exact K1 and K5 launches; seeded); the
               bf16 step by events and kernel time by kind, peak memory; K1's
               and K5's rows beside plain, SDPA / F.dropout and bounds. Then
               the Evaluator built for w8a8 (the twin quantized on the card
               as the model is filled): its bf16 prediction equal to the
               first's bit for bit, test() in w8a8, the prediction, trunk and
               stitched field within 0.05 of bf16, its step timed; the line
               {"serving_10b": {...}}
  8. moe1b  — configs/interm_1b_moe.yaml (the 1B trunk with 8 Switch top-1
               experts in every 2nd Block, capacity 1.25; 3,103,984,003
               parameters; its mesh cut to the card) on the 1B phases'
               synthetic PRISM tiles (66 x 132, 2,178 tokens), last: its
               training needs most of the card. Evaluator with w8a8 refused
               (JAX's ValueError); the bf16 Evaluator (routers fp32); K1 at
               (B16 | B1, N2178, H24, d128) with and without dropout, K5 at
               [34,848 | 69,696, 3,072 | 12,288] and K1-K3 at the training
               shapes against their plain versions; test() over 2 batches of
               16 tiles (exact K1 launches); one batch against the plain
               attention: the routers' flipped top-1 choices counted, the
               prediction and the trunk's output on the tokens routed alike
               within TRUNK_BF16_REL; the witness (the first 4 tiles in fp32
               on the plain attention); a stitched field against the plain
               attention's; an MC ensemble of 2 (exact K1 and K5 launches,
               K5 at pos_drop and 3 sites a dense Block, 2 an MoE Block);
               Trainer.fit from the served weights (batch 32, full remat,
               bf16 moments, dropout and drop-path 0.1, 2 epochs x 2 steps):
               exact launches, finite losses, the aux loss in [1, 8], every
               router and every expert that took tokens moved; one step at 4
               tiles with remat full, dots and none bit for bit; the step by
               events, its kernel time by kind (the experts' products and
               the dispatch and combine einsums apart), peak memory, tiles/s
               and MFU on the products it executes; K1-K3 and K5 rows at the
               training shapes and K1's at the serving batch; the line
               {"moe_1b": {...}}

Each phase prints "== name (at T s)" as it starts and, at its larger steps,
"  -- step: S s (at T s)": where the script's time limit goes.

The second-to-last line is {"kernels": [...]}: for each kernel its launches
on its path, max abs error, ms, plain ms, library ms (null where no single
PyTorch call computes its function; then `chain_ms`, where timed, is the
unfused chain of PyTorch calls), and its bound: the larger of its useful
tensor-core flops over 989 TFLOP/s and the bytes it must move over 3.35 TB/s
(H100 SXM dense bf16 and HBM3 peaks), and for K1-K3 with dropout also
their Philox calls' integer instructions, per SM pipe (IMAD on the FMA pipe and
the other integer opcodes on the ALU pipe, 64 lanes each, and all of them at
the SM's issue rate of 128 lanes) at the card's maximum SM clock. The last line is {"ok": true, "device":
{...}}. No result is printed when a phase fails.
"""

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# torch.use_deterministic_algorithms (phase train1b) needs cuBLAS's workspace
# fixed before the first product: 8 buffers of 4 MiB, 32 MiB in all
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# expandable segments: a phase's cached memory goes back to the card when it
# is done (empty_cache), even where a few live tensors sit in its segments,
# so the later phases and the multi-rank phases' processes find it free
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "interm_117m.yaml"
# the tiled 1B serving phase: configs/interm_1b.yaml's PRISM key (7 -> 3
# variables) on a synthetic test split of FIELDS_1B fields at LOW_1B -> 4x;
# the config's div 4 / overlap 3 cut 66 x 132 tiles (33 x 66 = 2,178 tokens),
# served BATCH_1B tiles a batch
CONFIG_1B = ROOT / "configs" / "interm_1b.yaml"
LOW_1B = (252, 504)
FIELDS_1B = 3
BATCH_1B = 16
BATCHES_1B = 2
MC_SAMPLES = 4
# the w8a8 prediction against the bf16 one on the same batch, and the trunk's
# output alone (the prediction adds the unquantized CNN residual path, which
# at random weights dominates it): relative Frobenius error
W8A8_REL = 5e-2
# the bf16 1B trunk's output (its final norm's, [B, N, D]) on the kernels
# against the same trunk on the plain attention, for a batch and for the
# stitched tiles: relative Frobenius error. Both round p to bf16 before the
# value product; rounding that differs passes through 8 blocks. The
# prediction adds the CNN residual path, which at random weights dominates
# it (the trunk is ~5% of it), so the trunk is held apart
TRUNK_BF16_REL = 2e-2
# torch._int_mm on the card against the CPU: [M, K] x [K, N], the 1B qkv
# product's K and N; then K and N off the multiple of 8 the card's product
# takes (padded by ops/quant.py::pad_operands), at more and fewer than 17 rows
INT8_CHECK = (4096, 3072, 9216)
INT8_UNALIGNED = ((32, 12, 6), (3, 12, 6), (4096, 3070, 9214))
# the 1B training phase (train1b): the same tiles on a synthetic train split of
# FIELDS_TRAIN_1B fields (16 tiles each), the config's batch of 32 tiles in
# GRAD_ACCUM_1B microbatches under the config's full remat, 2 epochs of
# TRAIN_STEPS_1B steps; one step at MICRO_1B tiles with remat full, dots and
# none, bit for bit
BATCH_TRAIN_1B = 32
GRAD_ACCUM_1B = 1
FIELDS_TRAIN_1B = 4
TRAIN_STEPS_1B = 2
MICRO_1B = 4
# the 1B checkpoint phase (resume1b): the same tiles and batch on synthetic
# train and val splits of FIELDS_RESUME_1B fields each (the val split's 80
# tiles: two full 32-tile batches and a partial one of 16), RESUME_STEPS_1B
# steps an epoch; the fine-tune on FT_DIV / FT_OVERLAP tiles (86 x 172, 3,698
# tokens: pos_embed resized from 33 x 66 to 43 x 86) at FT_BATCH tiles, a cut
# of the config's 32 that keeps the phase short
FIELDS_RESUME_1B = 5
RESUME_STEPS_1B = 2
# the phase's model at the config's full width, its depth 8 cut to 2 (serve1b's
# first Blocks): four checkpoints of the whole model took most of the
# script's time limit on a slow disk
RESUME_DEPTH_1B = 2
FT_DIV, FT_OVERLAP = 3, 2
FT_BATCH = 8

# the 10B serving phase (serve10b): configs/interm_10b.yaml at full width and
# depth, its mesh cut to the card; ERA5_1's 23 -> 3 variables on a synthetic
# ERA5 1.0 deg test split (the config's ERA5_2 key: 180 x 360 -> 720 x 1440)
# of FIELDS_10B fields, since the config's own 5.625 deg grid cuts 11 x 22
# tiles, odd for patch 2; the config's div 4 / overlap 3 cut 48 x 96 tiles (24
# x 48 = 1,152 tokens), BATCH_10B tiles a batch (the config's 32 cut to 16)
CONFIG_10B = ROOT / "configs" / "interm_10b.yaml"
KEY_10B = "ERA5_2"
LOW_10B = (180, 360)
FIELDS_10B = 2
BATCH_10B = 16
BATCHES_10B = 2
MC_SAMPLES_10B = 2
# the parameters of the port's model at these tiles (JAX's count, key for key:
# tests/test_torch_serve10b.py) and K1's (B, N, H, d) on this path
PARAMS_10B = 9_408_639_363
ATTENTION_10B = (BATCH_10B, 1152, 32, 256)
# the witness of the bf16 prediction's error: the first WITNESS_TILES_10B
# tiles of the batch through the same bf16 weights computing in fp32 on the
# plain attention. The bf16 prediction on the kernels may lie at most
# WITNESS_RATIO times as far from it as the bf16 prediction on the plain
# attention does, by relative Frobenius error and by the largest difference
# (a fault confined to a few values moves the largest)
WITNESS_TILES_10B = 4
WITNESS_RATIO = 2.0

# the MoE phase (moe1b): configs/interm_1b_moe.yaml at full width and depth
# (the 1B trunk, 8 Switch experts in every 2nd Block), its mesh (fsdp 2 x
# expert_par 4) cut to the card, on the 1B phases' tiles: served BATCH_1B
# tiles a batch over BATCHES_1B batches, an MC ensemble of MC_SAMPLES_MOE and
# a witness of WITNESS_TILES_MOE tiles; trained as train1b, the config's 32
# tiles in GRAD_ACCUM_MOE microbatches. PARAMS_MOE: the port's parameters
# at its tiles TILE_MOE, JAX's count key for key (tests/test_torch_moe.py)
CONFIG_MOE = ROOT / "configs" / "interm_1b_moe.yaml"
GRAD_ACCUM_MOE = 1
MC_SAMPLES_MOE = 2
WITNESS_TILES_MOE = 4
PARAMS_MOE = 3_103_984_003
TILE_MOE = (66, 132)

# the forecasting phase (forecast): configs/forecast.yaml at its own size
# (ERA5 5.625 deg, 32 x 64; history 3 x 6 variables -> 2; pred_range 72;
# batch 32; bf16; the rasp-theurey-2020 ResNet, 19 blocks of 128 channels),
# its mesh cut to the card, on a synthetic one-grid set of FORECAST_FILES
# shards of FORECAST_T hourly fields a split (T - 84 DirectForecast pairs a
# shard: 2 batches of 32 a split); 2 epochs of FORECAST_STEPS steps
CONFIG_FORECAST = ROOT / "configs" / "forecast.yaml"
GRID_FORECAST = (32, 64)
FORECAST_FILES = 2
FORECAST_T = 120
FORECAST_STEPS = 2
# the model-hub phase (hub): configs/interm_fine_tune.yaml's model section
# (embed 256, depth 6, 4 heads, d 64, decoder 4, dropout and drop-path 0.1,
# bf16) and its DAYMET_2 variables (23 -> 3) on a synthetic regional crop of
# LOW_HUB -> 4x (the config's 0.5-arcmin field is millions of tokens), batch
# BATCH_HUB of the config's 32, mesh cut to the card; `finetune --arch` for
# each preset, 2 epochs of HUB_STEPS steps from drawn weights, then
# Evaluator.test over HUB_TEST_BATCHES batches. The ViT's tokens: the target
# grid at patch 2, (256 / 2) x (512 / 2) = 32,768 (ATTENTION_HUB)
CONFIG_HUB = ROOT / "configs" / "interm_fine_tune.yaml"
LOW_HUB = (64, 128)
BATCH_HUB = 8
FIELDS_HUB = 16
HUB_STEPS = 2
HUB_TEST_BATCHES = 2
ATTENTION_HUB = (BATCH_HUB, 32768, 4, 64)
HUB_LOSSES = {"vit": "bayesian_tv", "unet": "imagegradient", "resnet": "quantile"}
# the ClimateBench phase (climatebench): the CLI's run for each model at
# MODEL_KWARGS, fp32 (as the JAX driver), on synthetic forcings of 4
# variables at CB_GRID (two scenario runs of LEN_HISTORICAL + CB_FUTURE years,
# whose windows start at the scenario, and a historical run of
# LEN_HISTORICAL), history 10, batch CB_BATCH, CB_EPOCHS epochs
CB_GRID = (32, 64)
CB_FUTURE = 86
CB_BATCH = 16
CB_EPOCHS = 1

# (B, N_q, N_k, H, D): the slice, the 117M bench shape, the 1B serving shape,
# a ragged N over many kv tiles at the widest head, N_q != N_k, and one query
# against one key past a 128-key tile at an odd B*H
SHAPES = [
    (8, 512, 512, 16, 64),
    (8, 2048, 2048, 16, 64),
    (2, 2048, 2048, 24, 128),
    (1, 4100, 4100, 2, 256),
    (2, 300, 1000, 4, 128),
    (3, 1, 129, 5, 64),
]
# the fused dropout's [rows, cols]: the slice's pos_drop/proj and Mlp hidden,
# the bench geometry's Mlp hidden and its pos_drop, proj and Mlp output (34 of
# K5's 50 launches a bench-geometry step), and a ragged shape
DROPOUT_SHAPES = [(8 * 512, 1024), (8 * 512, 4096), (8 * 2048, 4096), (8 * 2048, 1024), (21, 200)]
DROP = 0.1
# bf16: both sides read the same bf16 inputs and accumulate in fp32; the kernel
# rounds p to bf16 for the tensor-core value product and o once at the end.
# fp32: summation order only
O_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
LSE_ATOL = 1e-3
# gradients against autograd of the plain forward (fp32 math): fp32 sums in
# another order (atol=rtol 1e-4); bf16 rounds p and ds to bf16 for the tensor
# cores, an error that grows with N, so atol 2e-2 of the largest gradient
# and rtol 2e-2
GRAD_FP32_TOL = 1e-4
GRAD_BF16_REL = 2e-2
# the bf16 model on the kernel vs on the plain ("xla") attention: bf16 probs
# in the plain path round to 8 bits before the value product, and that
# difference passes through 8 blocks and the decoder
PRED_BF16_TOL = 5e-2
# the fp32 model on the card (kernels, cuBLAS/cuDNN without TF32) vs on the CPU
PRED_FP32_TOL = 1e-4
# one bf16 train step's loss, kernels vs plain versions on the card
TRAIN_BF16_RTOL = 2e-2
# one fp32 train step's loss and gradients, card vs CPU
TRAIN_FP32_TOL = 1e-4
# the fused MLP's [tokens, D -> F -> D2]: the 117M serving slice, bench.py's
# 117M geometry, a ragged token count, a small case, and F != 4 D with a
# partial D2 tile, fed as a strided [1, N, D] view (B = 1)
MLP_SHAPES = [(8 * 512, 1024, 4096, 1024), (8 * 2048, 1024, 4096, 1024),
              (4104, 1024, 4096, 1024), (64, 128, 256, 128), (512, 256, 640, 384)]
# the fused MLP against its plain version (forward) and autograd of it
# (gradients), relative to the largest value: bf16 rounds h, dpre and do2 to
# bf16 where the plain autograd keeps fp32 (atol 2e-2 x max, rtol 2e-2);
# fp32 sums over up to 16,384 tokens in another order (atol 1e-4 x max, rtol
# 1e-4)
MLP_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# one gradient of the bf16 serving model, fused vs unfused MLP: relative L2
# error of each gradient tensor (the two paths round the hidden at different
# points, through 8 blocks and the decoder)
MODEL_GRAD_REL = 5e-2
# the attention probes' [BH, N] at head dim 64: scripts/bench_attn2.py's
# (B8 x H16, N2048) and a small case of three q and kv tiles
PROBE_SHAPES = [(128, 2048), (4, 192)]
# probes against their plain versions, relative to each row's max|o| over its
# 64 outputs (the unscaled scores make rows differ by orders of magnitude):
# both round s or p to bf16 at the same points, but fp32 sums run in another
# order, so a value may round to the other side of a tie (atol 1e-2 x the
# row's max|o|, rtol 1e-2)
PROBE_REL = 1e-2
# the bound shift against the fp32 softmax: bf16 p and o
PROBE_SOFTMAX_ATOL = 1e-2
# H100 SXM peaks (dense bf16 tensor cores, HBM3) for the kernels' bounds,
# and the dense int8 tensor-core rate for the w8a8 products'
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12
# Integer instructions on an SM (Hopper): IMAD and its forms issue to the FMA
# pipe, the other integer opcodes (LOP3, IADD3, SHF, ISETP, ...) to the ALU
# pipe, 64 lanes each, and the SM issues at most 4 warp instructions (128
# lanes) a clock. With the SM count and the card's maximum SM clock
# (nvidia-smi) they bound the dropout bits of K1, K2 and K3.
INT_PIPE_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
# elements of one Philox call (csrc/kernel_prng.cuh: 8 columns, 16 bits each)
ELEMENTS_PER_CALL = 8
# the Hopper kernel templates (csrc/flash_fwd_hopper.cuh: K1 and the probes;
# csrc/flash_bwd_hopper.cuh: K2 and K3; csrc/fused_mlp_hopper.cuh: the fused
# MLP's bf16 kernels), whose instances must issue wgmma (HGMMA) and TMA
# loads (UTMALDG) and spill nothing: 6 of K1, 4 probes, 4 each of K2 and K3
# (d 64 and 128, with and without dropout), stage H with and without dropout,
# and the products: dx and dW at output tiles of 128 and 256 columns, and
# the forward's F1 and F2 at both tile widths, with and without dropout
HOPPER_FWD = "flash_fwd_tma_wgmma"
HOPPER_KERNELS = {HOPPER_FWD: 10, "flash_bwd_dq_tma_wgmma": 4, "flash_bwd_dkv_tma_wgmma": 4,
                  "mlp_hidden_bwd_tma_wgmma": 2, "mlp_gemm_tma_wgmma": 12}
# the d64 instances whose dropout SASS is counted, and the Philox calls a lane
# makes per shuffle of drop flags in their draw: K1's and K2's drop_bits make
# BK / 16 calls and 2 exchanges of BK / 64 words, K3's drop_bits_t BQ / 16
# calls and 3 exchanges (csrc/flash_fwd_hopper.cuh, flash_bwd_hopper.cuh)
DROPOUT_SASS = {"fwd": (HOPPER_FWD, "ILi64ELi0ELb{}", 2.0),
                "dq": ("flash_bwd_dq_tma_wgmma", "ILi64ELb{}", 2.0),
                "dkv": ("flash_bwd_dkv_tma_wgmma", "ILi64ELb{}", 4.0 / 3.0)}
# bench.py:199-210, the 117M train geometry
BENCH_VARS = ("land_sea_mask", "orography", "lattitude", "landcover",
              "total_precipitation_24hr", "2m_temperature_min", "2m_temperature_max")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


START = time.perf_counter()
LAP = [START]


def phase(name):
    LAP[0] = time.perf_counter()
    print(f"== {name} (at {LAP[0] - START:.1f} s)", flush=True)


def lap(label):
    """Prints the seconds since the phase began or the last lap: where a
    phase's time goes."""
    now = time.perf_counter()
    print(f"  -- {label}: {now - LAP[0]:.1f} s (at {now - START:.1f} s)", flush=True)
    LAP[0] = now


def cuda_ms(fn, iters=20, warmup=3):
    """Median over `iters` runs of one call's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def best_ms(fn):
    """The better of two medians of `fn` (cuda_ms), as paired_ms takes for a
    kernel: the library calls' times."""
    return min(cuda_ms(fn), cuda_ms(fn))


def paired_ms(kernel, plain, iters=20):
    """(kernel ms, plain ms): each timed twice in turns (plain, kernel,
    kernel, plain), the better of its two medians."""
    p1, k1 = cuda_ms(plain, iters), cuda_ms(kernel, iters)
    k2, p2 = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    return min(k1, k2), min(p1, p2)


def make_qkv(b, n_q, n_k, h, d, dtype, gen):
    mk = lambda n: torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype)
    return mk(n_q), mk(n_k), mk(n_k)


def kernels():
    from orbit2_tpu_torch.ops.attn_probes import (
        PROBE_BOUND_SHIFT, PROBE_EXP_NOREDUCE, PROBE_FULL_SOFTMAX, PROBE_MATMUL_ONLY)
    from orbit2_tpu_torch.ops.dropout import FUSED_DROPOUT
    from orbit2_tpu_torch.ops.flash_attention import FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD
    from orbit2_tpu_torch.ops.fused_mlp import FUSED_MLP_DW, FUSED_MLP_DX, FUSED_MLP_FWD

    return {"flash_attn_fwd": FLASH_FWD, "flash_attn_bwd_dq": FLASH_BWD_DQ,
            "flash_attn_bwd_dkv": FLASH_BWD_DKV, "fused_dropout": FUSED_DROPOUT,
            "fused_mlp_fwd": FUSED_MLP_FWD, "fused_mlp_dx": FUSED_MLP_DX,
            "fused_mlp_dw": FUSED_MLP_DW, "probe_matmul_only": PROBE_MATMUL_ONLY,
            "probe_exp_noreduce": PROBE_EXP_NOREDUCE, "probe_full_softmax": PROBE_FULL_SOFTMAX,
            "probe_bound_shift": PROBE_BOUND_SHIFT}


def only(**launched):
    """The launch counts of a run that launched `launched` and nothing else."""
    return {name: launched.get(name, 0) for name in kernels()}


def nonzero(launched):
    """The kernels of `launched` (a counts() dict) launched at all."""
    return {k: n for k, n in launched.items() if n}


def reset_counts():
    for k in kernels().values():
        k.launches = 0


def counts():
    return {name: k.launches for name, k in kernels().items()}


def write_dataset(root: Path, in_vars, out_vars, seed: int, n_files=2, t=16, low=(32, 64),
                  mag=4, shards=("train", "val", "test"), same_samples=False):
    """The tests/conftest.py layout, by default at ERA5 5.625 deg (32 x 64) ->
    1.40625 deg (128 x 256): npz shards of [T, 1, H, W] arrays at `low` and
    `mag` x finer for the splits in `shards`, normalize mean/std, lat/lon and
    every split's climatology. `same_samples`: every sample of every file one
    field (a mesh's data ranks then read what one rank reads, in any
    grouping)."""
    rng = np.random.default_rng(seed)
    fields = {}

    def field(v, h, w):
        if same_samples and (v, h, w) in fields:
            return fields[v, h, w]
        n = 1 if same_samples else t
        if v == "total_precipitation_24hr":
            a = rng.gamma(0.3, 0.004, size=(n, 1, h, w))
        elif v in ("land_sea_mask", "landcover"):
            a = rng.integers(0, 2, size=(n, 1, h, w)).astype(np.float64)
        else:
            a = rng.normal(280, 10, size=(n, 1, h, w))
        if same_samples:
            a = fields[v, h, w] = np.repeat(a, t, axis=0)
        return a

    for base, (h, w), variables in ((root / "low", low, in_vars),
                                    (root / "high", (low[0] * mag, low[1] * mag), out_vars)):
        for split in ("train", "val", "test"):
            d = base / split
            d.mkdir(parents=True)
            for i in range(n_files if split in shards else 0):
                np.savez(d / f"shard_{i}.npz",
                         **{v: field(v, h, w).astype(np.float32) for v in variables})
            np.savez(d / "climatology.npz",
                     **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32)
                        for v in variables})
        np.save(base / "lat.npy", np.linspace(-88, 88, h).astype(np.float32))
        np.save(base / "lon.npy", np.linspace(0, 358, w).astype(np.float32))
        np.savez(base / "normalize_mean.npz", **{v: np.array([280.0], np.float32) for v in variables})
        np.savez(base / "normalize_std.npz", **{v: np.array([10.0], np.float32) for v in variables})
    return str(root / "low"), str(root / "high")


def to_one_card(cfg):
    """`cfg` with its mesh scaled to the one card by the train CLI's
    scale-down (orbit2_tpu_torch/train.py::scale_parallelism, examples/
    train.py:28-48's): pipeline and expert_par are left as they are."""
    from orbit2_tpu_torch.train import scale_parallelism

    return scale_parallelism(cfg, 1)


def raw_config(root: Path, seed: int, config=CONFIG, trainer=None, model=None, **dataset):
    """`config`'s raw sections with its first data key on a synthetic dataset
    of its variables written under `root` (write_dataset's `dataset`
    arguments), its mesh as shipped, and its trainer and model keys updated
    from `trainer`, `model`."""
    import yaml

    raw = yaml.safe_load(config.read_text())
    data = raw["data"]
    key = next(iter(data["low_res_dir"]))
    low, high = write_dataset(root, data["dict_in_variables"][key],
                              data["dict_out_variables"][key], seed, **dataset)
    data["low_res_dir"] = {key: low}
    data["high_res_dir"] = {key: high}
    raw["trainer"].update(trainer or {})
    raw["model"].update(model or {})
    return raw


def slice_config(root: Path, seed: int, config=CONFIG, trainer=None, model=None, **dataset):
    """`config` (configs/interm_117m.yaml) as raw_config writes it, its mesh
    (117M: fsdp 4 x simple_ddp 4) cut to the one card (to_one_card)."""
    from orbit2_tpu_torch.config import load_config

    return to_one_card(load_config(raw_config(root, seed, config, trainer, model, **dataset)))


def config_1b(root: Path, seed: int, low=LOW_1B, trainer=None, n_files=1, t=FIELDS_1B,
              shards=("test",), **model):
    """configs/interm_1b.yaml with its mesh (fsdp 8 x simple_ddp 4 x
    tensor_par 4) cut to the one card, batch BATCH_1B tiles (or what
    `trainer` says), and PRISM's variables on a synthetic split (`shards`) of
    n_files x t fields at `low`."""
    return slice_config(root, seed, CONFIG_1B, trainer={"batch_size": BATCH_1B, **(trainer or {})},
                        model=model, n_files=n_files, t=t, low=low, shards=shards)


def config_10b(root: Path, seed: int):
    """configs/interm_10b.yaml with its mesh (fsdp 4 x tensor_par 4) cut to
    the one card, batch BATCH_10B tiles, and ERA5_1's variables under
    KEY_10B on a synthetic test split of FIELDS_10B fields at LOW_10B."""
    import yaml

    from orbit2_tpu_torch.config import load_config

    raw = yaml.safe_load(CONFIG_10B.read_text())
    data = raw["data"]
    in_vars, out_vars = data["dict_in_variables"]["ERA5_1"], data["dict_out_variables"]["ERA5_1"]
    low, high = write_dataset(root, in_vars, out_vars, seed, n_files=1, t=FIELDS_10B,
                              low=LOW_10B, shards=("test",))
    data["low_res_dir"], data["high_res_dir"] = {KEY_10B: low}, {KEY_10B: high}
    data["dict_in_variables"], data["dict_out_variables"] = {KEY_10B: in_vars}, {KEY_10B: out_vars}
    raw["trainer"]["batch_size"] = BATCH_10B
    return to_one_card(load_config(raw))


def set_attention_impl(model, impl):
    from orbit2_tpu_torch.models.components.blocks import Attention

    for m in model.modules():
        if isinstance(m, Attention):
            m.attention_impl = impl


def set_use_fused(model, flag):
    from orbit2_tpu_torch.models.components.blocks import Mlp

    for m in model.modules():
        if isinstance(m, Mlp):
            m.use_fused = flag


def eval_grad(model, x, in_vars, out_vars):
    """(loss, gradients) of the eval-mode prediction's mean square with respect
    to the input ("input") and every trainable parameter."""
    model.eval()
    model.zero_grad(set_to_none=True)
    xg = x.detach().clone().requires_grad_()
    loss = model(xg, in_vars, out_vars).float().square().mean()
    loss.backward()
    grads = {"input": xg.grad.float()}
    grads.update((k, p.grad.float()) for k, p in model.named_parameters() if p.grad is not None)
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def mlp_inputs(shape, dtype, gen, batch_one=False):
    """x [T, D] (a strided view of a [1, T, 2D] tensor when batch_one), w1 [F, D],
    b1, w2 [D2, F], b2 on the card."""
    t, d, f, d2 = shape
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda") * scale).to(dtype)
    x = mk(t, d)
    if batch_one:
        x = torch.cat([x, mk(t, d)], dim=1).view(1, t, 2 * d)[..., :d].reshape(t, d)
    return x, mk(f, d, scale=d ** -0.5), mk(f, scale=0.1), mk(d2, f, scale=f ** -0.5), mk(d2, scale=0.1)


def beyond(got, want, rel, rows=False):
    """(values of got beyond atol rel x max|want| and rtol rel, max abs error),
    the max taken over each row's last dim when `rows`, else over the whole
    tensor."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    scale = mag.amax(dim=-1, keepdim=True) if rows else mag.max()
    return int((~(diff <= rel * scale + rel * mag)).sum().item()), diff.max().item()


def close(got, want, rel, what, rows=False):
    """Max abs error of got against want, raising where `beyond` counts a
    value."""
    bad, err = beyond(got, want, rel, rows)
    check(bad == 0, f"{what}: {bad} values beyond atol {rel:g} x max|want|"
          f"{' of their row' if rows else ''}, rtol {rel:g} (max|d| {err:.3e})")
    return err


def bf16_ulps(a, b):
    """Per element, how many bf16 steps apart a and b are (+0 and -0 equal)."""
    line = lambda v: (lambda i: torch.where(i < 0, -(i & 0x7FFF), i))(v.view(torch.int16).int())
    return (line(a) - line(b)).abs()


def check_fused_mlp(gen, kernel_seed, errs):
    """The fused MLP's three kernels against their plain versions at
    MLP_SHAPES; at the first, the forward's h_r (F1) against stage H's."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.dropout import dropout
    from orbit2_tpu_torch.ops.fused_mlp import (
        FUSED_MLP_DW, FUSED_MLP_FWD, fused_mlp, fused_mlp_bwd, fused_mlp_fwd, fused_mlp_reference,
        mlp_masks)
    from orbit2_tpu_torch.ops.kernel_prng import draw_seed

    s1, s2 = kernel_seed + 1, kernel_seed + 2
    for dtype in (torch.bfloat16, torch.float32):
        for shape in MLP_SHAPES:
            t, d, f, d2 = shape
            x, w1, b1, w2, b2 = mlp_inputs(shape, dtype, gen, batch_one=shape == MLP_SHAPES[-1])
            do = torch.randn(t, d2, generator=gen, device="cuda").to(dtype)
            for rate in (0.0, DROP):
                m1, m2 = mlp_masks(rate, s1, s2, t, f, d2, device="cuda")
                out = fused_mlp_fwd(x, w1, b1, w2, b2, rate, s1, s2)
                out_again = fused_mlp_fwd(x, w1, b1, w2, b2, rate, s1, s2)
                grads = fused_mlp_bwd(x, w1, b1, w2, do, rate, s1, s2)
                again = fused_mlp_bwd(x, w1, b1, w2, do, rate, s1, s2)
                want = fused_mlp_reference(x, w1, b1, w2, b2, m1, m2)
                leaves = [a.detach().float().requires_grad_() for a in (x, w1, b1, w2, b2)]
                fused_mlp_reference(*leaves, m1, m2).backward(do.float())
                torch.cuda.synchronize()
                case = f"fused mlp {str(dtype)[6:]} drop {rate:g} {list(shape)}"
                err = {"out": close(out, want, MLP_REL[dtype], f"{case} out")}
                for name, got, leaf in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, leaves):
                    err[name] = close(got, leaf.grad, MLP_REL[dtype], f"{case} {name}")
                check(torch.equal(out, out_again), f"{case}: two forward runs differ")
                check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                      f"{case}: two backward runs differ")
                line = "max abs err " + "  ".join(f"{k} {v:.3e}" for k, v in err.items())
                if rate:
                    with torch.no_grad():
                        fused = fused_mlp(x, w1, b1, w2, b2, rate, torch.Generator().manual_seed(5))
                        g = torch.Generator().manual_seed(5)
                        h = dropout(F.gelu(F.linear(x, w1, b1)), rate, True, g)
                        chain = dropout(F.linear(h, w2, b2), rate, True, g)
                        g = torch.Generator().manual_seed(5)
                        dropped = mlp_masks(rate, draw_seed(g), draw_seed(g), t, f, d2,
                                            device="cuda")[1] == 0
                        torch.cuda.synchronize()
                    # both drop exactly the output mask's elements; a kept element
                    # may still be an exact zero by cancellation (about one in 2^24)
                    stray = [((z == 0) & ~dropped).sum().item() for z in (fused, chain)]
                    check(bool((fused[dropped] == 0).all() and (chain[dropped] == 0).all())
                          and sum(stray) <= max(4, t * d2 >> 20),
                          f"{case}: zero pattern differs from the unfused chain's (stray {stray})")
                    err["chain"] = close(fused, chain, MLP_REL[dtype], f"{case} vs unfused chain")
                    line += (f"; zeros = the unfused K5 chain's ("
                             f"{dropped.float().mean().item():.4f} dropped; exact zeros "
                             f"among kept: {stray[0]} fused, {stray[1]} unfused)")
                    del fused, h, chain, dropped
                if dtype == torch.bfloat16 and shape == MLP_SHAPES[0]:
                    # the same accumulator through the same GELU in F1 and stage H;
                    # their product tiles differ (128 x 256 and 128 x 128)
                    _, h_fwd = FUSED_MLP_FWD(x, w1, b1, w2, b2, rate, s1, s2, keep_h=True)
                    *_, h_bwd = FUSED_MLP_DW(x, w1, b1, w2, do, rate, s1, s2, keep_h=True)
                    ulps = bf16_ulps(h_fwd, h_bwd)
                    unequal, worst = int((ulps > 0).sum().item()), int(ulps.max().item())
                    check(worst <= 1, f"{case}: h_r of F1 and of stage H {worst} bf16 ulp apart")
                    line += (f"; h_r (F1) vs stage H's: {unequal} of {ulps.numel()} unequal, "
                             f"at most {worst} ulp")
                    del h_fwd, h_bwd, ulps
                print(f"  {case}: {line}; fwd and bwd bit-equal over two runs")
                errs[("mlp_fwd", dtype, shape, rate)] = err["out"]
                errs[("mlp_dx", dtype, shape, rate)] = err["dx"]
                errs[("mlp_dw", dtype, shape, rate)] = max(err[k] for k in ("dw1", "db1", "dw2", "db2"))
                del out, out_again, grads, again, want, leaves, m1, m2
            del x, w1, b1, w2, b2, do
            torch.cuda.empty_cache()


def time_fused_mlp(gen, bounds, libs):
    """Kernel vs plain ms of the fused MLP in bf16 at dropout 0 (the model's
    eval-mode use) at the two 117M shapes: the forward, dx and dW kernels
    against the plain versions, and forward, backward and forward + backward
    also against the unfused bf16 chain (cuBLAS GEMMs, GELU; autograd), which
    is no single library call. Adds each kernel's bound to `bounds` and the
    chain's times to `libs`."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.fused_mlp import (
        FUSED_MLP_DW, FUSED_MLP_DX, fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_fwd,
        fused_mlp_reference)

    timed = {}
    for shape in MLP_SHAPES[:2]:
        t, d, f, d2 = shape
        args = mlp_inputs(shape, torch.bfloat16, gen)
        do = torch.randn(t, d2, generator=gen, device="cuda").to(torch.bfloat16)
        leaves = [a.detach().requires_grad_() for a in args]
        chain = lambda a: F.linear(F.gelu(F.linear(a[0], a[1], a[2])), a[3], a[4])
        kern_fb = lambda: (fused_mlp_fwd(*args), fused_mlp_bwd(*args[:4], do))
        before = counts()
        fwd, fwd_plain = paired_ms(lambda: fused_mlp_fwd(*args),
                                   lambda: fused_mlp_reference(*args))
        with torch.no_grad():
            _, fwd_chain = paired_ms(lambda: fused_mlp_fwd(*args), lambda: chain(args))
        fb, fb_plain = paired_ms(kern_fb, lambda: (fused_mlp_reference(*args),
                                                   fused_mlp_bwd_reference(*args[:4], do)))
        _, fb_chain = paired_ms(kern_fb, lambda: torch.autograd.grad(chain(leaves), leaves, do))
        dx = cuda_ms(lambda: FUSED_MLP_DX(*args[:4], do, 0.0, 0, 0))
        dw = cuda_ms(lambda: FUSED_MLP_DW(*args[:4], do, 0.0, 0, 0))
        bwd = cuda_ms(lambda: fused_mlp_bwd(*args[:4], do))
        bwd_plain = cuda_ms(lambda: fused_mlp_bwd_reference(*args[:4], do))
        out_chain = chain(leaves)
        bwd_chain = best_ms(lambda: torch.autograd.grad(out_chain, leaves, do, retain_graph=True))
        with torch.no_grad():
            host_fwd, host_chain = host_us(lambda: fused_mlp_fwd(*args)), host_us(lambda: chain(args))
        after = counts()
        check(all(after[n] > before[n] for n in ("fused_mlp_fwd", "fused_mlp_dx", "fused_mlp_dw")),
              "timing did not launch the fused MLP kernels")
        flops = 2 * t * (d * f + f * d2)  # the forward's two products
        print(f"  fused mlp bf16 [{t}, {d} -> {f} -> {d2}]: fwd {fwd:.4f} ms "
              f"({flops / fwd / 1e9:.1f} TFLOP/s of the two products) plain {fwd_plain:.4f}, "
              f"unfused chain {fwd_chain:.4f}; host {host_fwd:.1f} us a forward call (chain "
              f"{host_chain:.1f}); fwd + bwd {fb:.4f} ms ({3 * flops / fb / 1e9:.1f} "
              f"TFLOP/s of six products; dx {dx:.4f}, dW {dw:.4f}) plain {fb_plain:.4f} "
              f"(backward alone {bwd_plain:.4f}), unfused chain {fb_chain:.4f}")
        # useful products: the forward's two; dx alone takes h_pre, dh and dx
        # (stage H and dx); dW alone h_pre, dh, dW1 and dW2; the backward all
        # five, each once. Bytes: the inputs read once, the outputs written
        # once (dx in the dtype; dW1, db1, dW2, db2 in fp32)
        grads = 4 * (f * d + f + d2 * f + d2)
        bounds[("mlp_fwd", shape)] = roofline(flops, nbytes(*args) + 2 * t * d2)
        # F1 alone: x W1^T into h_r (written); F2 alone: h_r (read) W2^T
        bounds[("mlp_f1", shape)] = roofline(2 * t * d * f, nbytes(*args[:3]) + 2 * t * f)
        bounds[("mlp_f2", shape)] = roofline(2 * t * f * d2, 2 * t * f + nbytes(*args[3:]) + 2 * t * d2)
        bounds[("mlp_dx", shape)] = roofline(2 * t * (d * f + f * d2 + f * d),
                                             nbytes(*args[:4], do, args[0]))
        bounds[("mlp_dw", shape)] = roofline(2 * t * (d * f + f * d2 + f * d + d2 * f),
                                             nbytes(*args[:4], do) + grads)
        bounds[("mlp_bwd", shape)] = roofline(2 * t * (2 * d * f + 2 * f * d2 + f * d),
                                              nbytes(*args[:4], do, args[0]) + grads)
        libs[("mlp_fwd_chain", shape)] = fwd_chain
        libs[("mlp_bwd_chain", shape)] = bwd_chain
        print(f"    backward (fused_mlp_bwd) {bwd:.4f} ms; unfused chain backward alone "
              f"{bwd_chain:.4f} ms; bounds fwd {bounds[('mlp_fwd', shape)][0]:.4f} (F1 "
              f"{bounds[('mlp_f1', shape)][0]:.4f}, F2 {bounds[('mlp_f2', shape)][0]:.4f}), dx "
              f"{bounds[('mlp_dx', shape)][0]:.4f}, dW {bounds[('mlp_dw', shape)][0]:.4f}, "
              f"backward {bounds[('mlp_bwd', shape)][0]:.4f} ms")
        timed[("mlp_fwd", shape)] = (fwd, fwd_plain)
        timed[("mlp_dx", shape)] = (dx, bwd_plain)
        timed[("mlp_dw", shape)] = (dw, bwd_plain)
        timed[("mlp_bwd", shape)] = (bwd, bwd_plain)
        del args, do, leaves, out_chain
        torch.cuda.empty_cache()
    return timed


def check_forward(q, k, v, rate, seed, case):
    """K1 against its plain version on the same inputs and dropout multiplier:
    o within atol=rtol O_TOL, lse within LSE_ATOL. Returns (o, lse, the
    multiplier, max|do|)."""
    from orbit2_tpu_torch.ops.flash_attention import (
        attention_mult, flash_attention_fwd, flash_attention_reference)

    mult = attention_mult(q, k, rate, seed)
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    want_o, want_lse = flash_attention_reference(q, k, v, None, mult)
    return o, lse, mult, hold_forward(o, lse, want_o, want_lse, case)


def hold_forward(o, lse, want_o, want_lse, case):
    """K1's (o, lse) against the plain version's: o within atol=rtol O_TOL,
    lse within LSE_ATOL. Returns max|do|."""
    torch.cuda.synchronize()
    diff = (o.float() - want_o.float()).abs()
    err_o, err_lse = diff.max().item(), (lse - want_lse).abs().max().item()
    tol = O_TOL[o.dtype]
    ok_o = bool((diff <= tol + tol * want_o.float().abs()).all())
    print(f"  fwd {case}: max|do| {err_o:.3e} (atol=rtol={tol:g})  max|dlse| {err_lse:.3e} "
          f"(atol {LSE_ATOL:g})")
    check(ok_o and err_lse <= LSE_ATOL, f"flash forward disagrees with plain at {case}")
    return err_o


def check_dropout(r, c, dtype, rate, gen, seed):
    """K5 at [r, c] against its plain version: forward and backward bit-equal
    under the same mask, and the share kept within 4 sigma of 1 - rate."""
    from orbit2_tpu_torch.ops.dropout import FusedDropout, dropout_reference
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult, keep_threshold

    x = torch.randn(r, c, generator=gen, device="cuda").to(dtype).requires_grad_()
    g = torch.randn(r, c, generator=gen, device="cuda").to(dtype)
    out = FusedDropout.apply(x, seed + r, rate)
    out.backward(g)
    mult = keep_mult(seed + r, r, c, rate, device="cuda")
    same_fwd = torch.equal(out, dropout_reference(x.detach(), mult))
    same_bwd = torch.equal(x.grad, dropout_reference(g, mult))
    kept = (mult > 0).float().mean().item()
    print(f"  fused_dropout {str(dtype)[6:]:8s} [{r}, {c}]: fwd bit-equal {same_fwd}, "
          f"bwd bit-equal {same_bwd}, kept {kept:.4f}")
    check(same_fwd and same_bwd, f"fused dropout differs from plain at [{r}, {c}] {dtype}")
    p_keep = (keep_threshold(rate) + 1) / 2 ** 16  # within 2^-16 of 1 - rate
    check(abs(kept - p_keep) < 4 * math.sqrt(p_keep * (1 - p_keep) / (r * c)),
          f"fused dropout kept {kept} of [{r}, {c}]")


def check_backward(q, k, v, o, lse, do, mult, rate, seed, case):
    """dq, dk and dv of flash_attention_bwd against autograd of the plain
    forward under the same multiplier (fp32: atol=rtol GRAD_FP32_TOL; bf16:
    atol GRAD_BF16_REL x the largest value of the gradient, or of the case's
    gradients where that one is identically zero, rtol GRAD_BF16_REL), and
    two runs bit-equal. Returns ({name: max abs error}, a line to print)."""
    from orbit2_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_reference

    d = q.shape[-1]
    got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    again = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    err, line = hold_grads(got, plain_grads(q, k, v, do, mult), case)
    for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
        check(torch.equal(g, g2), f"{name}: two backward runs differ at {case}")
    return err, line + "; bit-equal over two runs"


def plain_grads(q, k, v, do, mult):
    """(dq, dk, dv) of autograd of the plain forward under `mult`, fp32."""
    from orbit2_tpu_torch.ops.flash_attention import flash_attention_reference

    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    flash_attention_reference(qf, kf, vf, None, mult)[0].backward(do.float())
    return qf.grad, kf.grad, vf.grad


def hold_grads(got, refs, case):
    """(dq, dk, dv) of the kernels against the plain ones (check_backward's
    tolerances). Returns ({name: max abs error}, a line to print)."""
    torch.cuda.synchronize()
    dtype = got[0].dtype
    err, line = {}, []
    for name, g, want in zip(("dq", "dk", "dv"), got, refs):
        check(g.dtype == dtype, f"{name} is {g.dtype}, want {dtype}")
        scale = want.abs().max().item()
        if scale == 0.0:
            # an identically zero gradient (dq at N_k = 1: a softmax over one
            # key has none), where the kernel leaves the rounding of
            # dp - delta: held against the case's largest gradient
            scale = max(r.abs().max().item() for r in refs)
        if dtype == torch.float32:
            atol = rtol = GRAD_FP32_TOL
        else:
            atol, rtol = GRAD_BF16_REL * scale, GRAD_BF16_REL
        diff = (g.float() - want).abs()
        err[name] = diff.max().item()
        check(bool((diff <= atol + rtol * want.abs()).all()),
              f"{name} kernel disagrees with plain at {case}")
        line.append(f"max|d{name}| {err[name]:.3e} (max|{name}| {scale:.3e})")
    return err, "  ".join(line)


def check_batch_rows(q, k, v, do, rate, seed, rows, case):
    """K1, K2 and K3 launched on the whole batch of q, k, v, held on the batch
    elements `rows` against their plain versions on those elements alone,
    each under the dropout multiplier of its own streams (b H .. b H + H - 1):
    o and lse as check_forward, dq, dk and dv as check_backward; K1 alone
    where do is None (a path that runs no backward). The plain versions of a
    whole large batch would not fit beside the model. Returns {name: max abs
    error}."""
    from orbit2_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    _, n_q, h, d = q.shape
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    got = None if do is None else flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    err = {}
    for b in rows:
        one = slice(b, b + 1)
        mult = (keep_mult(seed, n_q, k.shape[1], rate, streams=h, device=q.device,
                          first_stream=b * h) if rate > 0.0 else None)
        want_o, want_lse = flash_attention_reference(q[one], k[one], v[one], None, mult)
        where = f"{case}, batch element {b}"
        err[("fwd", b)] = hold_forward(o[one], lse[b * h:(b + 1) * h], want_o, want_lse, where)
        if got is not None:
            e, line = hold_grads([g[one] for g in got], plain_grads(q[one], k[one], v[one],
                                                                  do[one], mult), where)
            print(f"  bwd {where}: {line}")
            err.update(((name, b), val) for name, val in e.items())
        del mult, want_o, want_lse
    return {name: max(val for (n, _), val in err.items() if n == name)
            for name in ("fwd",) + (() if got is None else ("dq", "dk", "dv"))}


def sass_check(libraries):
    """cuobjdump -sass of the libraries: every instance of HOPPER_KERNELS
    must hold HGMMA and UTMALDG and no local-memory access (STL/LDL), and
    each template must have its count of instances. Returns {instance name:
    {opcode: static count}}."""
    import re

    from orbit2_tpu_torch.ops._nvcc import _nvcc

    cuobjdump = str(Path(_nvcc()).parent / "cuobjdump")
    found = {}
    for lib in libraries:
        sass = subprocess.run([cuobjdump, "-sass", str(lib.path())], capture_output=True,
                              text=True, check=True).stdout
        for section in sass.split("Function : ")[1:]:
            name = section.split("\n", 1)[0].strip()
            if not any(kernel in name for kernel in HOPPER_KERNELS):
                continue
            ops = {}
            for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", section):
                ops[op] = ops.get(op, 0) + 1
            found[name] = ops
            check(ops.get("HGMMA", 0) > 0 and ops.get("UTMALDG", 0) > 0,
                  f"{name}: no HGMMA or UTMALDG in its SASS")
            check(not ops.get("STL") and not ops.get("LDL"), f"{name}: local-memory spill")
    for kernel, want in HOPPER_KERNELS.items():
        have = sum(kernel in name for name in found)
        check(have == want, f"{have} instances of {kernel}, want {want}")
    return found


def dropout_ops(found):
    """Integer instructions the dropout adds to the d64 instances of K1, K2
    and K3, from their SASS: the integer opcodes of the dropout instance less
    those of the same kernel without it, over the Philox calls its code holds
    (DROPOUT_SASS: calls per extra shuffle). Returns {kernel: (IMAD on the
    FMA pipe a call, others on the ALU pipe a call, calls)}; a dropped
    element costs a call's instructions over ELEMENTS_PER_CALL. The drawing,
    compare, flag exchange and the multiply-select where the flags are read
    are all counted."""
    def instance(kernel, pattern, dropout):
        tag = pattern.format(int(dropout))
        return next(ops for name, ops in found.items() if kernel in name and tag in name)

    def integer(ops, fma_pipe):
        return sum(n for op, n in ops.items()
                   if (op.startswith(("I", "LOP", "SEL", "VIADD", "R2P", "LEA", "PRMT"))
                       or op == "SHF") and op.startswith("IMAD") == fma_pipe)

    out = {}
    for key, (kernel, pattern, calls_per_shfl) in DROPOUT_SASS.items():
        drop, plain = instance(kernel, pattern, True), instance(kernel, pattern, False)
        calls = (drop.get("SHFL", 0) - plain.get("SHFL", 0)) * calls_per_shfl
        check(calls > 0, f"cannot find the dropout bits in {kernel}'s SASS")
        out[key] = tuple((integer(drop, pipe) - integer(plain, pipe)) / calls
                         for pipe in (True, False)) + (calls,)
    return out


def call_clocks(fma, alu):
    """SM clocks a Philox call takes at best: its busier pipe, or the issue rate."""
    return max(fma / INT_PIPE_LANES_PER_SM, alu / INT_PIPE_LANES_PER_SM,
               (fma + alu) / ISSUE_LANES_PER_SM)


def device_switch_us(n=20000):
    """Host microseconds a kernel launch spends entering and leaving
    torch.cuda.device for the current device (NvccKernel.launch), and in the
    check that the device is current, which could skip it: the better of
    two means over n calls each."""
    dev = torch.device("cuda", torch.cuda.current_device())

    def switch():
        with torch.cuda.device(dev):
            pass

    def per_call(fn):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    return (min(per_call(switch) for _ in range(2)),
            min(per_call(lambda: dev.index == torch.cuda.current_device()) for _ in range(2)))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(flops, moved):
    """(ms, "operations" or "bytes"): the least time the card could take for
    `flops` useful tensor-core flops and `moved` bytes, at the H100 peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_ms(q, k, v, do, bwd_rate=DROP):
    """SDPA pinned to its flash backend (any other raises) on q, k, v
    [B, N, H, D] viewed as
    [B, H, N, D]: {"fwd": {0.0: ms, DROP: ms}, "bwd": ms of its backward alone
    (dq, dk and dv) at dropout `bwd_rate` under the cotangent do}."""
    import torch.nn.functional as F

    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = {"fwd": {}}
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.no_grad():
        for rate in (0.0, DROP):
            out["fwd"][rate] = best_ms(
                lambda: F.scaled_dot_product_attention(*leaves, dropout_p=rate))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(*leaves, dropout_p=bwd_rate)
        do_t = do.transpose(1, 2)
        out["bwd"] = best_ms(lambda: torch.autograd.grad(o, leaves, do_t, retain_graph=True))
    return out


def kernel_ms(fn, iters=10, sessions=6, by_name=None):
    """Device time of one call of fn by torch.profiler: the kernel time of
    every kernel one call launches, without the host's launch work. Over a
    session of `iters` calls after warm-up, each kernel name's mean time
    times its launches a call (its count over iters, rounded), summed. A
    session that records some kernel fewer than `iters` times (the profiler
    now and then hands back an empty or partial session, three times in a
    row once at K5's [16384, 1024] row) is run again, up to `sessions` times;
    the fullest is kept, and it must hold at least half of the kernels. by_name, a dict, receives each kernel name's ms a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ran = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ran.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if sum(map(len, ran.values())) > sum(map(len, best.values())):
            best = ran
        if all(len(v) >= iters for v in ran.values()) and ran:
            break
    per_call = {name: max(1, round(len(v) / iters)) for name, v in best.items()}
    got = sum(map(len, best.values()))
    check(bool(best) and iters * sum(per_call.values()) // 2 <= got,
          f"profiled {got} kernels of {iters} calls ({per_call})")
    each = {name: sum(v) / len(v) * per_call[name] / 1e3 for name, v in best.items()}
    if by_name is not None:
        by_name.update(each)
    return sum(each.values())


def host_us(fn, n=200):
    """Host microseconds one call of fn takes to return (wrapper, ctypes and
    launch), the device idle before the first: the mean over n calls, fewer
    than the launch queue holds, so none waits for the device."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    per = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return per


def dropout_rows(gen, seed, timed, libs, bounds, smi):
    """K5's rows at each DROPOUT_SHAPES case in both dtypes: its kernel time
    alone and F.dropout's (the profiler's), beside their event times (phase
    6), the bytes bound and the host time a call."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.dropout import FusedDropout

    for dtype in (torch.bfloat16, torch.float32):
        for r, c in DROPOUT_SHAPES:
            x = torch.randn(r, c, generator=gen, device="cuda").to(dtype)
            alone = kernel_ms(lambda: FusedDropout.apply(x, seed, DROP))
            lib_alone = kernel_ms(lambda: F.dropout(x, DROP, training=True))
            key = (dtype, (r, c))
            timed[("fused_dropout_kernel",) + key] = alone
            libs[("fused_dropout_kernel",) + key] = lib_alone
            bound = bounds[("fused_dropout",) + key][0]
            print(f"  K5 {str(dtype)[6:]:8s} [{r}, {c}]: kernel alone {alone:.4f} ms "
                  f"({2 * nbytes(x) / alone / 1e6:.0f} GB/s, {bound / alone:.3f} of the bytes bound "
                  f"{bound:.4f}), events {timed[('fused_dropout',) + key][0]:.4f}; F.dropout kernel "
                  f"alone {lib_alone:.4f} ({alone / lib_alone:.2f}x), events "
                  f"{libs[('fused_dropout',) + key]:.4f}; host "
                  f"{timed[('fused_dropout_host_us',) + key]:.1f} us a call; gpu: {smi}")
            del x


def k1_rows(gen, seed, timed, libs, bounds, smi):
    """K1's row at each SHAPES case, bf16: its event times (phase 6), its
    kernel time alone, SDPA's (flash) and both bounds, the tensor cores' (or
    bytes') and the Philox calls' of its dropout."""
    from orbit2_tpu_torch.ops.flash_attention import flash_attention_fwd

    for shape in SHAPES:
        b, n_q, n_k, h, d = shape
        q, k, v = make_qkv(*shape, torch.bfloat16, gen)
        ms = {rate: (timed[("fwd", torch.bfloat16, shape, rate)][0],
                     kernel_ms(lambda: flash_attention_fwd(q, k, v, None, rate, seed)))
              for rate in (0.0, DROP)}
        print(f"  K1 bf16 B{b} Nq{n_q} Nk{n_k} H{h} d{d}: fwd {ms[0.0][0]:.4f} ms (kernel alone "
              f"{ms[0.0][1]:.4f}), drop {ms[DROP][0]:.4f} ms (kernel alone {ms[DROP][1]:.4f}); "
              f"SDPA (flash) {libs[('fwd', shape, 0.0)]:.4f} / {libs[('fwd', shape, DROP)]:.4f}; "
              f"bounds: tensor cores and bytes {bounds[('fwd', shape)][0]:.4f} "
              f"({bounds[('fwd', shape)][1]}), Philox integer {bounds[('philox_fwd', shape)]:.4f} "
              f"({b * h * n_q * n_k / ELEMENTS_PER_CALL / 1e6:.1f} M calls); gpu: {smi}")


def bwd_rows(gen, seed, timed, libs, bounds, smi):
    """K2's and K3's rows at each SHAPES case, bf16, on contiguous (aligned)
    operands, so that no copy kernel runs: the event times (phase 6), each
    kernel's time alone with and without dropout, SDPA's whole backward (flash,
    dropout DROP) and the bounds, the tensor cores' (or bytes') and with
    dropout the Philox calls'."""
    from orbit2_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, attention_delta, flash_attention_fwd)

    for shape in SHAPES:
        b, n_q, n_k, h, d = shape
        q, k, v = make_qkv(*shape, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        alone = {}
        for rate in (0.0, DROP):
            o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
            delta = attention_delta(o, do)
            for name, kern in (("dq", FLASH_BWD_DQ), ("dkv", FLASH_BWD_DKV)):
                alone[(name, rate)] = kernel_ms(
                    lambda: kern(q, k, v, do, lse, delta, d ** -0.5, rate, seed))
        ev = {name: timed[(name, torch.bfloat16, shape, DROP)][0] for name in ("dq", "dkv")}
        both = alone[("dq", DROP)] + alone[("dkv", DROP)]
        print(f"  K2/K3 bf16 B{b} Nq{n_q} Nk{n_k} H{h} d{d}: kernel alone dq "
              f"{alone[('dq', 0.0)]:.4f} / drop {alone[('dq', DROP)]:.4f} ms, dk/dv "
              f"{alone[('dkv', 0.0)]:.4f} / drop {alone[('dkv', DROP)]:.4f} ms, with dropout "
              f"together {both:.4f} ms (events dq {ev['dq']:.4f}, dk/dv {ev['dkv']:.4f}); SDPA "
              f"(flash) whole backward, drop {libs[('bwd', shape)]:.4f} ms "
              f"({both / libs[('bwd', shape)]:.2f}x); bounds: tensor cores and bytes dq "
              f"{bounds[('dq', shape)][0]:.4f} ({bounds[('dq', shape)][1]}), dk/dv "
              f"{bounds[('dkv', shape)][0]:.4f} ({bounds[('dkv', shape)][1]}), Philox integer "
              f"dq {bounds[('philox_dq', shape)]:.4f}, dk/dv {bounds[('philox_dkv', shape)]:.4f}; "
              f"gpu: {smi}")
        del q, k, v, do
        torch.cuda.empty_cache()


def mlp_part(name):
    """(label, useful products) of a fused-MLP kernel by its profiler name:
    csrc/fused_mlp_hopper.cuh's F1 and F2 (mlp_gemm_tma_wgmma<false, BN, 1 or
    2, ..>), dx (<false, BN, 0, ..>), dW1 and dW2 (<true, ..>), stage H (h_pre
    and dh), db2's partials (none)."""
    import re

    gemm = re.search(r"mlp_gemm_tma_wgmma<(true|false), (\d+), (\d)", name)
    if gemm:
        if gemm[1] == "true":
            return "dW (dW1, dW2)", 2
        return {"0": "dx", "1": "F1", "2": "F2"}[gemm[3]], 1
    if "mlp_hidden" in name:
        return "stage H", 2
    return name.split("(")[0], 0


def mlp_rows(gen, timed, libs, bounds, smi):
    """The fused MLP's rows at the two 117M shapes, bf16, dropout 0, each by
    the kernel time of every kernel one call launches, beside their event
    times (phase 6) and bounds: the forward (F1 and F2) and the unfused
    chain's forward (F.linear, GELU, F.linear); K6b alone (stage H and dx),
    K6c alone (stage H, db2's partials, dW1 and dW2), the whole backward
    (fused_mlp_bwd: stage H once) and the unfused chain's backward
    (autograd of the chain)."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.fused_mlp import (
        FUSED_MLP_DW, FUSED_MLP_DX, fused_mlp_bwd, fused_mlp_fwd)

    for shape in MLP_SHAPES[:2]:
        t, d, f, d2 = shape
        args = mlp_inputs(shape, torch.bfloat16, gen)
        do = torch.randn(t, d2, generator=gen, device="cuda").to(torch.bfloat16)
        leaves = [a.detach().requires_grad_() for a in args]
        out_chain = F.linear(F.gelu(F.linear(leaves[0], leaves[1], leaves[2])), leaves[3], leaves[4])
        fparts, parts = {}, {}
        with torch.no_grad():
            alone = {
                "mlp_fwd": kernel_ms(lambda: fused_mlp_fwd(*args), by_name=fparts),
                "fwd_chain": kernel_ms(lambda: F.linear(F.gelu(F.linear(*args[:3])), *args[3:])),
            }
        alone.update({
            "mlp_dx": kernel_ms(lambda: FUSED_MLP_DX(*args[:4], do, 0.0, 0, 0)),
            "mlp_dw": kernel_ms(lambda: FUSED_MLP_DW(*args[:4], do, 0.0, 0, 0)),
            "mlp_bwd": kernel_ms(lambda: fused_mlp_bwd(*args[:4], do), by_name=parts),
            "chain": kernel_ms(lambda: torch.autograd.grad(out_chain, leaves, do,
                                                           retain_graph=True)),
        })
        for name in ("mlp_fwd", "mlp_dx", "mlp_dw", "mlp_bwd"):
            timed[(name + "_kernel", shape)] = alone[name]
        libs[("mlp_fwd_chain_kernel", shape)] = alone["fwd_chain"]
        libs[("mlp_bwd_chain_kernel", shape)] = alone["chain"]
        b = {name: bounds[(name, shape)][0]
             for name in ("mlp_fwd", "mlp_f1", "mlp_f2", "mlp_dx", "mlp_dw", "mlp_bwd")}
        product = 2 * t * d * f  # one product (D = D2 here)
        print(f"  K6a forward bf16 [{t}, {d} -> {f} -> {d2}], kernel time: "
              f"{alone['mlp_fwd']:.4f} ms (bound {b['mlp_fwd']:.4f}, {b['mlp_fwd'] / alone['mlp_fwd']:.3f}"
              f" of it; events {timed[('mlp_fwd', shape)][0]:.4f}); unfused chain's forward "
              f"{alone['fwd_chain']:.4f} ms (events {libs[('mlp_fwd_chain', shape)]:.4f}; forward / "
              f"chain {alone['mlp_fwd'] / alone['fwd_chain']:.3f}); gpu: {smi}")
        for name, ms in sorted(fparts.items(), key=lambda kv: -kv[1]):
            label, products = mlp_part(name)
            bound = {"F1": b["mlp_f1"], "F2": b["mlp_f2"]}.get(label)
            extra = (f", {products * product / ms / 1e9:.1f} TFLOP/s of its product, bound "
                     f"{bound:.4f} ({bound / ms:.3f} of it)") if bound and d == d2 else ""
            print(f"    {label}: {ms:.4f} ms{extra}")
            if label in ("F1", "F2"):
                timed[("mlp_" + label.lower() + "_kernel", shape)] = ms
        print(f"  K6 backward bf16 [{t}, {d} -> {f} -> {d2}], kernel time: dx (K6b alone) "
              f"{alone['mlp_dx']:.4f} ms (bound {b['mlp_dx']:.4f}, events "
              f"{timed[('mlp_dx', shape)][0]:.4f}), dW (K6c alone) {alone['mlp_dw']:.4f} ms (bound "
              f"{b['mlp_dw']:.4f}, events {timed[('mlp_dw', shape)][0]:.4f}), backward "
              f"{alone['mlp_bwd']:.4f} ms (bound {b['mlp_bwd']:.4f}, {b['mlp_bwd'] / alone['mlp_bwd']:.3f}"
              f" of it; events {timed[('mlp_bwd', shape)][0]:.4f}); unfused chain's backward "
              f"{alone['chain']:.4f} ms (events {libs[('mlp_bwd_chain', shape)]:.4f}; backward / chain "
              f"{alone['mlp_bwd'] / alone['chain']:.3f}); gpu: {smi}")
        for name, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
            label, products = mlp_part(name)
            rate = f", {products * product / ms / 1e9:.1f} TFLOP/s of its {products} products" \
                if products and d == d2 else ""
            print(f"    {label}: {ms:.4f} ms{rate}")
        del args, do, leaves, out_chain
        torch.cuda.empty_cache()


def serving_rows(step, fused_step, x, y, ms_off, ms_fused, smi):
    """The serving eval step without and with use_fused by the kernel time of
    every kernel one step launches, beside its events (phase 6): the share
    of the step the device is busy."""
    k_off, k_fused = kernel_ms(lambda: step(x, y)), kernel_ms(lambda: fused_step(x, y))
    print(f"  serving eval step, batch {x.shape[0]}, kernel time: use_fused {k_fused:.4f} ms, "
          f"off {k_off:.4f} ms (events {ms_fused:.3f} / {ms_off:.3f}, so the device is busy "
          f"{k_fused / ms_fused:.3f} / {k_off / ms_off:.3f} of the step); gpu: {smi}")


def cuda_kernel_names(fn):
    """Names of the CUDA kernels one call of fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def probe_cases(q, k, v):
    """(name, kernel call, plain call) of each probe on q, k, v [BH, N, 64],
    the bound shift on bound_shift_inputs(q, k)."""
    from orbit2_tpu_torch.ops import attn_probes as ap

    qs, bound = ap.bound_shift_inputs(q, k)
    return [("probe_matmul_only", lambda: ap.matmul_only(q, k, v),
             lambda: ap.matmul_only_reference(q, k, v)),
            ("probe_exp_noreduce", lambda: ap.exp_noreduce(q, k, v),
             lambda: ap.exp_noreduce_reference(q, k, v)),
            ("probe_full_softmax", lambda: ap.full_softmax(q, k, v),
             lambda: ap.full_softmax_reference(q, k, v)),
            ("probe_bound_shift", lambda: ap.bound_shift(qs, k, v, bound),
             lambda: ap.bound_shift_reference(qs, k, v, bound))]


def check_probes(gen, errs):
    """Each probe against its plain version at PROBE_SHAPES, the bound shift
    also against the fp32 softmax; one launch a call. The tolerance must fail
    the plain version run without the last kv tile."""
    from orbit2_tpu_torch.ops.attn_probes import BLOCK, HEAD_DIM, softmax_attention

    reset_counts()
    for bh, n in PROBE_SHAPES:
        q, k, v = (torch.randn(bh, n, HEAD_DIM, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cut = probe_cases(q, k[:, :-BLOCK], v[:, :-BLOCK])
        line = []
        for (name, kernel, plain), (_, _, plain_cut) in zip(probe_cases(q, k, v), cut):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs[(name, (bh, n))] = close(got, want, PROBE_REL, f"{name} BH{bh} N{n}", rows=True)
            missed = beyond(plain_cut(), want, PROBE_REL, rows=True)[0]
            check(missed > 0, f"{name} BH{bh} N{n}: the tolerance passes the plain version "
                  "without the last kv tile")
            line.append(f"{name[6:]} {errs[(name, (bh, n))]:.3e} (max|o| "
                        f"{want.float().abs().max().item():.3e}; last kv tile dropped: "
                        f"{missed} beyond)")
        soft = (got.float() - softmax_attention(q, k, v)).abs().max().item()
        print(f"  probes BH{bh} N{n} d{HEAD_DIM} bf16 vs plain, max abs err: " + "; ".join(line)
              + f" (atol {PROBE_REL:g} x max|o| of the row, rtol {PROBE_REL:g}); bound_shift "
              f"vs fp32 softmax {soft:.3e} (atol {PROBE_SOFTMAX_ATOL:g})")
        check(soft <= PROBE_SOFTMAX_ATOL, f"bound shift vs softmax {soft} at BH{bh} N{n}")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    want = only(**{name: len(PROBE_SHAPES) for name in kernels() if name.startswith("probe_")})
    check(counts() == want, f"probe checks launched {counts()}, want {want}")


def run_probe_path():
    """The probe path: `python -m orbit2_tpu_torch.scripts.bench_attn2`'s run
    at its shape, the counts reset just before and read just after. Returns
    (its result, the counts)."""
    from orbit2_tpu_torch.scripts import bench_attn2 as cli

    reset_counts()
    res = cli.run(cli.B, cli.N, cli.H, cli.D, "cuda")
    torch.cuda.synchronize()
    launched = counts()
    # each timed variant; the bound shift twice, plus its checked output
    per = cli.ITERS + cli.WARMUP
    want = only(probe_matmul_only=per, probe_exp_noreduce=per, probe_full_softmax=per,
                probe_bound_shift=2 * per + 1, flash_attn_fwd=per)
    print(f"  probe path (bench_attn2.run, B{cli.B} N{cli.N} H{cli.H} d{cli.D}): launches "
          f"{launched}")
    for variant, ms in res["times"]:
        print(f"    {variant:32s} {ms:8.4f} ms {res['flops'] / ms / 1e9:6.1f} TFLOP/s")
    print(f"    bound shift max abs err vs fp32 softmax {res['bound_shift_err']:.3e} "
          f"(atol {PROBE_SOFTMAX_ATOL:g})")
    check(launched == want, f"probe path launched {launched}, want {want}")
    check(all(ms > 0 for _, ms in res["times"]), "a probe path time is not positive")
    check(res["bound_shift_err"] <= PROBE_SOFTMAX_ATOL, "probe path bound shift vs softmax")
    return res, launched


def time_probes(res, smi):
    """Each probe against its plain version (in turns) and against the one
    PyTorch call that computes its function (SDPA, flash backend) or, for the
    first two, their bmm pair, at the probe path's shape, with its bound; then
    the decomposition of the flash forward from the probe path's times."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.attn_probes import EXP_SHIFT, bound_shift_inputs
    from orbit2_tpu_torch.ops.flash_attention import flash_attention_fwd
    from orbit2_tpu_torch.scripts import bench_attn2 as cli

    b, n, h, d = cli.B, cli.N, cli.H, cli.D
    q, k, v = cli.make_inputs(b, n, h, d, "cuda")
    flops = res["flops"]
    moved = nbytes(q, k, v, q)  # q, k, v read; o written
    bound = roofline(flops, moved)
    sdpa = lambda scale=None: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                              scale=scale)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        sdpa_t = best_ms(sdpa)
        sdpa_ln2_t = best_ms(lambda: sdpa(math.log(2.0)))
        names = cuda_kernel_names(sdpa)
    scores = lambda: torch.bmm(q, k.transpose(1, 2))  # bf16 out: s rounded as in the probe
    library = {"probe_matmul_only": (None, best_ms(lambda: torch.bmm(scores(), v))),
               "probe_exp_noreduce": (None, best_ms(
                   lambda: torch.bmm(torch.exp2(scores() - EXP_SHIFT), v))),
               "probe_full_softmax": (sdpa_ln2_t, None),
               "probe_bound_shift": (sdpa_t, None)}
    timed = {}
    for name, kernel, plain in probe_cases(q, k, v):
        before = counts()[name]
        ms = paired_ms(kernel, plain)
        check(counts()[name] > before, f"timing did not launch {name}")
        extra = 4 * q.shape[0] * n if name == "probe_bound_shift" else 0  # the fp32 bound
        lib, chain = library[name]
        timed[name] = (ms, roofline(flops, moved + extra), lib, chain)
        print(f"  {name} bf16 BH{q.shape[0]} N{n} d{d}: {ms[0]:.4f} ms "
              f"({flops / ms[0] / 1e9:.1f} TFLOP/s) plain {ms[1]:.4f}; "
              + (f"SDPA (flash) {lib:.4f}" if lib is not None else f"bmm chain {chain:.4f}")
              + f"; bound {timed[name][1][0]:.4f} ms ({timed[name][1][1]})")
    q4, k4, v4 = (t.view(b, h, n, d).transpose(1, 2) for t in (q, k, v))
    k1_drop = cuda_ms(lambda: flash_attention_fwd(q4, k4, v4, None, DROP, 7))
    rows = res["times"] + [("flash forward (K1), dropout 0.1", k1_drop),
                           ("SDPA, flash backend", sdpa_t)]
    print(f"  decomposition of the flash forward at (B{b}, N{n}, H{h}, d{d}) bf16, "
          f"{flops / 1e9:.1f} GFLOP; bound {bound[0]:.4f} ms ({bound[1]}: "
          f"{flops / 1e9:.1f} GFLOP at {PEAK_FLOPS / 1e12:g} TFLOP/s, {moved / 1e6:.1f} MB at "
          f"{PEAK_BYTES_PER_S / 1e12:g} TB/s); {b * h * n * n / 1e6:.0f} M exp2 a softmax; "
          f"gpu: {smi}")
    print(f"    {'variant':34s} {'ms':>8s} {'TFLOP/s':>8s} {'bound/ms':>8s}")
    for variant, ms in rows:
        print(f"    {variant:34s} {ms:8.4f} {flops / ms / 1e9:8.1f} {bound[0] / ms:8.3f}")
    print(f"    SDPA backend FLASH_ATTENTION (pinned by sdpa_kernel); its kernels: {names}; "
          f"with scale ln 2 (probe_full_softmax's function) {sdpa_ln2_t:.4f} ms")
    return timed


def check_int8_product(seed):
    """torch._int_mm on the card against the CPU at [4096, 3072] x [3072,
    9216], the 1B qkv product's K and N, and at INT8_UNALIGNED: the int32
    accumulators equal; the weight and row quantizations on the card equal
    the CPU's (the w8a8 twin quantizes its weights on the card);
    w8a8_matmul's bf16 output within 1 bf16 ulp of the CPU's. Returns the
    largest ulp distance."""
    from orbit2_tpu_torch.ops.quant import (
        int8_matmul, quantize_rows, quantize_weight, w8a8_matmul)

    gen = torch.Generator().manual_seed(seed)
    for m, k, n in (INT8_CHECK,) + INT8_UNALIGNED:
        xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
        acc = int8_matmul(xq.cuda(), wq.cuda()).cpu()
        check(acc.shape == (m, n) and torch.equal(acc, int8_matmul(xq, wq)),
              f"the int8 product [{m}, {k}] x [{k}, {n}] on the card differs from the CPU's")
    print(f"  int8 products {[INT8_CHECK, *INT8_UNALIGNED]} ([M, K, N]): the card's int32 "
          f"accumulators equal the CPU's")
    m, k, n = INT8_CHECK
    x = torch.randn(m, k, generator=gen).bfloat16()
    w = torch.randn(n, k, generator=gen) * k ** -0.5
    wq, ws = quantize_weight(w)
    b = torch.randn(n, generator=gen) * 0.1
    for name, fn, arg in (("weight", quantize_weight, w), ("row", quantize_rows, x)):
        same = all(torch.equal(a.cpu(), c) for a, c in zip(fn(arg.cuda()), fn(arg)))
        check(same, f"the {name} quantization on the card differs from the CPU's")
    got = w8a8_matmul(x.cuda(), wq.cuda(), ws.cuda(), b.cuda()).cpu()
    ulps = bf16_ulps(got, w8a8_matmul(x, wq, ws, b)).max().item()
    print(f"  int8 product [{m}, {k}] x [{k}, {n}]: int32 accumulators, int8 weights, rows and "
          f"their scales on the card equal the CPU's; w8a8_matmul bf16 output within {ulps} "
          f"bf16 ulp of the CPU's (bound 1)")
    check(ulps <= 1, f"w8a8_matmul on the card is {ulps} bf16 ulps from the CPU")
    return ulps


@contextlib.contextmanager
def trunk_outputs(model):
    """Collects, in fp32, the trunk's output (its final norm's) of every
    forward of `model` inside the block."""
    got = []
    handle = model.norm.register_forward_hook(lambda mod, args, out: got.append(out.float()))
    try:
        yield got
    finally:
        handle.remove()


def rel_frob(got, want):
    return ((got - want).norm() / want.norm()).item()


def stitch_field(model, x_full, div, overlap, mag, in_vars, out_vars):
    """stitched_inference of one field [C, H, W] through `model`, one tile at
    a time: (field [C_out, H mag, W mag], wall seconds). Each tile's core in
    the field must be that tile's own prediction: its block of the div x div
    grid less the halo widths on the sides it shares with a neighbour, which
    neighbours' halos may overwrite."""
    from orbit2_tpu_torch.data.reader import halo_lrtb, tile_slices
    from orbit2_tpu_torch.utils.visualize import model_forward_fn, stitched_inference

    fwd = model_forward_fn(model, in_vars, out_vars)
    preds = []

    def recorded(tile):
        preds.append(fwd(tile))
        return preds[-1]

    t0 = time.perf_counter()
    out = stitched_inference(recorded, x_full, div, overlap, mag)
    seconds = time.perf_counter() - t0
    left, right, top, bottom = halo_lrtb(overlap)
    _, h, w = x_full.shape
    bh, bw = h * mag // div, w * mag // div
    hy, hx = (top + bottom) * mag, (left + right) * mag
    for t, pred in zip(tile_slices(div, overlap, h, w, h * mag, w * mag), preds):
        y0 = t.vindex * bh + (t.vindex > 0) * hy
        y1 = (t.vindex + 1) * bh - (t.vindex < div - 1) * hy
        x0 = t.hindex * bw + (t.hindex > 0) * hx
        x1 = (t.hindex + 1) * bw - (t.hindex < div - 1) * hx
        core = pred[0, :, y0 - t.yo[0]:y1 - t.yo[0], x0 - t.xo[0]:x1 - t.xo[0]]
        check(core.size > 0 and np.array_equal(out[:, y0:y1, x0:x1], core),
              f"the stitched field's core of tile ({t.vindex}, {t.hindex}) is not its prediction")
    check(len(preds) == div * div, f"{len(preds)} tiles stitched")
    return out, seconds


def serve1b(cfg, seed):
    """Phase serve1b: the tiled 1B serving path. Its kernels at its own
    shapes against their plain versions (K1 at the batch's and a stitched
    tile's shape, and with the ensemble's dropout; K5 at the ensemble's
    [rows, cols]); Evaluator.test in bf16 and with w8a8 (exact K1 launches,
    finite metrics, the prediction and the trunk's output against the plain
    attention and the w8a8 ones against bf16, the fp model restored), the
    int8 product against the CPU, stitched inference of field 0 (bf16, w8a8,
    plain attention; exact K1 launches; the tiles' trunk outputs as the
    batch's), and an MC-dropout ensemble (K1 with dropout and K5, exact
    launches; seeded). Returns what phase 6 times."""
    from orbit2_tpu_torch.evaluate import Evaluator, make_data_module
    from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions

    m = cfg.model
    div, overlap, mag = cfg.tiling.effective_div, cfg.tiling.effective_overlap, m.superres_mag
    tt = time.perf_counter()
    ev = Evaluator(cfg, "cuda")
    build_s = time.perf_counter() - tt
    dm = ev.data_module
    in_vars, out_vars = dm.get_data_variables()
    in_shape, out_shape = dm.get_data_dims()
    tokens = (in_shape[2] // m.patch_size) * (in_shape[3] // m.patch_size)
    n_params = sum(t.numel() for t in ev.model.parameters())
    print(f"  config {CONFIG_1B.name}: embed {m.embed_dim} depth {m.depth} heads {m.num_heads} "
          f"(d {m.embed_dim // m.num_heads}) decoder {m.decoder_depth} mlp_ratio {m.mlp_ratio} "
          f"gelu {m.gelu_approx} {cfg.trainer.data_type}, {n_params / 1e9:.3f} B parameters drawn "
          f"from trainer.seed on the card in {build_s:.1f} s; tiling div {div} overlap "
          f"{overlap}: tiles {tuple(in_shape[2:])} -> {tuple(out_shape[2:])}, {tokens} tokens, "
          f"batch {in_shape[0]} tiles")
    # the path's kernels at its shapes: K1 on a batch and on one stitched
    # tile, and with the ensemble's dropout; K5 at the ensemble's pos_drop /
    # proj / fc2 and fc1 widths
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 40 + seed
    h, d = m.num_heads, m.embed_dim // m.num_heads
    for b, rate in ((in_shape[0], 0.0), (in_shape[0], m.drop_rate), (1, 0.0)):
        q, k, v = make_qkv(b, tokens, tokens, h, d, torch.bfloat16, gen)
        check_forward(q, k, v, rate, kseed, f"bf16 drop {rate:g} B{b} N{tokens} H{h} d{d}")
        del q, k, v
    for c in (m.embed_dim, int(m.embed_dim * m.mlp_ratio)):
        check_dropout(in_shape[0] * tokens, c, torch.bfloat16, m.drop_rate, gen, kseed)
    torch.cuda.empty_cache()

    batches = BATCHES_1B
    want_k1 = only(flash_attn_fwd=m.depth * batches)

    def serve(quant):
        reset_counts()
        t0 = time.perf_counter()
        metrics = ev.test(max_batches=batches, quant=quant)
        torch.cuda.synchronize()
        seconds, launched = time.perf_counter() - t0, counts()
        print(f"  test(max_batches={batches}, quant={quant!r}) {seconds:.3f} s; launches {launched}")
        check(len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values()),
              f"{quant} tiled metrics missing or not finite")
        check(launched == want_k1, f"{quant} tiled serving launches {launched}, want "
              f"flash_attn_fwd = depth x batches = {m.depth * batches} and nothing else")
        return metrics, seconds

    metrics, test_s = serve("none")
    for key, val in metrics.items():
        print(f"    {key} {val:.6f}")

    # the host's share of test(): the loader alone over the same batches
    loader = iter(dm.test_dataloader())
    t0 = time.perf_counter()
    batch = next(loader)
    for _ in range(batches - 1):
        next(loader)
    data_s = (time.perf_counter() - t0) / batches
    loader.close()
    print(f"  the test loader alone: {data_s:.3f} s a batch of {in_shape[0]} tiles "
          f"(test() {test_s / batches:.3f} s a batch)")
    x = torch.from_numpy(batch[0]).cuda()
    y = torch.from_numpy(batch[1]).cuda()
    with torch.no_grad(), trunk_outputs(ev.model) as trunks:
        pred = ev.model(x, in_vars, out_vars).float()
        set_attention_impl(ev.model, "xla")
        pred_plain = ev.model(x, in_vars, out_vars).float()
        set_attention_impl(ev.model, m.attention_impl)
        torch.cuda.synchronize()
    trunk, trunk_plain = trunks
    want_shape = (x.shape[0], len(out_vars)) + tuple(out_shape[2:])
    check(tuple(pred.shape) == want_shape and bool(pred.isfinite().all()),
          f"bad 1B prediction {tuple(pred.shape)}, want {want_shape}")
    rel_plain = rel_frob(trunk, trunk_plain)
    print(f"  bf16 prediction of one batch, kernel vs plain attention: max|d| "
          f"{(pred - pred_plain).abs().max().item():.3e} (max|pred| "
          f"{pred_plain.abs().max().item():.3e}; atol=rtol={PRED_BF16_TOL:g}); the trunk's "
          f"output: relative Frobenius error {rel_plain:.4e} (bound {TRUNK_BF16_REL:g})")
    torch.testing.assert_close(pred, pred_plain, atol=PRED_BF16_TOL, rtol=PRED_BF16_TOL)
    check(rel_plain <= TRUNK_BF16_REL, f"the 1B trunk on the kernels is {rel_plain} off the "
          f"same trunk on the plain attention")
    del pred_plain, trunk_plain, trunks

    metrics_q, test_q_s = serve("w8a8")
    qmodel = ev.serving_model("w8a8")
    with torch.no_grad(), trunk_outputs(qmodel) as trunks:
        pred_q = qmodel(x, in_vars, out_vars).float()
    rel = rel_frob(pred_q, pred)
    rel_trunk = rel_frob(trunks[0], trunk)
    del trunk, trunks
    print(f"  w8a8 prediction of the same batch against bf16: relative Frobenius error "
          f"{rel:.4e} (bound {W8A8_REL:g}), of the trunk's output alone {rel_trunk:.4e}; "
          f"metrics " + ", ".join(
              f"{k.split('/')[1]} {metrics_q[k]:.6f} (bf16 {metrics[k]:.6f})"
              for k in metrics if k.endswith("aggregate")))
    check(0.0 < rel <= W8A8_REL and 0.0 < rel_trunk <= W8A8_REL
          and bool(pred_q.isfinite().all()),
          f"w8a8 prediction off the bf16 one by {rel}, its trunk's output by {rel_trunk}")
    again, _ = serve("none")
    check(again == metrics, f"bf16 metrics after w8a8 serving changed: {again} vs {metrics}")
    print("  bf16 test() after the w8a8 one reproduces the first one's metrics exactly")
    del pred, pred_q
    check_int8_product(seed)

    dm_vis = make_data_module(cfg, ev.data_key, 1, 0, "test")
    sample, _, names, _ = next(iter(dm_vis.data_test))
    x_full = np.stack([sample[k] for k in names])
    stitched, tile_trunks = {}, {}
    for label, model in (("bf16", ev.model), ("w8a8", qmodel), ("plain", ev.model)):
        if label == "plain":
            set_attention_impl(ev.model, "xla")
        reset_counts()
        with trunk_outputs(model) as trunks:
            out, seconds = stitch_field(model, x_full, div, overlap, mag, in_vars, out_vars)
        launched = counts()
        tile_trunks[label] = torch.cat(trunks)
        set_attention_impl(ev.model, m.attention_impl)
        want = (len(out_vars), x_full.shape[1] * mag, x_full.shape[2] * mag)
        print(f"  stitched field 0, {label}: {x_full.shape} -> {out.shape} from {div * div} tiles "
              f"in {seconds:.3f} s; launches {launched}")
        check(out.shape == want and bool(np.isfinite(out).all()),
              f"{label} stitched field {out.shape}, want {want}, or not finite")
        k1 = 0 if label == "plain" else m.depth * div * div
        check(launched == only(flash_attn_fwd=k1), f"{label} stitching launched {launched}")
        stitched[label] = (out, seconds)
    rel_stitch = (np.linalg.norm(stitched["w8a8"][0] - stitched["bf16"][0])
                  / np.linalg.norm(stitched["bf16"][0]))
    rel_tiles = rel_frob(tile_trunks["bf16"], tile_trunks["plain"])
    rel_tiles_q = rel_frob(tile_trunks["w8a8"], tile_trunks["bf16"])
    del tile_trunks
    print(f"  stitched bf16 vs plain attention: max|d| "
          f"{np.abs(stitched['bf16'][0] - stitched['plain'][0]).max():.3e} (atol=rtol="
          f"{PRED_BF16_TOL:g}), the tiles' trunk outputs' relative Frobenius error "
          f"{rel_tiles:.4e} (bound {TRUNK_BF16_REL:g}); w8a8 vs bf16: relative Frobenius error "
          f"{rel_stitch:.4e}, of the tiles' trunk outputs {rel_tiles_q:.4e} (bound {W8A8_REL:g})")
    torch.testing.assert_close(torch.from_numpy(stitched["bf16"][0]),
                               torch.from_numpy(stitched["plain"][0]),
                               atol=PRED_BF16_TOL, rtol=PRED_BF16_TOL)
    check(rel_tiles <= TRUNK_BF16_REL, f"the stitched tiles' trunk on the kernels is "
          f"{rel_tiles} off the same trunk on the plain attention")
    check(rel_stitch <= W8A8_REL and 0.0 < rel_tiles_q <= W8A8_REL,
          f"w8a8 stitched field off the bf16 one by {rel_stitch}, its tiles' trunk by {rel_tiles_q}")

    reset_counts()
    ens = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, MC_SAMPLES,
                                      torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    mc_counts = counts()
    again = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, MC_SAMPLES,
                                        torch.Generator().manual_seed(seed))
    spread = ens.float().std(dim=0).mean().item()
    print(f"  MC dropout, {MC_SAMPLES} samples of one batch at drop_rate {m.drop_rate}: "
          f"{tuple(ens.shape)}, mean member std {spread:.4e}; launches {mc_counts}")
    check(tuple(ens.shape) == (MC_SAMPLES,) + want_shape and bool(ens.isfinite().all()),
          f"bad MC ensemble {tuple(ens.shape)}")
    check(mc_counts == only(flash_attn_fwd=MC_SAMPLES * m.depth,
                            fused_dropout=MC_SAMPLES * (1 + 3 * m.depth)),
          f"MC dropout launches {mc_counts}, want flash_attn_fwd = samples x depth = "
          f"{MC_SAMPLES * m.depth} and fused_dropout = samples x (1 + 3 depth) = "
          f"{MC_SAMPLES * (1 + 3 * m.depth)}")
    check(all(not torch.equal(ens[i], ens[j])
              for i in range(MC_SAMPLES) for j in range(i + 1, MC_SAMPLES)),
          "two MC-dropout samples are equal")
    check(torch.equal(ens, again), "the same seed gave other MC-dropout samples")
    print("  MC-dropout samples differ pairwise; the same seed gives them bit for bit")
    del ens, again
    return {"ev": ev, "qmodel": qmodel, "x": x, "y": y, "in_vars": in_vars,
            "out_vars": out_vars, "x_full": x_full, "tokens": tokens, "test_s": test_s,
            "test_q_s": test_q_s, "data_s": data_s}


def remat_launches(depth, remat=True, moe_blocks=0):
    """Kernel launches of one train microbatch of the ResSlimViT with
    `moe_blocks` MoE Blocks: K1 once a Block, and again in each Block's
    recomputation under remat (both policies: the kernels are no products);
    K2 and K3 once a Block; K5 at pos_drop and three sites a dense Block,
    two an MoE Block (the attention's projection and the MoE output: the
    experts' hidden has no dropout), forward and backward, and again in the
    recomputation but for Block 0's last: its drop-path rate is 0, so nothing
    after it is saved and the recomputation stops there
    (torch.utils.checkpoint's early stop; tests/test_torch_remat.py,
    tests/test_torch_moe.py)."""
    again = int(remat)
    sites = 3 * depth - moe_blocks
    return dict(flash_attn_fwd=(1 + again) * depth, flash_attn_bwd_dq=depth,
                flash_attn_bwd_dkv=depth, fused_dropout=2 * (1 + sites) + again * (sites - 1))


def train_flops(model, tokens, b, n, h, d):
    """(model flops, hardware flops) of one train step over `tokens` tokens:
    6 x parameters x tokens, plus attention's two forward products and the
    backward's four (3 x attention_flops) a Block; the hardware's also count
    each Block's forward again (full remat: 2 x its parameters x tokens, K1
    again) and the backward kernels' recomputed scores (K2: 3 products, K3:
    4, so 3.5 x attention_flops against the model's 2)."""
    from orbit2_tpu_torch.ops.flash_attention import attention_flops

    params = sum(p.numel() for p in model.parameters())
    block_params = sum(p.numel() for p in model.blocks.parameters())
    depth = len(model.blocks)
    att = attention_flops(b, n, n, h, d)
    model_flops = 6 * params * tokens + 3 * depth * att
    hardware = 6 * params * tokens + 2 * block_params * tokens + depth * (1 + 1 + 3.5) * att
    return model_flops, hardware


def train1b(s1b, root, seed):
    """Phase train1b: Trainer.fit on configs/interm_1b.yaml at full width on
    the config's TILES tiles, batch 32, full remat, from serve1b's weights
    (fp32 masters of them: nothing drawn again). Exact launch counts, finite
    losses, moved parameters; one step at MICRO_1B tiles with remat full,
    dots and none under torch.use_deterministic_algorithms, bit for bit
    (losses, every gradient, the generators); K1, K2 and K3 at the path's
    shape against their plain versions (the fit's microbatch on two of its
    batch elements, and MICRO_1B whole); the step time by events, its
    kernel time by kind, peak memory and MFU. Returns what phase 6 times."""
    import types

    from orbit2_tpu_torch.training.train import make_train_step
    from orbit2_tpu_torch.training.trainer import Trainer

    ev = s1b["ev"]
    cfg = config_1b(root, seed, trainer={"batch_size": BATCH_TRAIN_1B,
                                         "grad_accum": GRAD_ACCUM_1B},
                    n_files=FIELDS_TRAIN_1B, t=1, shards=("train",))
    m, tc = cfg.model, cfg.trainer
    depth, h, d = m.depth, m.num_heads, m.embed_dim // m.num_heads
    micro = tc.batch_size // tc.grad_accum
    print(f"  config {CONFIG_1B.name}: embed {m.embed_dim} depth {depth} heads {h} (d {d}) "
          f"gelu {m.gelu_approx}, {tc.data_type} compute, fp32 masters, adam mu "
          f"{tc.adam_mu_dtype} nu {tc.adam_nu_dtype}, drop_rate {m.drop_rate} drop_path "
          f"{m.drop_path}, remat {tc.remat} policy {tc.remat_policy}; batch {tc.batch_size} tiles "
          f"in grad_accum {tc.grad_accum} microbatches of {micro}; 2 epochs x {TRAIN_STEPS_1B} "
          f"steps on a synthetic train split of {FIELDS_TRAIN_1B} fields")
    check(tc.remat and tc.remat_policy == "full" and cfg.tiling.effective_div == 4,
          "interm_1b.yaml no longer trains with full remat on div 4 tiles")
    steps = 2 * TRAIN_STEPS_1B
    init = ev.model.state_dict()  # serve1b's bf16 weights, on the card
    reset_counts()
    tt = time.perf_counter()
    trainer = Trainer(cfg, "cuda", state_dict=init)
    history = trainer.fit(max_epochs=2, max_steps_per_epoch=TRAIN_STEPS_1B)
    torch.cuda.synchronize()
    fit_s, launched = time.perf_counter() - tt, counts()
    for rec in history:
        print(f"    {json.dumps(rec)}")
    want = only(**{k: v * steps * tc.grad_accum for k, v in remat_launches(depth).items()})
    print(f"  fit {fit_s:.3f} s (model build from the state dict included); launches {launched}")
    check(sum(r["batches"] for r in history) == steps, f"fit took {history}")
    check(all(np.isfinite(r["loss"]) for r in history), "a 1B train loss is not finite")
    check(launched == want, f"1B train launches {launched}, want {want}")
    model = trainer.model
    params = dict(model.named_parameters())
    fed = {k for k, p in params.items() if p.grad is not None}
    still = [k for k in fed if torch.equal(params[k].detach(), init[k].float())]
    print(f"  parameters moved: {len(fed) - len(still)} of the {len(fed)} the loss reaches "
          f"({len(params) - len(fed)} more are token embeddings of default variables the phase "
          f"does not feed: zero gradient), all fp32 masters "
          f"{all(p.dtype == torch.float32 for p in params.values())}")
    check(not still and all(p.dtype == torch.float32 for p in params.values()),
          f"1B parameters did not move or are not fp32 masters: {still}")
    del init

    tdm = trainer._data_modules[next(iter(cfg.data.low_res_dir))]
    in_vars, out_vars = tdm.get_data_variables()
    in_shape, _ = tdm.get_data_dims()
    tokens = (in_shape[2] // m.patch_size) * (in_shape[3] // m.patch_size)
    loader = iter(tdm.train_dataloader())
    batch = next(loader)
    loader.close()
    xb = torch.from_numpy(batch[0]).to(torch.bfloat16).cuda()
    yb = torch.from_numpy(batch[1]).to(torch.bfloat16).cuda()

    # remat full and dots against none, one microbatch, bit for bit
    no_update = types.SimpleNamespace(step=lambda: None)
    grad_step = make_train_step(model, trainer.train_loss, cfg.data.var_weights, no_update,
                                in_vars, out_vars)
    first = None
    torch.use_deterministic_algorithms(True)
    try:
        for remat, policy in ((True, "full"), (True, "dots"), (False, "full")):
            model.remat, model.remat_policy = remat, policy
            g1, g2 = gens(seed + 23)
            reset_counts()
            loss = grad_step(xb[:MICRO_1B], yb[:MICRO_1B], g1, g2)
            torch.cuda.synchronize()
            run = (loss, {k: p.grad for k, p in params.items() if p.grad is not None},
                   (g1.get_state(), g2.get_state()))
            label = policy if remat else "none"
            print(f"  deterministic step at {MICRO_1B} tiles, remat {label}: loss "
                  f"{loss.item():.7f}; launches {counts()}")
            check(counts() == only(**remat_launches(depth, remat)),
                  f"remat {label} step launched {counts()}")
            if first is None:
                first = run
                continue
            same = (torch.equal(run[0], first[0]) and run[1].keys() == first[1].keys()
                    and all(torch.equal(run[1][k], first[1][k]) for k in first[1])
                    and all(torch.equal(a, b) for a, b in zip(run[2], first[2])))
            check(same, f"remat {label} differs from remat full: loss {run[0].item()!r} vs "
                  f"{first[0].item()!r}")
            del run
    finally:
        torch.use_deterministic_algorithms(False)
        model.remat, model.remat_policy = tc.remat, tc.remat_policy
    print(f"  remat full, dots and none: losses, all {len(first[1])} gradients and both "
          f"generators' states equal bit for bit")
    del first
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # the path's attention kernels at its own shape, with its dropout
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 41 + seed
    errs = {}
    for b in (micro, MICRO_1B):
        q, k, v = make_qkv(b, tokens, tokens, h, d, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        case = f"bf16 drop {m.drop_rate:g} B{b} N{tokens} H{h} d{d}"
        errs[b] = check_batch_rows(q, k, v, do, m.drop_rate, kseed, sorted({0, b - 1}), case)
        del q, k, v, do
        torch.cuda.empty_cache()
    for c in (m.embed_dim, int(m.embed_dim * m.mlp_ratio)):
        check_dropout(micro * tokens, c, torch.bfloat16, m.drop_rate, gen, kseed)
    torch.cuda.empty_cache()

    # the step's time, memory and MFU
    tstep = make_train_step(model, trainer.train_loss, cfg.data.var_weights, trainer.optimizer,
                            in_vars, out_vars, grad_accum=tc.grad_accum)
    g1, g2 = gens(seed + 29)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: tstep(xb, yb, g1, g2), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    by_name = {}
    kern = kernel_ms(lambda: tstep(xb, yb, g1, g2), iters=2, by_name=by_name)
    model_flops, hw_flops = train_flops(model, xb.shape[0] * tokens, xb.shape[0], tokens, h, d)
    out = {"batch_tiles": xb.shape[0], "tokens_per_tile": tokens, "grad_accum": tc.grad_accum,
           "remat": tc.remat_policy, "step_ms": ms, "kernel_ms": kern, "busy": kern / ms,
           "tiles_per_s": xb.shape[0] / ms * 1e3, "peak_gib": peak / 2 ** 30,
           "step_gib": (peak - base) / 2 ** 30, "model_tflop": model_flops / 1e12,
           "hardware_tflop": hw_flops / 1e12, "mfu": model_flops / (ms * 1e-3) / PEAK_FLOPS,
           "hfu": hw_flops / (ms * 1e-3) / PEAK_FLOPS, "fit_s": fit_s,
           "by_kind": step_kinds(by_name), "losses": [r["loss"] for r in history],
           "kernels": {name[:80]: t for name, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}}
    print(f"  1B train step, batch {xb.shape[0]} tiles of {tokens} tokens, grad_accum "
          f"{tc.grad_accum}, remat {tc.remat_policy}: {ms:.3f} ms by events (median of 5 after a "
          f"warm-up), {out['tiles_per_s']:.2f} tiles/s; kernel time {kern:.3f} ms (busy "
          f"{out['busy']:.3f}); peak memory {out['peak_gib']:.2f} GiB "
          f"({out['step_gib']:.2f} the step's own); model {out['model_tflop']:.1f} TFLOP a step "
          f"(6 x params x tokens + attention), MFU {out['mfu']:.4f}; hardware "
          f"{out['hardware_tflop']:.1f} TFLOP (with the recomputation), {out['hfu']:.4f} of "
          f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s")
    print("    by kind: " + ", ".join(f"{kind} {t:.3f} ms" for kind, t in out["by_kind"].items()))
    for name, t in out["kernels"].items():
        print(f"    {t:9.4f} ms  {name}")
    del trainer, model, params, tstep, grad_step, xb, yb
    torch.cuda.empty_cache()
    return {"out": out, "launched": launched, "errs": errs, "shape": (micro, tokens, h, d),
            "rate": m.drop_rate, "depth": depth,
            "width": (m.embed_dim, int(m.embed_dim * m.mlp_ratio)),
            "steps": steps * tc.grad_accum}


def flat_state(state):
    """A {"model", "optimizer"} state as ({"model/<name>" and
    "optimizer/<mu|nu>/<name>": tensor}, {"count", "lr"})."""
    opt = state["optimizer"]
    flat = {f"model/{k}": v for k, v in state["model"].items()}
    flat.update((f"optimizer/{m}/{k}", v) for m in ("mu", "nu") for k, v in opt[m].items())
    return flat, {"count": opt["count"], "lr": opt["lr"]}


def trainer_state(trainer):
    return flat_state({"model": trainer.model.state_dict(),
                       "optimizer": trainer.optimizer.state_dict()})


def same_state(saved, live, what):
    """Every tensor of the checkpoint `saved` equal bit for bit to `live`'s
    (on the card), and the scalars equal."""
    (got, got_scalars), (want, want_scalars) = saved, live
    check(got.keys() == want.keys(), f"{what}: keys differ: {sorted(got.keys() ^ want.keys())[:4]}")
    for k, v in want.items():
        g = got[k]
        check(g.dtype == v.dtype and g.shape == v.shape
              and torch.equal(g.to(v.device, non_blocking=True), v), f"{what}: {k} differs")
    check(got_scalars == want_scalars, f"{what}: {got_scalars} vs {want_scalars}")


def within_depth(key, depth):
    """Whether the state-dict key `key` belongs to a model cut to its first
    `depth` Blocks."""
    block = re.match(r"blocks\.(\d+)\.", key)
    return block is None or int(block.group(1)) < depth


def resume1b(s1b, root, seed):
    """Phase resume1b: checkpoints, resume, validation and fine-tuning of
    configs/interm_1b.yaml at full width on its tiles (batch 32, full remat,
    bf16 moments), from serve1b's weights. Trainer A fits 2 epochs with a
    checkpoint directory, keep_last_checkpoints 1 and validation after each
    epoch (timed, with its launches: K1 depth x val batches, nothing else);
    restore_checkpoint of its epoch_1 equals its state bit for bit; Trainer B
    resumes from the directory with async checkpoints and fits epochs 2 and 3
    (epoch 3's steps run while epoch_2 is written), and the epoch_2 on disk
    equals B's state at its save; two resumes from epoch_1 at MICRO_1B tiles
    under torch.use_deterministic_algorithms give the same losses bit for
    bit; orbit2_tpu_torch.finetune from epoch_1 on FT_DIV tiles resizes
    pos_embed. Exact launch counts over the phase; K1 at the fine-tune's
    shape against its plain version. Returns what phase 6 times."""
    import dataclasses
    import shutil

    import yaml

    from orbit2_tpu_torch import finetune
    from orbit2_tpu_torch.data.reader import tile_shapes
    from orbit2_tpu_torch.training import checkpoint as ck
    from orbit2_tpu_torch.training.train import make_eval_step
    from orbit2_tpu_torch.training.trainer import Trainer

    ev = s1b["ev"]
    cfg = config_1b(root, seed, trainer={"batch_size": BATCH_TRAIN_1B,
                                         "grad_accum": GRAD_ACCUM_1B},
                    n_files=1, t=FIELDS_RESUME_1B, shards=("train", "val"),
                    depth=RESUME_DEPTH_1B)
    m, tc = cfg.model, cfg.trainer
    depth, h, d = m.depth, m.num_heads, m.embed_dim // m.num_heads
    tiles = cfg.tiling.effective_div ** 2  # a field's
    val_batches = -(-FIELDS_RESUME_1B * tiles // BATCH_TRAIN_1B)
    n_params = sum(p.numel() for k, p in ev.model.named_parameters() if within_depth(k, depth))
    moment_bytes = sum(torch.finfo(getattr(torch, dt or "float32")).bits // 8
                       for dt in (tc.adam_mu_dtype, tc.adam_nu_dtype))
    reckoned = n_params * (4 + moment_bytes)
    ck_root = Path(tempfile.mkdtemp(prefix="checkpoints", dir=root))
    ck_dir, ft_dir = ck_root / "climate", ck_root / "finetune"
    free = shutil.disk_usage(ck_root).free
    # at most three checkpoints lie on the disk at once (B's epoch_1..epoch_3)
    print(f"  {n_params / 1e9:.4f} B parameters: a checkpoint is reckoned at {reckoned / 1e9:.3f} "
          f"GB (fp32 masters, mu {tc.adam_mu_dtype}, nu {tc.adam_nu_dtype}); {free / 1e9:.1f} GB "
          f"free under {ck_root}")
    check(free > 3.2 * reckoned, f"{free / 1e9:.1f} GB free on the disk, the phase needs "
                                 f"{3.2 * reckoned / 1e9:.1f} (three checkpoints)")
    writes, epochs, saves, validations = [], [], [], []
    write = ck._write

    def timed_write(path, state):
        t0 = time.perf_counter()
        write(path, state)
        writes.append((os.path.basename(path), t0, time.perf_counter()))

    def instrument(trainer):
        save, validate, epoch = trainer._save, trainer.validate, trainer._epoch

        def timed_save(e):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(e)
            saves.append((e, time.perf_counter() - t0))

        def timed_validate(*a):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            out = validate(*a)
            torch.cuda.synchronize()
            validations.append((time.perf_counter() - t0,
                                {k: v - before[k] for k, v in counts().items()}))
            return out

        def timed_epoch(e, *a):
            t0 = time.perf_counter()
            out = epoch(e, *a)
            epochs.append((e, t0, time.perf_counter()))
            return out

        trainer._save, trainer.validate, trainer._epoch = timed_save, timed_validate, timed_epoch
        return trainer

    out = {"checkpoint_bytes_reckoned": reckoned, "parameters": n_params}
    ck._write = timed_write
    try:
        # serve1b's bf16 weights, on the card: its first `depth` Blocks
        init = {k: t for k, t in ev.model.state_dict().items() if within_depth(k, depth)}
        reset_counts()  # the phase's main path: A, B, the two resumes, the fine-tune
        tt = time.perf_counter()
        a = instrument(Trainer(cfg, "cuda", state_dict=init, checkpoint_dir=str(ck_dir),
                               run_validation=True, keep_last_checkpoints=1))
        hist_a = a.fit(max_epochs=2, max_steps_per_epoch=RESUME_STEPS_1B)
        torch.cuda.synchronize()
        out["fit_a_s"] = time.perf_counter() - tt
        del init
        for rec in hist_a:
            print(f"    A {json.dumps(rec)}")
        listing = sorted(os.listdir(ck_dir))
        on_disk = os.path.getsize(ck_dir / "epoch_1" / ck.CHECKPOINT_FILE)
        val = a.last_validation
        out.update(checkpoint_bytes=on_disk, sync_save_s=[t for _, t in saves],
                   sync_write_s=[t1 - t0 for _, t0, t1 in writes],
                   validation_s=[t for t, _ in validations], validation=val,
                   validation_launches=[c for _, c in validations],
                   losses_a=[r["loss"] for r in hist_a])
        print(f"  A: fit {out['fit_a_s']:.1f} s; saves {[f'{t:.2f}' for t in out['sync_save_s']]} s "
              f"(writes {[f'{t:.2f}' for t in out['sync_write_s']]} s), {on_disk} bytes on disk "
              f"({on_disk / reckoned:.4f} of the reckoning); after the prune {listing}; "
              f"validations {[f'{t:.2f}' for t in out['validation_s']]} s over {val['samples']} "
              f"tiles ({val_batches} batches), launches {validations[-1][1]}")
        check(listing == ["epoch_1"], f"keep_last_checkpoints 1 left {listing}")
        check(on_disk >= reckoned, f"the checkpoint holds {on_disk} bytes, under {reckoned}")
        check(val["samples"] == FIELDS_RESUME_1B * tiles and len(val["means"]) == 16
              and all(np.isfinite(v) for v in val["means"].values()),
              f"validation {val}")
        check(all(c == only(flash_attn_fwd=depth * val_batches) for _, c in validations),
              f"validation launches {[c for _, c in validations]}, want K1 {depth} x {val_batches}")
        check(all(np.isfinite(r["loss"]) for r in hist_a), "a 1B train loss is not finite")
        # a validation batch's device time, full and the tail (fp32 masters
        # cast per use, as the validation runs them); its launches are taken
        # off the phase's count below
        timing_from = counts()
        vdm = a.data_module(next(iter(cfg.data.low_res_dir)))
        in_vars, out_vars = vdm.get_data_variables()
        val_shape, _ = vdm.get_data_dims()
        tokens = (val_shape[2] // m.patch_size) * (val_shape[3] // m.patch_size)
        step = make_eval_step(a.model, in_vars, out_vars)
        val_batches_seen = list(vdm.val_dataloader())
        for name, batch in (("val_batch_ms", val_batches_seen[0]),
                            ("val_tail_ms", val_batches_seen[-1])):
            xv, yv = (torch.from_numpy(t).cuda() for t in batch[:2])
            out[name] = cuda_ms(lambda: step(xv, yv), iters=5, warmup=1)
        out["val_tail_tiles"] = int(val_batches_seen[-1][0].shape[0])
        print(f"  validation eval step (forward + clip, fp32 masters cast per use): a "
              f"{BATCH_TRAIN_1B}-tile batch {out['val_batch_ms']:.3f} ms, the "
              f"{out['val_tail_tiles']}-tile tail {out['val_tail_ms']:.3f} ms (events, median of 5)")
        del vdm, step, val_batches_seen, xv, yv
        timing = {k: v - timing_from[k] for k, v in counts().items()}

        # the restore, bit for bit
        torch.cuda.synchronize()
        tt = time.perf_counter()
        restored = ck.restore_checkpoint(str(ck_dir / "epoch_1"))
        flat, scalars = flat_state(restored)
        on_card = {k: v.to("cuda", non_blocking=True) for k, v in flat.items()}
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - tt
        same_state((on_card, scalars), trainer_state(a), "restored epoch_1 against trainer A")
        check(restored["epoch"] == 1, f"restored epoch {restored['epoch']}")
        print(f"  restore of epoch_1 (read and moved to the card) {out['restore_s']:.2f} s: every "
              f"parameter, mu, nu, count {scalars['count']}, lr {scalars['lr']!r} and epoch "
              f"{restored['epoch']} equal to trainer A's bit for bit")
        del a, restored, flat, on_card
        torch.cuda.empty_cache()

        # resume with async saves: epoch_2 is written while epoch 3 trains
        b = instrument(Trainer(cfg, "cuda", checkpoint_dir=str(ck_dir), async_checkpoints=True))
        snap = {}
        saved_at = b._save

        def save_and_snapshot(e):
            saved_at(e)
            if e == 2:  # B's state at its save, on the card: the next steps move the model
                flat_b, scalars_b = trainer_state(b)
                snap["state"] = ({k: v.detach().clone() for k, v in flat_b.items()}, scalars_b)

        b._save = save_and_snapshot
        n_writes = len(writes)
        tt = time.perf_counter()
        hist_b = b.fit(max_epochs=4, max_steps_per_epoch=RESUME_STEPS_1B)
        torch.cuda.synchronize()
        out["fit_b_s"] = time.perf_counter() - tt
        for rec in hist_b:
            print(f"    B {json.dumps(rec)}")
        check([r["epoch"] for r in hist_b] == [2, 3], f"B resumed at {[r['epoch'] for r in hist_b]}")
        check(all(np.isfinite(r["loss"]) for r in hist_b), "a resumed 1B loss is not finite")
        b_writes = {name: (t0, t1) for name, t0, t1 in writes[n_writes:]}
        e3 = next((t0, t1) for e, t0, t1 in epochs if e == 3)
        w2 = b_writes["epoch_2"]
        overlap = max(0.0, min(w2[1], e3[1]) - max(w2[0], e3[0]))
        out.update(async_save_s=[t for e, t in saves if e >= 2],
                   async_write_s={k: t1 - t0 for k, (t0, t1) in b_writes.items()},
                   epoch3_s=e3[1] - e3[0], async_overlap_s=overlap,
                   losses_b=[r["loss"] for r in hist_b])
        same_state(flat_state(ck.restore_checkpoint(str(ck_dir / "epoch_2"))), snap["state"],
                   "epoch_2 written asynchronously against B's state at its save")
        print(f"  B: resumed at epoch 2 from epoch_1, fit {out['fit_b_s']:.1f} s; the async saves "
              f"returned in {[f'{t:.2f}' for t in out['async_save_s']]} s (host copies), their "
              f"writes took {[f'{t:.2f}' for t in out['async_write_s'].values()]} s; epoch 3 "
              f"({out['epoch3_s']:.2f} s) overlapped epoch_2's write for {overlap:.2f} s; epoch_2 "
              f"on disk equals B's state at its save bit for bit")
        del b, snap
        torch.cuda.empty_cache()
        for name in ("epoch_2", "epoch_3"):
            shutil.rmtree(ck_dir / name)

        # two resumes from epoch_1 at MICRO_1B tiles, deterministic
        micro = copy.deepcopy(cfg)
        micro.trainer.batch_size = MICRO_1B
        micro.trainer.checkpoint = str(ck_dir / "epoch_1")
        runs = []
        torch.use_deterministic_algorithms(True)
        try:
            for _ in range(2):
                tt = time.perf_counter()
                c = Trainer(micro, "cuda")
                hist = c.fit(max_epochs=3, max_steps_per_epoch=RESUME_STEPS_1B)
                torch.cuda.synchronize()
                runs.append(([r["loss"] for r in hist], [r["epoch"] for r in hist],
                             time.perf_counter() - tt))
                del c
                torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
        out["deterministic_losses"] = runs[0][0]
        out["resume_s"] = [r[2] for r in runs]
        print(f"  two resumes from epoch_1 at {MICRO_1B} tiles, deterministic: epochs {runs[0][1]} "
              f"losses {runs[0][0]!r} and {runs[1][0]!r} ({[f'{r[2]:.1f}' for r in runs]} s)")
        check(runs[0][1] == runs[1][1] == [2] and runs[0][0] == runs[1][0]
              and all(np.isfinite(runs[0][0])), "the two resumes differ")

        # the fine-tune on another tile geometry
        raw = dataclasses.asdict(cfg)
        raw["tiling"].update(div=FT_DIV, overlap=FT_OVERLAP)
        raw["trainer"].update(batch_size=FT_BATCH, checkpoint=None)
        ft_yaml = ck_root / "finetune.yaml"
        ft_yaml.write_text(yaml.safe_dump(raw))
        before = counts()
        tt = time.perf_counter()
        ft = finetune.main([str(ft_yaml), "--pretrain", str(ck_dir / "epoch_1"), "--loss",
                            tc.train_loss, "--max-epochs", "1", "--max-steps-per-epoch",
                            str(RESUME_STEPS_1B), "--checkpoint-dir", str(ft_dir),
                            "--device", "cuda"])
        torch.cuda.synchronize()
        out["finetune_s"] = time.perf_counter() - tt
        launched = {k: v - timing[k] for k, v in counts().items()}
        ft_launched = {k: v - before[k] for k, v in counts().items()}
        rep = ft["pretrain"]
        (fh, fw), _ = tile_shapes(FT_DIV, FT_OVERLAP, *LOW_1B, *(4 * x for x in LOW_1B))
        ft_tokens = (fh // m.patch_size) * (fw // m.patch_size)
        out.update(finetune_tokens=ft_tokens, finetune_tile=[fh, fw], finetune_batch=FT_BATCH,
                   finetune_losses=[r["loss"] for r in ft["history"]],
                   pretrain={k: len(v) for k, v in rep.items()}, resized=rep["resized"])
        print(f"  fine-tune from epoch_1 on div {FT_DIV} overlap {FT_OVERLAP} tiles {fh} x {fw} "
              f"({ft_tokens} tokens, batch {FT_BATCH}): {out['finetune_s']:.1f} s; pretrain "
              f"import {len(rep['used'])} used, {len(rep['dropped'])} dropped, resized "
              f"{rep['resized']}; losses {out['finetune_losses']}; launches {ft_launched}")
        check(rep["resized"] == ["pos_embed"] and rep["used"] and not rep["dropped"],
              f"pretrain import {rep}")
        check(all(np.isfinite(out["finetune_losses"])), "a fine-tune loss is not finite")
        check(sorted(os.listdir(ft_dir)) == ["epoch_0"], f"the fine-tune saved {os.listdir(ft_dir)}")
    finally:
        ck._write = write
        shutil.rmtree(ck_root, ignore_errors=True)

    # the phase's launches: 2 x 2 steps of A, of B, 2 x 1 x 2 of the resumes
    # and 2 of the fine-tune, all under remat; A's validations
    steps = (2 + 2 + 2 + 1) * RESUME_STEPS_1B
    want = only(**{k: v * steps * tc.grad_accum for k, v in remat_launches(depth).items()})
    want["flash_attn_fwd"] += 2 * depth * val_batches
    print(f"  phase launches {launched}")
    check(launched == want, f"resume1b launches {launched}, want {want}")
    check(ft_launched == only(**{k: v * RESUME_STEPS_1B for k, v in remat_launches(depth).items()}),
          f"fine-tune launches {ft_launched}")

    # the shapes this phase adds, against their plain versions: K1, K2, K3
    # and K5 at the fine-tune's, and the validation's K1 (no dropout) at a
    # full val batch (its 16-tile tail is serve1b's shape, held there)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 42 + seed
    q, k, v = make_qkv(FT_BATCH, ft_tokens, ft_tokens, h, d, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    errs = check_batch_rows(q, k, v, do, m.drop_rate, kseed, [0, FT_BATCH - 1],
                            f"bf16 drop {m.drop_rate:g} B{FT_BATCH} N{ft_tokens} H{h} d{d}")
    del q, k, v, do
    torch.cuda.empty_cache()
    width = (m.embed_dim, int(m.embed_dim * m.mlp_ratio))
    for c in width:
        check_dropout(FT_BATCH * ft_tokens, c, torch.bfloat16, m.drop_rate, gen, kseed)
    torch.cuda.empty_cache()
    q, k, v = make_qkv(BATCH_TRAIN_1B, tokens, tokens, h, d, torch.bfloat16, gen)
    val_err = check_batch_rows(q, k, v, None, 0.0, kseed, [0, BATCH_TRAIN_1B - 1],
                               f"bf16 B{BATCH_TRAIN_1B} N{tokens} H{h} d{d} (validation)")["fwd"]
    del q, k, v
    torch.cuda.empty_cache()
    val_launches = sum(c["flash_attn_fwd"] for c in out["validation_launches"])
    return {"out": out, "launched": launched, "errs": errs, "val_err": val_err,
            "finetune": {"shape": (FT_BATCH, ft_tokens, h, d), "rate": m.drop_rate,
                         "launched": ft_launched, "steps": RESUME_STEPS_1B * tc.grad_accum,
                         "width": width},
            "validation": {"shape": (BATCH_TRAIN_1B, tokens, h, d), "launches": val_launches}}

def host_rss_gib():
    """This process's resident set (VmRSS), GiB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2 ** 20
    raise RuntimeError("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def host_rss_peak(interval=0.005):
    """Samples this process's resident set every `interval` seconds inside
    the block (the kernel's own peak cannot be reset here): yields a dict
    whose "peak_gib" holds the largest sample once the block ends."""
    import threading

    got = {"peak_gib": host_rss_gib()}
    done = threading.Event()

    def sample():
        while not done.wait(interval):
            got["peak_gib"] = max(got["peak_gib"], host_rss_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield got
    finally:
        done.set()
        thread.join()
        got["peak_gib"] = max(got["peak_gib"], host_rss_gib())


@contextlib.contextmanager
def launch_widths(kernel):
    """Counts the launches of K5's wrapper `kernel` inside the block by the
    [rows, cols] each was made on: yields a collections.Counter of them."""
    import collections

    got = collections.Counter()
    launch = kernel.launch

    def counted(device, dtype, x, out, rows, cols, *rest):
        got[(rows, cols)] += 1
        return launch(device, dtype, x, out, rows, cols, *rest)

    kernel.launch = counted
    try:
        yield got
    finally:
        del kernel.launch


def build_10b(cfg, quant_modes):
    """The 10B Evaluator asked for `quant_modes`, built with the card's
    memory peak reset first: (Evaluator, {build seconds, host resident set
    before, its sampled peak during the build and after it, getrusage's
    lifetime peak, the card's peak and in-use bytes})."""
    import gc
    import resource

    from orbit2_tpu_torch.evaluate import Evaluator
    from orbit2_tpu_torch.utils.memory import device_memory_stats

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = host_rss_gib()
    t0 = time.perf_counter()
    with host_rss_peak() as rss:
        ev = Evaluator(cfg, "cuda", quant_modes=quant_modes)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after, card = host_rss_gib(), device_memory_stats()
    out = {"quant_modes": list(quant_modes), "build_s": seconds, "host_rss_before_gib": before,
           "host_peak_rss_gib": rss["peak_gib"], "host_rss_gib": after,
           "ru_maxrss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
           "card_peak_gib": card["peak_bytes_in_use"] / 2 ** 30,
           "card_in_use_gib": card["bytes_in_use"] / 2 ** 30}
    fp32 = [k for k, t in ev.model.state_dict().items() if t.dtype == torch.float32]
    check(not fp32, f"{quant_modes} Evaluator keeps fp32 tensors: {fp32[:3]}")
    check(sorted(ev._twins) == sorted(set(quant_modes) - {"none"}),
          f"{quant_modes} Evaluator holds the twins {sorted(ev._twins)}")
    print(f"  Evaluator(quant_modes={tuple(quant_modes)}) built in {seconds:.2f} s: card peak "
          f"{out['card_peak_gib']:.2f} GiB, in use {out['card_in_use_gib']:.2f} GiB; host resident "
          f"{before:.2f} GiB before, peak {rss['peak_gib']:.2f} during (sampled every 5 ms), "
          f"{after:.2f} after (getrusage's lifetime peak {out['ru_maxrss_gib']:.2f}); no fp32 "
          f"tensor kept")
    return ev, out


def step_10b(label, step, x, y, smi):
    """A 10B serving step (forward + clip of one batch) by events (median of
    3) and by the kernel time of every kernel it launches, split by kind,
    and its peak card memory."""
    from orbit2_tpu_torch.utils.memory import device_memory_stats

    ms = cuda_ms(lambda: step(x, y), iters=3, warmup=1)
    by_name = {}
    kern = kernel_ms(lambda: step(x, y), iters=3, sessions=2, by_name=by_name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(x, y)
    torch.cuda.synchronize()
    peak = device_memory_stats()["peak_bytes_in_use"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"step_ms": ms, "kernel_ms": kern, "busy": kern / ms, "peak_gib": peak / 2 ** 30,
           "step_gib": (peak - base) / 2 ** 30, "by_kind": step_kinds(by_name),
           "kernels": {name[:80]: t for name, t in top}}
    print(f"  serving 10B {label} step, batch {x.shape[0]} tiles: {ms:.3f} ms by events (median "
          f"of 3), kernel time {kern:.3f} ms (busy {kern / ms:.3f}); peak memory "
          f"{row['peak_gib']:.2f} GiB ({row['step_gib']:.2f} the step's own); gpu: {smi}")
    print("    by kind: " + ", ".join(f"{kind} {t:.3f} ms" for kind, t in row["by_kind"].items()))
    for name, t in top:
        print(f"    {t:9.4f} ms  {name[:110]}")
    return row


def serve10b(cfg, seed, call_s, smi):
    """Phase serve10b: configs/interm_10b.yaml served on the card at full
    width and depth. Evaluator built for bf16 alone (no fp32 kept anywhere;
    build seconds, host and card memory), K1 (B16, N1152, H32, d256) with and
    without dropout against its plain version on the first and last batch
    elements and at one stitched tile's (B1), K5 bit for bit at [18432, 8192
    | 32768]; test() over BATCHES_10B batches (exact K1 launches), one batch
    against the plain attention (the trunk and the prediction within
    TRUNK_BF16_REL) and its first tiles against an fp32 forward (the
    witness), the stitched 720 x 1440 field against the same field on the
    plain attention, an MC ensemble of MC_SAMPLES_10B samples (exact K1
    launches and K5 launches at each width; seeded); the bf16 step, K1's
    rows (batch, stitched tile, dropout) and K5's timed. Then the
    Evaluator built for w8a8 too (the twin quantized on the card as the
    model is filled): its bf16 prediction equals the first one's bit for
    bit, test() in w8a8 (exact K1 launches), its prediction and trunk within
    W8A8_REL of bf16, its stitched field, its step timed. Returns the
    {"serving_10b"} line's numbers and the kernels line's rows."""
    import gc

    import torch.nn.functional as F

    from orbit2_tpu_torch.evaluate import make_data_module
    from orbit2_tpu_torch.ops.dropout import FUSED_DROPOUT, FusedDropout, dropout_reference
    from orbit2_tpu_torch.ops.flash_attention import (
        attention_flops, attention_mult, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult
    from orbit2_tpu_torch.training.train import make_eval_step
    from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions
    from orbit2_tpu_torch.utils.memory import device_memory_stats

    from orbit2_tpu_torch.models.components.blocks import Block

    m = cfg.model
    div, overlap, mag = cfg.tiling.effective_div, cfg.tiling.effective_overlap, m.superres_mag
    out = {"gpu": smi}
    # what the card's draw replaces: one trunk Block drawn on the host
    with torch.device("meta"):
        block = Block(m.embed_dim, m.num_heads, m.mlp_ratio, qkv_bias=True,
                      gelu_tanh=m.gelu_approx == "tanh")
    block.to_empty(device="cpu")
    t0 = time.perf_counter()
    block.reset_parameters(torch.Generator().manual_seed(seed))
    out["host_block_draw_s"] = time.perf_counter() - t0
    print(f"  one Block drawn on the host ({sum(p.numel() for p in block.parameters()):,} "
          f"parameters, as an Evaluator drew the model before it drew on its device): "
          f"{out['host_block_draw_s']:.2f} s")
    del block
    ev, out["bf16_build"] = build_10b(cfg, ("none",))
    lap("serve10b bf16 build")
    dm = ev.data_module
    in_vars, out_vars = dm.get_data_variables()
    in_shape, out_shape = dm.get_data_dims()
    tokens = (in_shape[2] // m.patch_size) * (in_shape[3] // m.patch_size)
    n_params = sum(t.numel() for t in ev.model.parameters())
    b, h, d = in_shape[0], m.num_heads, m.embed_dim // m.num_heads
    hidden = int(m.embed_dim * m.mlp_ratio)
    print(f"  config {CONFIG_10B.name}: embed {m.embed_dim} depth {m.depth} heads {h} (d {d}) "
          f"decoder {m.decoder_depth} mlp_ratio {m.mlp_ratio} gelu {m.gelu_approx} "
          f"{cfg.trainer.data_type}, {n_params:,} parameters drawn from trainer.seed on the card; "
          f"{len(in_vars)} -> {len(out_vars)} variables, {KEY_10B} {LOW_10B} -> "
          f"{tuple(x * mag for x in LOW_10B)}; tiling div {div} overlap {overlap}: tiles "
          f"{tuple(in_shape[2:])} -> {tuple(out_shape[2:])}, {tokens} tokens, batch {b} tiles")
    check(n_params == PARAMS_10B and (b, tokens, h, d) == ATTENTION_10B,
          f"10B geometry {n_params, b, tokens, h, d}, want {PARAMS_10B, ATTENTION_10B}")
    out["config"] = {"params": n_params, "batch_tiles": b, "tokens_per_tile": tokens,
                     "heads": h, "head_dim": d, "depth": m.depth, "embed_dim": m.embed_dim}

    # the path's kernels at its shapes against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 40 + seed
    errs = {}
    q, k, v = make_qkv(b, tokens, tokens, h, d, torch.bfloat16, gen)
    for rate in (0.0, m.drop_rate):
        errs[("fwd", rate)] = check_batch_rows(q, k, v, None, rate, kseed, (0, b - 1),
                                               f"bf16 drop {rate:g} B{b} N{tokens} H{h} d{d}")["fwd"]
    del q, k, v
    # stitched_inference runs the model one tile at a time
    q, k, v = make_qkv(1, tokens, tokens, h, d, torch.bfloat16, gen)
    errs[("fwd_tile", 0.0)] = check_forward(q, k, v, 0.0, kseed,
                                            f"bf16 drop 0 B1 N{tokens} H{h} d{d} (a stitched "
                                            f"tile)")[3]
    del q, k, v
    for c in (m.embed_dim, hidden):
        check_dropout(b * tokens, c, torch.bfloat16, m.drop_rate, gen, kseed)
    torch.cuda.empty_cache()

    want_k1 = only(flash_attn_fwd=m.depth * BATCHES_10B)

    def serve(evaluator, quant):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = evaluator.test(max_batches=BATCHES_10B, quant=quant)
        torch.cuda.synchronize()
        seconds, launched = time.perf_counter() - t0, counts()
        peak = device_memory_stats()["peak_bytes_in_use"] / 2 ** 30
        print(f"  test(max_batches={BATCHES_10B}, quant={quant!r}) {seconds:.3f} s, card peak "
              f"{peak:.2f} GiB; launches {launched}")
        check(len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values()),
              f"{quant} 10B metrics missing or not finite")
        check(launched == want_k1, f"{quant} 10B serving launches {launched}, want "
              f"flash_attn_fwd = depth x batches = {m.depth * BATCHES_10B} and nothing else")
        return metrics, {"test_s_per_batch": seconds / BATCHES_10B, "test_peak_gib": peak,
                         "launches": launched["flash_attn_fwd"]}

    metrics, out["bf16_test"] = serve(ev, "none")
    for key, val in metrics.items():
        print(f"    {key} {val:.6f}")
    loader = iter(dm.test_dataloader())
    batch = next(loader)
    loader.close()
    x = torch.from_numpy(batch[0]).cuda()
    y = torch.from_numpy(batch[1]).cuda()
    with torch.no_grad(), trunk_outputs(ev.model) as trunks:
        pred = ev.model(x, in_vars, out_vars).float()
        set_attention_impl(ev.model, "xla")
        pred_plain = ev.model(x, in_vars, out_vars).float()
        set_attention_impl(ev.model, m.attention_impl)
        torch.cuda.synchronize()
    trunk, trunk_plain = trunks
    want_shape = (b, len(out_vars)) + tuple(out_shape[2:])
    check(tuple(pred.shape) == want_shape and bool(pred.isfinite().all()),
          f"bad 10B prediction {tuple(pred.shape)}, want {want_shape}")
    # held by relative Frobenius error: the 117M and 1B phases' elementwise
    # atol=rtol PRED_BF16_TOL does not hold here (the rounding that differs
    # passes 11 blocks and a decoder of four 8192-wide layers: max|d| 0.25
    # at max|pred| 34.5 in the first run, 3,443 of 3,538,944 values beyond)
    rel_plain, rel_pred = rel_frob(trunk, trunk_plain), rel_frob(pred, pred_plain)
    pred_err = (pred - pred_plain).abs().max().item()
    out["trunk_rel_vs_plain"], out["pred_rel_vs_plain"] = rel_plain, rel_pred
    out["pred_max_abs_vs_plain"] = pred_err
    print(f"  bf16 prediction of one batch, kernel vs plain attention: relative Frobenius error "
          f"{rel_pred:.4e}, max|d| {pred_err:.3e} (max|pred| {pred_plain.abs().max().item():.3e}); "
          f"the trunk's output after {m.depth} blocks: relative Frobenius error {rel_plain:.4e} "
          f"(bound {TRUNK_BF16_REL:g} for both)")
    check(rel_plain <= TRUNK_BF16_REL and rel_pred <= TRUNK_BF16_REL,
          f"the 10B trunk on the kernels is {rel_plain} off the same trunk on the plain "
          f"attention, the prediction {rel_pred}")
    n = WITNESS_TILES_10B
    with torch.no_grad():
        ev.model.dtype = torch.float32  # every layer casts its bf16 weights to fp32 at use
        set_attention_impl(ev.model, "xla")
        pred_ref = ev.model(x[:n], in_vars, out_vars).float()
        ev.model.dtype = torch.bfloat16
        set_attention_impl(ev.model, m.attention_impl)
    witness = {}
    for label, got in (("kernels", pred[:n]), ("plain", pred_plain[:n])):
        diff = (got - pred_ref).abs()
        witness[label] = {"rel": rel_frob(got, pred_ref), "max_abs": diff.max().item(),
                          "beyond_tol": int((diff > PRED_BF16_TOL * (1 + pred_ref.abs())).sum())}
    out["witness_fp32"] = dict(witness, tiles=n, max_abs_ref=pred_ref.abs().max().item())
    print(f"  witness: the first {n} tiles' bf16 predictions against the same weights computing "
          f"in fp32 on the plain attention (max|pred| {out['witness_fp32']['max_abs_ref']:.3e}): "
          + "; ".join(f"{label}: relative Frobenius error {w['rel']:.4e}, max|d| "
                      f"{w['max_abs']:.3e}, {w['beyond_tol']} of {pred_ref.numel()} values beyond "
                      f"atol=rtol {PRED_BF16_TOL:g}" for label, w in witness.items())
          + f" (the kernels' path within {WITNESS_RATIO:g}x the plain path's)")
    check(all(witness["kernels"][key] <= WITNESS_RATIO * witness["plain"][key]
              for key in ("rel", "max_abs")),
          f"the 10B bf16 prediction on the kernels is further from fp32 than the plain path's: "
          f"{witness}")
    del pred_plain, trunk_plain, trunks, pred_ref
    lap("serve10b kernels, test, witness")

    dm_vis = make_data_module(cfg, ev.data_key, 1, 0, "test")
    sample, _, names, _ = next(iter(dm_vis.data_test))
    x_full = np.stack([sample[k] for k in names])
    want_field = (len(out_vars), x_full.shape[1] * mag, x_full.shape[2] * mag)
    stitched = {}

    def stitch(label, model):
        reset_counts()
        field, seconds = stitch_field(model, x_full, div, overlap, mag, in_vars, out_vars)
        launched = counts()
        print(f"  stitched field 0, {label}: {x_full.shape} -> {field.shape} from {div * div} "
              f"tiles in {seconds:.3f} s; launches {launched}")
        check(field.shape == want_field and bool(np.isfinite(field).all()),
              f"{label} stitched field {field.shape}, want {want_field}, or not finite")
        check(launched == only(flash_attn_fwd=m.depth * div * div),
              f"{label} stitching launched {launched}")
        stitched[label] = field
        out[label + "_stitch_s"] = seconds
        out[label + "_stitch_launches"] = launched["flash_attn_fwd"]

    stitch("bf16", ev.model)
    set_attention_impl(ev.model, "xla")
    field_plain, _ = stitch_field(ev.model, x_full, div, overlap, mag, in_vars, out_vars)
    set_attention_impl(ev.model, m.attention_impl)
    rel_field = float(np.linalg.norm(stitched["bf16"] - field_plain) / np.linalg.norm(field_plain))
    out["stitch_rel_vs_plain"] = rel_field
    print(f"  stitched bf16 field on the kernels against the same field on the plain attention: "
          f"relative Frobenius error {rel_field:.4e} (bound {TRUNK_BF16_REL:g})")
    check(rel_field <= TRUNK_BF16_REL, f"the stitched 10B field on the kernels is {rel_field} "
          f"off the same field on the plain attention")
    del field_plain

    reset_counts()
    t0 = time.perf_counter()
    with launch_widths(FUSED_DROPOUT) as k5_widths:
        ens = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, MC_SAMPLES_10B,
                                          torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
    mc_s, mc_counts = time.perf_counter() - t0, counts()
    again = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, MC_SAMPLES_10B,
                                        torch.Generator().manual_seed(seed))
    want_mc = only(flash_attn_fwd=MC_SAMPLES_10B * m.depth,
                   fused_dropout=MC_SAMPLES_10B * (1 + 3 * m.depth))
    # pos_drop, proj and fc2's output at the model width, the MLP hidden wider
    want_widths = {(b * tokens, m.embed_dim): MC_SAMPLES_10B * (1 + 2 * m.depth),
                   (b * tokens, hidden): MC_SAMPLES_10B * m.depth}
    print(f"  MC dropout, {MC_SAMPLES_10B} samples of one batch at drop_rate {m.drop_rate}: "
          f"{tuple(ens.shape)} in {mc_s:.3f} s, mean member std "
          f"{ens.float().std(dim=0).mean().item():.4e}; launches {mc_counts}")
    check(tuple(ens.shape) == (MC_SAMPLES_10B,) + want_shape and bool(ens.isfinite().all()),
          f"bad 10B MC ensemble {tuple(ens.shape)}")
    check(mc_counts == want_mc, f"10B MC dropout launches {mc_counts}, want {want_mc}")
    check(k5_widths == want_widths, f"10B MC dropout's K5 launches by shape {dict(k5_widths)}, "
          f"want {want_widths}")
    print(f"  K5 launches by [rows, cols]: {dict(k5_widths)}")
    check(not torch.equal(ens[0], ens[1]), "two MC-dropout samples are equal")
    check(torch.equal(ens, again), "the same seed gave other MC-dropout samples")
    print("  MC-dropout samples differ; the same seed gives them bit for bit")
    out["mc"] = {"samples": MC_SAMPLES_10B, "seconds": mc_s, "launches": mc_counts,
                 "fused_dropout_by_width": {c: n for (_, c), n in k5_widths.items()}}
    del ens, again

    # times: the bf16 step, K1 and K5 at the path's shapes
    out["bf16"] = step_10b("bf16", make_eval_step(ev.model, in_vars, out_vars), x, y, smi)
    rows = {}
    # the stitched tiles' launches are known once the w8a8 field is stitched
    launches = {("fwd", 0.0): out["bf16_test"]["launches"], ("fwd_tile", 0.0): None,
                ("fwd", m.drop_rate): mc_counts["flash_attn_fwd"]}
    for (name, rate), n_launched in launches.items():
        rows[(name, rate)] = k1_row(1 if name == "fwd_tile" else b, tokens, h, d, rate, gen,
                                    kseed, call_s, smi, n_launched)
    for width in (m.embed_dim, hidden):
        xd = torch.randn(b * tokens, width, generator=gen, device="cuda").to(torch.bfloat16)
        mult = keep_mult(kseed, b * tokens, width, m.drop_rate, device="cuda")
        fn = lambda: FusedDropout.apply(xd, kseed, m.drop_rate)
        lib = lambda: F.dropout(xd, m.drop_rate, training=True)
        row_bound = roofline(0, 2 * nbytes(xd))
        rows[("fused_dropout", width)] = r = {
            "shape": [b * tokens, width], "dropout": m.drop_rate, "ms": cuda_ms(fn),
            "kernel_ms": kernel_ms(fn), "plain_ms": cuda_ms(lambda: dropout_reference(xd, mult)),
            "library_ms": best_ms(lib), "library_kernel_ms": kernel_ms(lib),
            "bound_ms": row_bound[0], "bound_by": row_bound[1],
            "launches": k5_widths[(b * tokens, width)]}
        print(f"  K5 bf16 [{b * tokens}, {width}]: {r['ms']:.4f} ms (kernel alone "
              f"{r['kernel_ms']:.4f}, {row_bound[0] / r['kernel_ms']:.3f} of the bytes bound), "
              f"plain {r['plain_ms']:.4f}, F.dropout {r['library_ms']:.4f} (kernel alone "
              f"{r['library_kernel_ms']:.4f}); bound {row_bound[0]:.4f}; "
              f"{r['launches']} of the ensemble's {mc_counts['fused_dropout']} launches at this "
              f"shape; gpu: {smi}")
        del xd, mult
    torch.cuda.empty_cache()

    # the w8a8 Evaluator: the same draw, the twin quantized as it is filled
    lap("serve10b stitched fields, MC, times")
    pred_bf16, field_bf16 = pred.cpu(), stitched["bf16"]
    del ev, pred, trunk
    gc.collect()
    torch.cuda.empty_cache()
    ev, out["w8a8_build"] = build_10b(cfg, ("none", "w8a8"))
    lap("serve10b w8a8 build")
    qmodel = ev.serving_model("w8a8")
    with torch.no_grad(), trunk_outputs(ev.model) as trunks, trunk_outputs(qmodel) as qtrunks:
        pred = ev.model(x, in_vars, out_vars).float().cpu()
        pred_q = qmodel(x, in_vars, out_vars).float().cpu()
    check(torch.equal(pred, pred_bf16), "the w8a8 Evaluator's bf16 prediction differs from the "
          "bf16-only Evaluator's: the two draws from trainer.seed differ")
    metrics_q, out["w8a8_test"] = serve(ev, "w8a8")
    rel, rel_trunk = rel_frob(pred_q, pred), rel_frob(qtrunks[0], trunks[0])
    out["w8a8_rel"], out["w8a8_trunk_rel"] = rel, rel_trunk
    del trunks, qtrunks
    print(f"  the w8a8 Evaluator's bf16 prediction equals the bf16-only one's bit for bit; its "
          f"w8a8 prediction against bf16: relative Frobenius error {rel:.4e} (bound {W8A8_REL:g}), "
          f"of the trunk's output alone {rel_trunk:.4e}; metrics " + ", ".join(
              f"{k.split('/')[1]} {metrics_q[k]:.6f} (bf16 {metrics[k]:.6f})"
              for k in metrics if k.endswith("aggregate")))
    check(0.0 < rel <= W8A8_REL and 0.0 < rel_trunk <= W8A8_REL and bool(pred_q.isfinite().all()),
          f"10B w8a8 prediction off the bf16 one by {rel}, its trunk's output by {rel_trunk}")
    stitch("w8a8", qmodel)
    rows[("fwd_tile", 0.0)]["launches"] = out["bf16_stitch_launches"] + out["w8a8_stitch_launches"]
    rel_stitch = np.linalg.norm(stitched["w8a8"] - field_bf16) / np.linalg.norm(field_bf16)
    out["w8a8_stitch_rel"] = float(rel_stitch)
    print(f"  stitched w8a8 field against bf16: relative Frobenius error {rel_stitch:.4e} "
          f"(bound {W8A8_REL:g})")
    check(rel_stitch <= W8A8_REL, f"w8a8 stitched 10B field off the bf16 one by {rel_stitch}")
    out["w8a8"] = step_10b("w8a8", make_eval_step(qmodel, in_vars, out_vars), x, y, smi)
    quant_rescale = out["w8a8"]["by_kind"]["other"] - out["bf16"]["by_kind"]["other"]
    out["w8a8"]["quant_rescale_ms"] = quant_rescale
    print(f"  w8a8 step, by the two steps' profiles: the quantization and rescale passes of its "
          f"{4 * m.depth} trunk products take {quant_rescale:.3f} ms of its "
          f"{out['w8a8']['kernel_ms']:.3f} ms of kernel time (its other kernels less the bf16 "
          f"step's)")
    del ev, qmodel, x, y
    lap("serve10b w8a8 test, field, step")
    gc.collect()
    torch.cuda.empty_cache()
    out["errors"] = {"k1_nodrop": errs[("fwd", 0.0)], "k1_drop": errs[("fwd", m.drop_rate)],
                     "k1_tile": errs[("fwd_tile", 0.0)], "fused_dropout": 0.0}
    out["rows"] = {f"{name}_{key}": r for (name, key), r in rows.items()}
    return {"out": out, "rows": rows, "errs": errs, "rate": m.drop_rate,
            "widths": (m.embed_dim, hidden)}


def config_moe(root: Path, seed: int, trainer=None, **dataset):
    """configs/interm_1b_moe.yaml with its mesh (fsdp 2 x expert_par 4) cut to
    the one card and PRISM's variables on a synthetic split at LOW_1B
    (write_dataset's `dataset` arguments). The scale-down leaves expert_par
    as it is, as JAX's does; one process holds every expert, so it is cut
    to 1 here by hand (phase seqexpert runs the expert axis on two ranks)."""
    cfg = slice_config(root, seed, CONFIG_MOE, trainer=trainer, low=LOW_1B, **dataset)
    cfg.parallelism.expert_par = 1
    return cfg


@contextlib.contextmanager
def router_choices(model):
    """Collects the top-1 choices [B, L] of every MoE Block of `model` in each
    forward inside the block (run it without grad): yields a list with one
    list of them a forward, in Block order."""
    from orbit2_tpu_torch.models.components.moe import MoEMlp

    got = []
    moes = [mod for mod in model.modules() if isinstance(mod, MoEMlp)]

    def record(mod, args):
        if mod is moes[0]:
            got.append([])
        got[-1].append(mod.router_probs(args[0]).argmax(-1))

    handles = [mod.register_forward_pre_hook(record) for mod in moes]
    try:
        yield got
    finally:
        for handle in handles:
            handle.remove()


def flips(got, want):
    """(top-1 choices that differ, in each MoE Block; the tokens whose choice
    differs in some Block), between two router_choices records of a batch."""
    per_block = [int((a != b).sum()) for a, b in zip(got, want)]
    any_flip = torch.stack([a != b for a, b in zip(got, want)]).any(dim=0)
    return per_block, any_flip


def fingerprints(model):
    """{name: (fp64 sum, fp64 sum of squares)} of every parameter, per
    expert (its first dimension) for the MoE Blocks' wi, bi, wo, bo: a
    parameter or an expert whose fingerprint changed has moved."""
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = p.detach().double()
            if ".moe_mlp." in name and "router_kernel" not in name:
                dims = tuple(range(1, t.dim()))
                out[name] = torch.stack([t.sum(dims), t.square().sum(dims)], dim=-1).cpu()
            else:
                out[name] = torch.stack([t.sum(), t.square().sum()]).cpu()
    return out


def moe_flops(model, b, n, h, d):
    """(model flops, hardware flops, 6 x parameters x tokens) of one MoE
    train step over b tiles of n tokens, on the products it executes: 6 x
    the parameters outside the experts (the routers among them) x the
    tokens; in each MoE Block the experts' two products on their E x b x C
    slots (2 x 2 D H a slot forward, 3x that with the backward) and the
    dispatch and combine einsums (2 b n E C D each forward; the backward
    takes the dispatch's once, for x, and the combine's twice, for the
    experts' output and the gates: 5 in all); attention as train_flops
    counts it. The hardware's also count full remat's forward again: the
    Blocks' dense products, the experts' and both einsums, K1 and the
    backward kernels' recomputed scores. The last counts every expert on
    every token, as a dense model's MFU would."""
    from orbit2_tpu_torch.ops.flash_attention import attention_flops

    moes = [blk.moe_mlp for blk in model.blocks if blk.moe]
    experts = sum(p.numel() for mlp in moes for name, p in mlp.named_parameters()
                  if name != "router_kernel")
    params = sum(p.numel() for p in model.parameters())
    dense_blocks = sum(p.numel() for p in model.blocks.parameters()) - experts
    depth, tokens = len(model.blocks), b * n
    att = attention_flops(b, n, n, h, d)
    expert_fwd = einsum_fwd = 0
    for mlp in moes:
        e, dim, hidden = mlp.wi.shape
        slots = e * b * mlp.capacity(n)
        expert_fwd += 2 * 2 * dim * hidden * slots
        einsum_fwd += 2 * (2 * b * n * e * mlp.capacity(n) * dim)
    model_flops = (6 * (params - experts) * tokens + 3 * expert_fwd + 5 / 2 * einsum_fwd
                   + 3 * depth * att)
    hardware = (model_flops + 2 * dense_blocks * tokens + expert_fwd + einsum_fwd
                + depth * (1 + 3.5 - 2) * att)
    return model_flops, hardware, 6 * params * tokens


def step_split(fn, tiles, experts, slots, hidden):
    """One call of fn's kernel ms by kind: K1, K2, K3 and K5 by the
    profiler's kernel time (kernel_ms, by kernel name); the matrix products
    by CUDA events recorded around each aten product op (a TorchDispatchMode,
    which also sees the backward's), in three kinds: bmm / baddbmm batched
    over the `experts` with the `hidden` width among their dimensions (the
    experts' products), bmm / baddbmm batched over the `tiles` with the
    experts' `slots` (E x C) among them (the dispatch and combine einsums),
    and the rest with mm / addmm and the convolutions (the dense products);
    "other" is the kernel time left (elementwise, copies, reductions,
    norms). Returns (the kernel time, {kind: ms}, {kernel name: ms})."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    batched = {aten.bmm.default, aten.baddbmm.default}
    products = batched | {aten.mm.default, aten.addmm.default, aten.convolution.default,
                          aten.convolution_backward.default}
    marks = []

    class ProductTimer(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func not in products:
                return func(*args, **(kwargs or {}))
            kind = "dense_products"
            if func in batched:
                a, b = [t for t in args if isinstance(t, torch.Tensor)][-2:]  # the batches
                dims = set(a.shape[1:]) | set(b.shape[1:])
                if a.shape[0] == experts and hidden in dims:
                    kind = "expert_products"
                elif a.shape[0] == tiles and slots in dims:
                    kind = "dispatch_combine"
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = func(*args, **(kwargs or {}))
            end.record()
            marks.append((kind, start, end))
            return out

    by_name = {}
    total = kernel_ms(fn, iters=1, by_name=by_name)
    named = {"k1": ("flash_fwd",), "k2": ("flash_bwd_dq",), "k3": ("flash_bwd_dkv",),
             "k5": ("dropout_vec_kernel", "dropout_scalar_kernel")}
    kinds = {kind: sum(t for name, t in by_name.items() if any(tag in name for tag in tags))
             for kind, tags in named.items()}
    kinds.update(dict.fromkeys(("expert_products", "dispatch_combine", "dense_products"), 0.0))
    torch.cuda.synchronize()
    with ProductTimer():
        fn()
    torch.cuda.synchronize()
    for kind, start, end in marks:
        kinds[kind] += start.elapsed_time(end)
    kinds["other"] = total - sum(kinds.values())
    return total, kinds, by_name


def moe1b(root, seed, call_s, smi):
    """Phase moe1b: configs/interm_1b_moe.yaml (the 1B trunk with 8 Switch
    experts in every 2nd Block) served and trained on the card at full width
    and depth, on the 1B phases' tiles (66 x 132, 2,178 tokens). w8a8 is
    refused; the Evaluator draws the model on the card (its routers fp32);
    K1 (B16 and B1, with and without dropout), K5 at the serving and
    training widths, and K1-K3 at the training shapes against their plain
    versions; test() over BATCHES_1B batches (exact K1 launches); one batch
    against the plain attention (the routers' flipped choices counted, the
    prediction and the trunk's output on tokens routed alike within
    TRUNK_BF16_REL) and its first tiles against an fp32 forward (the
    witness); a stitched field against the plain attention's; an MC
    ensemble (exact K1 and K5 launches; seeded). Then Trainer.fit from the
    served weights, batch 32 tiles, full remat, bf16 moments, dropout and
    drop-path 0.1: exact launches, finite losses, the aux term in [1, E],
    every router and every expert that took tokens moved; one step at
    MICRO_1B tiles with remat full, dots and none bit for bit; the step's
    time by events, its kernel time by kind (the experts' products and the
    dispatch and combine einsums apart), peak memory, tiles/s and MFU on the
    products it executes; the kernels' rows at the path's shapes. Returns
    the {"moe_1b"} line's numbers and the kernels line's rows."""
    import gc
    import types

    from orbit2_tpu_torch.evaluate import Evaluator, make_data_module
    from orbit2_tpu_torch.models.components.blocks import MOE_QUANT_ERROR
    from orbit2_tpu_torch.training.train import make_eval_step, make_train_step
    from orbit2_tpu_torch.training.trainer import Trainer
    from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions

    cfg = config_moe(root / "serve", seed, trainer={"batch_size": BATCH_1B}, n_files=1,
                     t=FIELDS_1B, shards=("test",))
    m = cfg.model
    depth, h, d = m.depth, m.num_heads, m.embed_dim // m.num_heads
    hidden = int(m.embed_dim * m.mlp_ratio)
    div, overlap, mag = cfg.tiling.effective_div, cfg.tiling.effective_overlap, m.superres_mag
    out = {"gpu": smi}
    try:
        Evaluator(cfg, "cuda", quant_modes=("none", "w8a8"))
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"  Evaluator(quant_modes=('none', 'w8a8')) raises ValueError: {refused!r}")
    check(refused == MOE_QUANT_ERROR, f"w8a8 on the MoE config: {refused!r}")

    # the phase trains near the card's size, in a process whose earlier phases
    # left live tensors: without expandable segments (set at the top) their
    # cached segments ran a 9.57 GiB gradient of the variable aggregation out
    # of memory with 19 GiB reserved and unused
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev = Evaluator(cfg, "cuda")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    dm = ev.data_module
    lap("moe1b build")
    in_vars, out_vars = dm.get_data_variables()
    in_shape, out_shape = dm.get_data_dims()
    b = in_shape[0]
    tokens = (in_shape[2] // m.patch_size) * (in_shape[3] // m.patch_size)
    model = ev.model
    moe_blocks = [i for i, blk in enumerate(model.blocks) if blk.moe]
    n_moe = len(moe_blocks)
    n_params = sum(p.numel() for p in model.parameters())
    routers = [model.blocks[i].moe_mlp.router_kernel for i in moe_blocks]
    capacity = model.blocks[moe_blocks[0]].moe_mlp.capacity(tokens)
    print(f"  config {CONFIG_MOE.name}: embed {m.embed_dim} depth {depth} heads {h} (d {d}) gelu "
          f"{m.gelu_approx} {cfg.trainer.data_type}; {m.moe_experts} experts top-{m.moe_top_k} in "
          f"Blocks {moe_blocks} (capacity factor {m.moe_capacity_factor}: C = {capacity} of "
          f"{tokens} tokens), aux weight {m.moe_aux_weight}; {n_params:,} parameters drawn on "
          f"the card in {out['build_s']:.2f} s (the routers "
          f"{sorted({str(r.dtype)[6:] for r in routers})}); tiles {tuple(in_shape[2:])} -> "
          f"{tuple(out_shape[2:])}, batch {b}; card peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(n_params == PARAMS_MOE and moe_blocks == list(range(m.moe_every - 1, depth, m.moe_every))
          and tuple(in_shape[2:]) == TILE_MOE, f"MoE geometry {n_params, moe_blocks, tokens}")
    check(all(r.dtype == torch.float32 for r in routers) and ev.quant_modes == ("none",)
          and not ev._twins, "the bf16 MoE Evaluator's routers are not fp32, or it holds a twin")
    out["config"] = {"params": n_params, "moe_blocks": moe_blocks, "experts": m.moe_experts,
                     "capacity": capacity, "tokens_per_tile": tokens, "batch_tiles": b}

    # the path's kernels at its shapes against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 42 + seed
    errs = {}
    q, k, v = make_qkv(b, tokens, tokens, h, d, torch.bfloat16, gen)
    for rate in (0.0, m.drop_rate):
        errs[("serve", rate)] = check_batch_rows(
            q, k, v, None, rate, kseed, (0, b - 1), f"bf16 drop {rate:g} B{b} N{tokens} H{h} "
            f"d{d}")["fwd"]
    del q, k, v
    q, k, v = make_qkv(1, tokens, tokens, h, d, torch.bfloat16, gen)
    errs[("tile", 0.0)] = check_forward(q, k, v, 0.0, kseed, f"bf16 drop 0 B1 N{tokens} H{h} "
                                        f"d{d} (a stitched tile)")[3]
    del q, k, v
    for c in (m.embed_dim, hidden):
        check_dropout(b * tokens, c, torch.bfloat16, m.drop_rate, gen, kseed)
    torch.cuda.empty_cache()

    # serving
    sites = 3 * depth - n_moe  # K5 sites: pos_drop aside, 3 a dense Block, 2 an MoE Block
    reset_counts()
    t0 = time.perf_counter()
    metrics = ev.test(max_batches=BATCHES_1B)
    torch.cuda.synchronize()
    test_s, launched = time.perf_counter() - t0, counts()
    print(f"  test(max_batches={BATCHES_1B}) {test_s:.3f} s; launches {launched}")
    check(len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values()),
          "MoE metrics missing or not finite")
    check(launched == only(flash_attn_fwd=depth * BATCHES_1B),
          f"MoE serving launches {launched}, want flash_attn_fwd = depth x batches")
    out["test_s_per_batch"], out["test_launches"] = test_s / BATCHES_1B, launched["flash_attn_fwd"]
    out["metrics"] = {k: v for k, v in metrics.items() if k.endswith("aggregate")}
    loader = iter(dm.test_dataloader())
    batch = next(loader)
    loader.close()
    x = torch.from_numpy(batch[0]).cuda()
    y = torch.from_numpy(batch[1]).cuda()
    with torch.no_grad(), trunk_outputs(model) as trunks, router_choices(model) as routes:
        pred = model(x, in_vars, out_vars).float()
        set_attention_impl(model, "xla")
        pred_plain = model(x, in_vars, out_vars).float()
        set_attention_impl(model, m.attention_impl)
        torch.cuda.synchronize()
    want_shape = (b, len(out_vars)) + tuple(out_shape[2:])
    check(tuple(pred.shape) == want_shape and bool(pred.isfinite().all()),
          f"bad MoE prediction {tuple(pred.shape)}, want {want_shape}")
    per_block, flipped = flips(*routes)
    agree = ~flipped
    trunk, trunk_plain = trunks
    rel_pred, rel_trunk = rel_frob(pred, pred_plain), rel_frob(trunk, trunk_plain)
    rel_agree = rel_frob(trunk[agree], trunk_plain[agree])
    out["prediction"] = {
        "flips_per_moe_block": per_block, "tokens_flipped": int(flipped.sum()),
        "tokens": flipped.numel(), "pred_rel_vs_plain": rel_pred,
        "pred_max_abs_vs_plain": (pred - pred_plain).abs().max().item(),
        "trunk_rel_vs_plain": rel_trunk, "trunk_rel_routed_alike": rel_agree}
    print(f"  bf16 prediction of one batch, kernels vs plain attention: the routers' top-1 "
          f"choices differ at {per_block} of {flipped.numel()} tokens in MoE Blocks "
          f"{moe_blocks} ({int(flipped.sum())} tokens routed otherwise somewhere); prediction "
          f"relative Frobenius error {rel_pred:.4e}, max|d| "
          f"{out['prediction']['pred_max_abs_vs_plain']:.3e} (max|pred| "
          f"{pred_plain.abs().max().item():.3e}); the trunk's output {rel_trunk:.4e}, on the "
          f"{int(agree.sum())} tokens routed alike {rel_agree:.4e} (bound {TRUNK_BF16_REL:g} "
          f"for the prediction and the tokens routed alike)")
    check(rel_pred <= TRUNK_BF16_REL and rel_agree <= TRUNK_BF16_REL,
          f"the MoE prediction on the kernels is {rel_pred} off the plain attention's, the "
          f"trunk on the tokens routed alike {rel_agree}")
    n = WITNESS_TILES_MOE
    with torch.no_grad(), router_choices(model) as ref_routes:
        model.dtype = torch.float32  # every layer casts its bf16 weights to fp32 at use
        set_attention_impl(model, "xla")
        pred_ref = model(x[:n], in_vars, out_vars).float()
        model.dtype = torch.bfloat16
        set_attention_impl(model, m.attention_impl)
    witness = {}
    for label, got, got_routes in (("kernels", pred[:n], routes[0]),
                                   ("plain", pred_plain[:n], routes[1])):
        diff = (got - pred_ref).abs()
        witness[label] = {"rel": rel_frob(got, pred_ref), "max_abs": diff.max().item(),
                          "flips_vs_fp32": flips([r[:n] for r in got_routes], ref_routes[0])[0]}
    out["witness_fp32"] = dict(witness, tiles=n, max_abs_ref=pred_ref.abs().max().item())
    print(f"  witness: the first {n} tiles' bf16 predictions against the same weights computing "
          f"in fp32 on the plain attention (max|pred| {out['witness_fp32']['max_abs_ref']:.3e}): "
          + "; ".join(f"{label}: relative Frobenius error {w['rel']:.4e}, max|d| "
                      f"{w['max_abs']:.3e}, top-1 choices off fp32's {w['flips_vs_fp32']}"
                      for label, w in witness.items())
          + f" (the kernels' path within {WITNESS_RATIO:g}x the plain path's)")
    check(all(witness["kernels"][key] <= WITNESS_RATIO * witness["plain"][key]
              for key in ("rel", "max_abs")),
          f"the MoE bf16 prediction on the kernels is further from fp32 than the plain path's: "
          f"{witness}")
    del pred_plain, trunk, trunk_plain, trunks, pred_ref, routes, ref_routes
    lap("moe1b kernels, test, witness")

    dm_vis = make_data_module(cfg, ev.data_key, 1, 0, "test")
    sample, _, names, _ = next(iter(dm_vis.data_test))
    x_full = np.stack([sample[k] for k in names])
    reset_counts()
    field, stitch_s = stitch_field(model, x_full, div, overlap, mag, in_vars, out_vars)
    stitch_launched = counts()
    set_attention_impl(model, "xla")
    field_plain, _ = stitch_field(model, x_full, div, overlap, mag, in_vars, out_vars)
    set_attention_impl(model, m.attention_impl)
    rel_field = float(np.linalg.norm(field - field_plain) / np.linalg.norm(field_plain))
    want_field = (len(out_vars), x_full.shape[1] * mag, x_full.shape[2] * mag)
    out["stitch"] = {"seconds": stitch_s, "launches": stitch_launched["flash_attn_fwd"],
                     "rel_vs_plain": rel_field}
    print(f"  stitched field 0: {x_full.shape} -> {field.shape} from {div * div} tiles in "
          f"{stitch_s:.3f} s; launches {stitch_launched}; against the same field on the plain "
          f"attention: relative Frobenius error {rel_field:.4e} (bound {TRUNK_BF16_REL:g})")
    check(field.shape == want_field and bool(np.isfinite(field).all()),
          f"MoE stitched field {field.shape}, want {want_field}, or not finite")
    check(stitch_launched == only(flash_attn_fwd=depth * div * div),
          f"MoE stitching launched {stitch_launched}")
    check(rel_field <= TRUNK_BF16_REL, f"the stitched MoE field is {rel_field} off the plain "
          f"attention's")
    del field, field_plain

    reset_counts()
    ens = get_monte_carlo_predictions(model, x, in_vars, out_vars, MC_SAMPLES_MOE,
                                      torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    mc_counts = counts()
    again = get_monte_carlo_predictions(model, x, in_vars, out_vars, MC_SAMPLES_MOE,
                                        torch.Generator().manual_seed(seed))
    want_mc = only(flash_attn_fwd=MC_SAMPLES_MOE * depth,
                   fused_dropout=MC_SAMPLES_MOE * (1 + sites))
    print(f"  MC dropout, {MC_SAMPLES_MOE} samples of one batch at drop_rate {m.drop_rate}: "
          f"{tuple(ens.shape)}, mean member std {ens.float().std(dim=0).mean().item():.4e}; "
          f"launches {mc_counts} (K5 at pos_drop and {sites} sites: 3 a dense Block, 2 an MoE "
          f"Block, whose output is dropped and its experts' hidden not)")
    check(tuple(ens.shape) == (MC_SAMPLES_MOE,) + want_shape and bool(ens.isfinite().all()),
          f"bad MoE MC ensemble {tuple(ens.shape)}")
    check(mc_counts == want_mc, f"MoE MC dropout launches {mc_counts}, want {want_mc}")
    check(not torch.equal(ens[0], ens[1]) and torch.equal(ens, again),
          "MC-dropout samples are equal, or the same seed gave others")
    out["mc_launches"] = mc_counts
    del ens, again
    serve_step = make_eval_step(model, in_vars, out_vars)
    out["serve_step_ms"] = cuda_ms(lambda: serve_step(x, y), iters=3, warmup=1)
    print(f"  serving step (forward + clip), batch {b} tiles: {out['serve_step_ms']:.3f} ms by "
          f"events (median of 3); gpu: {smi}")
    del serve_step, x, y, pred

    # training, from the served bf16 weights (fp32 masters of them)
    tcfg = config_moe(root / "train", seed, trainer={"batch_size": BATCH_TRAIN_1B,
                                                      "grad_accum": GRAD_ACCUM_MOE},
                      n_files=FIELDS_TRAIN_1B, t=1, shards=("train",))
    tc = tcfg.trainer
    micro = tc.batch_size // tc.grad_accum
    check(tc.remat and tc.remat_policy == "full" and tc.adam_mu_dtype == "bfloat16",
          "interm_1b_moe.yaml no longer trains with full remat and bf16 moments")
    before = fingerprints(model)
    gc.collect()
    torch.cuda.empty_cache()  # the fp32 masters in segments of their own
    trainer = Trainer(tcfg, "cuda")
    key = next(iter(tcfg.data.low_res_dir))
    tdm = trainer.data_module(key)
    trainer.build_model(tdm, model.state_dict())
    del ev, model, routers, dm, dm_vis
    lap("moe1b stitched field, MC, serving step")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = 2 * TRAIN_STEPS_1B
    print(f"  training: batch {tc.batch_size} tiles in grad_accum {tc.grad_accum} microbatches "
          f"of {micro}, remat {tc.remat_policy}, adam mu {tc.adam_mu_dtype} nu "
          f"{tc.adam_nu_dtype}, drop_rate {m.drop_rate} drop_path {m.drop_path}; 2 epochs x "
          f"{TRAIN_STEPS_1B} steps on a synthetic train split of {FIELDS_TRAIN_1B} fields")
    reset_counts()
    tt = time.perf_counter()
    history = trainer.fit(max_epochs=2, max_steps_per_epoch=TRAIN_STEPS_1B)
    torch.cuda.synchronize()
    fit_s, fit_launched = time.perf_counter() - tt, counts()
    fit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for rec in history:
        print(f"    {json.dumps(rec)}")
    want = only(**{k: v * steps * tc.grad_accum
                   for k, v in remat_launches(depth, moe_blocks=n_moe).items()})
    print(f"  fit {fit_s:.3f} s, card peak {fit_peak:.2f} GiB; launches {fit_launched}")
    lap("moe1b fit")
    check(sum(r["batches"] for r in history) == steps, f"fit took {history}")
    check(all(np.isfinite(r["loss"]) for r in history), "an MoE train loss is not finite")
    check(fit_launched == want, f"MoE train launches {fit_launched}, want {want}")
    model = trainer.model
    params = dict(model.named_parameters())
    after = fingerprints(model)
    fed = {k for k, p in params.items() if p.grad is not None}
    still = [k for k in fed if ".moe_mlp." not in k and torch.equal(after[k], before[k])]
    router_still = [k for k in after if k.endswith("router_kernel")
                    and torch.equal(after[k], before[k])]
    took, expert_still = 0, []
    for i in moe_blocks:
        name = f"blocks.{i}.moe_mlp.wi"
        received = (params[name].grad != 0).flatten(1).any(dim=1).cpu()  # the last step's
        took += int(received.sum())
        for e in received.nonzero().flatten().tolist():
            if any(torch.equal(after[f"blocks.{i}.moe_mlp.{w}"][e], before[f"blocks.{i}.moe_mlp.{w}"][e])
                   for w in ("wi", "wo")):
                expert_still.append((i, e))
    print(f"  moved (by fingerprint: fp64 sum and sum of squares, per expert): "
          f"{len(fed) - len(still) - sum('.moe_mlp.' in k for k in fed)} of the dense parameters "
          f"the loss reaches, the {n_moe} routers, and the {took} of {n_moe * m.moe_experts} "
          f"experts that took tokens in the last step; all fp32 masters "
          f"{all(p.dtype == torch.float32 for p in params.values())}")
    check(not still and not router_still and not expert_still and took > 0
          and all(p.dtype == torch.float32 for p in params.values()),
          f"MoE parameters did not move: {still[:3]} {router_still} {expert_still}")
    del before, after

    loader = iter(tdm.train_dataloader())
    batch = next(loader)
    loader.close()
    tvars_in, tvars_out = tdm.get_data_variables()
    xb = torch.from_numpy(batch[0]).to(torch.bfloat16).cuda()
    yb = torch.from_numpy(batch[1]).to(torch.bfloat16).cuda()
    with torch.no_grad():
        _, aux = model.train()(xb[:MICRO_1B], tvars_in, tvars_out, *gens(seed + 31),
                               return_aux=True)
    aux = [a.item() for a in aux]
    aux_mean = sum(aux) / len(aux)
    out["aux"] = {"per_moe_block": aux, "mean": aux_mean, "weight": m.moe_aux_weight,
                  "term": m.moe_aux_weight * aux_mean}
    print(f"  the load-balance losses of a train-mode forward at {MICRO_1B} tiles after the fit: "
          f"{[round(a, 5) for a in aux]}, mean {aux_mean:.5f} in [1, {m.moe_experts}], x weight "
          f"{m.moe_aux_weight} = {m.moe_aux_weight * aux_mean:.6f} of the train loss")
    check(all(np.isfinite(aux)) and 1.0 <= aux_mean <= m.moe_experts,
          f"the MoE aux term {aux} is not in [1, E]")

    # remat full and dots against none, one microbatch, bit for bit
    no_update = types.SimpleNamespace(step=lambda: None)
    grad_step = make_train_step(model, trainer.train_loss, tcfg.data.var_weights, no_update,
                                tvars_in, tvars_out, moe_aux_weight=m.moe_aux_weight)
    first = None
    torch.use_deterministic_algorithms(True)
    try:
        for remat, policy in ((True, "full"), (True, "dots"), (False, "full")):
            model.remat, model.remat_policy = remat, policy
            g1, g2 = gens(seed + 23)
            reset_counts()
            loss = grad_step(xb[:MICRO_1B], yb[:MICRO_1B], g1, g2)
            torch.cuda.synchronize()
            run = (loss, {k: p.grad for k, p in params.items() if p.grad is not None},
                   (g1.get_state(), g2.get_state()))
            label = policy if remat else "none"
            print(f"  deterministic step at {MICRO_1B} tiles, remat {label}: loss "
                  f"{loss.item():.7f}; launches {counts()}")
            check(counts() == only(**remat_launches(depth, remat, n_moe)),
                  f"MoE remat {label} step launched {counts()}")
            if first is None:
                first = run
                continue
            same = (torch.equal(run[0], first[0]) and run[1].keys() == first[1].keys()
                    and all(torch.equal(run[1][k], first[1][k]) for k in first[1])
                    and all(torch.equal(a, b) for a, b in zip(run[2], first[2])))
            check(same, f"MoE remat {label} differs from remat full: loss {run[0].item()!r} vs "
                  f"{first[0].item()!r}")
            del run
    finally:
        torch.use_deterministic_algorithms(False)
        model.remat, model.remat_policy = tc.remat, tc.remat_policy
    print(f"  remat full, dots and none: losses, all {len(first[1])} gradients (the routers' "
          f"and experts' among them) and both generators' states equal bit for bit")
    del first
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # the training path's attention and dropout kernels at its shapes
    for bt in sorted({micro, MICRO_1B}):
        q, k, v = make_qkv(bt, tokens, tokens, h, d, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        errs[("train", bt)] = check_batch_rows(q, k, v, do, m.drop_rate, kseed,
                                               sorted({0, bt - 1}),
                                               f"bf16 drop {m.drop_rate:g} B{bt} N{tokens} H{h} "
                                               f"d{d}")
        del q, k, v, do
        torch.cuda.empty_cache()
    for c in (m.embed_dim, hidden):
        check_dropout(micro * tokens, c, torch.bfloat16, m.drop_rate, gen, kseed)
    torch.cuda.empty_cache()

    # the step's time, memory, kernel split and MFU
    tstep = make_train_step(model, trainer.train_loss, tcfg.data.var_weights, trainer.optimizer,
                            tvars_in, tvars_out, grad_accum=tc.grad_accum,
                            moe_aux_weight=m.moe_aux_weight)
    g1, g2 = gens(seed + 29)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: tstep(xb, yb, g1, g2), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    kern, kinds, by_name = step_split(lambda: tstep(xb, yb, g1, g2), xb.shape[0] // tc.grad_accum,
                                      m.moe_experts, m.moe_experts * capacity, hidden)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    model_flops, hw_flops, naive_flops = moe_flops(model, xb.shape[0], tokens, h, d)
    step = {"batch_tiles": xb.shape[0], "tokens_per_tile": tokens, "grad_accum": tc.grad_accum,
            "remat": tc.remat_policy, "step_ms": ms, "kernel_ms": kern, "busy": kern / ms,
            "tiles_per_s": xb.shape[0] / ms * 1e3, "peak_gib": peak / 2 ** 30,
            "step_gib": (peak - base) / 2 ** 30, "fit_peak_gib": fit_peak,
            "model_tflop": model_flops / 1e12, "hardware_tflop": hw_flops / 1e12,
            "mfu": model_flops / (ms * 1e-3) / PEAK_FLOPS,
            "hfu": hw_flops / (ms * 1e-3) / PEAK_FLOPS,
            "dense_count_mfu": naive_flops / (ms * 1e-3) / PEAK_FLOPS, "fit_s": fit_s,
            "by_kind": kinds, "losses": [r["loss"] for r in history],
            "kernels": {name[:80]: t for name, t in top}}
    free_gib = torch.cuda.mem_get_info()[1] / 2 ** 30 - max(fit_peak, step["peak_gib"])
    print(f"  MoE train step, batch {xb.shape[0]} tiles of {tokens} tokens, grad_accum "
          f"{tc.grad_accum}, remat {tc.remat_policy}: {ms:.3f} ms by events (median of 3 after a "
          f"warm-up), {step['tiles_per_s']:.2f} tiles/s; kernel time {kern:.3f} ms (busy "
          f"{step['busy']:.3f}); peak memory {step['peak_gib']:.2f} GiB ({step['step_gib']:.2f} "
          f"the step's own; the fit's {fit_peak:.2f}; {free_gib:.2f} GiB of the card never "
          f"used); executed products {step['model_tflop']:.1f} TFLOP a step, MFU "
          f"{step['mfu']:.4f}; with the recomputation {step['hardware_tflop']:.1f} TFLOP, "
          f"{step['hfu']:.4f}; 6 x params x tokens (every expert on every token) would read "
          f"{step['dense_count_mfu']:.4f}; of {PEAK_FLOPS / 1e12:.0f} TFLOP/s; gpu: {smi}")
    print("    by kind: " + ", ".join(f"{kind} {t:.3f} ms" for kind, t in kinds.items()))
    for name, t in top:
        print(f"    {t:9.4f} ms  {name[:110]}")
    out["train"] = step
    out["fit_launches"] = fit_launched
    lap("moe1b checks and step after the fit")
    train_shape = (micro, tokens, h, d)
    del trainer, model, params, tstep, grad_step, xb, yb
    gc.collect()
    torch.cuda.empty_cache()

    m1b = {"shape": train_shape, "rate": m.drop_rate, "launched": fit_launched,
           "steps": steps * tc.grad_accum, "width": (m.embed_dim, hidden)}
    rows = train_1b_times(m1b, gen, kseed, call_s, smi, label="moe 1B")
    rows["serve"] = k1_row(b, tokens, h, d, 0.0, gen, kseed, call_s, smi,
                           out["test_launches"], chunk=MICRO_1B)
    out["errors"] = {"serve_k1": errs[("serve", 0.0)], "serve_k1_drop": errs[("serve", m.drop_rate)],
                     "tile_k1": errs[("tile", 0.0)],
                     **{f"train_{name}": e for name, e in errs[("train", micro)].items()}}
    out["rows"] = rows
    return {"out": out, "rows": rows, "errs": errs[("train", micro)],
            "serve_err": errs[("serve", 0.0)]}


def k1_row(b, n, h, d, rate, gen, seed, call_s, smi, launches, chunk=None):
    """K1's row at (b, n, h, d) bf16 with dropout `rate`: by events and by its
    kernel time alone, its plain version (`chunk` batch elements at a time,
    where the whole batch's scores would not fit; None: at once), SDPA's
    flash forward and its bound (tensor cores and bytes, with dropout also
    its Philox calls). Prints it; `launches` is the path's count, or None
    where the caller fills it in."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.flash_attention import (
        attention_flops, attention_mult, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    q, k, v = make_qkv(b, n, n, h, d, torch.bfloat16, gen)
    leaves = [t.transpose(1, 2) for t in (q, k, v)]
    bound = roofline(attention_flops(b, n, n, h, d), nbytes(q, k, v, q) + 4 * b * h * n)
    philox = b * h * n * n / ELEMENTS_PER_CALL * call_s["fwd"] * 1e3
    fn = lambda: flash_attention_fwd(q, k, v, None, rate, seed)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.no_grad():
        lib = best_ms(lambda: F.scaled_dot_product_attention(*leaves, dropout_p=rate))
    if chunk is None:
        mult = attention_mult(q, k, rate, seed)
        plain = cuda_ms(lambda: flash_attention_reference(q, k, v, None, mult), iters=3,
                        warmup=1)
    else:
        parts = [slice(i, min(b, i + chunk)) for i in range(0, b, chunk)]
        mult = [keep_mult(seed, n, n, rate, streams=(sl.stop - sl.start) * h, device="cuda",
                          first_stream=sl.start * h) if rate > 0.0 else None for sl in parts]

        def chunked():
            for sl, mu in zip(parts, mult):
                flash_attention_reference(q[sl], k[sl], v[sl], None, mu)

        plain = cuda_ms(chunked, iters=3, warmup=1)
    del mult
    torch.cuda.empty_cache()
    row_bound = bound if rate == 0.0 else max(bound, (philox, "operations"))
    r = {"shape": [b, n, h, d], "dropout": rate, "ms": cuda_ms(fn), "kernel_ms": kernel_ms(fn),
         "plain_ms": plain, "library_ms": lib, "bound_ms": row_bound[0],
         "bound_by": row_bound[1], "launches": launches}
    print(f"  K1 bf16 B{b} N{n} H{h} d{d} drop {rate:g}: {r['ms']:.4f} ms (kernel alone "
          f"{r['kernel_ms']:.4f}, {row_bound[0] / r['kernel_ms']:.3f} of the bound), plain "
          f"{plain:.4f}, SDPA (flash) {lib:.4f} ({r['kernel_ms'] / lib:.2f}x by kernel time); "
          f"bound {row_bound[0]:.4f} ({row_bound[1]}; tensor cores {bound[0]:.4f}, Philox "
          f"{philox:.4f}); "
          + (f"{launches} launches on the path" if launches is not None else
             "launched by both stitched fields") + f"; gpu: {smi}")
    del q, k, v, leaves
    torch.cuda.empty_cache()
    return r


def step_kinds(by_name):
    """A step's kernel ms by kind, from its kernel names: int8 products
    (CUTLASS s8 GEMMs), other products (bf16 GEMMs and convolutions), K1,
    and the other kernels (elementwise, copies, reductions, norms)."""
    kinds = dict.fromkeys(("int8_products", "products", "k1", "other"), 0.0)
    for name, t in by_name.items():
        if "flash_fwd" in name:
            kinds["k1"] += t
        elif "gemm_s8" in name or "imma" in name:
            kinds["int8_products"] += t
        elif any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass", "conv")):
            kinds["products"] += t
        else:
            kinds["other"] += t
    return kinds


def serving_1b_times(s, gen, seed, call_s, smi):
    """Phase 6 for the tiled 1B path: the bf16 and w8a8 serving steps by
    events and by the kernel time of every kernel a step launches (the
    device's busy share), their peak memory, the stitched field's wall time,
    K1's rows at the path's shape and the w8a8 route's parts at the trunk's
    four products. Prints them, and returns them for the {"serving_1b"} line."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.flash_attention import (
        attention_flops, attention_mult, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.quant import (
        int8_matmul, quantize_rows, quantize_weight, rescale, w8a8_matmul)
    from orbit2_tpu_torch.training.train import make_eval_step

    ev, x, y = s["ev"], s["x"], s["y"]
    m = ev.cfg.model
    cfg = ev.cfg
    div, overlap = cfg.tiling.effective_div, cfg.tiling.effective_overlap
    steps = {"bf16": make_eval_step(ev.model, s["in_vars"], s["out_vars"]),
             "w8a8": make_eval_step(s["qmodel"], s["in_vars"], s["out_vars"])}
    t0 = time.perf_counter()
    ms = dict(zip(("w8a8", "bf16"), paired_ms(lambda: steps["w8a8"](x, y),
                                              lambda: steps["bf16"](x, y), iters=5)))
    out = {"gpu": smi, "batch_tiles": x.shape[0], "tokens_per_tile": s["tokens"],
           "loader_s_per_batch": s["data_s"]}
    for label, step in steps.items():
        by_name = {}
        kern = kernel_ms(lambda: step(x, y), iters=5, by_name=by_name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(x, y)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        _, wall = stitch_field(s["qmodel"] if label == "w8a8" else ev.model, s["x_full"], div,
                               overlap, m.superres_mag, s["in_vars"], s["out_vars"])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[label] = {"step_ms": ms[label], "kernel_ms": kern, "busy": kern / ms[label],
                      "peak_gib": peak / 2 ** 30, "step_gib": (peak - base) / 2 ** 30,
                      "stitch_s": wall, "test_s_per_batch": s["test_s" if label == "bf16"
                                                               else "test_q_s"] / BATCHES_1B,
                      "by_kind": step_kinds(by_name),
                      "kernels": {name[:80]: t for name, t in top}}
        print(f"  serving 1B {label} step, batch {x.shape[0]} tiles of {s['tokens']} tokens: "
              f"{ms[label]:.3f} ms by events (the better of two medians of 5, in turns), "
              f"kernel time {kern:.3f} ms (busy {kern / ms[label]:.3f}); peak memory "
              f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} the step's own); "
              f"stitched field {wall:.3f} s; gpu: {smi}")
        print("    by kind: " + ", ".join(f"{kind} {t:.3f} ms"
                                         for kind, t in out[label]["by_kind"].items()))
        for name, t in top:
            print(f"    {t:9.4f} ms  {name[:110]}")

    seconds = {"steps": time.perf_counter() - t0}
    t0 = time.perf_counter()
    b, n, h, d = x.shape[0], s["tokens"], m.num_heads, m.embed_dim // m.num_heads
    q, k, v = make_qkv(b, n, n, h, d, torch.bfloat16, gen)
    leaves = [t.transpose(1, 2) for t in (q, k, v)]
    bound = roofline(attention_flops(b, n, n, h, d), nbytes(q, k, v, q) + 4 * b * h * n)
    philox = b * h * n * n / ELEMENTS_PER_CALL * call_s["fwd"] * 1e3
    out["k1"] = []
    for rate in (0.0, DROP):
        fn = lambda: flash_attention_fwd(q, k, v, None, rate, seed)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.no_grad():
            lib = best_ms(lambda: F.scaled_dot_product_attention(*leaves, dropout_p=rate))
        # the plain version holds [B H, N, N] fp32 scores (7.3 GB here): a few calls
        mult = attention_mult(q, k, rate, seed)
        plain = cuda_ms(lambda: flash_attention_reference(q, k, v, None, mult), iters=5,
                        warmup=1)
        del mult
        torch.cuda.empty_cache()
        row_bound = bound if rate == 0.0 else max(bound, (philox, "operations"))
        row = {"shape": [b, n, h, d], "dropout": rate, "launches_per_batch": m.depth,
               "ms": cuda_ms(fn), "kernel_ms": kernel_ms(fn), "plain_ms": plain, "sdpa_ms": lib,
               "bound_ms": row_bound[0], "bound_by": row_bound[1]}
        out["k1"].append(row)
        print(f"  K1 bf16 B{b} N{n} H{h} d{d} drop {rate:g}: {row['ms']:.4f} ms (kernel alone "
              f"{row['kernel_ms']:.4f}), plain {plain:.4f}, SDPA (flash) {lib:.4f}; bound "
              f"{row_bound[0]:.4f} ({row_bound[1]}); {m.depth} launches a batch; gpu: {smi}")
    del q, k, v, leaves
    seconds["k1"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    rows, dim, hidden = b * n, m.embed_dim, int(m.embed_dim * m.mlp_ratio)
    out["w8a8_route"] = []
    # the trunk's four products, [K -> N]: qkv, proj, fc1, fc2
    for kk, nn in ((dim, 3 * dim), (dim, dim), (dim, hidden), (hidden, dim)):
        xb = torch.randn(rows, kk, generator=gen, device=gen.device).to(torch.bfloat16)
        w = torch.randn(nn, kk, generator=gen, device=gen.device) * kk ** -0.5
        bias = torch.randn(nn, generator=gen, device=gen.device) * 0.1
        wq, ws = quantize_weight(w)
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        xq, xs = quantize_rows(xb)
        acc = int8_matmul(xq, wq)
        ops = 2 * rows * kk * nn
        int8 = lambda moved: max((ops / PEAK_INT8_OPS * 1e3, "operations"),
                                 (moved / PEAK_BYTES_PER_S * 1e3, "bytes"))
        parts = {
            "quant": (lambda: quantize_rows(xb), roofline(0, 3 * rows * kk + 4 * rows)),
            "int_mm": (lambda: int8_matmul(xq, wq), int8(rows * kk + nn * kk + 4 * rows * nn)),
            "rescale": (lambda: rescale(acc, xs, ws, bias, torch.bfloat16),
                        roofline(0, 6 * rows * nn + 4 * rows + 8 * nn)),
            "w8a8_matmul": (lambda: w8a8_matmul(xb, wq, ws, bias),
                            int8(2 * rows * kk + nn * kk + 8 * nn + 2 * rows * nn)),
            "bf16_linear": (lambda: F.linear(xb, wb, bb),
                            roofline(ops, 2 * (rows * kk + nn * kk + nn + rows * nn))),
        }
        row = {"m": rows, "k": kk, "n": nn}
        for name, (fn, (bound_ms, bound_by)) in parts.items():
            row[name] = {"ms": cuda_ms(fn, iters=10), "kernel_ms": kernel_ms(fn, iters=5),
                         "bound_ms": bound_ms, "bound_by": bound_by}
        out["w8a8_route"].append(row)
        print(f"  w8a8 route [{rows}, {kk}] x [{kk}, {nn}]: " + "; ".join(
            f"{name} {r['ms']:.4f} ms (kernel {r['kernel_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']})" for name, r in row.items() if isinstance(r, dict))
            + f"; gpu: {smi}")
        del xb, w, bias, wq, ws, wb, bb, xq, xs, acc
        torch.cuda.empty_cache()
    seconds["w8a8_route"] = time.perf_counter() - t0
    out["seconds"] = seconds
    print("  serving 1B times took " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    # the two steps run the same elementwise work but for the trunk's w8a8
    # quantization and rescale passes (bf16 F.linear adds its bias in the
    # product's epilogue): the difference of their "other" kernels
    quant_rescale = out["w8a8"]["by_kind"]["other"] - out["bf16"]["by_kind"]["other"]
    out["w8a8"]["quant_rescale_ms"] = quant_rescale
    out["w8a8"]["quant_rescale_share"] = quant_rescale / out["w8a8"]["kernel_ms"]
    print(f"  w8a8 step, by the two steps' profiles: the quantization and rescale passes of its "
          f"{4 * m.depth} trunk products take {quant_rescale:.3f} ms of its "
          f"{out['w8a8']['kernel_ms']:.3f} ms of kernel time "
          f"({out['w8a8']['quant_rescale_share']:.3f}; its other kernels less the bf16 step's)")
    return out


def train_1b_times(t1b, gen, seed, call_s, smi, label="train 1B", chunk=MICRO_1B):
    """Phase 6 for a 1B training path (train1b's fit, resume1b's fine-tune):
    K1 (with the path's dropout), K2, K3 at its attention shape and K5 at its
    [tokens, width] and [tokens, 4 width], bf16, each by events and by its
    kernel time alone, beside its plain version (over the same inputs,
    `chunk` batch elements at a time, each under its own streams'
    multiplier, made before the timing: the whole batch's [B H, N, N] fp32
    tensors would not fit), its library call (SDPA's flash backend, its
    whole backward for K2 and K3; F.dropout) and its bound. Returns the rows
    by kernel name."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.dropout import FusedDropout, dropout_reference
    from orbit2_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, attention_delta, attention_flops,
        flash_attention_bwd_reference, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    b, n, h, d = t1b["shape"]
    rate = t1b["rate"]
    q, k, v = make_qkv(b, n, n, h, d, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    delta = attention_delta(o, do)
    parts = [slice(i, min(b, i + chunk)) for i in range(0, b, chunk)]
    mults = [keep_mult(seed, n, n, rate, streams=(sl.stop - sl.start) * h, device="cuda",
                       first_stream=sl.start * h) for sl in parts]

    def plain_fwd():
        for sl, mult in zip(parts, mults):
            flash_attention_reference(q[sl], k[sl], v[sl], None, mult)

    def plain_bwd():
        for sl, mult in zip(parts, mults):
            flash_attention_bwd_reference(q[sl], k[sl], v[sl], o[sl], lse[sl.start * h:sl.stop * h],
                                          do[sl], d ** -0.5, mult)

    att = attention_flops(b, n, n, h, d)
    rows_f32 = 4 * b * h * n
    calls = b * h * n * n / ELEMENTS_PER_CALL
    check(rate == DROP, f"the 1B dropout rate {rate} is not the SDPA rows' {DROP}")
    lib = sdpa_ms(q, k, v, do)
    kernels_ = {
        "flash_attn_fwd": (lambda: flash_attention_fwd(q, k, v, None, rate, seed), plain_fwd,
                           lib["fwd"][DROP],
                           roofline(att, nbytes(q, k, v, q) + rows_f32), "fwd"),
        "flash_attn_bwd_dq": (lambda: FLASH_BWD_DQ(q, k, v, do, lse, delta, d ** -0.5, rate, seed),
                              plain_bwd, lib["bwd"],
                              roofline(1.5 * att, nbytes(q, k, v, do, q) + 2 * rows_f32), "dq"),
        "flash_attn_bwd_dkv": (lambda: FLASH_BWD_DKV(q, k, v, do, lse, delta, d ** -0.5, rate,
                                                     seed), plain_bwd, lib["bwd"],
                               roofline(2 * att, nbytes(q, k, v, do, k, v) + 2 * rows_f32), "dkv"),
    }
    rows = {}
    plain_ms = {}
    for name, (fn, plain, library, bound, op) in kernels_.items():
        if plain not in plain_ms:
            plain_ms[plain] = cuda_ms(plain, iters=3, warmup=1)
        bound = max(bound, (calls * call_s[op] * 1e3, "operations"))
        rows[name] = {"shape": [b, n, h, d], "dropout": rate, "ms": cuda_ms(fn),
                      "kernel_ms": kernel_ms(fn), "plain_ms": plain_ms[plain],
                      "library_ms": library, "bound_ms": bound[0], "bound_by": bound[1],
                      "launches_per_step": t1b["launched"][name] // t1b["steps"]}
    del q, k, v, do, o, lse, delta, mults
    torch.cuda.empty_cache()
    tokens = b * n
    for width in t1b["width"]:
        x = torch.randn(tokens, width, generator=gen, device="cuda").to(torch.bfloat16)
        mult = keep_mult(seed, tokens, width, rate, device="cuda")
        fn = lambda: FusedDropout.apply(x, seed, rate)
        bound = roofline(0, 2 * nbytes(x))
        # the last width (the Mlp hidden) keys the kernels line's K5 row; the
        # launches are K5's at both widths
        rows["fused_dropout"] = {
            "shape": [tokens, width], "dropout": rate, "ms": cuda_ms(fn),
            "kernel_ms": kernel_ms(fn), "plain_ms": cuda_ms(lambda: dropout_reference(x, mult)),
            "library_ms": best_ms(lambda: F.dropout(x, rate, training=True)),
            "bound_ms": bound[0], "bound_by": bound[1],
            "launches_per_step": t1b["launched"]["fused_dropout"] // t1b["steps"]}
        r = rows["fused_dropout"]
        print(f"  {label} fused_dropout bf16 [{tokens}, {width}]: {r['ms']:.4f} ms (kernel alone "
              f"{r['kernel_ms']:.4f}), plain {r['plain_ms']:.4f}, F.dropout {r['library_ms']:.4f}; "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}); gpu: {smi}")
        del x, mult
    torch.cuda.empty_cache()
    for name, r in rows.items():
        if name == "fused_dropout":
            continue  # printed above, at both widths
        print(f"  {label} {name} bf16 {r['shape']} drop {r['dropout']:g}: {r['ms']:.4f} ms "
              f"(kernel alone {r['kernel_ms']:.4f}), plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ({r['bound_by']}); "
              f"{r['launches_per_step']} launches a step; gpu: {smi}")
    return rows


def resume_1b_times(r1b, gen, seed, call_s, smi):
    """Phase 6 for resume1b: K1, K2, K3 and K5 at the fine-tune's shapes, as
    train_1b_times times them at the fit's (the plain versions two batch
    elements at a time: the fine-tune's tiles are larger), and the
    validation's K1 without dropout at a full val batch, by events and by
    its kernel time alone, beside its plain version (MICRO_1B batch elements
    at a time), SDPA's flash forward and its bound. Returns the rows by
    kernel name, the validation's K1 under "validation"."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.flash_attention import (
        attention_flops, flash_attention_fwd, flash_attention_reference)

    rows = train_1b_times(r1b["finetune"], gen, seed, call_s, smi, label="fine-tune 1B", chunk=2)
    b, n, h, d = r1b["validation"]["shape"]
    q, k, v = make_qkv(b, n, n, h, d, torch.bfloat16, gen)
    leaves = [t.transpose(1, 2) for t in (q, k, v)]
    parts = [slice(i, min(b, i + MICRO_1B)) for i in range(0, b, MICRO_1B)]

    def plain():
        for sl in parts:
            flash_attention_reference(q[sl], k[sl], v[sl], None, None)

    fn = lambda: flash_attention_fwd(q, k, v, None, 0.0, seed)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.no_grad():
        library = best_ms(lambda: F.scaled_dot_product_attention(*leaves))
    bound = roofline(attention_flops(b, n, n, h, d), nbytes(q, k, v, q) + 4 * b * h * n)
    row = {"shape": [b, n, h, d], "dropout": 0.0, "ms": cuda_ms(fn), "kernel_ms": kernel_ms(fn),
           "plain_ms": cuda_ms(plain, iters=3, warmup=1), "library_ms": library,
           "bound_ms": bound[0], "bound_by": bound[1], "launches": r1b["validation"]["launches"]}
    print(f"  validation 1B flash_attn_fwd bf16 {row['shape']}: {row['ms']:.4f} ms (kernel alone "
          f"{row['kernel_ms']:.4f}), plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}; "
          f"bound {row['bound_ms']:.4f} ({row['bound_by']}); {row['launches']} launches in the "
          f"phase's validations; gpu: {smi}")
    del q, k, v, leaves
    torch.cuda.empty_cache()
    rows["validation"] = row
    return rows


def write_forecast_dataset(root: Path, variables, seed: int, grid, n_files: int, t: int):
    """One grid of the tests/conftest.py layout (forecasting reads inputs
    and targets from it): n_files npz shards of [t, 1, H, W] hourly fields
    a split, normalize mean/std, lat/lon and every split's climatology."""
    rng = np.random.default_rng(seed)
    h, w = grid
    for split in ("train", "val", "test"):
        d = root / split
        d.mkdir(parents=True)
        for i in range(n_files):
            np.savez(d / f"shard_{i}.npz",
                     **{v: rng.normal(280, 10, size=(t, 1, h, w)).astype(np.float32)
                        for v in variables})
        np.savez(d / "climatology.npz",
                 **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32) for v in variables})
    np.save(root / "lat.npy", np.linspace(-87.1875, 87.1875, h).astype(np.float32))
    np.save(root / "lon.npy", np.linspace(0, 360 - 360 / w, w).astype(np.float32))
    np.savez(root / "normalize_mean.npz", **{v: np.array([280.0], np.float32) for v in variables})
    np.savez(root / "normalize_std.npz", **{v: np.array([10.0], np.float32) for v in variables})
    return str(root)


def forecast_raw(root: Path, seed: int):
    """configs/forecast.yaml's raw sections as shipped (its mesh fsdp 4 x
    simple_ddp 2), on write_forecast_dataset's synthetic grid."""
    import yaml

    raw = yaml.safe_load(CONFIG_FORECAST.read_text())
    data = raw["data"]
    key = next(iter(data["low_res_dir"]))
    path = write_forecast_dataset(root, data["dict_in_variables"][key], seed, GRID_FORECAST,
                                  FORECAST_FILES, FORECAST_T)
    data["low_res_dir"], data["high_res_dir"] = {key: path}, {key: path}
    return raw


def forecast_config(root: Path, seed: int):
    """configs/forecast.yaml with its mesh cut to the card, on
    write_forecast_dataset's synthetic grid."""
    from orbit2_tpu_torch.config import load_config

    return to_one_card(load_config(forecast_raw(root, seed)))


def conv_train_flops(model, x_shape):
    """A train step's convolution flops: 6 x the conv weights x the output
    positions of each conv (2 a MAC, forward and the backward's two
    products), counted by forward hooks on one meta forward of x_shape."""
    flops = []

    def hook(mod, inp, out):
        flops.append(6 * mod.weight[0].numel() * out.numel())

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        meta = copy.deepcopy(model).to("meta").eval()
        with torch.no_grad():
            meta(torch.zeros(x_shape, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return float(sum(flops))


def k5_row(shape, dtype, rate, gen, seed, launches, smi, label):
    """K5's row at [rows, cols] of `dtype`: events, kernel time alone, its
    plain version (the mask precomputed), F.dropout, the bytes bound."""
    import torch.nn.functional as F

    from orbit2_tpu_torch.ops.dropout import FusedDropout, dropout_reference
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    r, c = shape
    check(launches > 0, f"{label}: K5 at [{r}, {c}] was launched no time on the path")
    x = torch.randn(r, c, generator=gen, device="cuda").to(dtype)
    mult = keep_mult(seed, r, c, rate, device="cuda")
    fn = lambda: FusedDropout.apply(x, seed, rate)  # noqa: E731
    ms, plain = paired_ms(fn, lambda: dropout_reference(x, mult))
    bound = roofline(0, 2 * nbytes(x))
    row = {"shape": [r, c], "dtype": str(dtype)[6:], "dropout": rate, "ms": ms,
           "kernel_ms": kernel_ms(fn), "plain_ms": plain,
           "library_ms": best_ms(lambda: F.dropout(x, rate, training=True)),
           "bound_ms": bound[0], "bound_by": bound[1], "launches": launches}
    print(f"  {label} K5 {row['dtype']} [{r}, {c}]: {ms:.4f} ms (kernel alone "
          f"{row['kernel_ms']:.4f}, {bound[0] / row['kernel_ms']:.3f} of the bytes bound "
          f"{bound[0]:.4f}), plain {plain:.4f} (mask precomputed), F.dropout "
          f"{row['library_ms']:.4f}; {launches} launches on the path; gpu: {smi}")
    del x, mult
    torch.cuda.empty_cache()
    return row


def hub_kinds(by_name):
    """A step's kernel ms by kind, from its kernel names: K1, K2, K3, K5,
    products (GEMMs and convolutions), cuDNN's NCHW <-> NHWC layout
    conversions, and the other kernels (elementwise, BatchNorm's passes,
    reductions, copies)."""
    kinds = dict.fromkeys(("k1", "k2", "k3", "k5", "products", "layout", "other"), 0.0)
    for name, t in by_name.items():
        low = name.lower()
        if "flash_fwd" in name:
            kinds["k1"] += t
        elif "flash_bwd_dq" in name:
            kinds["k2"] += t
        elif "flash_bwd_dkv" in name:
            kinds["k3"] += t
        elif "dropout" in low:
            kinds["k5"] += t
        elif "nchwtonhwc" in low or "nhwctonchw" in low:
            kinds["layout"] += t
        elif any(tag in low for tag in ("gemm", "nvjet", "xmma", "cutlass", "conv", "wgrad",
                                        "dgrad", "fprop")):
            kinds["products"] += t
        else:
            kinds["other"] += t
    return kinds


def step_row(step, label, samples, flops, smi, iters=5):
    """A train step's time by events (median of `iters` after a warm-up),
    its kernel time by kind (hub_kinds), busy share, peak memory and its
    flops' share of the tensor-core peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, iters=iters, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    by_name = {}
    kern = kernel_ms(step, iters=3, by_name=by_name)
    row = {"step_ms": ms, "kernel_ms": kern, "busy": kern / ms, "idle": 1 - kern / ms,
           "samples_per_s": samples / ms * 1e3, "peak_gib": peak / 2 ** 30,
           "tflop": flops / 1e12, "flop_share": flops / (ms * 1e-3) / PEAK_FLOPS,
           "by_kind": hub_kinds(by_name),
           "kernels": {name[:80]: t for name, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}}
    print(f"  {label} train step: {ms:.3f} ms by events (median of {iters}), kernel time "
          f"{kern:.3f} ms (busy {row['busy']:.3f}, idle {row['idle']:.3f}); "
          f"{row['samples_per_s']:.2f} samples/s; peak memory {row['peak_gib']:.2f} GiB; "
          f"{row['tflop']:.3f} TFLOP a step, {row['flop_share']:.4f} of "
          f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s; gpu: {smi}")
    print("    by kind: " + ", ".join(f"{kind} {t:.3f} ms" for kind, t in row["by_kind"].items()))
    for name, t in row["kernels"].items():
        print(f"    {t:9.4f} ms  {name}")
    return row


def batchnorms(model):
    from orbit2_tpu_torch.models.components.cnn import BatchNorm2d

    return [m for m in model.modules() if isinstance(m, BatchNorm2d)]


def dropout_shapes(net, b, h, w, times=1):
    """K5's launches by [rows, cols] in `times` forwards of the hub model
    `net` on a batch of b [., h, w] fields, as a collections.Counter: for a
    ViT, pos_drop and a Block's attention projection and Mlp output at
    [b tokens, embed] and its Mlp hidden at [b tokens, hidden]; for a CNN,
    two a ResidualBlock at [b C h', w'], C its output channels and h' x w'
    the resolution it runs at (halved after each Downsample, doubled after
    each Upsample, in the order the forward runs them)."""
    import collections

    from orbit2_tpu_torch.models.components.blocks import Block
    from orbit2_tpu_torch.models.components.cnn import Downsample, ResidualBlock, Upsample

    got = collections.Counter()
    blocks = [m for m in net.modules() if isinstance(m, Block)]
    if blocks:
        rows = b * (h // net.patch_size) * (w // net.patch_size)
        got[(rows, net.embed_dim)] += times * (1 + 2 * len(blocks))
        for blk in blocks:
            got[(rows, blk.mlp.fc1.out_features)] += times
        return got
    for m in net.modules():
        if isinstance(m, Downsample):
            h, w = h // 2, w // 2
        elif isinstance(m, Upsample):
            h, w = 2 * h, 2 * w
        elif isinstance(m, ResidualBlock):
            got[(b * m.conv1.conv.out_channels * h, w)] += 2 * times
    return got


def forecast(root: Path, seed: int, smi):
    """Phase forecast: configs/forecast.yaml's ResNet trained, validated and
    tested on the card (module docstring)."""
    from orbit2_tpu_torch.evaluate import Evaluator, load_module, model_kwargs
    from orbit2_tpu_torch.training.optim import make_optimizer
    from orbit2_tpu_torch.training.train import make_train_step
    from orbit2_tpu_torch.training.trainer import Trainer

    cfg = forecast_config(root, seed)
    m, tc = cfg.model, cfg.trainer
    key = next(iter(cfg.data.low_res_dir))
    steps = 2 * FORECAST_STEPS
    print(f"  config {CONFIG_FORECAST.name}: preset {m.preset}, {tc.data_type}, batch "
          f"{tc.batch_size}, history {cfg.data.history} x {len(cfg.data.dict_in_variables[key])} "
          f"variables -> {len(cfg.data.dict_out_variables[key])} at {GRID_FORECAST}, pred_range "
          f"{cfg.data.pred_range}; 2 epochs x {FORECAST_STEPS} steps with validation")
    reset_counts()
    trainer = Trainer(cfg, "cuda", run_validation=True)
    tt = time.perf_counter()
    with launch_widths(kernels()["fused_dropout"]) as k5_widths:
        history = trainer.fit(max_epochs=2, max_steps_per_epoch=FORECAST_STEPS)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - tt
    launched = counts()
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    # forward and backward a step; nothing in validation
    want_widths = dropout_shapes(model, tc.batch_size, *GRID_FORECAST, times=2 * steps)
    for rec in history:
        print(f"    {json.dumps(rec)}")
    val = trainer.last_validation
    print(f"  fit {fit_s:.3f} s; {n_params:,} parameters; launches {launched}; validation over "
          f"{val['samples']} samples: " + ", ".join(f"{k} {v:.5f}" for k, v in val["means"].items()))
    check(sum(r["batches"] for r in history) == steps, f"fit took {history}")
    check(all(np.isfinite(r["loss"]) for r in history), "a forecast train loss is not finite")
    check(len(val["means"]) == 9 and all(np.isfinite(v) for v in val["means"].values()),
          "forecast validation means missing or not finite")
    want = only(fused_dropout=sum(want_widths.values()))
    check(launched == want, f"forecast launches {launched}, want {want}")
    check(k5_widths == want_widths, f"forecast K5 launches by [rows, cols] {dict(k5_widths)}, "
          f"want {dict(want_widths)}")
    print(f"  K5 launches by [rows, cols]: {dict(k5_widths)}")

    dm = trainer.data_module(key)
    in_vars, out_vars = dm.get_data_variables()
    init = load_module(cfg, dm, model_kwargs(cfg))[0].state_dict()  # the fit's draw, on the host
    still = [k for k, p in model.named_parameters() if torch.equal(p.detach().cpu(), init[k])]
    check(not still, f"forecast parameters did not move: {still}")
    norms = batchnorms(model)
    moved = [bn for bn in norms if not (torch.equal(bn.running_mean.cpu(), torch.zeros_like(
        bn.running_mean.cpu())) or torch.equal(bn.running_var.cpu(), torch.ones_like(
            bn.running_var.cpu())))]
    check(len(moved) == len(norms) == 2 * len(model.blocks) + 1,
          f"{len(norms) - len(moved)} of {len(norms)} BatchNorms kept their initial statistics")
    loader = iter(dm.test_dataloader())
    batch = next(loader)
    loader.close()
    x, y = torch.from_numpy(batch[0]).to("cuda"), torch.from_numpy(batch[1]).to("cuda")
    with torch.no_grad():
        pred = model.eval()(x).float()
        fresh = copy.deepcopy(model)
        for bn in batchnorms(fresh):
            bn.reset_running_stats()
        pred_fresh = fresh.eval()(x).float()
        del fresh
    want_shape = (x.shape[0], len(out_vars)) + GRID_FORECAST
    check(tuple(pred.shape) == want_shape and bool(pred.isfinite().all()),
          f"bad forecast {tuple(pred.shape)}, want {want_shape}")
    used = ((pred - pred_fresh).norm() / pred.norm()).item()
    print(f"  eval uses the running statistics: the prediction with them reset differs by "
          f"{used:.3e} (relative Frobenius)")
    check(used > 1e-3, "the eval-mode prediction does not read the BatchNorm running statistics")

    reset_counts()
    tt = time.perf_counter()
    ev = Evaluator(cfg, "cuda", state_dict=model.state_dict())
    metrics = ev.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - tt
    check(counts() == only(), f"forecast serving launched {counts()}")
    print(f"  Evaluator.test {test_s:.3f} s (build included): " +
          ", ".join(f"{k} {v:.5f}" for k, v in metrics.items()))
    check(len(metrics) == 6 and all(np.isfinite(v) for v in metrics.values()),
          "forecast test metrics missing or not finite")
    del ev

    # one seeded fp32 step with dropout, card (K5, cuDNN) against the CPU
    # (plain), and its witness: the same step in fp64 on the CPU. Through 19
    # train-mode BatchNorms at 4 samples the CPU's own fp32 gradients lie
    # ~1e-3 (weights) to ~1e-2 (the conv biases before a BatchNorm, whose
    # true gradient is 0) from fp64, so the card is held against the fp64
    # step as the CPU's fp32 step is: its gradients (relative Frobenius over
    # all of them) at most WITNESS_RATIO times as far
    results = []
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        mdl = copy.deepcopy(model).to(device=device, dtype=dtype)
        mdl.dtype = dtype
        opt = make_optimizer("adamw", {"lr": m.lr, "weight_decay": m.weight_decay,
                                       "betas": (m.beta_1, m.beta_2)}, mdl.named_parameters())
        step = make_train_step(mdl, trainer.train_loss, cfg.data.var_weights, opt, in_vars,
                               out_vars)
        loss = step(x[:4].to(device=device, dtype=dtype), y[:4].to(device=device, dtype=dtype),
                    *gens(11)).item()
        results.append((loss, {k: p.grad.cpu().double() for k, p in mdl.named_parameters()}))
        del mdl, opt, step
    (loss_gpu, g_gpu), (loss_cpu, g_cpu), (loss_64, g_64) = results
    norm = math.sqrt(sum(g.square().sum().item() for g in g_64.values()))
    far = lambda got: math.sqrt(sum((got[k] - g_64[k]).square().sum().item()  # noqa: E731
                                    for k in g_64)) / norm
    card_far, cpu_far = far(g_gpu), far(g_cpu)
    worst = max(((g_gpu[k] - g_cpu[k]).norm() / g_cpu[k].norm(), k) for k in g_cpu)
    print(f"  fp32 step with dropout: loss card (K5, cuDNN) {loss_gpu:.7f}, CPU (plain) "
          f"{loss_cpu:.7f}, CPU fp64 {loss_64:.7f}; gradients from fp64 (relative Frobenius "
          f"over all {len(g_64)}): card {card_far:.3e}, CPU fp32 {cpu_far:.3e} (card at most "
          f"{WITNESS_RATIO:g}x the CPU's); worst tensor card vs CPU {worst[0].item():.3e} at "
          f"{worst[1]}")
    check(math.isclose(loss_gpu, loss_cpu, rel_tol=TRAIN_FP32_TOL, abs_tol=TRAIN_FP32_TOL),
          "fp32 forecast step losses differ between card and CPU")
    check(card_far <= WITNESS_RATIO * cpu_far,
          "the card's fp32 forecast gradients lie further from fp64 than the CPU's allow")
    del results, g_gpu, g_cpu, g_64

    # K5 at the path's shape ([B, 128, 32, 64] viewed [B 128 32, 64]), bit for bit
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 41 + seed
    hidden = model.blocks[0].conv1.conv.out_channels
    k5_shape = (tc.batch_size * hidden * GRID_FORECAST[0], GRID_FORECAST[1])
    check_dropout(*k5_shape, torch.bfloat16, m.drop_rate, gen, kseed)

    # the step's time: bf16 compute, fp32 masters, batches cast on the host as the fit does
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    tstep = make_train_step(model, trainer.train_loss, cfg.data.var_weights, trainer.optimizer,
                            in_vars, out_vars)
    g1, g2 = gens(seed + 31)
    flops = conv_train_flops(model, tuple(xb.shape))
    step = step_row(lambda: tstep(xb, yb, g1, g2), "forecast", xb.shape[0], flops, smi)
    row = k5_row(k5_shape, torch.bfloat16, m.drop_rate, gen, kseed, k5_widths[k5_shape], smi,
                 "forecast")
    out = {"gpu": smi, "params": n_params, "fit_s": fit_s, "losses": [r["loss"] for r in history],
           "validation": val["means"], "test": metrics, "launches": launched,
           "eval_uses_stats": used, "fp32_from_fp64": {"card": card_far, "cpu": cpu_far},
           "step": step}
    del trainer, model, tstep, xb, yb
    torch.cuda.empty_cache()
    return {"out": out, "rows": {"fused_dropout": row}}


def hub_config(root: Path, seed: int):
    """configs/interm_fine_tune.yaml with its mesh (fsdp 4 x simple_ddp 4)
    cut to the card, batch BATCH_HUB, and DAYMET_2's variables on a synthetic
    LOW_HUB -> 4x crop (train and test splits of FIELDS_HUB fields), written
    as a YAML the finetune CLI reads. Returns (its path, its raw sections)."""
    import dataclasses

    import yaml

    from orbit2_tpu_torch.config import load_config

    raw = raw_config(root, seed, CONFIG_HUB, trainer={"batch_size": BATCH_HUB}, n_files=1,
                     t=FIELDS_HUB, low=LOW_HUB, shards=("train", "test"))
    # the finetune CLI, as JAX's, does not scale the mesh: written scaled
    raw["parallelism"] = dataclasses.asdict(to_one_card(load_config(raw)).parallelism)
    path = root / "hub.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return str(path), raw


def check_pairs(q, k, v, do, rate, seed, pairs, case):
    """K1, K2 and K3 launched on the whole batch, held on the (batch, head)
    pairs `pairs` against their plain versions on each pair alone, under
    that pair's stream (b H + h): o and lse as check_forward, dq, dk and dv
    as check_backward; K1 alone where do is None. One pair's fp32 scores at
    N 32,768 are 4.3 GB: a batch element's would not fit beside them.
    Returns {name: max abs error}."""
    from orbit2_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    _, n, h, d = q.shape
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    got = None if do is None else flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    err = {}
    for b, hh in pairs:
        at = (slice(b, b + 1), slice(None), slice(hh, hh + 1))
        mult = (keep_mult(seed, n, n, rate, streams=1, device=q.device, first_stream=b * h + hh)
                if rate > 0.0 else None)
        want_o, want_lse = flash_attention_reference(q[at], k[at], v[at], None, mult)
        where = f"{case}, batch {b} head {hh}"
        err[("fwd", b, hh)] = hold_forward(o[at], lse[b * h + hh:b * h + hh + 1], want_o,
                                           want_lse, where)
        del want_o, want_lse
        if got is not None:
            e, line = hold_grads([g[at] for g in got],
                                 plain_grads(q[at], k[at], v[at], do[at], mult), where)
            print(f"  bwd {where}: {line}")
            err.update(((name, b, hh), val) for name, val in e.items())
        del mult
        torch.cuda.empty_cache()
    names = ("fwd",) + (() if got is None else ("dq", "dk", "dv"))
    return {name: max(val for (nm, *_), val in err.items() if nm == name) for name in names}


def hub_attention_rows(gen, seed, rate, call_s, smi, launches, shape=ATTENTION_HUB,
                       label="hub ViT"):
    """K1 (with and without dropout), K2 and K3 at `shape` (B, N, H, d) bf16:
    by events and kernel time alone; their plain versions over every (batch,
    head) pair one at a time (one pair's dropout multiplier, drawn before
    the timing, serves every pair: the plain versions' work does not depend
    on its values); SDPA's flash forward and whole backward; the bounds
    (tensor cores and bytes, with dropout the Philox calls)."""
    from orbit2_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, attention_delta, attention_flops,
        flash_attention_bwd_reference, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    b, n, h, d = shape
    q, k, v = make_qkv(b, n, n, h, d, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
    delta = attention_delta(o, do)
    mult = keep_mult(seed, n, n, rate, streams=1, device="cuda")
    pairs = [(bb, hh) for bb in range(b) for hh in range(h)]

    def at(bb, hh):
        return slice(bb, bb + 1), slice(None), slice(hh, hh + 1)

    def plain_fwd(m):
        for bb, hh in pairs:
            flash_attention_reference(q[at(bb, hh)], k[at(bb, hh)], v[at(bb, hh)], None, m)

    def plain_bwd():
        for bb, hh in pairs:
            i = bb * h + hh
            flash_attention_bwd_reference(q[at(bb, hh)], k[at(bb, hh)], v[at(bb, hh)],
                                          o[at(bb, hh)], lse[i:i + 1], do[at(bb, hh)],
                                          d ** -0.5, mult)

    att = attention_flops(b, n, n, h, d)
    rows_f32 = 4 * b * h * n
    philox = b * h * n * n / ELEMENTS_PER_CALL
    lib = sdpa_ms(q, k, v, do)
    plain = {"fwd": cuda_ms(lambda: plain_fwd(mult), iters=1, warmup=1),
             "fwd0": cuda_ms(lambda: plain_fwd(None), iters=1, warmup=1),
             "bwd": cuda_ms(plain_bwd, iters=1, warmup=1)}
    cases = {
        ("flash_attn_fwd", rate): (lambda: flash_attention_fwd(q, k, v, None, rate, seed),
                                   plain["fwd"], lib["fwd"][DROP],
                                   roofline(att, nbytes(q, k, v, q) + rows_f32), "fwd"),
        ("flash_attn_fwd", 0.0): (lambda: flash_attention_fwd(q, k, v), plain["fwd0"],
                                  lib["fwd"][0.0], roofline(att, nbytes(q, k, v, q) + rows_f32),
                                  None),
        ("flash_attn_bwd_dq", rate): (
            lambda: FLASH_BWD_DQ(q, k, v, do, lse, delta, d ** -0.5, rate, seed), plain["bwd"],
            lib["bwd"], roofline(1.5 * att, nbytes(q, k, v, do, q) + 2 * rows_f32), "dq"),
        ("flash_attn_bwd_dkv", rate): (
            lambda: FLASH_BWD_DKV(q, k, v, do, lse, delta, d ** -0.5, rate, seed), plain["bwd"],
            lib["bwd"], roofline(2 * att, nbytes(q, k, v, do, k, v) + 2 * rows_f32), "dkv"),
    }
    check(rate == DROP, f"the hub's dropout rate {rate} is not the SDPA rows' {DROP}")
    rows = {}
    for (name, r), (fn, plain_ms, library, bound, op) in cases.items():
        if op is not None:
            bound = max(bound, (philox * call_s[op] * 1e3, "operations"))
        rows[(name, r)] = row = {
            "shape": [b, n, h, d], "dropout": r, "ms": cuda_ms(fn, iters=10),
            "kernel_ms": kernel_ms(fn, iters=5), "plain_ms": plain_ms, "library_ms": library,
            "bound_ms": bound[0], "bound_by": bound[1], "launches": launches.get((name, r))}
        print(f"  {label} {name} bf16 B{b} N{n} H{h} d{d} drop {r:g}: {row['ms']:.3f} ms "
              f"(kernel alone {row['kernel_ms']:.3f}, {bound[0] / row['kernel_ms']:.3f} of the "
              f"bound {bound[0]:.3f} ({bound[1]})), plain {plain_ms:.3f} (pair by pair), "
              f"library {library:.3f} ({row['kernel_ms'] / library:.2f}x by kernel time); "
              f"{row['launches']} launches on the path; gpu: {smi}")
    del q, k, v, do, o, lse, delta, mult
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def attention_by_head():
    """Routes the Blocks' attention to its plain version (fp32 math) one
    (batch, head) pair at a time, for eval mode (no dropout): at N 32,768
    one pair's fp32 scores take 4.3 GB."""
    import orbit2_tpu_torch.models.components.blocks as blocks
    from orbit2_tpu_torch.ops.flash_attention import flash_attention_reference

    def attention(q, k, v, impl, scale=None, dropout_rate=0.0, generator=None, fold=(),
                  seq=None):
        check(dropout_rate == 0.0 and seq is None,
              "attention_by_head serves eval mode on one device only")
        out = torch.empty_like(q)
        for b in range(q.shape[0]):
            for h in range(q.shape[2]):
                at = (slice(b, b + 1), slice(None), slice(h, h + 1))
                out[at] = flash_attention_reference(q[at], k[at], v[at], scale)[0]
        return out

    saved = blocks.dot_product_attention
    blocks.dot_product_attention = attention
    try:
        yield
    finally:
        blocks.dot_product_attention = saved


def hub(root: Path, seed: int, call_s, smi):
    """Phase hub: `python -m orbit2_tpu_torch.finetune --arch vit|unet|resnet`
    on configs/interm_fine_tune.yaml's model at a regional crop, then
    Evaluator.test of each (module docstring)."""
    from orbit2_tpu_torch import finetune
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.evaluate import Evaluator
    from orbit2_tpu_torch.training.checkpoint import restore_checkpoint
    from orbit2_tpu_torch.training.train import make_eval_step, make_train_step
    from orbit2_tpu_torch.training.trainer import Trainer

    path, raw = hub_config(root, seed)
    key = next(iter(raw["data"]["low_res_dir"]))
    m = raw["model"]
    rate = m["drop_rate"]
    steps = 2 * HUB_STEPS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 42 + seed
    out, rows, errs = {"gpu": smi}, {}, {}
    launches = {}
    for arch in ("vit", "unet", "resnet"):
        loss = HUB_LOSSES[arch]
        print(f"  finetune --arch {arch} --loss {loss}: {raw['trainer']['data_type']}, batch "
              f"{BATCH_HUB}, {LOW_HUB} -> 4x, 2 epochs x {HUB_STEPS} steps from drawn weights")
        reset_counts()
        tt = time.perf_counter()
        with launch_widths(kernels()["fused_dropout"]) as k5_widths:
            res = finetune.main([path, "--arch", arch, "--loss", loss, "--max-epochs", "2",
                                 "--max-steps-per-epoch", str(HUB_STEPS), "--checkpoint-dir",
                                 str(root / f"ft_{arch}"), "--device", "cuda"])
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - tt
        fit_counts = counts()
        history = res["history"]
        lap(f"hub {arch} fine-tune")
        check(sum(r["batches"] for r in history) == steps and
              all(np.isfinite(r["loss"]) for r in history), f"{arch} fine-tune took {history}")
        state = restore_checkpoint(str(root / f"ft_{arch}" / "epoch_1"))["model"]
        cfg = load_config(dict(raw, model=dict(m, preset=arch),
                               trainer=dict(raw["trainer"], train_loss=loss)))
        reset_counts()
        tt = time.perf_counter()
        ev = Evaluator(cfg, "cuda", state_dict=state)
        metrics = ev.test(max_batches=HUB_TEST_BATCHES)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - tt
        test_counts = counts()
        model = ev.model
        n_params = sum(p.numel() for p in model.parameters())
        # forward and backward a step, at the target grid
        want_widths = dropout_shapes(model.backbone, BATCH_HUB, LOW_HUB[0] * 4, LOW_HUB[1] * 4,
                                     times=2 * steps)
        depth = len(getattr(model.backbone, "blocks", ()))
        vit = arch == "vit"
        want_fit = only(fused_dropout=sum(want_widths.values()),
                        **(dict(flash_attn_fwd=depth * steps, flash_attn_bwd_dq=depth * steps,
                                flash_attn_bwd_dkv=depth * steps) if vit else {}))
        want_test = only(**(dict(flash_attn_fwd=depth * HUB_TEST_BATCHES) if vit else {}))
        print(f"    fit {fit_s:.3f} s, losses {[round(r['loss'], 6) for r in history]}; "
              f"{n_params:,} parameters; launches {fit_counts}; test {test_s:.3f} s (build "
              f"included) over {HUB_TEST_BATCHES} batches, launches {test_counts}")
        for k_, v_ in metrics.items():
            print(f"      {k_} {v_:.6f}")
        check(fit_counts == want_fit, f"{arch} fine-tune launches {fit_counts}, want {want_fit}")
        check(k5_widths == want_widths, f"{arch} fine-tune's K5 launches by [rows, cols] "
              f"{dict(k5_widths)}, want {dict(want_widths)}")
        print(f"    K5 launches by [rows, cols]: {dict(k5_widths)}")
        check(test_counts == want_test, f"{arch} test launches {test_counts}, want {want_test}")
        check(len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values()),
              f"{arch} test metrics missing or not finite")
        with pytest_raises(ValueError, "no quantized serving path"):
            ev.test(quant="w8a8")

        dm = ev.data_module
        in_vars, out_vars = dm.get_data_variables()
        loader = iter(dm.test_dataloader())
        batch = next(loader)
        loader.close()
        x, y = torch.from_numpy(batch[0]).to("cuda"), torch.from_numpy(batch[1]).to("cuda")
        entry = {"params": n_params, "fit_s": fit_s, "losses": [r["loss"] for r in history],
                 "test": metrics, "fit_launches": fit_counts, "test_launches": test_counts,
                 "test_s": test_s, "fused_dropout_by_shape": {
                     f"{r_}x{c_}": n_ for (r_, c_), n_ in k5_widths.items()}}
        if vit:
            check(tuple(model.backbone.pos_embed.shape) == (1, ATTENTION_HUB[1], m["embed_dim"]),
                  f"ViT pos_embed {tuple(model.backbone.pos_embed.shape)}")
            entry["pos_embed_params"] = model.backbone.pos_embed.numel()
            # the prediction on the kernels against the plain attention, on one
            # batch element, its plain version one head at a time (the plain
            # scores of all heads of the batch would take 137 GB in fp32)
            with torch.no_grad():
                pred = model(x[:1]).float()
                with attention_by_head():
                    pred_plain = model(x[:1]).float()
                torch.cuda.synchronize()
            rel = rel_frob(pred, pred_plain)
            print(f"    bf16 prediction (batch element 0), kernel vs plain attention: relative "
                  f"Frobenius error {rel:.3e} (bound {TRUNK_BF16_REL:g})")
            check(bool(pred.isfinite().all()) and rel <= TRUNK_BF16_REL,
                  "ViT prediction differs from the plain attention's")
            entry["vs_plain"] = rel
            torch.cuda.empty_cache()
            b, n, h, d = ATTENTION_HUB
            q, k, v = make_qkv(b, n, n, h, d, torch.bfloat16, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            pairs = [(0, 0), (b - 1, h - 1)]
            errs["train"] = check_pairs(q, k, v, do, rate, kseed, pairs,
                                        f"bf16 drop {rate:g} B{b} N{n} H{h} d{d}")
            errs["serve"] = check_pairs(q, k, v, None, 0.0, kseed, pairs,
                                        f"bf16 drop 0 B{b} N{n} H{h} d{d}")
            del q, k, v, do
            torch.cuda.empty_cache()
            tokens = b * n
            lap("hub vit checks against the plain attention")
            widths = (m["embed_dim"], int(m["embed_dim"] * m["mlp_ratio"]))
            launches.update({("flash_attn_fwd", rate): fit_counts["flash_attn_fwd"],
                             ("flash_attn_fwd", 0.0): test_counts["flash_attn_fwd"],
                             ("flash_attn_bwd_dq", rate): fit_counts["flash_attn_bwd_dq"],
                             ("flash_attn_bwd_dkv", rate): fit_counts["flash_attn_bwd_dkv"]})
            k5_shapes = [(tokens, c) for c in widths]
        else:
            # K5 at the top level's [B, C, H, W] and, for the Unet, the lowest's
            first = model.backbone.blocks[0] if arch == "resnet" else model.backbone.down[0].res
            c = first.conv1.conv.out_channels
            k5_shapes = [(BATCH_HUB * c * LOW_HUB[0] * 4, LOW_HUB[1] * 4)]
            if arch == "unet":
                c = model.backbone.middle.res1.conv1.conv.out_channels
                scale = 2 ** (len([mm for mm in model.backbone.down if hasattr(mm, "conv")]))
                k5_shapes.append((BATCH_HUB * c * LOW_HUB[0] * 4 // scale,
                                  LOW_HUB[1] * 4 // scale))
        for shape in k5_shapes:
            check_dropout(*shape, torch.bfloat16, rate, gen, kseed)
        # the step: the fine-tune's train step on the served weights (fp32 masters)
        trainer = Trainer(cfg, "cuda", state_dict=state)
        tdm = trainer.data_module(key)
        trainer._start(tdm)
        tstep = make_train_step(trainer.model, trainer.train_loss, cfg.data.var_weights,
                                trainer.optimizer, in_vars, out_vars)
        xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
        g1, g2 = gens(seed + 37)
        if vit:
            from orbit2_tpu_torch.ops.flash_attention import attention_flops

            bb = trainer.model.backbone
            att = attention_flops(*ATTENTION_HUB[:2], ATTENTION_HUB[1], *ATTENTION_HUB[2:])
            linear = sum(p.numel() for name, p in bb.named_parameters()
                         if name.endswith("weight") and p.dim() == 2)
            patch = bb.patch_embed.proj.weight.numel()
            flops = 6 * (linear + patch) * BATCH_HUB * ATTENTION_HUB[1] + 3 * depth * att
        else:
            flops = conv_train_flops(trainer.model.backbone, (BATCH_HUB, len(in_vars),
                                                              LOW_HUB[0] * 4, LOW_HUB[1] * 4))
        entry["step"] = step_row(lambda: tstep(xb, yb, g1, g2), f"hub {arch}", BATCH_HUB, flops,
                                 smi, iters=3)
        eval_step = make_eval_step(model, in_vars, out_vars)
        entry["serve_ms"] = cuda_ms(lambda: eval_step(x, y), iters=5, warmup=1)
        print(f"    {arch} serving: eval step {entry['serve_ms']:.3f} ms a batch of {x.shape[0]}")
        lap(f"hub {arch} test, steps timed")
        del trainer, tstep, xb, yb, ev, model, eval_step
        torch.cuda.empty_cache()
        rows.update({(arch, "fused_dropout", s): k5_row(s, torch.bfloat16, rate, gen, kseed,
                                                         k5_widths[s], smi, f"hub {arch}")
                     for s in k5_shapes})
        out[arch] = entry
    rows.update(hub_attention_rows(gen, kseed, rate, call_s, smi, launches))
    lap("hub attention rows")
    out["errors"] = {k_: v_ for k_, v_ in errs.items()}
    return {"out": out, "rows": rows, "errs": errs}


class pytest_raises:
    """`with pytest_raises(Error, text)`: the block must raise Error whose
    message holds `text` (pytest is not needed on the card's path)."""

    def __init__(self, error, text):
        self.error, self.text = error, text

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        check(kind is not None and issubclass(kind, self.error) and self.text in str(value),
              f"expected {self.error.__name__} holding {self.text!r}, got {kind}: {value}")
        return True


def cb_arrays(seed: int):
    """Synthetic ClimateBench forcings (CO2, SO2, CH4, BC) and a tas target
    at CB_GRID: two scenario runs (historical + future years; their windows
    start at the scenario) and a historical run."""
    from orbit2_tpu_torch.data.climatebench import LEN_HISTORICAL

    rng = np.random.default_rng(seed)
    h, w = CB_GRID
    runs = {"ssp126": LEN_HISTORICAL + CB_FUTURE, "ssp370": LEN_HISTORICAL + CB_FUTURE,
            "historical": LEN_HISTORICAL}
    dict_x = {k: rng.normal(size=(t, 4, h, w)).astype(np.float32) for k, t in runs.items()}
    dict_y = {k: rng.normal(15, 3, size=(t, 1, h, w)).astype(np.float32) for k, t in runs.items()}
    return dict_x, dict_y, np.linspace(-87.5, 87.5, h), np.linspace(0, 357.5, w)


def climatebench_phase(seed: int, smi):
    """Phase climatebench: the ClimateBench CLI's run (AdamW + warmup-cosine,
    early stopping on val/mse, the best weights tested) for resnet (28
    blocks), unet and vit at MODEL_KWARGS on synthetic arrays: finite NRMSE
    trio, exact K5 launches, the ViT's attention on the plain path (head dim
    32: no flash launch); K5 bit for bit at the ResNet's and the ViT's
    shapes."""
    from orbit2_tpu_torch import climatebench
    from orbit2_tpu_torch.data.climatebench import ClimateBenchDataModule

    arrays = cb_arrays(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 43 + seed
    out, rows = {"gpu": smi}, {}
    for name in ("resnet", "unet", "vit"):
        dm = ClimateBenchDataModule(history=10, batch_size=CB_BATCH, _arrays=arrays,
                                    list_train_simu=tuple(arrays[0]), list_test_simu=("ssp245",))
        with torch.device("meta"):
            meta = climatebench.build_model(name)
        reset_counts()
        history = []
        tt = time.perf_counter()
        with launch_widths(kernels()["fused_dropout"]) as k5_widths:
            best_val, test = climatebench.run(dm, name, max_epochs=CB_EPOCHS, patience=CB_EPOCHS,
                                              device="cuda", seed=seed, history=history)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - tt
        launched = counts()
        steps = sum(r["steps"] for r in history)
        # forward and backward a step (run() drops a short last batch)
        want_widths = dropout_shapes(meta, CB_BATCH, *CB_GRID, times=2 * steps)
        want = only(fused_dropout=sum(want_widths.values()))
        print(f"  {name}: {sum(p.numel() for p in meta.parameters()):,} parameters, "
              f"{len(dm.dataset_train)} train / {len(dm.dataset_val)} val / "
              f"{len(dm.dataset_test)} test windows, {steps} steps in {run_s:.3f} s; best "
              f"val/mse {best_val:.6f}; " + ", ".join(f"{k} {v:.6f}" for k, v in test.items())
              + f"; launches {launched}")
        check(np.isfinite(best_val) and len(test) == 6
              and all(np.isfinite(v) for v in test.values()),
              f"ClimateBench {name}: best val {best_val}, test {test}")
        check(launched == want, f"ClimateBench {name} launches {launched}, want {want}")
        check(k5_widths == want_widths, f"ClimateBench {name} K5 launches by [rows, cols] "
              f"{dict(k5_widths)}, want {dict(want_widths)}")
        print(f"    K5 launches by [rows, cols]: {dict(k5_widths)}")
        out[name] = {"run_s": run_s, "steps": steps, "best_val": best_val, "test": test,
                     "launches": launched, "history": history, "fused_dropout_by_shape": {
                         f"{r_}x{c_}": n_ for (r_, c_), n_ in k5_widths.items()}}
        if name != "unet":
            if name == "resnet":
                shape = (CB_BATCH * meta.blocks[0].conv1.conv.out_channels * CB_GRID[0],
                         CB_GRID[1])
            else:
                tokens = (CB_GRID[0] // meta.patch_size) * (CB_GRID[1] // meta.patch_size)
                shape = (CB_BATCH * tokens, meta.embed_dim)
            check_dropout(*shape, torch.float32, 0.1, gen, kseed)
            rows[name] = k5_row(shape, torch.float32, 0.1, gen, kseed, k5_widths[shape], smi,
                                f"climatebench {name}")
    return {"out": out, "rows": rows}


# the mesh phase: configs/interm_1b.yaml through the train CLI at its shipped
# mesh (scaled to the card), MESH_STEPS steps of its batch; its model wrapped
# on a one-rank NCCL mesh (every sharding rule: the tensor plan, FSDP2 per
# Block and at the root, DTensor parameters, AdamW on the shards) against
# the same steps unwrapped, at BATCH_MESH tiles a step; then two ranks on
# the one card over gloo at interm_117m.yaml's width (MESH_TWO: embed 1024,
# 16 heads, d 64; depth cut to 2), fp32 on the kernels, dropout 0, under
# fsdp 2 and under tensor 2, against the one-rank step: relative Frobenius
# error MESH_REL a gradient, the loss within MESH_REL relative
BATCH_MESH = 8
MESH_STEPS = 2
# (a) and (b) at the config's full width, its depth 8 cut to 2 (the npz's
# first Blocks; the others dropped on import): the script's time
MESH_DEPTH_1B = 2
MESH_TWO = dict(embed_dim=1024, num_heads=16, depth=2, decoder_depth=2, batch=4)
MESH_REL = 1e-4
MESH_TWO_SEED = 7
MESH_AXES = ("fsdp", "simple_ddp", "tensor_par", "seq_par", "pipeline", "expert_par")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(root: Path, seed: int, weights: str, call_s, smi):
    """Phase mesh (module docstring): (a) the train CLI on interm_1b.yaml as
    shipped, from `weights` (serve1b's, an npz); (b) the wrapped 1B path on
    a one-rank NCCL mesh against the unwrapped one, losses and parameters
    bit for bit, launches exactly equal, each step's time, kernel time and
    peak memory; K1-K3 and K5 at the path's shapes against their plain
    versions ((c), two ranks on the card over gloo against one rank, runs
    beside phase seqexpert: start_two_ranks, two_ranks). Returns what the
    kernels line reads."""
    import dataclasses
    import shutil

    import torch.distributed as dist
    import yaml

    from orbit2_tpu_torch import train as train_cli
    from orbit2_tpu_torch.parallel import full_state_dict
    from orbit2_tpu_torch.training.checkpoint import load_state_npz
    from orbit2_tpu_torch.training.train import make_train_step
    from orbit2_tpu_torch.training.trainer import Trainer

    out = {}
    # serve1b's weights cut to MESH_DEPTH_1B (a one-device Trainer loads
    # its state strictly), an npz as the CLI reads it
    cut = str(root / "weights_1b_cut.npz")
    full_npz = load_state_npz(weights)
    np.savez(cut, **{k: full_npz[k].numpy() for k in full_npz
                     if within_depth(k, MESH_DEPTH_1B)})
    del full_npz
    # (a) the CLI on the config as shipped: the scale-down brings it to the card
    raw = raw_config(root / "cli", seed, CONFIG_1B, model={"depth": MESH_DEPTH_1B},
                     n_files=FIELDS_TRAIN_1B, t=1, low=LOW_1B, shards=("train",))
    shipped = {a: raw["parallelism"].get(a, 1) for a in MESH_AXES}
    path = root / "interm_1b.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    reset_counts()
    t0 = time.perf_counter()
    trainer = train_cli.main([str(path), "--torch-npz", cut, "--device", "cuda",
                              "--max-epochs", "1", "--max-steps-per-epoch", str(MESH_STEPS),
                              "--checkpoint-dir", str(root / "ck")])
    torch.cuda.synchronize()
    cli_s, cli_launched = time.perf_counter() - t0, counts()
    shutil.rmtree(root / "ck")
    scaled = {a: getattr(trainer.cfg.parallelism, a) for a in MESH_AXES}
    m, tc = trainer.cfg.model, trainer.cfg.trainer
    depth, h, d = m.depth, m.num_heads, m.embed_dim // m.num_heads
    want = only(**{k: v * MESH_STEPS * tc.grad_accum for k, v in remat_launches(depth).items()})
    hist = trainer.history
    print(f"  (a) train CLI, {CONFIG_1B.name} as shipped {shipped} -> {scaled} at world 1: "
          f"{json.dumps(hist)}; {cli_s:.1f} s with the build and one checkpoint; launches "
          f"{cli_launched}")
    check(shipped["fsdp"] * shipped["simple_ddp"] * shipped["tensor_par"] > 1,
          f"interm_1b.yaml ships no mesh: {shipped}")
    check(all(v == 1 for v in scaled.values()), f"the CLI scaled the mesh to {scaled}")
    check(hist[0]["batches"] == MESH_STEPS and all(np.isfinite(r["loss"]) for r in hist),
          f"the CLI's run: {hist}")
    check(cli_launched == want, f"the CLI's launches {cli_launched}, want {want}")
    out["cli"] = {"shipped": shipped, "scaled": scaled, "batch_tiles": tc.batch_size,
                  "losses": [r["loss"] for r in hist], "launches": cli_launched, "seconds": cli_s}
    lap("mesh (a)")
    del trainer
    torch.cuda.empty_cache()

    # (b) the wrapped path on a one-rank NCCL mesh against the unwrapped one
    cfg = config_1b(root / "wrap", seed, trainer={"batch_size": BATCH_MESH}, n_files=1, t=1,
                    shards=("train",), depth=MESH_DEPTH_1B)
    key = next(iter(cfg.data.low_res_dir))
    state = load_state_npz(cut)

    def run():
        """The fit on the config's mesh where a process group runs (the
        Trainer's own choice), else unwrapped."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, "cuda", state_dict=state)
        with launch_widths(kernels()["fused_dropout"]) as k5_widths:
            history = tr.fit(max_epochs=MESH_STEPS, max_steps_per_epoch=1)
            torch.cuda.synchronize()
        launched = counts()
        meshed = tr.mesh is not None
        params = (full_state_dict(tr.model) if meshed else
                  {k: t.detach().cpu() for k, t in tr.model.state_dict().items()})
        dm = tr._data_modules[key]
        in_vars, out_vars = dm.get_data_variables()
        loader = iter(dm.train_dataloader())
        batch = next(loader)
        loader.close()
        xb, yb = (torch.from_numpy(a).to(torch.bfloat16).cuda() for a in batch[:2])
        step = make_train_step(tr.model, tr.train_loss, cfg.data.var_weights, tr.optimizer,
                               in_vars, out_vars)
        g1, g2 = gens(seed + 31)
        ms = cuda_ms(lambda: step(xb, yb, g1, g2), iters=3, warmup=1)
        kern = kernel_ms(lambda: step(xb, yb, g1, g2), iters=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tokens = (xb.shape[2] // m.patch_size) * (xb.shape[3] // m.patch_size)
        del tr, step, xb, yb
        torch.cuda.empty_cache()
        return {"losses": [r["loss"] for r in history], "launched": launched, "params": params,
                "step_ms": ms, "kernel_ms": kern, "busy": kern / ms, "peak_gib": peak,
                "tokens": tokens, "k5_widths": dict(k5_widths), "meshed": meshed}

    plain = run()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        wrapped = run()
    finally:
        dist.destroy_process_group()
    check(wrapped["meshed"] and not plain["meshed"],
          "the Trainer took no mesh under the NCCL group, or one without it")
    want = only(**{k: v * MESH_STEPS for k, v in remat_launches(depth).items()})
    # K5 a step under full remat (remat_launches): pos_drop and each Block's
    # projection and Mlp output at [rows, embed], its Mlp hidden at [rows,
    # hidden], forward and backward, and all again in the recomputation but
    # Block 0's Mlp output: 6 depth + 1 at the embed width, 3 depth at the hidden
    rows_k5 = BATCH_MESH * plain["tokens"]
    hidden = int(m.embed_dim * m.mlp_ratio)
    want_widths = {(rows_k5, m.embed_dim): MESH_STEPS * (6 * depth + 1),
                   (rows_k5, hidden): MESH_STEPS * 3 * depth}
    differ = [k for k in plain["params"] if not torch.equal(plain["params"][k],
                                                            wrapped["params"][k])]
    for label, r in (("unwrapped", plain), ("wrapped", wrapped)):
        print(f"  (b) {label}: losses {r['losses']}, launches {r['launched']}; step "
              f"{r['step_ms']:.3f} ms by events (median of 3), kernel time {r['kernel_ms']:.3f} "
              f"ms (busy {r['busy']:.3f}), peak {r['peak_gib']:.2f} GiB; gpu: {smi}")
    print(f"  (b) the wrapped steps against the unwrapped: losses equal "
          f"{wrapped['losses'] == plain['losses']}, {len(plain['params']) - len(differ)} of "
          f"{len(plain['params'])} parameters bit-equal after {MESH_STEPS} steps")
    check(wrapped["losses"] == plain["losses"] and not differ,
          f"the wrapped 1B steps differ from the unwrapped: losses {wrapped['losses']} vs "
          f"{plain['losses']}, parameters {differ[:5]}")
    check(plain["launched"] == want and wrapped["launched"] == want,
          f"launches unwrapped {plain['launched']}, wrapped {wrapped['launched']}, want {want}")
    check(plain["k5_widths"] == want_widths and wrapped["k5_widths"] == want_widths,
          f"K5 launches by [rows, cols]: unwrapped {plain['k5_widths']}, wrapped "
          f"{wrapped['k5_widths']}, want {want_widths}")
    print(f"  (b) K5 launches by [rows, cols], wrapped: {wrapped['k5_widths']}")
    out["wrapped"] = {key: {k: r[k] for k in ("losses", "step_ms", "kernel_ms", "busy",
                                              "peak_gib")}
                      for key, r in (("unwrapped", plain), ("one_rank_mesh", wrapped))}
    out["wrapped"]["batch_tiles"] = BATCH_MESH
    out["wrapped"]["launches"] = wrapped["launched"]
    out["wrapped"]["fused_dropout_by_shape"] = {f"{r_}x{c_}": n_ for (r_, c_), n_
                                                in wrapped["k5_widths"].items()}
    tokens, k5_launched = wrapped["tokens"], wrapped["k5_widths"]
    lap("mesh (b)")
    del plain, wrapped, state
    torch.cuda.empty_cache()

    # the path's kernels at its shapes: B8 of the tiles, H24 (one rank: every head)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 42 + seed
    q, k, v = make_qkv(BATCH_MESH, tokens, tokens, h, d, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    errs = check_batch_rows(q, k, v, do, m.drop_rate, kseed, [0, BATCH_MESH - 1],
                            f"bf16 drop {m.drop_rate:g} B{BATCH_MESH} N{tokens} H{h} d{d}")
    del q, k, v, do
    torch.cuda.empty_cache()
    path_t = {"shape": (BATCH_MESH, tokens, h, d), "rate": m.drop_rate,
              "launched": out["wrapped"]["launches"], "steps": MESH_STEPS, "width": ()}
    rows = train_1b_times(path_t, gen, kseed, call_s, smi, label="mesh 1B")
    # K5 at each width of the path, its launches the wrapped fit's at that width
    for shape, n in k5_launched.items():
        check_dropout(*shape, torch.bfloat16, m.drop_rate, gen, kseed)
        rows[("fused_dropout", shape)] = k5_row(shape, torch.bfloat16, m.drop_rate, gen, kseed,
                                                n, smi, "mesh 1B")
    lap("mesh (b) kernels and rows")
    # (c) runs beside phase seqexpert's ranks (start_two_ranks, two_ranks)
    return {"out": out, "rows": rows, "errs": errs, "launched": path_t["launched"],
            "k5_shapes": list(k5_launched)}


def start_two_ranks(two: Path, seed: int):
    """Starts phase mesh (c)'s two gloo ranks of mesh_worker on the one card
    (serving strict_serve_raw's split under TWO), each writing its output to
    TWO/rank{r}.log, and returns them."""
    import yaml

    two.mkdir()
    serve_raw = strict_serve_raw(two / "data", seed, MESH_TWO["batch"])
    (two / "serve.yaml").write_text(yaml.safe_dump(serve_raw, sort_keys=False))
    port = str(free_port())
    procs = []
    for r in (0, 1):
        with open(two / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           "--mesh-worker", str(r), port, str(two)],
                                          stdout=log, stderr=subprocess.STDOUT, text=True))
    return procs


def two_ranks(two: Path, procs):
    """Phase mesh (c): waits for start_two_ranks' two ranks `procs`, held
    against one rank (and serving); a rank that fails or dies fails the
    phase."""
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(two / f"rank{r}.log").read_text() for r in range(len(procs))]
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"two-rank worker {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    res = json.loads((two / "result.json").read_text())
    print("\n".join(line for line in logs[0].splitlines() if line.startswith("  (c) serving")))
    for mode in ("fsdp", "tensor"):
        r = res[mode]
        print(f"  (c) two ranks on one card over gloo, {mode} 2, fp32 on the kernels: loss "
              f"{r['loss']!r} against one rank's {r['loss_one']!r}; gradients within "
              f"{r['max_rel']:.3e} relative Frobenius ({r['worst']}); launches a rank "
              f"{r['launches']}; {r['step_s']:.3f} s a step")
        check(abs(r["loss"] - r["loss_one"]) <= MESH_REL * abs(r["loss_one"])
              and r["max_rel"] <= MESH_REL,
              f"the two-rank {mode} step differs from the one-rank step: {r}")
        depth2 = MESH_TWO["depth"]
        check(r["launches"] == only(flash_attn_fwd=depth2, flash_attn_bwd_dq=depth2,
                                    flash_attn_bwd_dkv=depth2),
              f"the two-rank {mode} step launched {r['launches']}")
    return res


def mesh_worker(rank: int, port: str, out_dir: str):
    """One of phase mesh's two ranks on the one card (gloo, whose
    all-gather, reduce-scatter and all-reduce take the CUDA tensors FSDP2
    and the tensor splits hand them): the MESH_TWO model's fp32 train step
    on a fsdp-2 and on a tensor-2 mesh against the same step on one rank
    (rank 0 runs it unwrapped). Rank 0 writes result.json."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    from orbit2_tpu_torch.evaluate import materialize
    from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY
    from orbit2_tpu_torch.models import ResSlimViT
    from orbit2_tpu_torch.parallel import (
        data_group, data_rank, data_size, full_tensor, make_mesh, shard_model)
    from orbit2_tpu_torch.training.optim import make_optimizer
    from orbit2_tpu_torch.training.train import make_train_step

    faulthandler.enable()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    result = {}
    kw = dict(attention_impl="auto", drop_rate=0.0, drop_path=0.0, learn_pos_emb=True,
              spatial_resolution=111.0, superres_mag=4, patch_size=2,
              **{k: v for k, v in MESH_TWO.items() if k != "batch"})
    args = (BENCH_VARS, (64, 128), 7, 3)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(MESH_TWO["batch"], 7, 64, 128)).astype(np.float32))
    y = torch.from_numpy((rng.normal(size=(MESH_TWO["batch"], 3, 256, 512)) * 0.5)
                         .astype(np.float32))
    x, y = x.cuda(), y.cuda()
    loss_fn = METRICS_REGISTRY["bayesian_tv"](aggregate_only=True)

    def step_of(model):
        opt = make_optimizer("adamw", {"lr": 1e-4}, model.named_parameters())
        return make_train_step(model, loss_fn, None, opt, BENCH_VARS, BENCH_VARS[4:])

    one = None
    if rank == 0:  # the one-rank step, unwrapped
        ref = ResSlimViT(*args, generator=torch.Generator().manual_seed(MESH_TWO_SEED), **kw)
        ref.cuda()
        loss_one = step_of(ref)(x, y, torch.Generator(), None).item()
        one = (loss_one, {k: p.grad.detach().cpu() for k, p in ref.named_parameters()
                          if p.grad is not None})
        del ref
    for mode, axes in (("fsdp", dict(fsdp=2)), ("tensor", dict(tensor=2))):
        mesh = make_mesh(device_type="cuda", **axes)
        with torch.device("meta"):
            skeleton = ResSlimViT(*args, **kw)
        model = shard_model(copy.deepcopy(skeleton), mesh)
        model.to_empty(device="cuda")
        materialize(skeleton, "cpu", generator=torch.Generator().manual_seed(MESH_TWO_SEED),
                    into=model)
        xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
        step = step_of(model)
        reset_counts()
        t0 = time.perf_counter()
        loss = step(xs, ys, torch.Generator(), None).detach().clone()
        torch.cuda.synchronize()
        step_s, launched = time.perf_counter() - t0, counts()
        dist.all_reduce(loss, group=data_group(mesh))
        loss = loss.item() / data_size(mesh)
        grads = {k: full_tensor(p.grad).cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        if rank == 0:
            rel = {k: ((grads[k] - g).norm() / g.norm().clamp_min(1e-30)).item()
                   for k, g in one[1].items()}
            worst = max(rel, key=rel.get)
            result[mode] = {"loss": loss, "loss_one": one[0], "max_rel": rel[worst],
                            "worst": worst, "launches": launched, "step_s": step_s,
                            "same_keys": set(grads) == set(one[1])}
            check(set(grads) == set(one[1]), f"{mode}: gradients of {set(grads) ^ set(one[1])}")
        del model, step, grads
        torch.cuda.empty_cache()
    import yaml

    serve = serve_meshes(rank, yaml.safe_load((Path(out_dir) / "serve.yaml").read_text()),
                         {"fsdp": {"fsdp": 2}, "tensor": {"tensor_par": 2}}, "(c)")
    if rank == 0:
        result["serve"] = serve
        (Path(out_dir) / "result.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


# the seq and expert axes (phase seqexpert, after mesh): (a) configs/
# interm_1b.yaml's model at full width (embed 3072, 24 heads of d 128, its
# full remat), depth cut to SEQ_DEPTH (two ranks on the card sum the Blocks'
# fp32 gradients, 3.6 GB a step at depth 8, through gloo's host copies: ~10
# s a step), on SEQ_LOW crops without tiling (2,048 tokens, N/s 1,024 at seq
# 2), SEQ_BATCH a step, bf16: SEQ_STEPS steps of Trainer.fit on two gloo
# ranks of the card at seq 2 under gather and Ulysses (dropout SEQ_DROP) and
# ring (dropout 0: ring with dropout is the gather path), each against the
# same fit on one unwrapped rank: the losses and the parameters, all of them
# as one vector, within relative Frobenius SEQEXP_REL (the ranks' dropout
# masks fold the seq coordinate, so they are not the one rank's, and a
# zero-initialised bias moved by two steps differs by far more than that
# relative to itself), launches exact. The first epoch's warm-up rate leaves
# the parameters at their draw and the CNN path sets the loss, so what holds
# the trunk is its first step's gradients, all of them as one vector, at
# dropout 0 (a one-step fit for gather and Ulysses) within relative
# Frobenius SEQEXP_GRAD_REL of one rank's: sound bf16 readings are 2.0e-3 to
# 2.2e-3, a trunk that skips the seq sum of its gradients reads 0.51, gather
# on the rank's own keys alone 0.14 (chip_faults.py plants such faults;
# PERF.md §6); (b) configs/interm_1b_moe.yaml at full width, depth cut to
# EXPERT_DEPTH (MoE Block 1, 8 experts: full depth is ~2.0B a rank, too much
# for two ranks on one card), its tiles, EXPERT_BATCH tiles a
# step, at expert 2 on two gloo ranks against one rank: the trunk's
# first-step gradients but the expert stacks' (whole on every rank; upstream
# of an MoE layer they take its expert sums' backward) within
# SEQEXP_GRAD_REL (sound: 0, bit-equal; the MoE's f skipped: 6.0e-2), the
# dense parameters bit-equal on both ranks; (c) four gloo ranks, fp32 on the
# kernels, MESH_TWO's width: one step at seq 2 x fsdp 2 under each impl, and
# at expert 2 x fsdp 2 and expert 2 x tensor 2 on an MoE variant (MESH_MOE),
# against the one-rank step within MESH_REL (each gradient relative to its
# own norm, or to GRAD_FLOOR of the largest where its own is below that).
# The weights of (a) and (b) are drawn on the card from SEQEXP_SEED (a host
# draw of 1.1B takes minutes)
SEQ_LOW = (64, 128)
# cut from 4 to 2 for the script's time (phase servemesh)
SEQ_DEPTH = 2
SEQ_BATCH = 8
SEQ_STEPS = 2
SEQ_DROP = 0.1
SEQ_IMPL_DROP = {"gather": SEQ_DROP, "ulysses": SEQ_DROP, "ring": 0.0}
SEQEXP_REL = 0.02
SEQEXP_GRAD_REL = 1e-2
SEQEXP_SEED = 23
EXPERT_DEPTH = 2
EXPERT_BATCH = 8
MESH_MOE = dict(moe_experts=4, moe_every=2)
GRAD_FLOOR = 1e-3
EXPERT_STACKS = r"moe_mlp\.(wi|bi|wo|bo)$"
# the gradients (a) and (b) hold: the trunk's, (b) but the expert stacks'
TRUNK = r"^blocks\."
TRUNK_DENSE = r"^blocks\.(?!.*moe_mlp\.(wi|bi|wo|bo)$)"
SEQEXP_MESHES = {**{f"seq_{impl}": dict(seq=2, fsdp=2) for impl in SEQ_IMPL_DROP},
                 "expert_fsdp": dict(expert=2, fsdp=2), "expert_tensor": dict(expert=2, tensor=2)}


def seqexpert_configs(root: Path, seed: int):
    """(the seq config at seq 2, the MoE config at expert 2) as raw dicts,
    each on a synthetic train split under `root`."""
    seq = raw_config(root / "seq", seed, CONFIG_1B, trainer={"batch_size": SEQ_BATCH},
                     model={"depth": SEQ_DEPTH}, n_files=1, t=SEQ_BATCH * SEQ_STEPS,
                     low=SEQ_LOW, shards=("train",))
    seq["tiling"] = {"do_tiling": False}
    seq["parallelism"] = {"seq_par": 2}
    # one 252 x 504 field cuts 16 tiles of 66 x 132: SEQ_STEPS batches
    moe = raw_config(root / "moe", seed, CONFIG_MOE, trainer={"batch_size": EXPERT_BATCH},
                     model={"depth": EXPERT_DEPTH}, n_files=1, t=1, low=LOW_1B,
                     shards=("train", "test"))
    moe["parallelism"] = {"expert_par": 2}
    return seq, moe


def drawn_weights(cfg, seed: int):
    """The config's model's weights drawn on the card (evaluate.py::materialize
    from a CUDA generator at `seed`), as a state dict on the host."""
    from orbit2_tpu_torch.evaluate import load_module, make_data_module, materialize, model_kwargs

    key = next(iter(cfg.data.low_res_dir))
    dm = make_data_module(cfg, key, cfg.tiling.effective_div, cfg.tiling.effective_overlap)
    with torch.device("meta"):
        model = load_module(cfg, dm, dict(model_kwargs(cfg), generator=None))[0]
    materialize(model, "cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    state = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    return state


@contextlib.contextmanager
def timed_collectives():
    """Host seconds inside the collectives torch.distributed hands gloo (each
    synced with the device around it; an async one waited for): yields a
    dict {"s": seconds, "calls": n}."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "broadcast")
    saved = {n: getattr(dist, n) for n in names}
    took = {"s": 0.0, "calls": 0}

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = fn(*args, **kwargs)
            if work is not None and hasattr(work, "wait"):
                work.wait()
            torch.cuda.synchronize()
            took["s"] += time.perf_counter() - t0
            took["calls"] += 1
            return work
        return run

    for n, fn in saved.items():
        setattr(dist, n, timed(fn))
    try:
        yield took
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def rel_params(got, want):
    """(the largest relative Frobenius error of a parameter, its name, the
    whole state's relative Frobenius error) of `got` against `want`."""
    rel = {k: rel_frob(got[k].float(), want[k].float()) for k in want}
    worst = max(rel, key=rel.get)
    num = sum(float((got[k].float() - want[k].float()).norm() ** 2) for k in want)
    den = sum(float(want[k].float().norm() ** 2) for k in want)
    return rel[worst], worst, math.sqrt(num / den)


@contextlib.contextmanager
def first_step_grads(of=TRUNK):
    """Keeps the first train step's gradients as the optimizer takes them
    (after the seq sum, training/train.py::reduce_seq_grads) of the
    parameters whose names match the regex `of`, each whole (full_tensor:
    every rank keeps them) in fp32 on the host: yields the dict it fills."""
    import orbit2_tpu_torch.training.train as train
    from orbit2_tpu_torch.parallel import full_tensor

    summed, grads = train.reduce_seq_grads, {}

    def keep(model):
        summed(model)
        if not grads:
            grads.update({n: full_tensor(p.grad).float().cpu()
                          for n, p in model.named_parameters()
                          if p.grad is not None and re.search(of, n)})

    train.reduce_seq_grads = keep
    try:
        yield grads
    finally:
        train.reduce_seq_grads = summed


def rel_grads(got, want):
    """(the whole gradient's relative Frobenius error, the largest of one
    parameter's relative to its own norm or, below that, to GRAD_FLOOR of
    the largest's, its name) of `got` against `want`."""
    check(set(got) == set(want), f"gradients of {sorted(set(got) ^ set(want))}")
    num = sum(float((got[k] - g).norm() ** 2) for k, g in want.items())
    den = sum(float(g.norm() ** 2) for g in want.values())
    floor = GRAD_FLOOR * max(float(g.norm()) for g in want.values())
    rel = {k: float((got[k] - g).norm()) / max(float(g.norm()), floor) for k, g in want.items()}
    worst = max(rel, key=rel.get)
    return math.sqrt(num / den), rel[worst], worst


def fit_run(cfg, weights, label, steps=SEQ_STEPS, grads_of=TRUNK):
    """Trainer.fit of `cfg` from `weights`, `steps` steps: {losses,
    launches (K5's also by [rows, cols]), seconds, collective seconds, peak
    GiB}, the parameters gathered whole on the host and the first step's
    gradients (first_step_grads(grads_of)), on every rank."""
    from orbit2_tpu_torch.parallel import full_state_dict
    from orbit2_tpu_torch.training.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, "cuda", state_dict=weights)
    reset_counts()
    with timed_collectives() as coll, launch_widths(kernels()["fused_dropout"]) as widths:
        with first_step_grads(grads_of) as grads:
            hist = trainer.fit(max_epochs=1, max_steps_per_epoch=steps)
        torch.cuda.synchronize()
    launched = counts()
    params = (full_state_dict(trainer.model) if trainer.mesh is not None else
              {k: t.detach().cpu() for k, t in trainer.model.state_dict().items()})
    out = {"losses": [r["loss"] for r in hist], "batches": hist[0]["batches"],
           "launches": launched, "k5_widths": sorted([r, c, n] for (r, c), n in widths.items()),
           "fit_s": hist[0]["seconds"], "collective_s": coll["s"],
           "collective_calls": coll["calls"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"  {label}: losses {out['losses']}, {out['fit_s']:.2f} s for {steps} steps "
          f"({coll['s']:.2f} s in {coll['calls']} collectives), peak {out['peak_gib']:.2f} GiB, "
          f"launches {launched}", flush=True)
    del trainer
    gc.collect()  # FSDP2's hooks hold the model in reference cycles
    torch.cuda.empty_cache()
    return out, params, grads


def seqexp_config(raw, drop_rate=None, **par):
    """load_config of a copy of `raw` with these parallelism entries and,
    given one, this model drop_rate."""
    from orbit2_tpu_torch.config import load_config

    raw = copy.deepcopy(raw)
    raw["parallelism"].update(par)
    if drop_rate is not None:
        raw["model"]["drop_rate"] = drop_rate
    return load_config(raw)


def one_rank_fits(seq_raw, moe_raw, seq_w, moe_w):
    """Phase seqexpert's one-rank fits, unwrapped: (a)'s at each dropout
    rate of SEQ_IMPL_DROP, the trunk's first-step gradients kept at rate 0,
    and (b)'s, the trunk's but the expert stacks'. {rate | "moe": (fit_run's
    result, params, grads)}."""
    refs = {}
    for rate in sorted(set(SEQ_IMPL_DROP.values())):
        run, params, grads = fit_run(seqexp_config(seq_raw, seq_par=1, drop_rate=rate), seq_w,
                                     f"(a) one rank, dropout {rate:g}")
        refs[rate] = (run, params, grads if rate == 0 else None)
    refs["moe"] = fit_run(seqexp_config(moe_raw, expert_par=1), moe_w, "(b) one rank",
                          grads_of=TRUNK_DENSE)
    return refs


def seq_fits(rank, seq_raw, seq_w, refs):
    """Phase seqexpert (a) on one of its two ranks: under each impl, one
    step at dropout 0, the trunk's gradients against the one rank's first
    step's (SEQEXP_GRAD_REL), then SEQ_STEPS steps at the impl's dropout rate:
    launches exact, losses and parameters within SEQEXP_REL of one rank's
    (ring's one fit serves both). Returns rank 0's results."""
    from orbit2_tpu_torch.config import load_config

    m = load_config(seq_raw).model
    seq_tokens = (SEQ_LOW[0] // m.patch_size) * (SEQ_LOW[1] // m.patch_size)
    result = {}
    for impl, rate in SEQ_IMPL_DROP.items():
        run, params, grads = fit_run(seqexp_config(seq_raw, seq_impl=impl, drop_rate=rate), seq_w,
                                     f"(a) seq 2 {impl} rank {rank}")
        if rate:
            grads = fit_run(seqexp_config(seq_raw, seq_impl=impl, drop_rate=0.0), seq_w,
                            f"(a) seq 2 {impl} rank {rank}, dropout 0", steps=1)[2]
        base = remat_launches(m.depth)
        chunks = 2 if impl == "ring" else 1
        want = only(flash_attn_fwd=chunks * base["flash_attn_fwd"] * SEQ_STEPS,
                    flash_attn_bwd_dq=chunks * base["flash_attn_bwd_dq"] * SEQ_STEPS,
                    flash_attn_bwd_dkv=chunks * base["flash_attn_bwd_dkv"] * SEQ_STEPS,
                    fused_dropout=base["fused_dropout"] * SEQ_STEPS if rate else 0)
        check(run["launches"] == want, f"seq {impl}: launches {run['launches']}, want {want}")
        # K5 at pos_drop on the whole tokens, at the Blocks' sites on the
        # rank's half (remat_launches' count by site)
        rows, d = SEQ_BATCH * seq_tokens, m.embed_dim
        want_widths = sorted([[rows, d, 2 * SEQ_STEPS],
                              [rows // 2, d, (6 * m.depth - 1) * SEQ_STEPS],
                              [rows // 2, int(d * m.mlp_ratio), 3 * m.depth * SEQ_STEPS]]
                             if rate else [])
        check(run["k5_widths"] == want_widths,
              f"seq {impl}: K5 by [rows, cols, launches] {run['k5_widths']}, want "
              f"{want_widths}")
        if rank == 0:
            ref, ref_params, _ = refs[rate]
            grad_rel, grad_worst, grad_name = rel_grads(grads, refs[0.0][2])
            print(f"  (a) seq 2 {impl}: the trunk's first-step gradients at dropout 0 within "
                  f"{grad_rel:.3e} relative Frobenius of one rank's (the worst parameter "
                  f"{grad_name}: {grad_worst:.3e})", flush=True)
            check(grad_rel <= SEQEXP_GRAD_REL,
                  f"seq {impl}: the trunk's first-step gradients {grad_rel:.3e} from one "
                  f"rank's")
            worst, name, whole = rel_params(params, ref_params)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
            check(whole <= SEQEXP_REL and loss_rel <= SEQEXP_REL,
                  f"seq {impl}: parameters {whole:.3e} (worst {name}: {worst:.3e}), losses "
                  f"{loss_rel:.3e} from one rank's")
            run.update(one_rank=ref, param_rel=worst, param_worst=name, state_rel=whole,
                       loss_rel=loss_rel, grad_rel=grad_rel, grad_param_rel=grad_worst,
                       grad_worst=grad_name)
            result[f"seq_{impl}"] = run
        del params, grads
    return result


def expert_fit(rank, world, moe_raw, moe_w, refs):
    """Phase seqexpert (b) on one of its two ranks: SEQ_STEPS steps at
    expert 2, launches exact, the dense parameters bit-equal on both ranks,
    the trunk's first-step gradients but the expert stacks' within
    SEQEXP_GRAD_REL of one rank's (they take the expert sums' backward),
    losses and parameters within SEQEXP_REL. Returns rank 0's results."""
    import torch.distributed as dist

    from orbit2_tpu_torch.config import load_config

    run, params, grads = fit_run(seqexp_config(moe_raw), moe_w, f"(b) expert 2 rank {rank}",
                                 grads_of=TRUNK_DENSE)
    mm = load_config(moe_raw).model
    moe_blocks = sum((i + 1) % mm.moe_every == 0 for i in range(mm.depth))
    want = only(**{k: v * SEQ_STEPS for k, v in remat_launches(
        mm.depth, moe_blocks=moe_blocks).items()})
    check(run["launches"] == want, f"expert: launches {run['launches']}, want {want}")
    dense = equal = 0
    for name, t in params.items():  # whole on both ranks: the dense ones the same
        if re.search(EXPERT_STACKS, name):
            continue  # the expert stacks, gathered from both ranks' experts
        both = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(both, t.contiguous())
        dense += 1
        equal += int(torch.equal(both[0], both[1]))
    check(dense > 0 and equal == dense,
          f"expert: {dense - equal} of {dense} dense parameters differ across expert ranks")
    # the trained MoE model served at expert 2 against one rank
    serve = serve_meshes(rank, moe_raw, {"expert": {"expert_par": 2}}, "(b)",
                         bound=SERVE_METRIC_REL, state=params)
    if rank != 0:
        return {}
    ref, ref_params, ref_grads = refs["moe"]
    grad_rel, grad_worst, grad_name = rel_grads(grads, ref_grads)
    print(f"  (b) expert 2: the trunk's first-step gradients but the expert stacks' within "
          f"{grad_rel:.3e} relative Frobenius of one rank's (the worst parameter {grad_name}: "
          f"{grad_worst:.3e})", flush=True)
    check(grad_rel <= SEQEXP_GRAD_REL,
          f"expert: the trunk's first-step gradients {grad_rel:.3e} from one rank's")
    worst, name, whole = rel_params(params, ref_params)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
    check(whole <= SEQEXP_REL and loss_rel <= SEQEXP_REL,
          f"expert: parameters {whole:.3e} (worst {name}: {worst:.3e}), losses "
          f"{loss_rel:.3e} from one rank's")
    run.update(one_rank=ref, param_rel=worst, param_worst=name, state_rel=whole,
               loss_rel=loss_rel, dense_equal=f"{equal} of {dense}", grad_rel=grad_rel,
               grad_param_rel=grad_worst, grad_worst=grad_name, serve=serve)
    return {"expert": run}


def seqexpert_worker(mode: str, rank: int, world: int, port: str, out_dir: str):
    """One rank of phase seqexpert: mode "full" ((a) and (b), 2 ranks: rank 0
    runs the one-rank fits before the group starts) or "strict" ((c), 4
    ranks). Rank 0 writes OUT_DIR/{mode}.json; a failing check raises."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()
    torch.cuda.set_device(0)
    out = Path(out_dir)

    def join():
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=900))

    if mode == "strict":
        join()
        result = strict_meshes(rank, out)
    else:
        import yaml

        raws = yaml.safe_load((out / "configs.yaml").read_text())
        seq_raw, moe_raw = raws["seq"], raws["moe"]
        seq_w = drawn_weights(seqexp_config(seq_raw, seq_par=1), SEQEXP_SEED)
        moe_w = drawn_weights(seqexp_config(moe_raw, expert_par=1), SEQEXP_SEED + 1)
        # the one-rank fits run before the group starts
        refs = one_rank_fits(seq_raw, moe_raw, seq_w, moe_w) if rank == 0 else {}
        join()
        result = seq_fits(rank, seq_raw, seq_w, refs)
        result.update(expert_fit(rank, world, moe_raw, moe_w, refs))
    if rank == 0:
        (out / f"{mode}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


# the fp32 serving checks of phases mesh (c), seqexpert (c) and pipeline (b):
# configs/interm_117m.yaml at MESH_TWO's width, fp32, on a test split of two
# files whose samples are one field (so a mesh's rounds hold what one rank's
# batches hold), STRICT_BATCHES batches: test() on each mesh against the same
# config at mesh 1 (rank 0 serves it, the other ranks idle), every metric
# within MESH_REL (serve_readings), the samples equal, K1 depth a batch a rank
STRICT_BATCHES = 1


def strict_serve_raw(root: Path, seed: int, batch: int, **model):
    """The raw config of the fp32 serving checks (the comment above), its
    model changed by `model`."""
    raw = raw_config(root, seed, CONFIG, trainer={"batch_size": batch, "data_type": "float32"},
                     model=dict({k: v for k, v in MESH_TWO.items() if k != "batch"},
                                drop_rate=0.0, drop_path=0.0, **model),
                     n_files=2, t=batch, low=(64, 128), shards=("test",), same_samples=True)
    raw["tiling"] = {"do_tiling": False}
    return raw


def serve_meshes(rank: int, raw, meshes, label: str, bound=MESH_REL, state=None):
    """test() of `raw` over STRICT_BATCHES (weights `state`, None: drawn from
    trainer.seed) on each of `meshes` ({name: parallelism}) against the
    same config at mesh 1 (rank 0 serves it, the other ranks idle): every
    metric within `bound` by serve_readings (the largest over the ranks),
    the samples equal, K1 launched depth times a batch (none in a model-hub
    CNN), on a stage rank its Blocks' times the microbatches (the bubble
    runs none). Returns rank 0's readings."""
    import torch.distributed as dist

    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.evaluate import Evaluator
    from orbit2_tpu_torch.parallel.pipeline import owned_blocks

    def served(par):
        r = copy.deepcopy(raw)
        r["parallelism"] = dict({a: 1 for a in MESH_AXES}, **par)
        cfg = load_config(r)
        t0 = time.perf_counter()
        ev = Evaluator(cfg, "cuda", quant_modes=("none",), state_dict=state)
        t1 = time.perf_counter()
        reset_counts()
        metrics = ev.test(max_batches=STRICT_BATCHES)
        torch.cuda.synchronize()
        got = {"metrics": metrics, "samples": ev.last_test["samples"] if ev.last_test else 0,
               "launches": counts(), "idle": ev.idle, "seconds": time.perf_counter() - t1,
               "build_s": t1 - t0}
        m, p = cfg.model, cfg.parallelism
        if not ev.idle:
            calls = m.depth if m.preset in ("res_slimvit", "vit") else 0  # a CNN: no K1
            if p.pipeline > 1:
                stage = ev.mesh.get_local_rank("stage")
                calls = (p.pipeline_microbatches or p.pipeline) * len(
                    owned_blocks(m.depth, p.pipeline, p.pipeline_interleave, stage))
            chunks = 2 if p.seq_par > 1 and p.seq_impl == "ring" else 1
            want = only(flash_attn_fwd=chunks * calls * STRICT_BATCHES)
            check(got["launches"] == want, f"{label} {par}: test() launched {got['launches']}, "
                  f"want {want}")
        del ev
        gc.collect()
        torch.cuda.empty_cache()
        return got

    one = [served({})]
    dist.broadcast_object_list(one, src=0)
    want = one[0]
    result = {}
    for name, par in meshes.items():
        got = served(par)
        rel, worst = serve_readings(got["metrics"], want["metrics"]) if not got["idle"] else (
            0.0, None)
        readings = [None] * dist.get_world_size()
        dist.all_gather_object(readings, (rel, worst, got["samples"], got["idle"]))
        largest = max(readings, key=lambda r: r[0])
        r = {"metric_rel": largest[0], "worst": largest[1], "seconds": got["seconds"],
             "build_s": got["build_s"], "samples": [x[2] for x in readings],
             "launches_rank0": got["launches"]}
        if rank == 0:
            print(f"  {label} serving on {name} {par}: metrics within {largest[0]:.3e} of one "
                  f"rank's ({largest[1]}; bound {bound:g}), samples a rank {r['samples']} (one "
                  f"rank {want['samples']}), test() {got['seconds']:.3f} s, built in "
                  f"{got['build_s']:.1f} s (one rank {want['build_s']:.1f})", flush=True)
        check(largest[0] <= bound and all(x[2] == want["samples"] for x in readings if not x[3]),
              f"{label} serving on {name} differs from one rank: {r}")
        result[name] = r
    return result


def strict_meshes(rank: int, out: Path):
    """Phase seqexpert (c) on one rank: MESH_TWO's fp32 step, dense (seq
    meshes) and with MESH_MOE (expert meshes), on each of SEQEXP_MESHES
    against the one-rank step (rank 0, unwrapped), then test() of OUT's
    serve_*.yaml on the same meshes (serve_meshes); then phase pipeline (b)
    and its serving. Returns rank 0's results."""
    import yaml
    import torch.distributed as dist

    from orbit2_tpu_torch.evaluate import materialize
    from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY
    from orbit2_tpu_torch.models import ResSlimViT
    from orbit2_tpu_torch.parallel import (
        data_group, data_rank, data_size, full_tensor, make_mesh, shard_model)
    from orbit2_tpu_torch.training.optim import make_optimizer
    from orbit2_tpu_torch.training.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(attention_impl="auto", drop_rate=0.0, drop_path=0.0, learn_pos_emb=True,
              spatial_resolution=111.0, superres_mag=4, patch_size=2,
              **{k: v for k, v in MESH_TWO.items() if k != "batch"})
    args = (BENCH_VARS, (64, 128), 7, 3)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(MESH_TWO["batch"], 7, 64, 128)).astype(np.float32))
    y = torch.from_numpy((rng.normal(size=(MESH_TWO["batch"], 3, 256, 512)) * 0.5)
                         .astype(np.float32))
    x, y = x.cuda(), y.cuda()
    loss_fn = METRICS_REGISTRY["bayesian_tv"](aggregate_only=True)

    def step_of(model):
        opt = make_optimizer("adamw", {"lr": 1e-4}, model.named_parameters())
        return make_train_step(model, loss_fn, None, opt, BENCH_VARS, BENCH_VARS[4:])

    def drawn():  # the one-process draw, on the card (a host draw costs seconds a rank)
        return torch.Generator(device="cuda").manual_seed(MESH_TWO_SEED)

    ones = {}
    if rank == 0:  # the one-rank steps, unwrapped
        for kind, extra in (("dense", {}), ("moe", MESH_MOE)):
            with torch.device("meta"):
                ref = ResSlimViT(*args, **kw, **extra)
            materialize(ref, "cuda", generator=drawn())
            loss = step_of(ref)(x, y, torch.Generator(), None).item()
            ones[kind] = (loss, {k: p.grad.detach().cpu() for k, p in ref.named_parameters()
                                 if p.grad is not None})
            del ref
    result, depth = {}, MESH_TWO["depth"]
    for name, axes in SEQEXP_MESHES.items():
        seq = name.startswith("seq_")
        extra = dict(seq_shard=True, seq_impl=name[4:]) if seq else MESH_MOE
        mesh = make_mesh(device_type="cuda", **axes)
        with torch.device("meta"):
            skeleton = ResSlimViT(*args, **kw, **extra)
        model = shard_model(copy.deepcopy(skeleton), mesh)
        model.to_empty(device="cuda")
        materialize(skeleton, "cuda", generator=drawn(), into=model)
        xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
        step = step_of(model)
        reset_counts()
        t0 = time.perf_counter()
        loss = step(xs, ys, torch.Generator(), None).detach().clone()
        torch.cuda.synchronize()
        step_s, launched = time.perf_counter() - t0, counts()
        chunks = 2 if name == "seq_ring" else 1
        want = only(flash_attn_fwd=chunks * depth, flash_attn_bwd_dq=chunks * depth,
                    flash_attn_bwd_dkv=chunks * depth)
        check(launched == want, f"(c) {name}: launches {launched}, want {want}")
        dist.all_reduce(loss, group=data_group(mesh))
        loss = loss.item() / data_size(mesh)
        grads = {k: full_tensor(p.grad).cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        if rank == 0:
            loss_one, one = ones["dense" if seq else "moe"]
            check(set(grads) == set(one), f"(c) {name}: gradients of {set(grads) ^ set(one)}")
            # a gradient near zero (the MoE variant's token embeddings: ~1e-7 of
            # the largest) is held against GRAD_FLOOR of the largest gradient's
            # norm: relative to itself its fp32 rounding exceeds MESH_REL
            floor = GRAD_FLOOR * max(float(g.norm()) for g in one.values())
            rel = {k: float((grads[k] - g).norm()) / max(float(g.norm()), floor)
                   for k, g in one.items()}
            worst = max(rel, key=rel.get)
            r = {"loss": loss, "loss_one": loss_one, "max_rel": rel[worst], "worst": worst,
                 "launches": launched, "step_s": step_s}
            print(f"  (c) {name} {axes}, fp32 on the kernels: loss {loss!r} against one rank's "
                  f"{loss_one!r}; gradients within {rel[worst]:.3e} relative Frobenius "
                  f"({worst}); {step_s:.3f} s a step", flush=True)
            check(abs(loss - loss_one) <= MESH_REL * abs(loss_one) and rel[worst] <= MESH_REL,
                  f"(c) {name} differs from the one-rank step: {r}")
            result[name] = r
        del model, step, grads
        torch.cuda.empty_cache()
    raws = {kind: yaml.safe_load((out / f"serve_{kind}.yaml").read_text())
            for kind in ("dense", "moe", "pipeline")}
    serve = serve_meshes(rank, raws["dense"], {
        name: {"seq_par": 2, "fsdp": 2, "seq_impl": name[4:]} for name in SEQEXP_MESHES
        if name.startswith("seq_")}, "(c)")
    serve.update(serve_meshes(rank, raws["moe"], {"expert_fsdp": {"expert_par": 2, "fsdp": 2},
                                                  "expert_tensor": {"expert_par": 2,
                                                                    "tensor_par": 2}}, "(c)"))
    result["serve"] = serve
    result["pipeline"] = strict_pipeline(rank, step_of, kw, args, drawn)
    result["pipeline"]["serve"] = serve_meshes(rank, raws["pipeline"], {
        f"{name}_{sched}": {"pipeline": 2, "pipeline_microbatches": PP_STRICT["microbatches"],
                            "pipeline_interleave": v,
                            **({"fsdp": 2} if "fsdp" in name else {"tensor_par": 2})}
        for name in PP_MESHES for sched, v in (("gpipe", 1), ("interleaved", 2))},
        "(pipeline b)")
    return result


def launch_ranks(mode: str, world: int, out: Path, timeout: int, worker="--seqexpert-worker"):
    """The `world` ranks of `worker` (--seqexpert-worker, --pipeline-worker,
    --servemesh-worker) in `mode` on the card; a rank that fails or dies
    fails the phase. Returns rank 0's json."""
    return finish_ranks(mode, start_ranks(mode, world, out, worker), out, timeout)


def start_ranks(mode: str, world: int, out: Path, worker: str):
    """Starts launch_ranks' processes (a free port of their own), each
    writing its output to OUT/{mode}.rank{r}.log (a file, not a pipe: a
    launch may run beside another, and a full pipe would stall its rank),
    and returns them."""
    port = str(free_port())
    procs = []
    # the ranks share the card with this process, all on expandable segments
    # (set at the top, inherited)
    for r in range(world):
        with open(out / f"{mode}.rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           worker, mode, str(r), str(world), port, str(out)],
                                          stdout=log, stderr=subprocess.STDOUT, text=True))
    return procs


@contextlib.contextmanager
def stopped_on_failure(procs):
    """Kills start_ranks' processes `procs` if the block raises: a launch
    that runs beside this process's work ends with the phase."""
    try:
        yield
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        raise


def finish_ranks(mode: str, procs, out: Path, timeout: int):
    """Waits for start_ranks' processes (each within `timeout` s), prints
    rank 0's "  (" lines, fails the phase on a failed rank and returns rank
    0's OUT/{mode}.json."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(out / f"{mode}.rank{r}.log").read_text() for r in range(len(procs))]
    print("\n".join(line for line in logs[0].splitlines() if line.startswith("  (")))
    failed = [f"{mode} rank {r} exited {p.returncode}:\n{logs[r][-3000:]}"
              for r, p in enumerate(procs) if p.returncode != 0]
    check(not failed, "\n".join(failed))
    return json.loads((out / f"{mode}.json").read_text())


def check_ring_chunks(q, k, v, do, case):
    """K1-K3 as ring attention calls them at seq 2 on one rank's queries: K1
    on each half of k/v, the (o, lse) merged as ops/ring_attention.py does,
    against the plain forward over all keys; K2 and K3 per half fed the
    merged o and global lse, dq summed, against the plain gradients over all
    keys. Returns {name: max abs error}."""
    from orbit2_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_bwd, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.ring_attention import _per_row

    b, n, h, d = q.shape
    halves = list(zip(k.chunk(2, 1), v.chunk(2, 1)))
    m = torch.full((b * h, n), float("-inf"), device="cuda")
    den = torch.zeros((b * h, n), device="cuda")
    num = torch.zeros((b, n, h, d), device="cuda")
    for kc, vc in halves:
        o_j, lse_j = flash_attention_fwd(q, kc.contiguous(), vc.contiguous())
        m_new = torch.maximum(m, lse_j)
        c_old, c_new = torch.exp2(m - m_new), torch.exp2(lse_j - m_new)
        num = num * _per_row(c_old, b, h) + o_j.float() * _per_row(c_new, b, h)
        den, m = den * c_old + c_new, m_new
    o = (num / _per_row(den, b, h)).to(q.dtype)
    lse = (m + torch.log2(den)).contiguous()
    want_o, want_lse = flash_attention_reference(q, k, v)
    err = {"fwd": hold_forward(o, lse, want_o, want_lse, f"{case}, merged over 2 chunks")}
    delta = attention_delta(o, do)
    parts = [flash_attention_bwd(q, kc.contiguous(), vc.contiguous(), o, lse, do, d ** -0.5,
                                 delta=delta) for kc, vc in halves]
    dq = sum(p[0].float() for p in parts).to(q.dtype)
    dk = torch.cat([p[1] for p in parts], 1)
    dv = torch.cat([p[2] for p in parts], 1)
    e, line = hold_grads([dq, dk, dv], plain_grads(q, k, v, do, None), case)
    print(f"  bwd {case}, per chunk against the global lse: {line}")
    err.update(e)
    return err


def seq_rows(shapes, gen, seed, call_s, smi):
    """K1, K2 and K3's rows at phase seqexpert's call shapes, {(path, name):
    row}: `shapes` maps a path to (b, n_q, n_k, h, d, dropout, launches a
    step by kernel name). Each by events and by its kernel time alone, its
    plain version (two batch elements at a time), SDPA's flash backend at
    the same shapes and dropout (its whole backward for K2 and K3) and its
    bound."""
    from orbit2_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, attention_delta, attention_flops,
        flash_attention_bwd_reference, flash_attention_fwd, flash_attention_reference)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    rows = {}
    for path, (b, n_q, n_k, h, d, rate, launched) in shapes.items():
        q, k, v = make_qkv(b, n_q, n_k, h, d, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, None, rate, seed)
        delta = attention_delta(o, do)
        parts = [slice(i, min(b, i + 2)) for i in range(0, b, 2)]
        mults = [keep_mult(seed, n_q, n_k, rate, streams=(sl.stop - sl.start) * h,
                           device="cuda", first_stream=sl.start * h) if rate else None
                 for sl in parts]

        def plain_fwd():
            for sl, mult in zip(parts, mults):
                flash_attention_reference(q[sl], k[sl], v[sl], None, mult)

        def plain_bwd():
            for sl, mult in zip(parts, mults):
                flash_attention_bwd_reference(q[sl], k[sl], v[sl], o[sl],
                                              lse[sl.start * h:sl.stop * h], do[sl], d ** -0.5,
                                              mult)

        lib = sdpa_ms(q, k, v, do, bwd_rate=rate)
        att = attention_flops(b, n_q, n_k, h, d)
        rows_f32 = 4 * b * h * n_q
        calls = b * h * n_q * n_k / ELEMENTS_PER_CALL if rate else 0
        fns = {
            "flash_attn_fwd": (lambda: flash_attention_fwd(q, k, v, None, rate, seed), plain_fwd,
                               lib["fwd"][DROP if rate else 0.0],
                               roofline(att, nbytes(q, k, v, q) + rows_f32), "fwd"),
            "flash_attn_bwd_dq": (
                lambda: FLASH_BWD_DQ(q, k, v, do, lse, delta, d ** -0.5, rate, seed), plain_bwd,
                lib["bwd"], roofline(1.5 * att, nbytes(q, k, v, do, q) + 2 * rows_f32), "dq"),
            "flash_attn_bwd_dkv": (
                lambda: FLASH_BWD_DKV(q, k, v, do, lse, delta, d ** -0.5, rate, seed), plain_bwd,
                lib["bwd"], roofline(2 * att, nbytes(q, k, v, do, k, v) + 2 * rows_f32), "dkv"),
        }
        plain_ms = {}
        for name, (fn, plain, library, bound, op) in fns.items():
            if plain not in plain_ms:
                plain_ms[plain] = cuda_ms(plain, iters=3, warmup=1)
            bound = max(bound, (calls * call_s[op] * 1e3, "operations"))
            r = rows[(path, name)] = {
                "shape": [b, n_q, n_k, h, d], "dropout": rate, "ms": cuda_ms(fn),
                "kernel_ms": kernel_ms(fn), "plain_ms": plain_ms[plain], "library_ms": library,
                "bound_ms": bound[0], "bound_by": bound[1], "launches_per_step": launched[name]}
            print(f"  {path} {name} bf16 B{b} Nq{n_q} Nk{n_k} H{h} d{d} drop {rate:g}: "
                  f"{r['ms']:.4f} ms (kernel alone {r['kernel_ms']:.4f}), plain "
                  f"{r['plain_ms']:.4f}, SDPA (flash) {library:.4f}; bound {bound[0]:.4f} "
                  f"({bound[1]}); {launched[name]} launches a step; gpu: {smi}")
        del q, k, v, do, o, lse, delta, mults
        torch.cuda.empty_cache()
    return rows


def seqexpert_phase(root: Path, seed: int, call_s, smi):
    """Phase seqexpert (the constants' comment): (a) and (b) on two gloo
    ranks, (c) on four; then K1-K3 at the seq path's new call shapes against
    their plain versions (gather: N_q N/2 against N_k N; Ulysses: N with
    half the heads; a ring chunk, its halves merged and K2/K3 fed the merged
    lse), their rows, and K5's at the path's widths. Returns what the
    kernels line reads."""
    import yaml

    from orbit2_tpu_torch.config import load_config

    seq_raw, moe_raw = seqexpert_configs(root, seed)
    (root / "configs.yaml").write_text(yaml.safe_dump({"seq": seq_raw, "moe": moe_raw}))
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved); the card has "
          f"{free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free", flush=True)
    for kind, (batch, model) in {"dense": (MESH_TWO["batch"], {}),
                                 "moe": (MESH_TWO["batch"], MESH_MOE),
                                 "pipeline": (PP_STRICT["batch"],
                                              {"depth": PP_STRICT["depth"]})}.items():
        (root / f"serve_{kind}.yaml").write_text(yaml.safe_dump(
            strict_serve_raw(root / f"serve_{kind}", seed, batch, **model), sort_keys=False))
    # (c)'s four ranks (117M width: a few GiB each) beside (a) and (b)'s two:
    # both launches spend most of their time in gloo's host copies
    strict_procs = start_ranks("strict", 4, root, "--seqexpert-worker")
    with stopped_on_failure(strict_procs):
        full = launch_ranks("full", 2, root, timeout=600)
    lap("seqexpert (a), (b)")
    strict = finish_ranks("strict", strict_procs, root, timeout=420)
    lap("seqexpert (c), after (a) and (b)")

    m = load_config(seq_raw).model
    h, d = m.num_heads, m.embed_dim // m.num_heads
    n = (SEQ_LOW[0] // m.patch_size) * (SEQ_LOW[1] // m.patch_size)
    launched = {impl: {k: v // SEQ_STEPS for k, v in full[f"seq_{impl}"]["launches"].items()}
                for impl in SEQ_IMPL_DROP}
    shapes = {"seqexpert gather": (SEQ_BATCH, n // 2, n, h, d, SEQ_DROP, launched["gather"]),
              "seqexpert ulysses": (SEQ_BATCH, n, n, h // 2, d, SEQ_DROP, launched["ulysses"]),
              "seqexpert ring": (SEQ_BATCH, n // 2, n // 2, h, d, 0.0, launched["ring"])}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 43 + seed
    errs = {}
    for path, (b, n_q, n_k, hh, dd, rate, _) in shapes.items():
        case = f"{path} bf16 drop {rate:g} B{b} Nq{n_q} Nk{n_k} H{hh} d{dd}"
        if path.endswith("ring"):  # one rank's queries against both halves of all N keys
            q, k, v = make_qkv(b, n_q, 2 * n_k, hh, dd, torch.bfloat16, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            errs[path] = check_ring_chunks(q, k, v, do, case)
        else:
            q, k, v = make_qkv(b, n_q, n_k, hh, dd, torch.bfloat16, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            errs[path] = check_batch_rows(q, k, v, do, rate, kseed, [0, b - 1], case)
        del q, k, v, do
        torch.cuda.empty_cache()
    rows = seq_rows(shapes, gen, kseed, call_s, smi)
    lap("seqexpert kernels and rows")
    # K5 at the seq path's shapes, each with the gather fit's launches at it
    k5 = {}
    for r, c, launches in full["seq_gather"]["k5_widths"]:
        check_dropout(r, c, torch.bfloat16, SEQ_DROP, gen, kseed)
        k5[(r, c)] = k5_row((r, c), torch.bfloat16, SEQ_DROP, gen, kseed, launches, smi,
                            "seqexpert gather")
    out = {"seq": {impl: {k: full[f"seq_{impl}"][k] for k in (
        "losses", "launches", "k5_widths", "fit_s", "collective_s", "collective_calls", "peak_gib",
        "param_rel", "param_worst", "state_rel", "loss_rel", "grad_rel", "grad_param_rel",
        "grad_worst")} | {
            "one_rank": full[f"seq_{impl}"]["one_rank"]} for impl in SEQ_IMPL_DROP},
           "expert": full["expert"], "strict": strict,
           "geometry": {"seq": [SEQ_BATCH, n, h, d, m.depth], "expert_depth": EXPERT_DEPTH,
                        "expert_batch_tiles": EXPERT_BATCH}}
    return {"out": out, "rows": rows, "errs": errs, "k5": k5, "launched": full}


# phase pipeline: configs/interm_1b_pp.yaml's model (embed 3072, 24 heads)
# and schedule (2 stages, 8 microbatches of a 32-tile batch,
# interleave 2) on the 1B tiles, its mesh cut to the stage axis (fsdp 4 and
# tensor 2 to 1): two gloo ranks on the card. (b)'s fp32 meshes run in phase
# seqexpert's four-rank launch.
CONFIG_PP = ROOT / "configs" / "interm_1b_pp.yaml"
PP_FIELDS = 4
PP_STEPS = 2
# interm_1b_pp.yaml's depth 8 cut to 4 (still dc 1 at S 2, V 2): the
# script's time and two ranks' memory beside this process's (phase pipeline
# ran at depth 8 alone on the card)
PP_DEPTH = 4
PP_SEED = 29
# the gradients (a) holds: the trunk's as one vector (rank 0, gathered over
# the stages), and on each stage those of the parameters before the trunk
EMBED = r"^(token_embeds\.|var_embed$|var_query$|var_agg\.|spatial_embed\.|pos_embed$)"
PP_GRADS = f"{TRUNK}|{EMBED}"
PP_STRICT = dict(depth=4, batch=8, microbatches=4)
PP_MESHES = {"stage2_fsdp2": dict(stage=2, fsdp=2), "stage2_tensor2": dict(stage=2, tensor=2)}


def pipeline_raw(root: Path, seed: int):
    """configs/interm_1b_pp.yaml as a raw dict on a synthetic train split of
    PP_FIELDS fields at LOW_1B, its mesh cut to stage 2 alone."""
    raw = raw_config(root, seed, CONFIG_PP, model={"depth": PP_DEPTH}, n_files=1, t=PP_FIELDS,
                     low=LOW_1B, shards=("train", "test"))
    raw["parallelism"].update(fsdp=1, tensor_par=1, simple_ddp=1)
    return raw


def pipeline_launches(depth, stages, interleave, microbatches, stage, drop=True):
    """Kernel launches of one pipelined train step on stage `stage` under
    full remat (module docstring of orbit2_tpu_torch/parallel/pipeline.py:
    the bubble runs no Block): each of the stage's Blocks runs once a
    microbatch, K1 twice (the recomputation), K2 and K3 once, K5 at three
    sites forward, in the recomputation and backward but for Block 0's last
    in its recomputation (remat_launches); pos_drop's K5, forward and
    backward, on every stage. Returns (the counts, widths(batch rows,
    microbatch rows, embed, hidden): K5's [rows, cols, launches])."""
    from orbit2_tpu_torch.parallel.pipeline import owned_blocks

    held = owned_blocks(depth, stages, interleave, stage)
    calls = microbatches * len(held)
    skipped = microbatches * (0 in held)
    k5 = 2 + 9 * calls - skipped if drop else 0
    counts = only(flash_attn_fwd=2 * calls, flash_attn_bwd_dq=calls, flash_attn_bwd_dkv=calls,
                  fused_dropout=k5)

    def widths(batch_rows, micro_rows, d, hidden):
        if not drop:
            return []
        return sorted([[batch_rows, d, 2], [micro_rows, d, 6 * calls - skipped],
                       [micro_rows, hidden, 3 * calls]])
    return counts, widths


def pp_fit(cfg, weights, label, steps, grads_of=None, keep=False):
    """Trainer.fit of `cfg` from `weights`, `steps` steps, on this rank:
    {losses, launches, K5's by [rows, cols], step seconds, collective
    seconds and calls, peak GiB; with `keep` the trained model whole as
    "state"}, and the first step's gradients of the parameters matching
    `grads_of` (None: none kept), each whole; on a stage mesh the trunk's
    are then handed over the stages (full_named), so every rank holds all
    of them."""
    from orbit2_tpu_torch.parallel.sharding import full_named, full_state_dict
    from orbit2_tpu_torch.training.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, "cuda", state_dict=weights)
    reset_counts()
    with timed_collectives() as coll, launch_widths(kernels()["fused_dropout"]) as widths:
        with first_step_grads(grads_of or "$^") as grads:
            hist = trainer.fit(max_epochs=1, max_steps_per_epoch=steps)
        torch.cuda.synchronize()
    launched = counts()
    out = {"losses": [r["loss"] for r in hist], "launches": launched,
           "k5_widths": sorted([r, c, n] for (r, c), n in widths.items()),
           "step_s": hist[0]["seconds"] / steps, "collective_s": coll["s"] / steps,
           "data_wait_s": hist[0]["data_wait_s"] / steps,
           "collective_calls": coll["calls"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if getattr(trainer.model, "stage_split", None) is not None and grads:
        grads = full_named(trainer.model, grads)
    if keep:
        out["state"] = full_state_dict(trainer.model)
    print(f"  {label}: losses {out['losses']}, {out['step_s']:.3f} s a step "
          f"({out['collective_s']:.3f} s in {coll['calls'] // steps} collectives, "
          f"{out['data_wait_s']:.3f} s waiting for data a step), "
          f"peak {out['peak_gib']:.2f} GiB, launches {launched}", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out, grads


def pp_config(raw, drop_rate=None, **par):
    """seqexp_config of a pipeline raw dict: these parallelism entries and
    dropout (and drop-path) rate."""
    cfg = seqexp_config(raw, drop_rate, **par)
    if drop_rate is not None:
        cfg.model.drop_path = drop_rate
    return cfg


def pp_readings(grads, ref):
    """(the trunk's first-step gradients' relative Frobenius error against
    one rank's, where this rank holds them all; the embedding's; the worst
    single parameter and its reading) by rel_grads."""
    out = {}
    for name, pattern in (("trunk", TRUNK), ("embed", EMBED)):
        got = {k: g for k, g in grads.items() if re.search(pattern, k)}
        want = {k: ref[k] for k in got}
        if got:
            whole, worst, worst_name = rel_grads(got, want)
            out[name] = whole
            out[f"{name}_worst"] = (worst_name, worst)
    return out


def pp_reference(raw, weights, out: Path, steps=1):
    """Phase pipeline (a)'s one-rank fit, unpipelined, at dropout 0, before
    the group starts: `steps` steps, the first step's gradients kept (the
    embedding's also in OUT/pp_embed_ref.pt, for the other stage). Returns
    (pp_fit's result, the gradients)."""
    run, grads = pp_fit(pp_config(raw, 0.0, pipeline=1, pipeline_interleave=1), weights,
                        "(a) one rank, dropout 0", steps, PP_GRADS)
    torch.save({k: g for k, g in grads.items() if re.search(EMBED, k)}, out / "pp_embed_ref.pt")
    return run, grads


def pp_grad_check(rank, raw, weights, ref, out: Path, label="(a)"):
    """Phase pipeline (a)'s gradient check on one of its two ranks: one
    pipelined step at dropout 0 (the config's schedule), exact K1-K3
    launches, and its readings against the one rank's (rank 0: the trunk's
    gathered and its embedding's; rank 1: its embedding's, against
    OUT/pp_embed_ref.pt). Returns {readings, the largest}: on rank 0 both
    ranks' (rank 1's over the stage group)."""
    import torch.distributed as dist

    cfg = pp_config(raw, 0.0)
    run, grads = pp_fit(cfg, weights, f"{label} stage 2 rank {rank}, dropout 0", 1, PP_GRADS)
    par, m = cfg.parallelism, cfg.model
    want, _ = pipeline_launches(m.depth, par.pipeline, par.pipeline_interleave,
                                par.pipeline_microbatches, rank, drop=False)
    check(run["launches"] == want, f"{label} dropout 0: launches {run['launches']}, want {want}")
    if rank != 0:
        ref = torch.load(out / "pp_embed_ref.pt")
        grads = {k: g for k, g in grads.items() if re.search(EMBED, k)}
    readings = pp_readings(grads, ref)
    both = [None, None]
    dist.all_gather_object(both, readings)
    largest = max(v for r in both for k, v in r.items() if not k.endswith("_worst"))
    if rank == 0:
        print(f"  {label} the first-step gradients at dropout 0 against one rank's: trunk "
              f"{both[0]['trunk']:.3e} (worst {both[0]['trunk_worst']}), embedding on stage 0 "
              f"{both[0]['embed']:.3e}, on stage 1 {both[1]['embed']:.3e} (worst "
              f"{both[1]['embed_worst']}); the largest {largest:.3e}", flush=True)
    return {"readings": both, "grad_rel": largest}


def pp_fits(rank, raw, weights, ref, out: Path):
    """Phase pipeline (a) on one of its two ranks: the gradient check
    (within SEQEXP_GRAD_REL), then PP_STEPS steps at the config's dropout under
    its interleaved schedule and under GPipe (V 1): exact launches, K5 by
    width, finite losses, the step and gloo seconds, peak memory. Returns
    rank 0's results, each schedule's runs of both ranks."""
    import torch.distributed as dist

    from orbit2_tpu_torch.config import load_config

    result = {"grads": pp_grad_check(rank, raw, weights, ref, out)}
    check(result["grads"]["grad_rel"] <= SEQEXP_GRAD_REL,
          f"(a) the first-step gradients {result['grads']['grad_rel']:.3e} from one rank's")
    cfg = load_config(raw)
    m, par = cfg.model, cfg.parallelism
    tokens = (TILE_MOE[0] // m.patch_size) * (TILE_MOE[1] // m.patch_size)  # the 1B tiles'
    rows = cfg.trainer.batch_size * tokens  # a rank's batch: the stage axis splits no data
    for name, v in (("interleaved", par.pipeline_interleave), ("gpipe", 1)):
        run, _ = pp_fit(pp_config(raw, pipeline_interleave=v), weights,
                        f"(a) {name} (V {v}) rank {rank}", PP_STEPS, keep=name == "gpipe")
        trained = run.pop("state", None)
        want, widths = pipeline_launches(m.depth, par.pipeline, v, par.pipeline_microbatches,
                                         rank)
        want = {k: n * PP_STEPS for k, n in want.items()}
        check(run["launches"] == want, f"(a) {name}: launches {run['launches']}, want {want}")
        want_widths = [[r, c, n * PP_STEPS] for r, c, n in widths(
            rows, rows // par.pipeline_microbatches, m.embed_dim, int(m.embed_dim * m.mlp_ratio))]
        check(run["k5_widths"] == want_widths,
              f"(a) {name}: K5 by [rows, cols, launches] {run['k5_widths']}, want {want_widths}")
        check(all(np.isfinite(run["losses"])), f"(a) {name}: losses {run['losses']}")
        both = [None, None]
        dist.all_gather_object(both, run)
        result[name] = both
    # the GPipe fit's model served at stage 2 under both schedules
    result["serve"] = serve_meshes(rank, raw, {
        name: {"pipeline": par.pipeline, "pipeline_microbatches": par.pipeline_microbatches,
               "pipeline_interleave": v}
        for name, v in (("interleaved", par.pipeline_interleave), ("gpipe", 1))}, "(a)",
        bound=SERVE_METRIC_REL, state=trained)
    return result if rank == 0 else {}


def pipeline_worker(mode: str, rank: int, world: int, port: str, out_dir: str):
    """One of phase pipeline (a)'s two ranks (mode "pipeline"): the weights
    drawn on the card, rank 0's one-rank runs before the group starts, then
    pp_fits. Rank 0 writes OUT_DIR/pipeline.json; a failing check raises."""
    import datetime
    import faulthandler

    import torch.distributed as dist
    import yaml

    faulthandler.enable()
    torch.cuda.set_device(0)
    out = Path(out_dir)
    raw = yaml.safe_load((out / "pipeline.yaml").read_text())
    weights = drawn_weights(pp_config(raw, pipeline=1, pipeline_interleave=1), PP_SEED)
    one, ref = pp_reference(raw, weights, out, PP_STEPS) if rank == 0 else (None, None)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=900))
    result = pp_fits(rank, raw, weights, ref, out)
    if rank == 0:
        (out / f"{mode}.json").write_text(json.dumps(dict(result, one_rank=one)))
    dist.barrier()
    dist.destroy_process_group()


def pipeline_phase(root: Path, seed: int, call_s, smi, strict):
    """Phase pipeline (the constants' comment): (a) on two gloo ranks, its
    readings, launches against pipeline_launches, step and gloo seconds and
    peak memory a rank beside one rank's, GPipe beside interleaved; (b)'s
    results from phase seqexpert's launch (`strict`); (c) K1-K3 at a
    microbatch's shape on two batch elements and K5 at its widths against
    their plain versions, and their rows. Returns what the kernels line
    reads."""
    import yaml

    from orbit2_tpu_torch.config import load_config

    raw = pipeline_raw(root, seed)
    (root / "pipeline.yaml").write_text(yaml.safe_dump(raw))
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  the card has {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free", flush=True)
    full = launch_ranks("pipeline", 2, root, timeout=600, worker="--pipeline-worker")
    lap("pipeline (a)")
    cfg = load_config(raw)
    m, par = cfg.model, cfg.parallelism
    one = full["one_rank"]
    for name in ("interleaved", "gpipe"):
        v = par.pipeline_interleave if name == "interleaved" else 1
        for rank, run in enumerate(full[name]):
            want = pipeline_launches(m.depth, par.pipeline, v, par.pipeline_microbatches, rank)[0]
            print(f"  (a) {name} (V {v}) rank {rank}: a step {run['step_s']:.3f} s, "
                  f"{run['collective_s'] / run['step_s']:.3f} of it in gloo, "
                  f"{run['data_wait_s'] / run['step_s']:.3f} waiting for data; launches a step "
                  f"{ {k: n // PP_STEPS for k, n in run['launches'].items() if n} } (predicted "
                  f"{ {k: n for k, n in want.items() if n} }); peak {run['peak_gib']:.2f} GiB "
                  f"(one rank {one['peak_gib']:.2f}, {one['step_s']:.3f} s a step, "
                  f"{one['data_wait_s']:.3f} waiting for data); gpu: {smi}")
    h, d = m.num_heads, m.embed_dim // m.num_heads
    n = (TILE_MOE[0] // m.patch_size) * (TILE_MOE[1] // m.patch_size)
    mb = cfg.trainer.batch_size // par.pipeline_microbatches
    launched = {k: v // PP_STEPS for k, v in full["interleaved"][0]["launches"].items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 44 + seed
    case = f"pipeline bf16 drop {DROP:g} B{mb} N{n} H{h} d{d}"
    q, k, v = make_qkv(mb, n, n, h, d, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    errs = check_batch_rows(q, k, v, do, DROP, kseed, [0, mb - 1], case)
    del q, k, v, do
    torch.cuda.empty_cache()
    rows = seq_rows({"pipeline": (mb, n, n, h, d, DROP, launched)}, gen, kseed, call_s, smi)
    k5 = {}
    for r, c, launches in full["interleaved"][0]["k5_widths"]:
        if r == mb * n:  # the microbatch's widths (pos_drop's batch width is train1b's)
            check_dropout(r, c, torch.bfloat16, DROP, gen, kseed)
            k5[(r, c)] = k5_row((r, c), torch.bfloat16, DROP, gen, kseed, launches, smi,
                                "pipeline")
    out = {"grads": full["grads"], "one_rank": one, "strict": strict,
           **{name: full[name] for name in ("interleaved", "gpipe")},
           "geometry": {"batch": cfg.trainer.batch_size, "microbatches": par.pipeline_microbatches,
                        "interleave": par.pipeline_interleave, "stages": par.pipeline,
                        "depth": m.depth, "tokens": n, "heads": h, "head_dim": d}}
    lap("pipeline kernels and rows")
    return {"out": out, "rows": rows, "errs": errs, "k5": k5, "launched": full}


def strict_pipeline(rank, step_of, kw, args, drawn):
    """Phase pipeline (b) on one of the four ranks of phase seqexpert's (c)
    launch: the fp32 model of (c) at depth PP_STRICT["depth"], batch
    PP_STRICT["batch"], on each of PP_MESHES under GPipe and the interleaved
    schedule (M PP_STRICT["microbatches"]), one step against the unwrapped,
    unpipelined model's on this rank: the loss and the gradient of every
    parameter the rank holds within MESH_REL, exact launches. Returns rank
    0's results (readings the largest over the ranks)."""
    import torch.distributed as dist

    from orbit2_tpu_torch.evaluate import materialize
    from orbit2_tpu_torch.models import ResSlimViT
    from orbit2_tpu_torch.parallel import (
        AXIS_STAGE, data_group, data_rank, data_size, full_tensor, make_mesh, shard_model)
    from orbit2_tpu_torch.parallel.pipeline import owned_blocks

    depth, b, mb = PP_STRICT["depth"], PP_STRICT["batch"], PP_STRICT["microbatches"]
    kw = dict(kw, depth=depth)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(b, 7, 64, 128)).astype(np.float32)).cuda()
    y = torch.from_numpy((rng.normal(size=(b, 3, 256, 512)) * 0.5).astype(np.float32)).cuda()
    with torch.device("meta"):
        ref = ResSlimViT(*args, **kw)
    materialize(ref, "cuda", generator=drawn())
    loss_one = step_of(ref)(x, y, torch.Generator(), None).item()
    one = {k: p.grad.detach().cpu() for k, p in ref.named_parameters() if p.grad is not None}
    floor = GRAD_FLOOR * max(float(g.norm()) for g in one.values())
    del ref
    result = {}
    for name, axes in PP_MESHES.items():
        for sched, v in (("gpipe", 1), ("interleaved", 2)):
            mesh = make_mesh(device_type="cuda", **axes)
            with torch.device("meta"):
                skeleton = ResSlimViT(*args, **kw, pipeline_stages=2, pipeline_microbatches=mb,
                                      pipeline_interleave=v)
            model = shard_model(copy.deepcopy(skeleton), mesh)
            model.to_empty(device="cuda")
            materialize(skeleton, "cuda", generator=drawn(), into=model)
            xs, ys = (t.chunk(data_size(mesh))[data_rank(mesh)] for t in (x, y))
            step = step_of(model)
            reset_counts()
            loss = step(xs, ys, torch.Generator(), None).detach().clone()
            torch.cuda.synchronize()
            launched = counts()
            calls = mb * len(owned_blocks(depth, 2, v, mesh.get_local_rank(AXIS_STAGE)))
            want = only(flash_attn_fwd=calls, flash_attn_bwd_dq=calls, flash_attn_bwd_dkv=calls)
            check(launched == want, f"(b) {name} {sched}: launches {launched}, want {want}")
            dist.all_reduce(loss, group=data_group(mesh))
            loss = loss.item() / data_size(mesh)
            grads = {k: full_tensor(p.grad).cpu() for k, p in model.named_parameters()
                     if p.grad is not None}
            rel = {k: float((g - one[k]).norm()) / max(float(one[k].norm()), floor)
                   for k, g in grads.items()}
            worst = max(rel, key=rel.get)
            reading = torch.tensor([rel[worst], abs(loss - loss_one) / abs(loss_one)])
            dist.all_reduce(reading, op=dist.ReduceOp.MAX)
            if rank == 0:
                r = {"loss": loss, "loss_one": loss_one, "max_rel": float(reading[0]),
                     "loss_rel": float(reading[1]), "launches_rank0": launched}
                print(f"  (pipeline b) {name} {sched} (V {v}, M {mb}), fp32: loss {loss!r} "
                      f"against one rank's {loss_one!r}; every rank's gradients within "
                      f"{r['max_rel']:.3e} relative Frobenius", flush=True)
                check(r["loss_rel"] <= MESH_REL and r["max_rel"] <= MESH_REL,
                      f"(b) {name} {sched} differs from the one-rank step: {r}")
                result[f"{name}_{sched}"] = r
            del model, step, grads
            torch.cuda.empty_cache()
    return result


# serving on a mesh (phase servemesh, after mesh, from serve1b's weights, the
# npz phase mesh reads): configs/interm_1b.yaml's model at full width and
# depth (embed 3072, depth 8, 24 heads of d 128, gelu tanh, bf16) on serve1b's
# tiles (66 x 132, 2,178 tokens), a test split of SERVE_FILES files of one
# field each (16 tiles: one BATCH_1B-tile batch a file). (a) two gloo ranks on
# the card under each of SERVE_MESHES (the config's own axes cut to two
# ranks; both pairs at once): test() over BATCHES_1B batches in bf16 and in
# w8a8, an MC ensemble of SERVE_MC members, and at tensor 2 one stitched
# field (at fsdp 2 each tile's forward re-gathers the weights: 38 s), each
# held against one rank serving the same weights: the round-0 prediction
# (gathered over the data ranks) within PRED_BF16_TOL and its trunk's output
# within TRUNK_BF16_REL, the stitched field's trunk within TRUNK_BF16_REL,
# and every metric within SERVE_METRIC_REL (relative; mean_bias relative to
# its variable's rmse, pearson, near 0 at random weights, absolute) of the
# one rank's over the same rounds (at fsdp 2 a round is both data ranks'
# batches); the samples counted exactly. Sound readings: fsdp 2 bit-equal,
# tensor 2 7.8e-7; chip_faults.py servemesh's faults 1.4e-4 (a data rank's
# rows dropped; its samples 16 of 32 too) and 1.9e-3 (the row-parallel sum
# skipped; its trunk 1.11). (b) python -m orbit2_tpu_torch.evaluate under a
# one-rank NCCL group set up from torchrun's variables, on the config with
# its mesh at 1, beside (a)'s ranks: the wrapped Evaluator against the
# unwrapped one, metrics and prediction bit for bit
SERVE_FILES = 2
SERVE_MESHES = {"fsdp": {"fsdp": 2}, "tensor": {"tensor_par": 2}}
SERVE_MC = 2
SERVE_METRIC_REL = 2e-5


def serve_readings(got, want):
    """The largest error of the metrics `got` against `want` (test()'s dicts)
    as SERVE_METRIC_REL reads it, and its metric."""
    rel = {}
    for k, w in want.items():
        var = k.split(":")[1]
        scale = (abs(want[f"test/rmse:{var}"]) if "mean_bias" in k
                 else 1.0 if "pearson" in k else abs(w))
        rel[k] = abs(got[k] - w) / max(scale, 1e-30)
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def serve_raws(root: Path, seed: int):
    """{mode: raw config} of phase servemesh: interm_1b.yaml on the phase's
    test split, batch BATCH_1B, its mesh at 1 ("one") or SERVE_MESHES'."""
    raw = raw_config(root / "data", seed, CONFIG_1B, trainer={"batch_size": BATCH_1B},
                     n_files=SERVE_FILES, t=1, low=LOW_1B, shards=("test",))
    out = {}
    for mode, par in (("one", {}), *SERVE_MESHES.items()):
        r = copy.deepcopy(raw)
        r["parallelism"] = dict({a: 1 for a in MESH_AXES}, **par)
        out[mode] = r
    return out


def serve_rounds(cfg, data_size):
    """The (x, y) of the rounds a mesh of `data_size` data ranks of `cfg`
    gathers, each data rank's batch in turn, on one process."""
    from orbit2_tpu_torch.evaluate import make_data_module

    key = next(iter(cfg.data.low_res_dir))
    dms = [make_data_module(cfg, key, cfg.tiling.effective_div, cfg.tiling.effective_overlap,
                            "test", data_par_size=data_size, data_par_rank=r)
           for r in range(data_size)]
    loaders = [iter(dm.test_dataloader()) for dm in dms]
    try:
        for _ in range(BATCHES_1B):
            parts = [next(it) for it in loaders]
            yield tuple(torch.from_numpy(np.concatenate([p[i] for p in parts])).cuda()
                        for i in (0, 1))
    finally:
        for it in loaders:
            it.close()


def serve_reference(ev, cfgs, root: Path):
    """Phase servemesh's one rank (the unwrapped Evaluator `ev`): for each
    mesh, the metrics over the rounds it gathers (bf16 and w8a8) and round
    0's prediction and trunk output; field 0 stitched and its tiles' trunk
    outputs; test()'s seconds a batch and peak memory. Saved to
    ROOT/serve_ref.pt for the ranks; returns what the phase prints."""
    from orbit2_tpu_torch.evaluate import make_data_module
    from orbit2_tpu_torch.training.train import evaluate_batch, make_eval_step

    in_vars, out_vars = ev.data_module.get_data_variables()
    ref = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref["test"] = ev.test(max_batches=BATCHES_1B)
    torch.cuda.synchronize()
    ref["batch_s"] = (time.perf_counter() - t0) / BATCHES_1B
    ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for mode, par in SERVE_MESHES.items():
        ds = par.get("fsdp", 1) * par.get("simple_ddp", 1)
        for quant in ("none", "w8a8"):
            model = ev.serving_model(quant)
            step = make_eval_step(model, in_vars, out_vars)
            agg, n = {}, 0
            for i, (x, y) in enumerate(serve_rounds(cfgs[mode], ds)):
                if i == 0 and quant == "none":
                    with torch.no_grad(), trunk_outputs(model) as trunks:
                        ref[f"{mode}/pred"] = model(x, in_vars, out_vars).float().cpu()
                    ref[f"{mode}/trunk"] = trunks[0].cpu()
                yhat = step(x, y)
                for k, v in evaluate_batch(yhat, y, "test", ev.test_losses, ev.test_transforms,
                                           out_vars).items():
                    agg[k] = agg.get(k, 0.0) + v.item() * x.shape[0]
                n += x.shape[0]
            ref[f"{mode}/{quant}"] = {k: v / n for k, v in agg.items()}
            ref[f"{mode}/samples"] = n
    cfg = cfgs["one"]
    dm_vis = make_data_module(cfg, ev.data_key, 1, 0, "test")
    sample, _, names, _ = next(iter(dm_vis.data_test))
    x_full = np.stack([sample[k] for k in names])
    with trunk_outputs(ev.model) as trunks:
        ref["field"], ref["field_s"] = stitch_field(
            ev.model, x_full, cfg.tiling.effective_div, cfg.tiling.effective_overlap,
            cfg.model.superres_mag, in_vars, out_vars)
    ref["field"], ref["field_trunk"] = torch.from_numpy(ref["field"]), torch.cat(trunks).cpu()
    torch.save(ref, root / "serve_ref.tmp.pt")
    os.replace(root / "serve_ref.tmp.pt", root / "serve_ref.pt")  # the ranks wait for it
    return ref


def servemesh_field(ev, cfg, ref, mode: str):
    """Phase servemesh (a): field 0 stitched on the mesh against the one
    rank's (its tiles' trunks within TRUNK_BF16_REL, the field within
    PRED_BF16_TOL), depth x tiles K1 launches. Returns the readings."""
    from orbit2_tpu_torch.evaluate import make_data_module

    m, r = cfg.model, {}
    in_vars, out_vars = ev.data_module.get_data_variables()
    dm_vis = make_data_module(cfg, ev.data_key, 1, 0, "test")
    sample, _, names, _ = next(iter(dm_vis.data_test))
    x_full = np.stack([sample[k] for k in names])
    div = cfg.tiling.effective_div
    reset_counts()
    with trunk_outputs(ev.model) as trunks:
        field, r["field_s"] = stitch_field(ev.model, x_full, div,
                                           cfg.tiling.effective_overlap, m.superres_mag,
                                           in_vars, out_vars)
    r["field_launches"] = counts()
    check(r["field_launches"] == only(flash_attn_fwd=m.depth * div * div),
          f"({mode}) the stitched field launched {r['field_launches']}")
    r["field_trunk_rel"] = rel_frob(torch.cat(trunks), ref["field_trunk"].cuda())
    want_field = ref["field"].numpy()
    r["field_max_abs"] = float(np.abs(field - want_field).max())
    check(r["field_trunk_rel"] <= TRUNK_BF16_REL and np.allclose(
        field, want_field, atol=PRED_BF16_TOL, rtol=PRED_BF16_TOL),
          f"({mode}) the stitched field's trunk {r['field_trunk_rel']:.3e}, field "
          f"{r['field_max_abs']:.3e} from one rank's")
    return r


def servemesh_rank(rank: int, root: Path, weights, mode: str):
    """Phase servemesh (a) on one of its two gloo ranks: SERVE_MESHES[mode]
    served from `weights` (an npz path; None: drawn from trainer.seed, as
    the one rank draws them) against ROOT/serve_ref.pt; tensor 2 also
    stitches the field. Returns rank 0's readings (both ranks' seconds, gloo
    seconds and peak memory); every failing check is raised (check)."""
    import torch.distributed as dist

    import yaml

    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.evaluate import Evaluator
    from orbit2_tpu_torch.parallel import data_group, data_size
    from orbit2_tpu_torch.training.checkpoint import load_state_npz
    from orbit2_tpu_torch.utils.mc_dropout import get_monte_carlo_predictions

    state = load_state_npz(weights) if weights else None
    cfg = load_config(yaml.safe_load((root / f"serve_{mode}.yaml").read_text()))
    m = cfg.model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev = Evaluator(cfg, "cuda", state_dict=state)
    r = {"build_s": time.perf_counter() - t0}
    in_vars, out_vars = ev.data_module.get_data_variables()
    # the one rank's results, which this process's start overlaps
    while not (root / "serve_ref.pt").exists():
        time.sleep(0.5)
    ref = torch.load(root / "serve_ref.pt")
    for quant in ("none", "w8a8"):
        reset_counts()
        with timed_collectives() as coll:
            t0 = time.perf_counter()
            metrics = ev.test(max_batches=BATCHES_1B, quant=quant)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launched = counts()
        rel, worst = serve_readings(metrics, ref[f"{mode}/{quant}"])
        r[quant] = {"metrics": metrics, "samples": ev.last_test["samples"],
                    "metric_rel": rel, "metric_worst": worst, "launches": launched,
                    "batch_s": seconds / BATCHES_1B, "gloo_s": coll["s"] / BATCHES_1B}
        check(launched == only(flash_attn_fwd=m.depth * BATCHES_1B),
              f"({mode} {quant}) test() launched {launched}, want flash_attn_fwd = depth x "
              f"batches = {m.depth * BATCHES_1B} and nothing else")
        check(ev.last_test["samples"] == ref[f"{mode}/samples"],
              f"({mode} {quant}) {ev.last_test['samples']} samples, one rank "
              f"{ref[f'{mode}/samples']}")
        check(rel <= SERVE_METRIC_REL, f"({mode} {quant}) the metrics {rel:.3e} ({worst}) "
              f"from one rank's")
    # round 0's prediction and trunk, gathered over the data ranks
    loader = iter(ev.data_module.test_dataloader())
    x = torch.from_numpy(next(loader)[0]).cuda()
    loader.close()
    with torch.no_grad(), trunk_outputs(ev.model) as trunks:
        pred = ev.model(x, in_vars, out_vars).float()
    trunk = trunks[0]
    if data_size(ev.mesh) > 1:
        parts = [[torch.empty_like(t) for _ in range(data_size(ev.mesh))] for t in (pred, trunk)]
        for t, p in zip((pred, trunk), parts):
            dist.all_gather(p, t.contiguous(), group=data_group(ev.mesh))
        pred, trunk = (torch.cat(p) for p in parts)
    want_pred = ref[f"{mode}/pred"].cuda()
    same_shape = pred.shape == want_pred.shape
    r["pred_max_abs"] = (pred - want_pred).abs().max().item() if same_shape else math.inf
    r["trunk_rel"] = rel_frob(trunk, ref[f"{mode}/trunk"].cuda()) if same_shape else math.inf
    check(same_shape and bool(torch.isclose(pred, want_pred, atol=PRED_BF16_TOL,
                                            rtol=PRED_BF16_TOL).all()),
          f"({mode}) round 0's prediction {tuple(pred.shape)} off one rank's "
          f"{tuple(want_pred.shape)} by {r['pred_max_abs']:.3e}")
    check(r["trunk_rel"] <= TRUNK_BF16_REL, f"({mode}) round 0's trunk {r['trunk_rel']:.3e} "
          f"from one rank's")
    if mode == "tensor":  # one stitched field: every rank runs every tile
        r.update(servemesh_field(ev, cfg, ref, mode))
    # an MC ensemble: K1 with dropout and K5, the seeds folded with the rank's coordinates
    reset_counts()
    with launch_widths(kernels()["fused_dropout"]) as widths:
        ens = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, SERVE_MC,
                                          torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
    r["mc_launches"], r["mc_widths"] = counts(), sorted([a, b, n] for (a, b), n
                                                        in widths.items())
    # the same seed repeats the first member (its seeds are the generator's first)
    again = get_monte_carlo_predictions(ev.model, x, in_vars, out_vars, 1,
                                        torch.Generator().manual_seed(5))
    check(r["mc_launches"] == only(flash_attn_fwd=SERVE_MC * m.depth,
                                   fused_dropout=SERVE_MC * (1 + 3 * m.depth)),
          f"({mode}) MC launches {r['mc_launches']}")
    check(torch.equal(ens[:1], again) and not torch.equal(ens[0], ens[1])
          and bool(ens.isfinite().all()), f"({mode}) the MC ensemble: seeded repeat, "
          f"members equal or not finite")
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    both = [None, None]
    dist.all_gather_object(both, r)
    return {mode: both}


def servemesh_worker(mode: str, rank: int, port: str, out_dir: str):
    """One of phase servemesh (a)'s two gloo ranks on the card, serving
    SERVE_MESHES[mode]: servemesh_rank from OUT_DIR's weights; rank 0
    writes OUT_DIR/{mode}.json."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()
    torch.cuda.set_device(0)
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=600))
    weights = (out / "weights.txt").read_text().strip() or None
    result = servemesh_rank(rank, out, weights, mode)
    if rank == 0:
        (out / f"{mode}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def serve_cli_one_rank(path: Path, weights: str, ev):
    """Phase servemesh (b): `python -m orbit2_tpu_torch.evaluate` on `path`
    (mesh 1) under a one-rank NCCL group that torchrun's variables describe,
    against the unwrapped Evaluator `ev` on the same config and weights:
    metrics, the printed JSON and one batch's prediction bit for bit."""
    import io

    import torch.distributed as dist

    from orbit2_tpu_torch import evaluate as evaluate_mod

    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io.StringIO()
    try:
        reset_counts()
        with contextlib.redirect_stdout(out):
            cli = evaluate_mod.main([str(path), "--torch-npz", weights, "--device", "cuda",
                                     "--max-batches", str(BATCHES_1B)])
        launched = counts()
        check(dist.is_initialized() and dist.get_backend() == "nccl" and cli.mesh is not None,
              "the evaluate CLI joined no NCCL group or served unwrapped")
        printed = json.loads(out.getvalue())
        want = ev.last_test["means"]
        loader = iter(ev.data_module.test_dataloader())
        x = torch.from_numpy(next(loader)[0]).cuda()
        loader.close()
        in_vars, out_vars = ev.data_module.get_data_variables()
        with torch.no_grad():
            same_pred = torch.equal(cli.model(x, in_vars, out_vars), ev.model(x, in_vars,
                                                                             out_vars))
        r = {"metrics_equal": cli.last_test["means"] == want,
             "printed_equal": printed == {k: round(float(v), 6) for k, v in want.items()},
             "pred_equal": same_pred, "launches": launched}
        print(f"  (b) evaluate CLI under a one-rank NCCL group (torchrun's variables), "
              f"{path.name}: metrics bit-equal to the unwrapped Evaluator's "
              f"{r['metrics_equal']}, printed JSON equal {r['printed_equal']}, one batch's "
              f"prediction bit-equal {same_pred}; launches {nonzero(launched)}")
        check(r["metrics_equal"] and r["printed_equal"] and same_pred,
              f"the wrapped evaluate CLI differs from the unwrapped Evaluator: {r}")
        check(launched == only(flash_attn_fwd=ev.cfg.model.depth * BATCHES_1B),
              f"the evaluate CLI launched {launched}")
        del cli
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    gc.collect()
    torch.cuda.empty_cache()
    return r


def servemesh_phase(root: Path, seed: int, weights: str, call_s, smi):
    """Phase servemesh (the constants' comment): the one rank and (b) in this
    process, then (a)'s two ranks, then K1 and K5 at the meshes' shapes
    against their plain versions, and their rows. Returns what the kernels
    line reads."""
    import yaml

    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.evaluate import Evaluator
    from orbit2_tpu_torch.training.checkpoint import load_state_npz

    root.mkdir(exist_ok=True)
    raws = serve_raws(root, seed)
    for mode, raw in raws.items():
        (root / f"serve_{mode}.yaml").write_text(yaml.safe_dump(raw, sort_keys=False))
    cfgs = {mode: load_config(raw) for mode, raw in raws.items()}
    m = cfgs["one"].model
    (root / "weights.txt").write_text(weights)
    # the two meshes' rank pairs at once (their time is mostly gloo's host
    # copies), building while this process serves the one rank and (b)
    procs = {mode: start_ranks(mode, 2, root, "--servemesh-worker") for mode in SERVE_MESHES}
    with stopped_on_failure([p for ps in procs.values() for p in ps]):
        ev = Evaluator(cfgs["one"], "cuda", state_dict=load_state_npz(weights))
        ref = serve_reference(ev, cfgs, root)
        print(f"  one rank, {CONFIG_1B.name} at full width and depth (embed {m.embed_dim}, "
              f"depth {m.depth}, {m.num_heads} heads), {SERVE_FILES} fields of 16 tiles: test() "
              f"{ref['batch_s']:.3f} s a batch, peak {ref['peak_gib']:.2f} GiB; gpu: {smi}")
        cli = serve_cli_one_rank(root / "serve_one.yaml", weights, ev)
    lap("servemesh one rank and (b)")
    del ev
    gc.collect()
    torch.cuda.empty_cache()
    full = {mode: finish_ranks(mode, p, root, 900)[mode] for mode, p in procs.items()}
    lap("servemesh (a)")
    out = {"one_rank": {k: ref[k] for k in ("test", "batch_s", "peak_gib", "field_s")},
           "cli": cli}
    for mode, both in full.items():
        for rank, r in enumerate(both):
            for quant in ("none", "w8a8"):
                q = r[quant]
                print(f"  (a) {mode} 2 rank {rank} {quant}: {q['batch_s']:.3f} s a batch "
                      f"({q['gloo_s']:.3f} s in gloo; one rank {ref['batch_s']:.3f}), "
                      f"{q['samples']} samples, metrics within {q['metric_rel']:.3e} of one "
                      f"rank's ({q['metric_worst']}; bound {SERVE_METRIC_REL:g}); launches "
                      f"{nonzero(q['launches'])}")
            field = (f"stitched field max|d| {r['field_max_abs']:.3e}, trunk "
                     f"{r['field_trunk_rel']:.3e} (bound {TRUNK_BF16_REL:g}), {r['field_s']:.3f} "
                     f"s (one rank {ref['field_s']:.3f}); " if "field_s" in r else "")
            print(f"  (a) {mode} 2 rank {rank}: built in {r['build_s']:.1f} s; round 0's "
                  f"prediction max|d| {r['pred_max_abs']:.3e}, trunk {r['trunk_rel']:.3e}; "
                  f"{field}MC launches {nonzero(r['mc_launches'])}, K5 by [rows, cols, n] "
                  f"{r['mc_widths']}; peak {r['peak_gib']:.2f} GiB (one rank "
                  f"{ref['peak_gib']:.2f}); gpu: {smi}")
        out[mode] = both
    # K1 and K5 at the meshes' shapes: fsdp 2 halves the batch, tensor 2 the heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 45 + seed
    h, d = m.num_heads, m.embed_dim // m.num_heads
    n = ref["fsdp/trunk"].shape[1]
    rows, errs, k5 = {}, {}, {}
    for mode, (b, heads) in (("fsdp", (BATCH_1B // 2, h)), ("tensor", (BATCH_1B, h // 2))):
        q, k, v = make_qkv(b, n, n, heads, d, torch.bfloat16, gen)
        errs[mode] = check_forward(q, k, v, 0.0, kseed, f"servemesh {mode} bf16 drop 0 B{b} "
                                   f"N{n} H{heads} d{d}")[3]
        del q, k, v
        torch.cuda.empty_cache()
        rows[mode] = k1_row(b, n, heads, d, 0.0, gen, kseed, call_s, smi,
                            full[mode][0]["none"]["launches"]["flash_attn_fwd"])
        for r_, c_, launches in full[mode][0]["mc_widths"]:
            if (r_, c_) in k5 or c_ == m.embed_dim and mode == "tensor":
                continue  # tensor 2's [34,848, 3,072] is serve1b's
            check_dropout(r_, c_, torch.bfloat16, m.drop_rate, gen, kseed)
            k5[(r_, c_)] = k5_row((r_, c_), torch.bfloat16, m.drop_rate, gen, kseed, launches,
                                  smi, f"servemesh {mode} MC")
    lap("servemesh kernels and rows")
    return {"out": out, "rows": rows, "errs": errs, "k5": k5}


# phase hubmesh: the model hub on two gloo ranks of the card
# (`--hubmesh-worker hubmesh RANK 2 PORT DIR`, started with phase servemesh
# and waited for after phase seqexpert). (a) configs/forecast.yaml's ResNet at its own size (19
# blocks x 128 channels, bf16, batch 32) through the train CLI's scale-down
# to fsdp 2 at world 2, HUBMESH_STEPS steps on the global batches one
# unwrapped rank takes (rank 0 runs it before the group starts;
# pinned_batches): at dropout 0 (the preset hardcodes 0.1, as JAX's does:
# its factory patched, no_resnet_dropout) and fp32 the first-step gradients
# within SEQEXP_GRAD_REL of one rank's (in bf16 the sound reading is 2.1e-2:
# the products' rounding at two batch sizes, through 19 BatchNorms, PERF.md
# §6) and the BatchNorm running averages bit-equal on both ranks (each
# rank's own statistics part them); at the shipped
# dropout 0.1 K5's launches exact by [rows, cols], finite losses, and the
# two data ranks' masks differ on one sample (the ResidualBlocks' seeds fold
# the data rank); (b) `finetune --arch unet | vit` at interm_fine_tune.yaml's
# width on the hub crop (N 32,768 for the ViT), the mesh cut to fsdp 2, then
# the ViT at tensor 2 on its batch of BATCH_HUB: exact K1-K3 and K5 launches,
# finite losses, test() on the mesh in bf16 and, against one rank within
# SERVE_METRIC_REL, in fp32 (a test split whose samples are one field; in
# bf16 cuDNN's algorithms at batch 4 and 8 read 9.6e-5 on the Unet, tensor
# 2's partial sums 2.6e-5 on the ViT); (c) (this process) the train CLI on forecast.yaml under a one-rank NCCL group
# against the unwrapped fit, losses and the state bit for bit; (d) K1-K3 at
# the ranks' attention shapes and K5 at their widths against their plain
# versions, and their rows.
HUBMESH_STEPS = 2
HUBMESH_FINETUNES = {"unet": {"fsdp": 2}, "vit": {"fsdp": 2}, "vit_tensor2": {"tensor_par": 2}}


def hubmesh_raws(root: Path, seed: int):
    """The phase's raw configs: "forecast" (forecast.yaml as shipped), "hub"
    (interm_fine_tune.yaml's model on the hub crop, two train files of
    FIELDS_HUB // 2 fields) and "hub_serve" (on a test split of two files of
    BATCH_HUB // 2 samples, every one a field)."""
    fc = forecast_raw(root / "forecast", seed)
    hub_kw = dict(trainer={"batch_size": BATCH_HUB}, low=LOW_HUB)
    hub = raw_config(root / "hub", seed, CONFIG_HUB, n_files=2, t=FIELDS_HUB // 2,
                     shards=("train",), **hub_kw)
    serve = raw_config(root / "hub_serve", seed + 1, CONFIG_HUB, n_files=2, t=BATCH_HUB // 2,
                       shards=("test",), same_samples=True, **hub_kw)
    return {"forecast": fc, "hub": hub, "hub_serve": serve}


def write_hubmesh_configs(root: Path, seed: int):
    """Phase hubmesh's configs under `root`: ROOT/configs.yaml (hubmesh_raws)
    and, for the train CLI, ROOT/forecast.yaml and ROOT/forecast_fp32.yaml
    (the same in fp32: (a)'s gradient check)."""
    import yaml

    root.mkdir(exist_ok=True)
    raws = hubmesh_raws(root, seed)
    (root / "configs.yaml").write_text(yaml.safe_dump(raws, sort_keys=False))
    (root / "forecast.yaml").write_text(yaml.safe_dump(raws["forecast"], sort_keys=False))
    fp32 = copy.deepcopy(raws["forecast"])
    fp32["trainer"]["data_type"] = "float32"
    (root / "forecast_fp32.yaml").write_text(yaml.safe_dump(fp32, sort_keys=False))


def start_hubmesh(root: Path, seed: int):
    """Writes phase hubmesh's configs under `root` and starts its two ranks
    (start_ranks: ROOT/hubmesh.rank{r}.log); returns them."""
    write_hubmesh_configs(root, seed)
    return start_ranks("hubmesh", 2, root, "--hubmesh-worker")


@contextlib.contextmanager
def no_resnet_dropout():
    """The ResNet presets built at dropout 0 (rasp-theurey-2020 hardcodes
    0.1, as JAX's factory does)."""
    from orbit2_tpu_torch.utils import loaders

    resnet = loaders.ResNet
    loaders.ResNet = lambda *a, **kw: resnet(*a, **dict(kw, dropout=0.0))
    try:
        yield
    finally:
        loaders.ResNet = resnet


@contextlib.contextmanager
def pinned_batches(batches):
    """Each epoch's train loader yields `batches` (global (x, y) pairs) in
    order, each data rank its slice of each: one rank's fit and a mesh's
    take the same global batches."""
    from orbit2_tpu_torch.data.itermodule import IterDataModule

    loader, count = IterDataModule.train_dataloader, IterDataModule.num_batches

    def pinned(self):
        for batch in batches:
            n = batch[0].shape[0] // self.data_par_size
            yield tuple(a[self.data_par_rank * n:(self.data_par_rank + 1) * n] for a in batch)

    IterDataModule.train_dataloader = pinned
    IterDataModule.num_batches = lambda self, split="train": (
        len(batches) if split == "train" else count(self, split))
    try:
        yield
    finally:
        IterDataModule.train_dataloader, IterDataModule.num_batches = loader, count


def norm_stats(model):
    """Every BatchNorm's running mean and variance, as one host vector."""
    return torch.cat([torch.cat((bn.running_mean, bn.running_var)).float().cpu()
                      for bn in batchnorms(model)])


def hubmesh_reference(raws, out: Path):
    """Phase hubmesh (a)'s one unwrapped rank (run by rank 0 before the group
    starts): the fp32 dropout-0 fit of forecast.yaml cut to the card on its
    first HUBMESH_STEPS train batches (written to OUT/batches.npz for the
    mesh), its losses, first-step gradients and running averages."""
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.evaluate import make_data_module
    from orbit2_tpu_torch.training.trainer import Trainer

    cfg = to_one_card(load_config(str(out / "forecast_fp32.yaml")))
    dm = make_data_module(cfg, next(iter(cfg.data.low_res_dir)), 1, 0)
    loader = iter(dm.train_dataloader())
    batches = [tuple(np.asarray(a) for a in next(loader)[:2]) for _ in range(HUBMESH_STEPS)]
    loader.close()
    np.savez(out / "batches.npz", **{f"{t}{i}": a for i, b in enumerate(batches)
                                     for t, a in zip("xy", b)})
    with no_resnet_dropout(), pinned_batches(batches), first_step_grads("") as grads:
        trainer = Trainer(cfg, "cuda")
        hist = trainer.fit(max_epochs=1, max_steps_per_epoch=HUBMESH_STEPS)
    ref = {"losses": [r["loss"] for r in hist], "grads": grads,
           "stats": norm_stats(trainer.model)}
    del trainer
    torch.cuda.empty_cache()
    return ref


def hubmesh_forecast(rank: int, refs, out: Path):
    """Phase hubmesh (a) on one of its two ranks (the phase's comment).
    Returns rank 0's readings."""
    import shutil

    import torch.distributed as dist

    from orbit2_tpu_torch import train as train_cli

    raw = np.load(out / "batches.npz")
    batches = [(raw[f"x{i}"], raw[f"y{i}"]) for i in range(HUBMESH_STEPS)]
    # the launch's gloo group (NCCL takes one rank a card), joined by the CLI
    train_cli.init_distributed = lambda device: dist.get_world_size()

    def cli(name, dropout0):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        pinned = contextlib.ExitStack()
        if dropout0:  # on the one rank's batches, at dropout 0, in fp32
            pinned.enter_context(no_resnet_dropout())
            pinned.enter_context(pinned_batches(batches))
        ck = out / f"ck_{name.replace(' ', '_')}"
        path = out / ("forecast_fp32.yaml" if dropout0 else "forecast.yaml")
        with pinned, timed_collectives() as coll, first_step_grads("") as grads, \
                launch_widths(kernels()["fused_dropout"]) as widths:
            trainer = train_cli.main([str(path), "--device", "cuda",
                                      "--max-epochs", "1", "--max-steps-per-epoch",
                                      str(HUBMESH_STEPS), "--checkpoint-dir", str(ck)])
            torch.cuda.synchronize()
        if rank == 0:  # the next run starts afresh (a checkpoint there would resume)
            shutil.rmtree(ck, ignore_errors=True)
        dist.barrier()
        hist = trainer.history
        run = {"losses": [r["loss"] for r in hist], "batches": hist[0]["batches"],
               "fit_s": hist[0]["seconds"], "step_s": hist[0]["seconds"] / HUBMESH_STEPS,
               "collective_s": coll["s"], "launches": counts(),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "k5_widths": dict(widths),
               "parallelism": {a: getattr(trainer.cfg.parallelism, a) for a in MESH_AXES}}
        stats = norm_stats(trainer.model)
        both = [torch.empty_like(stats) for _ in range(2)]
        dist.all_gather(both, stats)
        run["stats_equal"] = torch.equal(both[0], both[1])
        ranks = [None, None]
        dist.all_gather_object(ranks, (run["step_s"], run["collective_s"], run["peak_gib"]))
        if rank == 0:
            print(f"  (a) train CLI, forecast.yaml {name}: scaled to {run['parallelism']}; "
                  f"losses {run['losses']}; a step a rank " + ", ".join(
                      f"rank {r}: {s:.3f} s ({g:.3f} s in gloo), peak {p:.2f} GiB"
                      for r, (s, g, p) in enumerate(ranks)), flush=True)
        check(run["parallelism"] == dict({a: 1 for a in MESH_AXES}, fsdp=2),
              f"forecast.yaml scaled to {run['parallelism']} at world 2")
        check(run["batches"] == HUBMESH_STEPS and all(np.isfinite(run["losses"])),
              f"forecast {name} on fsdp 2: {hist}")
        check(run["stats_equal"], f"forecast {name}: the BatchNorm running averages differ "
              "across the data ranks")
        return trainer, run, grads, stats

    trainer, run0, grads, stats = cli("fp32 dropout 0", True)
    del trainer
    out_a = {"drop0": run0}
    if rank == 0:
        grad_rel, grad_worst, grad_name = rel_grads(grads, refs["grads"])
        stats_rel = rel_frob(stats, refs["stats"])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run0["losses"], refs["losses"]))
        print(f"  (a) fsdp 2 at fp32, dropout 0 against one rank: first-step gradients within "
              f"{grad_rel:.3e} relative Frobenius (the worst parameter {grad_name}: "
              f"{grad_worst:.3e}), losses {loss_rel:.3e}, running averages {stats_rel:.3e}",
              flush=True)
        check(grad_rel <= SEQEXP_GRAD_REL,
              f"forecast fsdp 2: first-step gradients {grad_rel:.3e} from one rank's")
        run0.update(grad_rel=grad_rel, grad_param_rel=grad_worst, grad_worst=grad_name,
                    stats_rel=stats_rel, loss_rel=loss_rel, one_rank=refs["losses"])
    gc.collect()
    torch.cuda.empty_cache()

    trainer, run, _, _ = cli("dropout 0.1", False)
    model = trainer.model
    tc = trainer.cfg.trainer
    want_widths = dropout_shapes(model, tc.batch_size // 2, *GRID_FORECAST,
                                 times=2 * HUBMESH_STEPS)
    check(run["launches"] == only(fused_dropout=sum(want_widths.values())) and
          run["k5_widths"] == dict(want_widths),
          f"forecast at dropout 0.1 on fsdp 2: launches {run['launches']}, K5 by [rows, cols] "
          f"{run['k5_widths']}, want {dict(want_widths)}")
    # one sample on both data ranks, one seed: the masks differ
    x = torch.from_numpy(batches[0][0][:2]).to("cuda", torch.bfloat16)
    dm = trainer.data_module(next(iter(trainer.cfg.data.low_res_dir)))
    in_vars, out_vars = dm.get_data_variables()
    with torch.no_grad():
        y = model.train()(x, in_vars, out_vars, torch.Generator().manual_seed(5)).float()
    both = [torch.empty_like(y) for _ in range(2)]
    dist.all_gather(both, y.contiguous())
    run["masks_differ"] = not torch.equal(both[0], both[1])
    check(run["masks_differ"], "forecast on fsdp 2: both data ranks drew one dropout mask")
    run["k5_widths"] = sorted([r, c, n] for (r, c), n in run["k5_widths"].items())
    out_a["drop"] = run
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out_a


def hubmesh_finetunes(rank: int, raws, out: Path):
    """Phase hubmesh (b) on one of its two ranks (the phase's comment).
    Returns rank 0's readings."""
    import torch.distributed as dist
    import yaml

    from orbit2_tpu_torch import finetune
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.evaluate import load_module, make_data_module, model_kwargs
    from orbit2_tpu_torch.training.checkpoint import restore_checkpoint

    finetune.init_distributed = lambda device: dist.get_world_size()
    result = {}
    m = raws["hub"]["model"]
    h_img, w_img = LOW_HUB[0] * 4, LOW_HUB[1] * 4
    for label, par in HUBMESH_FINETUNES.items():
        arch = label.split("_")[0]
        raw = copy.deepcopy(raws["hub"])
        raw["parallelism"] = dict({a: 1 for a in MESH_AXES}, **par)
        path = out / f"hub_{label}.rank{rank}.yaml"
        path.write_text(yaml.safe_dump(raw, sort_keys=False))
        ck = out / f"ft_{label}"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with timed_collectives() as coll, \
                launch_widths(kernels()["fused_dropout"]) as widths:
            res = finetune.main([str(path), "--arch", arch, "--loss", HUB_LOSSES[arch],
                                 "--max-epochs", "1", "--max-steps-per-epoch", str(HUBMESH_STEPS),
                                 "--checkpoint-dir", str(ck), "--device", "cuda"])
            torch.cuda.synchronize()
        hist = res["history"]
        launched, peak = counts(), torch.cuda.max_memory_allocated() / 2 ** 30
        tp = par.get("tensor_par", 1)
        b = BATCH_HUB // (2 // tp)  # a rank's batch: halved on the data mesh
        state = restore_checkpoint(str(ck / "epoch_0"))["model"]
        # the launches a rank: K1-K3 a Block a step on its batch and heads;
        # K5 at pos_drop and each Block's projection and Mlp output at [b N,
        # embed], its Mlp hidden at [b N, hidden / tensor], forward and
        # backward; a CNN's two a ResidualBlock at [b C h', w']
        depth = m["depth"] if arch == "vit" else 0
        if arch == "vit":
            n = (h_img // m["patch_size"]) * (w_img // m["patch_size"])
            hidden = int(m["embed_dim"] * m["mlp_ratio"]) // tp
            want_widths = {(b * n, m["embed_dim"]): 2 * HUBMESH_STEPS * (1 + 2 * depth),
                           (b * n, hidden): 2 * HUBMESH_STEPS * depth}
        else:
            cfg = load_config(raw)
            cfg.model.preset = arch
            dm = make_data_module(cfg, next(iter(cfg.data.low_res_dir)), 1, 0)
            with torch.device("meta"):
                skeleton = load_module(cfg, dm, dict(model_kwargs(cfg), generator=None))[0]
            want_widths = dict(dropout_shapes(skeleton.backbone, b, h_img, w_img,
                                              times=2 * HUBMESH_STEPS))
        want = only(fused_dropout=sum(want_widths.values()),
                    **({k: depth * HUBMESH_STEPS for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                                                           "flash_attn_bwd_dkv")} if depth else {}))
        run = {"losses": [r["loss"] for r in hist], "fit_s": hist[0]["seconds"],
               "step_s": hist[0]["seconds"] / HUBMESH_STEPS, "collective_s": coll["s"],
               "peak_gib": peak, "launches": launched,
               "k5_widths": sorted([r_, c_, k_] for (r_, c_), k_ in widths.items()),
               "batch_a_rank": b, "parallelism": par}
        ranks = [None, None]
        dist.all_gather_object(ranks, (run["step_s"], run["collective_s"], run["peak_gib"]))
        if rank == 0:
            print(f"  (b) finetune --arch {arch} on {par}, {b} a rank: losses {run['losses']}; "
                  f"launches {launched}; a step a rank " + ", ".join(
                      f"rank {r}: {s:.3f} s ({g:.3f} s in gloo), peak {p:.2f} GiB"
                      for r, (s, g, p) in enumerate(ranks)), flush=True)
        check(hist[0]["batches"] == HUBMESH_STEPS and all(np.isfinite(run["losses"])),
              f"finetune --arch {arch} on {par}: {hist}")
        check(launched == want and dict(widths) == want_widths,
              f"finetune --arch {arch} on {par}: launches {launched}, K5 by [rows, cols] "
              f"{dict(widths)}, want {want}, {want_widths}")
        lap(f"hubmesh (b) finetune {label}")
        # test() in bf16 is the path (its K1 launches, the samples); the same
        # in fp32 is held against one rank: in bf16 cuDNN's algorithms at
        # batch 4 and 8 (the Unet) and tensor 2's partial sums (the ViT) read
        # above SERVE_METRIC_REL
        serve = copy.deepcopy(raws["hub_serve"])
        serve["model"]["preset"] = arch
        run["serve_bf16"] = serve_meshes(rank, serve, {label: par}, f"(b) {arch} bf16",
                                         bound=math.inf, state=state)[label]
        serve["trainer"]["data_type"] = "float32"
        run["serve"] = serve_meshes(rank, serve, {label: par}, f"(b) {arch} fp32",
                                    bound=SERVE_METRIC_REL, state=state)[label]
        result[label] = run
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return result


def hubmesh_worker(mode: str, rank: int, world: int, port: str, out_dir: str):
    """One of phase hubmesh's two ranks on the card (`mode` hubmesh): rank 0
    runs (a)'s one unwrapped rank, then both join a gloo group and run (a)
    and (b). Rank 0 writes OUT/hubmesh.json."""
    import datetime
    import faulthandler

    import torch.distributed as dist
    import yaml

    faulthandler.enable()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    raws = yaml.safe_load((out / "configs.yaml").read_text())
    refs = hubmesh_reference(raws, out) if rank == 0 else None
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=900))
    t0 = time.perf_counter()
    result = {"forecast": hubmesh_forecast(rank, refs, out)}
    lap("hubmesh (a)")
    result["finetune"] = hubmesh_finetunes(rank, raws, out)
    result["seconds"] = time.perf_counter() - t0
    if rank == 0:
        (out / f"{mode}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


def hubmesh_phase(root: Path, procs, seed: int, call_s, smi):
    """Phase hubmesh (the constants' comment): waits for start_hubmesh's
    ranks (a), (b), then (c) and (d) here. Returns what the kernels line
    reads."""
    import torch.distributed as dist

    from orbit2_tpu_torch import train as train_cli
    from orbit2_tpu_torch.config import load_config
    from orbit2_tpu_torch.parallel import full_state_dict
    from orbit2_tpu_torch.training.trainer import Trainer

    res = finish_ranks("hubmesh", procs, root, timeout=900)
    lap("hubmesh (a), (b), beside servemesh and seqexpert")

    # (c) the train CLI under a one-rank NCCL group against the unwrapped fit
    cfg = to_one_card(load_config(str(root / "forecast.yaml")))

    def fit(wrapped):
        reset_counts()
        if wrapped:
            trainer = train_cli.main([str(root / "forecast.yaml"), "--device", "cuda",
                                      "--max-epochs", "1", "--max-steps-per-epoch",
                                      str(HUBMESH_STEPS), "--checkpoint-dir", str(root / "ck_c")])
            state = full_state_dict(trainer.model)
        else:
            trainer = Trainer(cfg, "cuda")
            trainer.fit(max_epochs=1, max_steps_per_epoch=HUBMESH_STEPS)
            state = {k: t.detach().cpu() for k, t in trainer.model.state_dict().items()}
        torch.cuda.synchronize()
        run = {"losses": [r["loss"] for r in trainer.history], "launches": counts(),
               "meshed": trainer.mesh is not None}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return run, state

    plain, plain_state = fit(False)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        wrapped, wrapped_state = fit(True)
    finally:
        dist.destroy_process_group()
    differ = [k for k, t in plain_state.items() if not torch.equal(t, wrapped_state[k])]
    print(f"  (c) train CLI on forecast.yaml under a one-rank NCCL group: losses "
          f"{wrapped['losses']} (unwrapped {plain['losses']}); {len(plain_state) - len(differ)} "
          f"of {len(plain_state)} state tensors bit-equal; launches {wrapped['launches']}")
    check(wrapped["meshed"] and not plain["meshed"], "the CLI took no mesh under the group")
    check(list(wrapped_state) == list(plain_state) and not differ
          and wrapped["losses"] == plain["losses"] and wrapped["launches"] == plain["launches"],
          f"forecast.yaml on a one-rank mesh differs from unwrapped: {differ[:5]}")
    lap("hubmesh (c)")

    # (d) the ranks' attention shapes and K5 widths against the plain versions
    m = load_config(str(root / "forecast.yaml")).model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kseed = 2 ** 44 + seed
    ft = res["finetune"]
    _, n, h, d = ATTENTION_HUB
    shapes = {"fsdp": (BATCH_HUB // 2, n, h, d, ft["vit"]),
              "tensor": (BATCH_HUB, n, h // 2, d, ft["vit_tensor2"])}
    rate = DROP
    errs, rows = {}, {}
    for mode, (b, nn_, hh, dd, run) in shapes.items():
        launched, served = run["launches"], run["serve_bf16"]["launches_rank0"]
        q, k, v = make_qkv(b, nn_, nn_, hh, dd, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        pairs = [(0, 0), (b - 1, hh - 1)]
        case = f"hubmesh {mode} bf16 drop {rate:g} B{b} N{nn_} H{hh} d{dd}"
        errs[mode] = {"train": check_pairs(q, k, v, do, rate, kseed, pairs, case),
                      "serve": check_pairs(q, k, v, None, 0.0, kseed, pairs,
                                           case.replace(f"drop {rate:g}", "drop 0"))}
        del q, k, v, do
        torch.cuda.empty_cache()
        launches = {(name, rate): launched[name] for name in ("flash_attn_fwd",
                                                              "flash_attn_bwd_dq",
                                                              "flash_attn_bwd_dkv")}
        launches[("flash_attn_fwd", 0.0)] = served["flash_attn_fwd"]
        rows[mode] = hub_attention_rows(gen, kseed, rate, call_s, smi, launches,
                                        shape=(b, nn_, hh, dd), label=f"hubmesh {mode} ViT")
    lap("hubmesh (d) attention")
    k5 = {}
    widths = {tuple(w[:2]): (label, w[2]) for label, r in (
        ("forecast", res["forecast"]["drop"]), *ft.items()) for w in r["k5_widths"]}
    for shape, (label, n_launched) in sorted(widths.items()):
        check_dropout(*shape, torch.bfloat16, rate, gen, kseed)
        k5[shape] = k5_row(shape, torch.bfloat16, rate, gen, kseed, n_launched, smi,
                           f"hubmesh {label}")
    lap("hubmesh (d) K5")
    out = {"forecast": res["forecast"], "finetune": ft, "one_rank_nccl": {
        "losses": wrapped["losses"], "bit_equal": not differ}, "ranks_s": res["seconds"]}
    return {"out": out, "rows": rows, "errs": errs, "k5": k5}


@contextlib.contextmanager
def plain_versions():
    """Routes the model's kernel calls to the kernels' plain PyTorch versions
    (autograd of the plain forwards), drawing the same seeds in the same
    order, so a step under it is the same step without the kernels."""
    import orbit2_tpu_torch.models.components.blocks as blocks
    import orbit2_tpu_torch.models.res_slimvit as res_slimvit
    from orbit2_tpu_torch.ops.dropout import dropout_reference
    from orbit2_tpu_torch.ops.flash_attention import attention_mult, flash_attention_reference
    from orbit2_tpu_torch.ops.kernel_prng import draw_seed, fold_seed, keep_mult

    def attention(q, k, v, impl, scale=None, dropout_rate=0.0, generator=None, fold=(),
                  seq=None):
        check(seq is None, "plain_versions runs the tokens whole")
        seed = fold_seed(draw_seed(generator), fold) if dropout_rate > 0.0 else 0
        return flash_attention_reference(q, k, v, scale,
                                         attention_mult(q, k, dropout_rate, seed))[0]

    def drop(x, rate, training, generator, fold=()):
        if not training or rate <= 0.0:
            return x
        cols = x.shape[-1]
        mult = keep_mult(fold_seed(draw_seed(generator), fold), x.numel() // cols, cols, rate,
                         device=x.device)
        return dropout_reference(x, mult)

    saved = blocks.dot_product_attention, blocks.dropout, res_slimvit.dropout
    blocks.dot_product_attention, blocks.dropout, res_slimvit.dropout = attention, drop, drop
    try:
        yield
    finally:
        blocks.dot_product_attention, blocks.dropout, res_slimvit.dropout = saved


def train_step_of(model, cfg, in_vars, out_vars, grad_accum=1, mu_dtype=None, nu_dtype=None):
    from orbit2_tpu_torch.metrics.metrics import METRICS_REGISTRY
    from orbit2_tpu_torch.training.optim import make_optimizer
    from orbit2_tpu_torch.training.train import make_train_step

    m = cfg.model
    opt = make_optimizer("adamw", {"lr": m.lr, "weight_decay": m.weight_decay,
                                   "betas": (m.beta_1, m.beta_2), "mu_dtype": mu_dtype,
                                   "nu_dtype": nu_dtype}, model.named_parameters())
    loss = METRICS_REGISTRY[cfg.trainer.train_loss](aggregate_only=True)
    return make_train_step(model, loss, cfg.data.var_weights, opt, in_vars, out_vars, grad_accum)


def gens(seed):
    return torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3, help="train steps per epoch (2 epochs)")
    args = ap.parse_args()

    # 1. device
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        sys.exit(2)
    from orbit2_tpu_torch.ops.dropout import FusedDropout, dropout_reference
    from orbit2_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, HEAD_DIMS, attention_delta, attention_flops, attention_mult,
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference, tile_edge_lengths)
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}")
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build: one nvcc per source, all started together
    phase("build")
    libraries = {k.library.source.name: k.library for k in kernels().values()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        for lib in pool.map(lambda lib: (lib.load(), lib)[1], libraries.values()):
            print(f"  {lib.source.name} built in {lib.build_seconds:.2f} s ({lib.path().name})")
    print(f"  all built in {time.perf_counter() - t0:.2f} s (wall)")
    hopper = sass_check(libraries.values())
    for name, ops in sorted(hopper.items()):
        print(f"  {name[:60]}: HGMMA {ops['HGMMA']}, UTMALDG {ops['UTMALDG']}, no STL/LDL")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    call_s = {}  # seconds a Philox call takes the whole card, per kernel
    for key, (fma, alu, calls) in dropout_ops(hopper).items():
        clocks = call_clocks(fma, alu)
        call_s[key] = clocks / (sm_count * max_mhz * 1e6)
        print(f"  {DROPOUT_SASS[key][0]} d64 dropout: {fma + alu:.1f} integer instructions a "
              f"Philox call (SASS, {calls:g} calls in its code), {fma:.1f} IMAD on the FMA pipe "
              f"and {alu:.1f} on the ALU pipe; a dropped element {(fma + alu) / ELEMENTS_PER_CALL:.2f}"
              f" ({fma / ELEMENTS_PER_CALL:.2f} FMA, {alu / ELEMENTS_PER_CALL:.2f} ALU): "
              f"max({fma:.1f} / {INT_PIPE_LANES_PER_SM}, {alu:.1f} / {INT_PIPE_LANES_PER_SM}, "
              f"{fma + alu:.1f} / {ISSUE_LANES_PER_SM}) = {clocks:.3f} SM clocks a call; "
              f"{sm_count} SMs x {max_mhz:.0f} MHz = {1 / call_s[key] / 1e12:.3f} T calls/s")

    # 3. kernels against their plain versions
    phase("kernels")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = {}
    kernel_seed = 2 ** 40 + args.seed
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            b, n_q, n_k, h, d = shape
            q, k, v = make_qkv(b, n_q, n_k, h, d, dtype, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            for rate in (0.0, DROP):
                case = f"{str(dtype)[6:]:8s} drop {rate:g} B{b} Nq{n_q} Nk{n_k} H{h} d{d}"
                o, lse, mult, errs[("fwd", dtype, shape, rate)] = check_forward(
                    q, k, v, rate, kernel_seed, case)
                err, line = check_backward(q, k, v, o, lse, do, mult, rate, kernel_seed, case)
                print(f"  bwd {case}: {line}")
                for name in ("dq", "dk", "dv"):
                    errs[(name, dtype, shape, rate)] = err[name]
                del mult
            del q, k, v, do
    torch.cuda.empty_cache()
    # the bf16 backward at its tile edges: N_q rising against N_k falling
    for d in HEAD_DIMS:
        lengths = tile_edge_lengths(d)
        worst = {}
        for n_q, n_k in zip(lengths, reversed(lengths)):
            q, k, v = make_qkv(1, n_q, n_k, 2, d, torch.bfloat16, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            for rate in (0.0, DROP):
                mult = attention_mult(q, k, rate, kernel_seed)
                o, lse = flash_attention_fwd(q, k, v, None, rate, kernel_seed)
                case = f"bf16 drop {rate:g} B1 Nq{n_q} Nk{n_k} H2 d{d}"
                err, _ = check_backward(q, k, v, o, lse, do, mult, rate, kernel_seed, case)
                for name, e in err.items():
                    worst[name] = max(worst.get(name, 0.0), e)
        print(f"  bwd tile edges bf16 d{d}, (N_q, N_k) in {list(zip(lengths, reversed(lengths)))}, "
              f"dropout 0 and {DROP:g}: worst " + "  ".join(f"max|d{k}| {v:.3e}"
                                                          for k, v in worst.items())
              + "; bit-equal over two runs")
    for dtype in (torch.bfloat16, torch.float32):
        for r, c in DROPOUT_SHAPES:
            check_dropout(r, c, dtype, DROP, gen, kernel_seed)
    errs[("fused_dropout",)] = 0.0
    torch.cuda.synchronize()
    check_fused_mlp(gen, kernel_seed, errs)

    # 3b. the attention probes, then their path
    phase("probes")
    check_probes(gen, errs)
    probe_res, probe_counts = run_probe_path()

    from orbit2_tpu_torch.evaluate import Evaluator, model_kwargs
    from orbit2_tpu_torch.training.train import make_eval_step
    from orbit2_tpu_torch.training.trainer import Trainer
    from orbit2_tpu_torch.utils.loaders import load_architecture

    (ROOT / "_smoke").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        cfg = slice_config(Path(tmp), args.seed)
        m = cfg.model

        # 4. the serving slice
        phase("slice")
        print(f"  config {CONFIG.name}: embed {m.embed_dim} depth {m.depth} heads {m.num_heads} "
              f"decoder {m.decoder_depth} {cfg.trainer.data_type} batch {cfg.trainer.batch_size} "
              f"attention {m.attention_impl}")
        reset_counts()
        ev = Evaluator(cfg, "cuda")
        tt = time.perf_counter()
        metrics = ev.test(max_batches=args.batches)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - tt
        serve_counts = counts()
        print(f"  test(max_batches={args.batches}) {test_s:.3f} s; launches {serve_counts}")
        for key, val in metrics.items():
            print(f"    {key} {val:.6f}")
        check(len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values()),
              "slice metrics missing or not finite")
        check(serve_counts == only(flash_attn_fwd=m.depth * args.batches),
              f"serving launches {serve_counts}, want flash_attn_fwd = depth x batches = "
              f"{m.depth * args.batches} and nothing else")

        dm = ev.data_module
        in_vars, out_vars = dm.get_data_variables()
        loader = iter(dm.test_dataloader())
        batch = next(loader)
        loader.close()
        x = torch.from_numpy(batch[0]).cuda()
        y = torch.from_numpy(batch[1]).cuda()
        with torch.no_grad():
            pred = ev.model(x, in_vars, out_vars).float()
            set_attention_impl(ev.model, "xla")
            pred_plain = ev.model(x, in_vars, out_vars).float()
            set_attention_impl(ev.model, m.attention_impl)
            torch.cuda.synchronize()
        mag = m.superres_mag
        want_shape = (x.shape[0], len(out_vars), x.shape[2] * mag, x.shape[3] * mag)
        check(tuple(pred.shape) == want_shape and bool(pred.isfinite().all()),
              f"bad prediction {tuple(pred.shape)}, want {want_shape}")
        err_pred = (pred - pred_plain).abs().max().item()
        scale = pred_plain.abs().max().item()
        print(f"  bf16 prediction, kernel vs plain attention on the card: max|d| {err_pred:.3e} "
              f"(max|pred| {scale:.3e}; atol=rtol={PRED_BF16_TOL:g})")
        torch.testing.assert_close(pred, pred_plain, atol=PRED_BF16_TOL, rtol=PRED_BF16_TOL)

        m32 = copy.deepcopy(ev.model).float()
        m32.dtype = torch.float32
        with torch.no_grad():
            pred_gpu = m32(x[:1], in_vars, out_vars)
            torch.cuda.synchronize()
            pred_cpu = m32.cpu()(x[:1].cpu(), in_vars, out_vars)
        err32 = (pred_gpu.cpu() - pred_cpu).abs().max().item()
        print(f"  fp32 prediction, card (kernel) vs CPU (plain): max|d| {err32:.3e} "
              f"(atol=rtol={PRED_FP32_TOL:g})")
        torch.testing.assert_close(pred_gpu.cpu(), pred_cpu, atol=PRED_FP32_TOL,
                                   rtol=PRED_FP32_TOL)
        del m32

        # 4b. the serving slice with every Mlp on the fused MLP
        phase("fused")
        set_use_fused(ev.model, True)
        reset_counts()
        tt = time.perf_counter()
        metrics_fused = ev.test(max_batches=args.batches)
        torch.cuda.synchronize()
        fused_test_s = time.perf_counter() - tt
        fused_counts = counts()
        print(f"  test(max_batches={args.batches}) with use_fused {fused_test_s:.3f} s; "
              f"launches {fused_counts}")
        for key, val in metrics_fused.items():
            print(f"    {key} {val:.6f} (use_fused off {metrics[key]:.6f})")
        check(len(metrics_fused) == 12 and all(np.isfinite(v) for v in metrics_fused.values()),
              "fused slice metrics missing or not finite")
        check(fused_counts == only(flash_attn_fwd=m.depth * args.batches,
                                   fused_mlp_fwd=m.depth * args.batches),
              f"fused serving launches {fused_counts}, want flash_attn_fwd and fused_mlp_fwd = "
              f"depth x batches = {m.depth * args.batches} and nothing else")
        with torch.no_grad():
            pred_fused = ev.model(x, in_vars, out_vars).float()
            torch.cuda.synchronize()
        check(tuple(pred_fused.shape) == want_shape and bool(pred_fused.isfinite().all()),
              f"bad fused prediction {tuple(pred_fused.shape)}")
        print(f"  bf16 prediction, use_fused vs off on the card: max|d| "
              f"{(pred_fused - pred).abs().max().item():.3e} (atol=rtol={PRED_BF16_TOL:g})")
        torch.testing.assert_close(pred_fused, pred, atol=PRED_BF16_TOL, rtol=PRED_BF16_TOL)

        m32 = copy.deepcopy(ev.model).float()
        m32.dtype = torch.float32
        with torch.no_grad():
            pred_gpu = m32(x[:1], in_vars, out_vars).cpu()
        loss_gpu, g_gpu = eval_grad(m32, x[:1], in_vars, out_vars)
        g_gpu = {k: v.cpu() for k, v in g_gpu.items()}
        m32.cpu()
        with torch.no_grad():
            pred_cpu = m32(x[:1].cpu(), in_vars, out_vars)
        loss_cpu, g_cpu = eval_grad(m32, x[:1].cpu(), in_vars, out_vars)
        print(f"  fp32 prediction with use_fused, card (kernels) vs CPU (plain): max|d| "
              f"{(pred_gpu - pred_cpu).abs().max().item():.3e} (atol=rtol={PRED_FP32_TOL:g})")
        torch.testing.assert_close(pred_gpu, pred_cpu, atol=PRED_FP32_TOL, rtol=PRED_FP32_TOL)
        worst = max(((g_gpu[k] - g_cpu[k]).abs().max().item(), k) for k in g_cpu)
        print(f"  fp32 eval-mode gradient with use_fused, card vs CPU: loss {loss_gpu:.7f} vs "
              f"{loss_cpu:.7f}; max|dgrad| {worst[0]:.3e} at {worst[1]} "
              f"(atol=rtol={TRAIN_FP32_TOL:g})")
        check(math.isclose(loss_gpu, loss_cpu, rel_tol=TRAIN_FP32_TOL, abs_tol=TRAIN_FP32_TOL),
              "fp32 eval-mode losses differ between card and CPU")
        for k in g_cpu:
            torch.testing.assert_close(g_gpu[k], g_cpu[k], atol=TRAIN_FP32_TOL,
                                       rtol=TRAIN_FP32_TOL, msg=k)
        del m32, g_gpu, g_cpu

        # the gradient of the fused serving model: the dx and dW kernels on the model path
        reset_counts()
        loss_f, g_fused = eval_grad(ev.model, x, in_vars, out_vars)
        torch.cuda.synchronize()
        grad_counts = counts()
        print(f"  eval-mode gradient of the fused bf16 model (batch {x.shape[0]}): launches "
              f"{grad_counts}")
        check(grad_counts == only(flash_attn_fwd=m.depth, flash_attn_bwd_dq=m.depth,
                                  flash_attn_bwd_dkv=m.depth, fused_mlp_fwd=m.depth,
                                  fused_mlp_dx=m.depth, fused_mlp_dw=m.depth),
              f"eval-mode gradient launches {grad_counts}, want depth = {m.depth} of each "
              f"but the fused dropout")
        set_use_fused(ev.model, False)
        loss_u, g_unfused = eval_grad(ev.model, x, in_vars, out_vars)
        rel = {k: ((g_fused[k] - g_unfused[k]).norm() / g_unfused[k].norm().clamp_min(1e-30)).item()
               for k in g_unfused}
        worst = max((v, k) for k, v in rel.items())
        print(f"  bf16 eval-mode gradient, use_fused vs off: loss {loss_f:.6f} vs {loss_u:.6f}; "
              f"worst relative L2 error {worst[0]:.3e} at {worst[1]} over {len(rel)} tensors "
              f"(bound {MODEL_GRAD_REL:g})")
        check(all(torch.isfinite(g).all() for g in g_fused.values()), "a fused gradient is not finite")
        check(worst[0] <= MODEL_GRAD_REL, "bf16 eval-mode gradients differ with use_fused")
        del g_fused, g_unfused

        # 5. the training slice
        phase("train")
        print(f"  {cfg.trainer.data_type} compute, fp32 parameters, adam mu "
              f"{cfg.trainer.adam_mu_dtype} nu {cfg.trainer.adam_nu_dtype}, drop_rate "
              f"{m.drop_rate} drop_path {m.drop_path}, batch {cfg.trainer.batch_size}, "
              f"2 epochs x {args.steps} steps")
        steps = 2 * args.steps
        reset_counts()
        trainer = Trainer(cfg, "cuda")
        tt = time.perf_counter()
        history = trainer.fit(max_epochs=2, max_steps_per_epoch=args.steps)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - tt
        train_counts = counts()
        for rec in history:
            print(f"    {json.dumps(rec)}")
        print(f"  fit {fit_s:.3f} s; launches {train_counts}")
        check(sum(r["batches"] for r in history) == steps, f"fit took {history}")
        check(all(np.isfinite(r["loss"]) for r in history), "a train loss is not finite")
        want_counts = only(flash_attn_fwd=m.depth * steps, flash_attn_bwd_dq=m.depth * steps,
                           flash_attn_bwd_dkv=m.depth * steps,
                           fused_dropout=2 * (1 + 3 * m.depth) * steps)
        check(train_counts == want_counts, f"train launches {train_counts}, want {want_counts}")
        tdm = trainer._data_modules[next(iter(cfg.data.low_res_dir))]
        init = load_architecture(tdm, m.preset, **model_kwargs(cfg)).state_dict()
        params = dict(trainer.model.named_parameters())
        still = [k for k, p in params.items() if torch.equal(p.detach().cpu(), init[k])]
        print(f"  parameters moved: {len(params) - len(still)} of {len(params)} "
              f"({str(next(iter(params.values())).dtype)[6:]})")
        check(not still and all(p.dtype == torch.float32 for p in params.values()),
              f"parameters did not move or are not fp32 masters: {still}")

        loader = iter(tdm.train_dataloader())
        batch = next(loader)
        loader.close()
        xb = torch.from_numpy(batch[0]).cuda().to(torch.bfloat16)
        yb = torch.from_numpy(batch[1]).cuda().to(torch.bfloat16)
        mu, nu = cfg.trainer.adam_mu_dtype, cfg.trainer.adam_nu_dtype
        reset_counts()
        loss_k = train_step_of(copy.deepcopy(trainer.model), cfg, in_vars, out_vars,
                               mu_dtype=mu, nu_dtype=nu)(xb, yb, *gens(7)).item()
        check(all(c > 0 for c, w in zip(counts().values(), want_counts.values()) if w),
              f"kernel step launched {counts()}")
        reset_counts()
        with plain_versions():
            loss_p = train_step_of(copy.deepcopy(trainer.model), cfg, in_vars, out_vars,
                                   mu_dtype=mu, nu_dtype=nu)(xb, yb, *gens(7)).item()
        check(all(c == 0 for c in counts().values()), f"plain step launched {counts()}")
        print(f"  bf16 step loss, kernels {loss_k:.6f} vs plain versions {loss_p:.6f} "
              f"(rtol {TRAIN_BF16_RTOL:g})")
        check(abs(loss_k - loss_p) <= TRAIN_BF16_RTOL * abs(loss_p), "bf16 step losses differ")

        results = []
        for device in ("cuda", "cpu"):
            mdl = copy.deepcopy(trainer.model).to(device)
            mdl.dtype = torch.float32
            loss = train_step_of(mdl, cfg, in_vars, out_vars)(
                xb[:2].float().to(device), yb[:2].float().to(device), *gens(11)).item()
            results.append((loss, {k: p.grad.cpu() for k, p in mdl.named_parameters()}))
            del mdl
        (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results
        worst = max(((g_gpu[k] - g_cpu[k]).abs().max().item(), k) for k in g_cpu)
        print(f"  fp32 step with dropout, card (kernels) vs CPU (plain): loss {loss_gpu:.7f} vs "
              f"{loss_cpu:.7f}; max|dgrad| {worst[0]:.3e} at {worst[1]} "
              f"(atol=rtol={TRAIN_FP32_TOL:g})")
        check(math.isclose(loss_gpu, loss_cpu, rel_tol=TRAIN_FP32_TOL, abs_tol=TRAIN_FP32_TOL),
              "fp32 step losses differ between card and CPU")
        for k in g_cpu:
            torch.testing.assert_close(g_gpu[k], g_cpu[k], atol=TRAIN_FP32_TOL,
                                       rtol=TRAIN_FP32_TOL, msg=k)
        del results, g_gpu, g_cpu

        # 5b. the tiled 1B serving path
        phase("serve1b")
        s1b = serve1b(config_1b(Path(tmp) / "1b", args.seed), args.seed)

        # 5c. the tiled 1B training path
        phase("train1b")
        t1b = train1b(s1b, Path(tmp) / "1b_train", args.seed)

        # 5d. checkpoints, resume, validation and fine-tuning at 1B
        phase("resume1b")
        r1b = resume1b(s1b, Path(tmp) / "1b_resume", args.seed)

        # 6. times
        phase("times")
        print(f"gpu: {smi}")
        timed, libs, bounds = {}, {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            for shape in SHAPES:
                b, n_q, n_k, h, d = shape
                q, k, v = make_qkv(b, n_q, n_k, h, d, dtype, gen)
                do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
                mult = attention_mult(q, k, DROP, kernel_seed)
                before = counts()
                # fp32 (on no model's path but the fp32 checks') by medians of 5
                it = 20 if dtype == torch.bfloat16 else 5
                kern, plain = paired_ms(lambda: flash_attention_fwd(q, k, v),
                                        lambda: flash_attention_reference(q, k, v), it)
                kern_drop, plain_drop = paired_ms(
                    lambda: flash_attention_fwd(q, k, v, None, DROP, kernel_seed),
                    lambda: flash_attention_reference(q, k, v, None, mult), it)
                o, lse = flash_attention_fwd(q, k, v, None, DROP, kernel_seed)
                delta = attention_delta(o, do)
                dq_ms = cuda_ms(lambda: FLASH_BWD_DQ(q, k, v, do, lse, delta, d ** -0.5, DROP,
                                                     kernel_seed), it)
                dkv_ms = cuda_ms(lambda: FLASH_BWD_DKV(q, k, v, do, lse, delta, d ** -0.5, DROP,
                                                       kernel_seed), it)
                bwd, bwd_plain = paired_ms(
                    lambda: flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, DROP,
                                                kernel_seed),
                    lambda: flash_attention_bwd_reference(q, k, v, o, lse, do, d ** -0.5, mult),
                    it)
                after = counts()
                check(all(after[n] > before[n] for n in
                          ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")),
                      "timing did not launch the kernels")
                lib_line = ""
                if dtype == torch.bfloat16:
                    lib = sdpa_ms(q, k, v, do)
                    lib_line = (f"; SDPA (flash): fwd {lib['fwd'][0.0]:.4f}, fwd drop "
                                f"{lib['fwd'][DROP]:.4f}, backward drop {lib['bwd']:.4f}")
                    att = attention_flops(b, n_q, n_k, h, d)
                    rows_f32 = 4 * b * h * n_q  # one fp32 a query row: lse, delta
                    bounds[("fwd", shape)] = roofline(att, nbytes(q, k, v, q) + rows_f32)
                    bounds[("dq", shape)] = roofline(1.5 * att, nbytes(q, k, v, do, q)
                                                     + 2 * rows_f32)
                    bounds[("dkv", shape)] = roofline(2 * att, nbytes(q, k, v, do, k, v)
                                                      + 2 * rows_f32)
                    libs[("fwd", shape, 0.0)] = lib["fwd"][0.0]
                    libs[("fwd", shape, DROP)] = lib["fwd"][DROP]
                    libs[("bwd", shape)] = lib["bwd"]
                    # with dropout K1 also draws one Philox call per 8 scores, and so
                    # do K2 and K3, each regenerating the forward's mask, at each
                    # kernel's own cost a call
                    calls = b * h * n_q * n_k / ELEMENTS_PER_CALL
                    for op in ("fwd", "dq", "dkv"):
                        philox = calls * call_s[op] * 1e3
                        bounds[("philox_" + op, shape)] = philox
                        bounds[(op + "_drop", shape)] = max(bounds[(op, shape)],
                                                            (philox, "operations"))
                timed[("fwd", dtype, shape, 0.0)] = (kern, plain)
                timed[("fwd", dtype, shape, DROP)] = (kern_drop, plain_drop)
                timed[("bwd", dtype, shape, DROP)] = (bwd, bwd_plain)
                timed[("dq", dtype, shape, DROP)] = (dq_ms, bwd_plain)
                timed[("dkv", dtype, shape, DROP)] = (dkv_ms, bwd_plain)
                tflops = attention_flops(b, n_q, n_k, h, d) / kern / 1e9
                print(f"  {str(dtype)[6:]:8s} B{b} Nq{n_q} Nk{n_k} H{h} d{d}: fwd {kern:.4f} ms "
                      f"({tflops:.1f} TFLOP/s) plain {plain:.4f}; fwd drop {kern_drop:.4f} plain "
                      f"{plain_drop:.4f}; backward drop (delta + dq + dk/dv) {bwd:.4f} ms "
                      f"({2.5 * attention_flops(b, n_q, n_k, h, d) / bwd / 1e9:.1f} TFLOP/s; "
                      f"dq {dq_ms:.4f}, dk/dv {dkv_ms:.4f}) plain {bwd_plain:.4f}" + lib_line)
                del q, k, v, do, mult, o, lse, delta
                torch.cuda.empty_cache()
        lap("attention at SHAPES")
        for dtype in (torch.bfloat16, torch.float32):
            for r, c in DROPOUT_SHAPES:
                x_ = torch.randn(r, c, generator=gen, device="cuda").to(dtype)
                mult = keep_mult(kernel_seed, r, c, DROP, device="cuda")
                kern, plain = paired_ms(lambda: FusedDropout.apply(x_, kernel_seed, DROP),
                                        lambda: dropout_reference(x_, mult))
                timed[("fused_dropout", dtype, (r, c))] = (kern, plain)
                gbs = 2 * x_.numel() * x_.element_size() / kern / 1e6
                lib = best_ms(lambda: torch.nn.functional.dropout(x_, DROP, training=True))
                libs[("fused_dropout", dtype, (r, c))] = lib
                bounds[("fused_dropout", dtype, (r, c))] = roofline(0, 2 * nbytes(x_))
                host = host_us(lambda: FusedDropout.apply(x_, kernel_seed, DROP))
                timed[("fused_dropout_host_us", dtype, (r, c))] = host
                print(f"  fused_dropout {str(dtype)[6:]:8s} [{r}, {c}]: {kern:.4f} ms "
                      f"({gbs:.0f} GB/s) plain {plain:.4f} ms (mask precomputed); F.dropout "
                      f"{lib:.4f} ms; bound {bounds[('fused_dropout', dtype, (r, c))][0]:.4f} ms; "
                      f"host {host:.1f} us a call (events, host work included)")
                del x_, mult
        timed.update(time_fused_mlp(gen, bounds, libs))
        lap("dropout and fused MLP at their shapes")
        probe_timed = time_probes(probe_res, smi)
        lap("probes")

        step = make_eval_step(ev.model, in_vars, out_vars)
        fused_model = copy.deepcopy(ev.model)
        set_use_fused(fused_model, True)
        fused_step = make_eval_step(fused_model, in_vars, out_vars)
        ms_fused, ms_batch = paired_ms(lambda: fused_step(x, y), lambda: step(x, y))
        print(f"  serving: eval step (forward + clip) {ms_batch:.3f} ms per test batch of "
              f"{x.shape[0]}, with use_fused {ms_fused:.3f} ms (the better of two medians of 20, "
              f"in turns); test() wall {test_s / args.batches:.4f} s per batch over "
              f"{args.batches} batches incl. loading and metrics, with use_fused "
              f"{fused_test_s / args.batches:.4f} s")
        serving = (step, fused_step, x, y, ms_batch, ms_fused)  # their kernel time: at the end

        tstep = train_step_of(trainer.model, cfg, in_vars, out_vars, mu_dtype=mu, nu_dtype=nu)
        g1, g2 = gens(13)
        ms_train = cuda_ms(lambda: tstep(xb, yb, g1, g2))
        print(f"  train step, slice geometry (32 x 64 -> 512 tokens, 23 variables, batch "
              f"{xb.shape[0]}, bf16): {ms_train:.3f} ms, {xb.shape[0] / ms_train * 1e3:.2f} "
              f"samples/s (median of 20); fit {fit_s / steps:.4f} s per step over {steps} "
              f"steps incl. loading and the first step's warm-up")
        switch_us, current_us = device_switch_us()
        per_step = sum(train_counts.values()) / steps
        print(f"  launch host cost: torch.cuda.device entered and left {switch_us:.3f} us a "
              f"launch, the current-device check {current_us:.3f} us; {per_step:.0f} kernel "
              f"launches a slice train step, so {per_step * (switch_us - current_us) / 1e3:.4f} "
              f"ms a step of {ms_train:.3f}")
        del trainer, tstep, ev
        lap("slice steps")

    from orbit2_tpu_torch.models import ResSlimViT

    bench = ResSlimViT(BENCH_VARS, (64, 128), 7, 3, superres_mag=4, patch_size=2,
                       embed_dim=1024, depth=8, decoder_depth=2, num_heads=16,
                       learn_pos_emb=True, spatial_resolution=111.0, attention_impl="auto",
                       drop_rate=0.1, drop_path=0.1, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).cuda()
    bench_cfg = copy.deepcopy(cfg)
    bench_cfg.model.lr, bench_cfg.model.weight_decay = 1e-4, 1e-5
    bench_cfg.model.beta_1, bench_cfg.model.beta_2 = 0.9, 0.999
    bench_cfg.data.var_weights = None
    bstep = train_step_of(bench, bench_cfg, BENCH_VARS, BENCH_VARS[4:], mu_dtype="bfloat16")
    rng = np.random.default_rng(0)
    bx = torch.from_numpy(rng.normal(size=(8, 7, 64, 128)).astype(np.float32)).cuda()
    by = torch.from_numpy(rng.normal(size=(8, 3, 256, 512)).astype(np.float32)).cuda()
    g1, g2 = gens(17)
    ms_bench = cuda_ms(lambda: bstep(bx, by, g1, g2))
    print(f"  train step, bench.py 117M geometry (64 x 128 -> 2048 tokens, 7 variables, batch 8, "
          f"bf16, mu bf16): {ms_bench:.3f} ms, {8 / ms_bench * 1e3:.2f} samples/s "
          f"(median of 20)")
    lap("bench.py step")

    # after the steps: a profiler session may slow the launches that follow it
    k1_rows(gen, kernel_seed, timed, libs, bounds, smi)
    bwd_rows(gen, kernel_seed, timed, libs, bounds, smi)
    dropout_rows(gen, kernel_seed, timed, libs, bounds, smi)
    mlp_rows(gen, timed, libs, bounds, smi)
    lap("kernel rows")
    serving_rows(*serving, smi)
    del serving
    serving_1b = serving_1b_times(s1b, gen, kernel_seed, call_s, smi)
    lap("serving rows, serving 1B")
    # serve1b's weights for phase mesh, as the train CLI's --torch-npz reads them
    mesh_dir = tempfile.TemporaryDirectory(dir=ROOT / "_smoke")
    weights_1b = str(Path(mesh_dir.name) / "weights_1b.npz")
    np.savez(weights_1b, **{k: t.float().cpu().numpy() for k, t in
                            s1b["ev"].model.state_dict().items()})
    del s1b
    lap("serve1b's weights written")
    print(json.dumps({"serving_1b": serving_1b}))
    train_1b = train_1b_times(t1b, gen, kernel_seed, call_s, smi)
    lap("train 1B")
    print(json.dumps({"train_1b": {"gpu": smi, "step": t1b["out"], "kernels": train_1b}}))
    resume_1b = resume_1b_times(r1b, gen, kernel_seed, call_s, smi)
    lap("resume 1B")
    print(json.dumps({"resume_1b": {"gpu": smi, **r1b["out"], "launches": r1b["launched"],
                                    "finetune_launches": r1b["finetune"]["launched"],
                                    "errors": r1b["errs"], "validation_k1_error": r1b["val_err"],
                                    "kernels": resume_1b}}))

    del bench, bstep, bx, by
    torch.cuda.empty_cache()

    # 6b. the forecasting task, the model hub and the ClimateBench driver,
    # after phase 6's timings: placed before them, their profiler sessions
    # left one of phase 6's sessions empty three times over
    phase("forecast")
    with tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        fc = forecast(Path(tmp), args.seed, smi)
    print(json.dumps({"forecast": fc["out"]}))
    phase("hub")
    with tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        hb = hub(Path(tmp), args.seed, call_s, smi)
    print(json.dumps({"hub": hb["out"]}))
    phase("climatebench")
    cb = climatebench_phase(args.seed, smi)
    print(json.dumps({"climatebench": cb["out"]}))
    torch.cuda.empty_cache()

    # the device mesh: before serve10b and moe1b, which need most of the card
    phase("mesh")
    mesh_root = Path(mesh_dir.name)
    mp = mesh_phase(mesh_root, args.seed, weights_1b, call_s, smi)
    torch.cuda.empty_cache()
    # serving on a mesh, from the same weights; beside it and phase
    # seqexpert, phase hubmesh's two ranks (the model hub, ~12 GiB a rank)
    phase("servemesh")
    hub_ranks = start_hubmesh(mesh_root / "hub", args.seed)
    with stopped_on_failure(hub_ranks):
        sm = servemesh_phase(mesh_root / "serve", args.seed, weights_1b, call_s, smi)
    print(json.dumps({"servemesh": {"gpu": smi, **sm["out"], "errors": sm["errs"]}}))
    torch.cuda.empty_cache()

    # the seq and expert axes, on two and four gloo ranks of the card, and
    # beside them phase mesh's (c): two ranks at 117M width, a few GiB each
    phase("seqexpert")
    two = start_two_ranks(mesh_root / "two", args.seed)
    with stopped_on_failure(two + hub_ranks), \
            tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        se = seqexpert_phase(Path(tmp), args.seed, call_s, smi)
    with stopped_on_failure(hub_ranks):
        mp["out"]["two_ranks"] = two_ranks(mesh_root / "two", two)
    lap("mesh (c), beside seqexpert")
    print(json.dumps({"mesh": {"gpu": smi, **mp["out"], "errors": mp["errs"]}}))
    print(json.dumps({"seqexpert": {"gpu": smi, **{k: v for k, v in se["out"].items()
                                                   if k != "strict"},
                                    "strict": {k: v for k, v in se["out"]["strict"].items()
                                               if k != "pipeline"},
                                    "errors": se["errs"]}}))
    torch.cuda.empty_cache()

    # the model hub on the mesh: (a), (b) ran beside servemesh and seqexpert
    phase("hubmesh")
    hm = hubmesh_phase(mesh_root / "hub", hub_ranks, args.seed, call_s, smi)
    mesh_dir.cleanup()
    print(json.dumps({"hubmesh": {"gpu": smi, **hm["out"], "errors": hm["errs"]}}))
    torch.cuda.empty_cache()

    # the stage axis: two gloo ranks of the card ((b) ran in seqexpert's launch)
    phase("pipeline")
    with tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        pl = pipeline_phase(Path(tmp), args.seed, call_s, smi, se["out"]["strict"]["pipeline"])
    print(json.dumps({"pipeline": {"gpu": smi, **pl["out"], "errors": pl["errs"]}}))
    torch.cuda.empty_cache()

    # 7. the 10B config served on the card, last but one: it needs most of the card
    phase("serve10b")
    with tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        s10b = serve10b(config_10b(Path(tmp), args.seed), args.seed, call_s, smi)
    print(json.dumps({"serving_10b": s10b["out"]}))

    # 8. the MoE config served and trained on the card, last: its training
    # needs most of the card
    phase("moe1b")
    with tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        m1b = moe1b(Path(tmp), args.seed, call_s, smi)
    print(json.dumps({"moe_1b": m1b["out"]}))

    slice_shape = SHAPES[0]
    mlp_shape = MLP_SHAPES[0]
    bf16 = torch.bfloat16

    def entry(name, source, replaces, err, ms, bound, library, launched=None, chain=None):
        launched = train_counts if launched is None else launched
        e = {"name": name, "route": "cuda", "source": f"orbit2_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launched[name], "max_abs_err": err,
             "ms": ms[0], "plain_ms": ms[1], "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": library}
        if chain is not None:
            e["chain_ms"] = chain
        return e

    def probe_entry(name, line):
        ms, bound, library, chain = probe_timed[name]
        return entry(name, "attn_probes.cu", f"scripts/bench_attn2.py:{line}",
                     errs[(name, PROBE_SHAPES[0])], ms, bound, library, probe_counts, chain)

    def path_entry(rows, key, launched, path, name, source, replaces, err):
        r = rows[key]
        return {"name": name, "route": "cuda", "source": f"orbit2_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launched, "max_abs_err": err,
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"], "path": path,
                "shape": r["shape"]}

    def train1b_entry(name, source, replaces, err):
        return path_entry(train_1b, name, t1b["launched"][name], "train1b", name, source,
                          replaces, err)

    def resume1b_entry(name, source, replaces, err):
        # launches: the fine-tune's, the phase's run at this shape
        return path_entry(resume_1b, name, r1b["finetune"]["launched"][name], "resume1b", name,
                          source, replaces, err)

    t1b_errs = t1b["errs"][t1b["shape"][0]]
    r1b_errs = r1b["errs"]
    drop_shape = DROPOUT_SHAPES[1]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - START:.1f} s")
    print(json.dumps({"kernels": [
        entry("flash_attn_fwd", "flash_attn_fwd.cu", "orbit2_tpu/ops/flash_attention.py:117",
              errs[("fwd", bf16, slice_shape, DROP)], timed[("fwd", bf16, slice_shape, DROP)],
              bounds[("fwd_drop", slice_shape)], libs[("fwd", slice_shape, DROP)]),
        # the library call of K2 and K3 is SDPA's whole backward (dq, dk and dv)
        entry("flash_attn_bwd_dq", "flash_attn_bwd.cu", "orbit2_tpu/ops/flash_attention.py:287",
              errs[("dq", bf16, slice_shape, DROP)], timed[("dq", bf16, slice_shape, DROP)],
              bounds[("dq_drop", slice_shape)], libs[("bwd", slice_shape)]),
        entry("flash_attn_bwd_dkv", "flash_attn_bwd.cu", "orbit2_tpu/ops/flash_attention.py:328",
              max(errs[("dk", bf16, slice_shape, DROP)], errs[("dv", bf16, slice_shape, DROP)]),
              timed[("dkv", bf16, slice_shape, DROP)], bounds[("dkv_drop", slice_shape)],
              libs[("bwd", slice_shape)]),
        entry("fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39",
              errs[("fused_dropout",)], timed[("fused_dropout", bf16, drop_shape)],
              bounds[("fused_dropout", bf16, drop_shape)], libs[("fused_dropout", bf16, drop_shape)]),
        entry("fused_mlp_fwd", "fused_mlp.cu", "orbit2_tpu/ops/fused_mlp.py:125",
              errs[("mlp_fwd", bf16, mlp_shape, 0.0)], timed[("mlp_fwd", mlp_shape)],
              bounds[("mlp_fwd", mlp_shape)], None, fused_counts,
              libs[("mlp_fwd_chain", mlp_shape)]),
        entry("fused_mlp_dx", "fused_mlp.cu", "orbit2_tpu/ops/fused_mlp.py:177",
              errs[("mlp_dx", bf16, mlp_shape, 0.0)], timed[("mlp_dx", mlp_shape)],
              bounds[("mlp_dx", mlp_shape)], None, grad_counts,
              libs[("mlp_bwd_chain", mlp_shape)]),
        entry("fused_mlp_dw", "fused_mlp.cu", "orbit2_tpu/ops/fused_mlp.py:209",
              errs[("mlp_dw", bf16, mlp_shape, 0.0)], timed[("mlp_dw", mlp_shape)],
              bounds[("mlp_dw", mlp_shape)], None, grad_counts,
              libs[("mlp_bwd_chain", mlp_shape)]),
        probe_entry("probe_matmul_only", 47),
        probe_entry("probe_exp_noreduce", 56),
        probe_entry("probe_full_softmax", 66),
        probe_entry("probe_bound_shift", 78),
        # the tiled 1B training path's kernels at its shapes (phase train1b)
        train1b_entry("flash_attn_fwd", "flash_attn_fwd.cu",
                      "orbit2_tpu/ops/flash_attention.py:150", t1b_errs["fwd"]),
        train1b_entry("flash_attn_bwd_dq", "flash_attn_bwd.cu",
                      "orbit2_tpu/ops/flash_attention.py:287", t1b_errs["dq"]),
        train1b_entry("flash_attn_bwd_dkv", "flash_attn_bwd.cu",
                      "orbit2_tpu/ops/flash_attention.py:328", max(t1b_errs["dk"], t1b_errs["dv"])),
        train1b_entry("fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0),
        # the 1B fine-tune's shapes, and the validation's K1 (phase resume1b)
        resume1b_entry("flash_attn_fwd", "flash_attn_fwd.cu",
                       "orbit2_tpu/ops/flash_attention.py:150", r1b_errs["fwd"]),
        resume1b_entry("flash_attn_bwd_dq", "flash_attn_bwd.cu",
                       "orbit2_tpu/ops/flash_attention.py:287", r1b_errs["dq"]),
        resume1b_entry("flash_attn_bwd_dkv", "flash_attn_bwd.cu",
                       "orbit2_tpu/ops/flash_attention.py:328", max(r1b_errs["dk"], r1b_errs["dv"])),
        resume1b_entry("fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0),
        path_entry(resume_1b, "validation", resume_1b["validation"]["launches"],
                   "resume1b validation", "flash_attn_fwd", "flash_attn_fwd.cu",
                   "orbit2_tpu/ops/flash_attention.py:150", r1b["val_err"]),
        # the 10B serving path's kernels at its shapes (phase serve10b): K1 in
        # test(), on the stitched fields' tiles and, with dropout, in the MC
        # ensemble, which also runs K5
        *(path_entry(s10b["rows"], key, s10b["rows"][key]["launches"], path, "flash_attn_fwd",
                     "flash_attn_fwd.cu", "orbit2_tpu/ops/flash_attention.py:150", s10b["errs"][key])
          for key, path in ((("fwd", 0.0), "serve10b"), (("fwd_tile", 0.0), "serve10b stitch"),
                            (("fwd", s10b["rate"]), "serve10b mc"))),
        *(path_entry(s10b["rows"], ("fused_dropout", width),
                     s10b["rows"][("fused_dropout", width)]["launches"], "serve10b mc",
                     "fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for width in s10b["widths"]),
        # the MoE config's paths (phase moe1b): its training's K1-K3 and K5
        # (launches: the fit's), its serving's K1 (launches: test()'s)
        *(path_entry(m1b["rows"], name, m1b["out"]["fit_launches"][name], "moe1b", name, source,
                     replaces, err)
          for name, source, replaces, err in (
              ("flash_attn_fwd", "flash_attn_fwd.cu", "orbit2_tpu/ops/flash_attention.py:150",
               m1b["errs"]["fwd"]),
              ("flash_attn_bwd_dq", "flash_attn_bwd.cu", "orbit2_tpu/ops/flash_attention.py:287",
               m1b["errs"]["dq"]),
              ("flash_attn_bwd_dkv", "flash_attn_bwd.cu", "orbit2_tpu/ops/flash_attention.py:328",
               max(m1b["errs"]["dk"], m1b["errs"]["dv"])),
              ("fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0))),
        path_entry(m1b["rows"], "serve", m1b["rows"]["serve"]["launches"], "moe1b serve",
                   "flash_attn_fwd", "flash_attn_fwd.cu", "orbit2_tpu/ops/flash_attention.py:150",
                   m1b["serve_err"]),
        # the forecasting ResNet's K5 (phase forecast)
        path_entry(fc["rows"], "fused_dropout", fc["rows"]["fused_dropout"]["launches"],
                   "forecast", "fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39",
                   0.0),
        # the hub ViT's K1-K3 at N 32,768 (K1 also without dropout, as test()
        # runs it) and K5 at the hub models' shapes (phase hub)
        *(path_entry(hb["rows"], (name, rate), hb["rows"][(name, rate)]["launches"], path, name,
                     source, f"orbit2_tpu/ops/flash_attention.py:{line}", err)
          for name, rate, path, source, line, err in (
              ("flash_attn_fwd", DROP, "hub vit", "flash_attn_fwd.cu", 150,
               hb["errs"]["train"]["fwd"]),
              ("flash_attn_fwd", 0.0, "hub vit serve", "flash_attn_fwd.cu", 150,
               hb["errs"]["serve"]["fwd"]),
              ("flash_attn_bwd_dq", DROP, "hub vit", "flash_attn_bwd.cu", 287,
               hb["errs"]["train"]["dq"]),
              ("flash_attn_bwd_dkv", DROP, "hub vit", "flash_attn_bwd.cu", 328,
               max(hb["errs"]["train"]["dk"], hb["errs"]["train"]["dv"])))),
        *(path_entry(hb["rows"], key, hb["rows"][key]["launches"], f"hub {key[0]}",
                     "fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for key in hb["rows"] if key[1] == "fused_dropout"),
        # the ClimateBench driver's K5, fp32 (phase climatebench)
        *(path_entry(cb["rows"], name, cb["rows"][name]["launches"], f"climatebench {name}",
                     "fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for name in cb["rows"]),
        # the 1B model wrapped on a one-rank mesh (phase mesh): K1-K3 and K5
        # at its shapes, launches the wrapped steps'
        *(path_entry(mp["rows"], name, mp["launched"][name], "mesh", name, source,
                     f"orbit2_tpu/ops/{replaces}", err)
          for name, source, replaces, err in (
              ("flash_attn_fwd", "flash_attn_fwd.cu", "flash_attention.py:150", mp["errs"]["fwd"]),
              ("flash_attn_bwd_dq", "flash_attn_bwd.cu", "flash_attention.py:287",
               mp["errs"]["dq"]),
              ("flash_attn_bwd_dkv", "flash_attn_bwd.cu", "flash_attention.py:328",
               max(mp["errs"]["dk"], mp["errs"]["dv"])))),
        *(path_entry(mp["rows"], ("fused_dropout", shape),
                     mp["rows"][("fused_dropout", shape)]["launches"], "mesh", "fused_dropout",
                     "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for shape in mp["k5_shapes"]),
        # the seq axis's new calls (phase seqexpert): K1-K3 at the gather,
        # Ulysses and ring shapes, launches the two-rank fit's under each
        # impl (a rank's), and K5 at the seq path's widths
        *(path_entry(se["rows"], (path, name),
                     se["launched"][f"seq_{path.split()[-1]}"]["launches"][name], path, name,
                     source, f"orbit2_tpu/ops/flash_attention.py:{line}", err)
          for path in ("seqexpert gather", "seqexpert ulysses", "seqexpert ring")
          for name, source, line, err in (
              ("flash_attn_fwd", "flash_attn_fwd.cu", 150, se["errs"][path]["fwd"]),
              ("flash_attn_bwd_dq", "flash_attn_bwd.cu", 287, se["errs"][path]["dq"]),
              ("flash_attn_bwd_dkv", "flash_attn_bwd.cu", 328,
               max(se["errs"][path]["dk"], se["errs"][path]["dv"])))),
        *(path_entry(se["k5"], shape, se["k5"][shape]["launches"], "seqexpert gather",
                     "fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for shape in se["k5"]),
        # the pipeline's microbatches (phase pipeline): K1-K3 and K5 at a
        # microbatch's shapes, launches stage 0's in the interleaved fit
        *(path_entry(pl["rows"], ("pipeline", name),
                     pl["launched"]["interleaved"][0]["launches"][name], "pipeline", name, source,
                     f"orbit2_tpu/ops/flash_attention.py:{line}", err)
          for name, source, line, err in (
              ("flash_attn_fwd", "flash_attn_fwd.cu", 150, pl["errs"]["fwd"]),
              ("flash_attn_bwd_dq", "flash_attn_bwd.cu", 287, pl["errs"]["dq"]),
              ("flash_attn_bwd_dkv", "flash_attn_bwd.cu", 328,
               max(pl["errs"]["dk"], pl["errs"]["dv"])))),
        *(path_entry(pl["k5"], shape, pl["k5"][shape]["launches"], "pipeline", "fused_dropout",
                     "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for shape in pl["k5"]),
        # serving on a mesh (phase servemesh): K1 at a rank's shapes, launches
        # a rank's in test(), and K5 at the MC ensemble's widths
        *(path_entry(sm["rows"], mode, sm["rows"][mode]["launches"], f"servemesh {mode}",
                     "flash_attn_fwd", "flash_attn_fwd.cu",
                     "orbit2_tpu/ops/flash_attention.py:150", sm["errs"][mode])
          for mode in sm["rows"]),
        *(path_entry(sm["k5"], shape, sm["k5"][shape]["launches"], "servemesh mc",
                     "fused_dropout", "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for shape in sm["k5"]),
        # the model hub on the mesh (phase hubmesh): the ViT's K1-K3 at a
        # rank's shapes on fsdp 2 and tensor 2 (launches a rank's in its
        # fine-tune), K1 without dropout as test() runs it, and K5 at every
        # width the ranks launched it at
        *(path_entry(hm["rows"][mode], (name, rate), hm["rows"][mode][(name, rate)]["launches"],
                     f"hubmesh {mode}{' serve' if rate == 0.0 else ''}", name, source,
                     f"orbit2_tpu/ops/flash_attention.py:{line}", err)
          for mode in hm["rows"]
          for name, rate, source, line, err in (
              ("flash_attn_fwd", DROP, "flash_attn_fwd.cu", 150,
               hm["errs"][mode]["train"]["fwd"]),
              ("flash_attn_fwd", 0.0, "flash_attn_fwd.cu", 150,
               hm["errs"][mode]["serve"]["fwd"]),
              ("flash_attn_bwd_dq", DROP, "flash_attn_bwd.cu", 287,
               hm["errs"][mode]["train"]["dq"]),
              ("flash_attn_bwd_dkv", DROP, "flash_attn_bwd.cu", 328,
               max(hm["errs"][mode]["train"]["dk"], hm["errs"][mode]["train"]["dv"])))),
        *(path_entry(hm["k5"], shape, hm["k5"][shape]["launches"], "hubmesh", "fused_dropout",
                     "fused_dropout.cu", "orbit2_tpu/ops/dropout.py:39", 0.0)
          for shape in hm["k5"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:  # one of phase mesh's two ranks
        mesh_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--seqexpert-worker"]:  # one of phase seqexpert's ranks
        seqexpert_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                         sys.argv[6])
    elif sys.argv[1:2] == ["--servemesh-worker"]:  # one of phase servemesh's two ranks
        servemesh_worker(sys.argv[2], int(sys.argv[3]), sys.argv[5], sys.argv[6])
    elif sys.argv[1:2] == ["--hubmesh-worker"]:  # one of phase hubmesh's two ranks
        hubmesh_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                       sys.argv[6])
    elif sys.argv[1:2] == ["--pipeline-worker"]:  # one of phase pipeline's two ranks
        pipeline_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                        sys.argv[6])
    else:
        main()
