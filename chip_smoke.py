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
  6. times   — kernel vs plain (CUDA events, median of 20 after warm-up; K1,
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
               time of every kernel a step launches

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
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "interm_117m.yaml"

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
# H100 SXM peaks (dense bf16 tensor cores, HBM3) for the kernels' bounds
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
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


def phase(name):
    print(f"== {name} (at {time.perf_counter() - START:.1f} s)", flush=True)


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


def paired_ms(kernel, plain):
    """(kernel ms, plain ms): each timed twice in turns (plain, kernel,
    kernel, plain), the better of its two medians."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
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


def reset_counts():
    for k in kernels().values():
        k.launches = 0


def counts():
    return {name: k.launches for name, k in kernels().items()}


def write_dataset(root: Path, in_vars, out_vars, seed: int, n_files=2, t=16):
    """The tests/conftest.py layout at ERA5 5.625 deg (32 x 64) -> 1.40625 deg
    (128 x 256): per-split (train, val, test) npz shards of [T, 1, H, W]
    arrays, normalize mean/std, lat/lon and per-split climatology."""
    rng = np.random.default_rng(seed)

    def field(v, h, w):
        if v == "total_precipitation_24hr":
            return rng.gamma(0.3, 0.004, size=(t, 1, h, w))
        if v in ("land_sea_mask", "landcover"):
            return rng.integers(0, 2, size=(t, 1, h, w)).astype(np.float64)
        return rng.normal(280, 10, size=(t, 1, h, w))

    for base, (h, w), variables in ((root / "low", (32, 64), in_vars),
                                    (root / "high", (128, 256), out_vars)):
        for split in ("train", "val", "test"):
            d = base / split
            d.mkdir(parents=True)
            for i in range(n_files):
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


def slice_config(root: Path, seed: int):
    """configs/interm_117m.yaml with its data dirs on a synthetic dataset of
    its variables written under `root`, and its mesh (fsdp 4 x simple_ddp 4)
    cut to the one card."""
    import yaml

    from orbit2_tpu_torch.config import load_config

    raw = yaml.safe_load(CONFIG.read_text())
    data = raw["data"]
    key = next(iter(data["low_res_dir"]))
    low, high = write_dataset(root, data["dict_in_variables"][key],
                              data["dict_out_variables"][key], seed)
    data["low_res_dir"] = {key: low}
    data["high_res_dir"] = {key: high}
    raw["parallelism"] = {"fsdp": 1, "simple_ddp": 1, "tensor_par": 1, "seq_par": 1}
    return load_config(raw)


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


def check_backward(q, k, v, o, lse, do, mult, rate, seed, case):
    """dq, dk and dv of flash_attention_bwd against autograd of the plain
    forward under the same multiplier (fp32: atol=rtol GRAD_FP32_TOL; bf16:
    atol GRAD_BF16_REL x the largest value of the gradient, or of the case's
    gradients where that one is identically zero, rtol GRAD_BF16_REL), and
    two runs bit-equal. Returns ({name: max abs error}, a line to print)."""
    from orbit2_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_reference

    dtype, d = q.dtype, q.shape[-1]
    got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    again = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, rate, seed)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    flash_attention_reference(qf, kf, vf, None, mult)[0].backward(do.float())
    torch.cuda.synchronize()
    err, line = {}, []
    refs = (qf.grad, kf.grad, vf.grad)
    for name, g, want, g2 in zip(("dq", "dk", "dv"), got, refs, again):
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
        check(torch.equal(g, g2), f"{name}: two backward runs differ at {case}")
        line.append(f"max|d{name}| {err[name]:.3e} (max|{name}| {scale:.3e})")
    return err, "  ".join(line) + "; bit-equal over two runs"


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


def sdpa_ms(q, k, v, do):
    """SDPA pinned to its flash backend (any other raises) on q, k, v
    [B, N, H, D] viewed as
    [B, H, N, D]: {"fwd": {0.0: ms, DROP: ms}, "bwd": ms of its backward alone
    (dq, dk and dv) at dropout DROP under the cotangent do}."""
    import torch.nn.functional as F

    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = {"fwd": {}}
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION), torch.no_grad():
        for rate in (0.0, DROP):
            out["fwd"][rate] = best_ms(
                lambda: F.scaled_dot_product_attention(*leaves, dropout_p=rate))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(*leaves, dropout_p=DROP)
        do_t = do.transpose(1, 2)
        out["bwd"] = best_ms(lambda: torch.autograd.grad(o, leaves, do_t, retain_graph=True))
    return out


def kernel_ms(fn, iters=10, sessions=3, by_name=None):
    """Device time of one call of fn by torch.profiler: the kernel time of
    every kernel one call launches, without the host's launch work. Over a
    session of `iters` calls after warm-up, each kernel name's mean time
    times its launches a call (its count over iters, rounded), summed. A
    session that records some kernel fewer than `iters` times (the profiler
    now and then hands back an empty or partial session) is run again, up to
    `sessions` times; the fullest is kept, and it must hold at least half of
    the kernels. by_name, a dict, receives each kernel name's ms a call."""
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


@contextlib.contextmanager
def plain_versions():
    """Routes the model's kernel calls to the kernels' plain PyTorch versions
    (autograd of the plain forwards), drawing the same seeds in the same
    order, so a step under it is the same step without the kernels."""
    import orbit2_tpu_torch.models.components.blocks as blocks
    import orbit2_tpu_torch.models.res_slimvit as res_slimvit
    from orbit2_tpu_torch.ops.dropout import dropout_reference
    from orbit2_tpu_torch.ops.flash_attention import attention_mult, flash_attention_reference
    from orbit2_tpu_torch.ops.kernel_prng import draw_seed, keep_mult

    def attention(q, k, v, impl, scale=None, dropout_rate=0.0, generator=None):
        seed = draw_seed(generator) if dropout_rate > 0.0 else 0
        return flash_attention_reference(q, k, v, scale,
                                         attention_mult(q, k, dropout_rate, seed))[0]

    def drop(x, rate, training, generator):
        if not training or rate <= 0.0:
            return x
        cols = x.shape[-1]
        mult = keep_mult(draw_seed(generator), x.numel() // cols, cols, rate, device=x.device)
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
                                   "nu_dtype": nu_dtype}, model.parameters())
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
    from orbit2_tpu_torch.ops.kernel_prng import keep_mult, keep_threshold

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
                mult = attention_mult(q, k, rate, kernel_seed)
                o, lse = flash_attention_fwd(q, k, v, None, rate, kernel_seed)
                want_o, want_lse = flash_attention_reference(q, k, v, None, mult)
                torch.cuda.synchronize()
                err_o = (o.float() - want_o.float()).abs().max().item()
                err_lse = (lse - want_lse).abs().max().item()
                tol = O_TOL[dtype]
                ok_o = bool(((o.float() - want_o.float()).abs()
                             <= tol + tol * want_o.float().abs()).all())
                print(f"  fwd {str(dtype)[6:]:8s} drop {rate:g} B{b} Nq{n_q} Nk{n_k} H{h} d{d}: "
                      f"max|do| {err_o:.3e} (atol=rtol={tol:g})  max|dlse| {err_lse:.3e} "
                      f"(atol {LSE_ATOL:g})")
                check(ok_o and err_lse <= LSE_ATOL,
                      f"flash forward disagrees with plain at {shape} {dtype} drop {rate}")
                errs[("fwd", dtype, shape, rate)] = err_o

                case = f"{str(dtype)[6:]:8s} drop {rate:g} B{b} Nq{n_q} Nk{n_k} H{h} d{d}"
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
            x = torch.randn(r, c, generator=gen, device="cuda").to(dtype).requires_grad_()
            g = torch.randn(r, c, generator=gen, device="cuda").to(dtype)
            out = FusedDropout.apply(x, kernel_seed + r, DROP)
            out.backward(g)
            mult = keep_mult(kernel_seed + r, r, c, DROP, device="cuda")
            same_fwd = torch.equal(out, dropout_reference(x.detach(), mult))
            same_bwd = torch.equal(x.grad, dropout_reference(g, mult))
            kept = (mult > 0).float().mean().item()
            print(f"  fused_dropout {str(dtype)[6:]:8s} [{r}, {c}]: fwd bit-equal {same_fwd}, "
                  f"bwd bit-equal {same_bwd}, kept {kept:.4f}")
            check(same_fwd and same_bwd, f"fused dropout differs from plain at [{r}, {c}] {dtype}")
            p_keep = (keep_threshold(DROP) + 1) / 2 ** 16  # within 2^-16 of 1 - DROP
            check(abs(kept - p_keep) < 4 * math.sqrt(p_keep * (1 - p_keep) / (r * c)),
                  f"fused dropout kept {kept} of [{r}, {c}]")
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
                kern, plain = paired_ms(lambda: flash_attention_fwd(q, k, v),
                                        lambda: flash_attention_reference(q, k, v))
                kern_drop, plain_drop = paired_ms(
                    lambda: flash_attention_fwd(q, k, v, None, DROP, kernel_seed),
                    lambda: flash_attention_reference(q, k, v, None, mult))
                o, lse = flash_attention_fwd(q, k, v, None, DROP, kernel_seed)
                delta = attention_delta(o, do)
                dq_ms = cuda_ms(lambda: FLASH_BWD_DQ(q, k, v, do, lse, delta, d ** -0.5, DROP,
                                                     kernel_seed))
                dkv_ms = cuda_ms(lambda: FLASH_BWD_DKV(q, k, v, do, lse, delta, d ** -0.5, DROP,
                                                       kernel_seed))
                bwd, bwd_plain = paired_ms(
                    lambda: flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, DROP,
                                                kernel_seed),
                    lambda: flash_attention_bwd_reference(q, k, v, o, lse, do, d ** -0.5, mult))
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
        probe_timed = time_probes(probe_res, smi)

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

    # after the steps: a profiler session may slow the launches that follow it
    k1_rows(gen, kernel_seed, timed, libs, bounds, smi)
    bwd_rows(gen, kernel_seed, timed, libs, bounds, smi)
    dropout_rows(gen, kernel_seed, timed, libs, bounds, smi)
    mlp_rows(gen, timed, libs, bounds, smi)
    serving_rows(*serving, smi)
    del serving

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
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
