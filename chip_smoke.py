#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 / sm_90a).

    python3 chip_smoke.py [--seed 0] [--batches 3]

Phases, each of which raises (and so exits non-zero) on failure:
  1. device  — needs torch.cuda; prints the card's name and power limit
  2. build   — nvcc-builds every kernel of the serving path from csrc/
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the serving path and the configs give it
  4. slice   — the port's serving path (Evaluator.test) at interm_117m width
               (configs/interm_117m.yaml: embed 1024, depth 8, 16 heads, bf16,
               batch 8) on a synthetic dataset made from --seed; the kernels'
               launch counts over that run; the prediction against the same
               model on the plain attention, and in fp32 against the CPU
  5. times   — kernel vs plain (CUDA events, median of 20 after warm-up) and
               the slice's seconds per test batch

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. No result is printed when a phase fails.
"""

import argparse
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "interm_117m.yaml"

# (B, N_q, N_k, H, D): the slice, the 117M bench shape, the 1B serving shape,
# a ragged N over many kv tiles at the widest head, and N_q != N_k
SHAPES = [
    (8, 512, 512, 16, 64),
    (8, 2048, 2048, 16, 64),
    (2, 2048, 2048, 24, 128),
    (1, 4100, 4100, 2, 256),
    (2, 300, 1000, 4, 128),
]
# bf16: both sides read the same bf16 inputs and accumulate in fp32; the kernel
# rounds p to bf16 for the tensor-core value product and o once at the end.
# fp32: summation order only
O_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
LSE_ATOL = 1e-3
# the bf16 model on the kernel vs on the plain ("xla") attention: bf16 probs
# in the plain path round to 8 bits before the value product, and that
# difference passes through 8 blocks and the decoder
PRED_BF16_TOL = 5e-2
# the fp32 model on the card (kernel, cuBLAS/cuDNN without TF32) vs on the CPU
PRED_FP32_TOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


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


def make_qkv(b, n_q, n_k, h, d, dtype, gen):
    mk = lambda n: torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype)
    return mk(n_q), mk(n_k), mk(n_k)


def write_dataset(root: Path, in_vars, out_vars, seed: int, n_files=2, t=16):
    """The tests/conftest.py layout at ERA5 5.625 deg (32 x 64) -> 1.40625 deg
    (128 x 256): per-split npz shards of [T, 1, H, W] arrays, normalize
    mean/std, lat/lon and climatology."""
    rng = np.random.default_rng(seed)

    def field(v, h, w):
        if v == "total_precipitation_24hr":
            return rng.gamma(0.3, 0.004, size=(t, 1, h, w))
        if v in ("land_sea_mask", "landcover"):
            return rng.integers(0, 2, size=(t, 1, h, w)).astype(np.float64)
        return rng.normal(280, 10, size=(t, 1, h, w))

    for base, (h, w), variables in ((root / "low", (32, 64), in_vars),
                                    (root / "high", (128, 256), out_vars)):
        d = base / "test"
        d.mkdir(parents=True)
        for i in range(n_files):
            np.savez(d / f"shard_{i}.npz",
                     **{v: field(v, h, w).astype(np.float32) for v in variables})
        np.savez(d / "climatology.npz",
                 **{v: rng.normal(280, 1, size=(1, h, w)).astype(np.float32) for v in variables})
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args()

    # 1. device
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        sys.exit(2)
    from orbit2_tpu_torch.ops.flash_attention import (
        FLASH_FWD, attention_flops, flash_attention_fwd, flash_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    phase("build")
    FLASH_FWD.library.load()
    print(f"flash_attn_fwd built in {FLASH_FWD.library.build_seconds:.2f} s "
          f"({FLASH_FWD.library.path().name})")

    # 3. kernels against their plain versions
    phase("kernels")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            b, n_q, n_k, h, d = shape
            q, k, v = make_qkv(b, n_q, n_k, h, d, dtype, gen)
            o, lse = flash_attention_fwd(q, k, v)
            want_o, want_lse = flash_attention_reference(q, k, v)
            torch.cuda.synchronize()
            err_o = (o.float() - want_o.float()).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            tol = O_TOL[dtype]
            ok_o = bool(((o.float() - want_o.float()).abs()
                         <= tol + tol * want_o.float().abs()).all())
            print(f"  {str(dtype)[6:]:8s} B{b} Nq{n_q} Nk{n_k} H{h} d{d}: "
                  f"max|do| {err_o:.3e} (atol=rtol={tol:g})  max|dlse| {err_lse:.3e} "
                  f"(atol {LSE_ATOL:g})")
            check(ok_o and err_lse <= LSE_ATOL, f"kernel disagrees with plain at {shape} {dtype}")
            errs[(dtype, shape)] = err_o
    torch.cuda.synchronize()

    # 4. the serving slice
    phase("slice")
    from orbit2_tpu_torch.evaluate import Evaluator
    from orbit2_tpu_torch.training.train import make_eval_step

    (ROOT / "_smoke").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "_smoke") as tmp:
        cfg = slice_config(Path(tmp), args.seed)
        m = cfg.model
        print(f"  config {CONFIG.name}: embed {m.embed_dim} depth {m.depth} heads {m.num_heads} "
              f"decoder {m.decoder_depth} {cfg.trainer.data_type} batch {cfg.trainer.batch_size} "
              f"attention {m.attention_impl}")

        FLASH_FWD.launches = 0
        ev = Evaluator(cfg, "cuda")
        tt = time.perf_counter()
        metrics = ev.test(max_batches=args.batches)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - tt
        launches = FLASH_FWD.launches

        print(f"  test(max_batches={args.batches}) {test_s:.3f} s; flash_attn_fwd launches "
              f"{launches}")
        for key, val in metrics.items():
            print(f"    {key} {val:.6f}")
        check(len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values()),
              "slice metrics missing or not finite")
        check(launches == m.depth * args.batches,
              f"flash_attn_fwd launched {launches} times, want depth x batches = "
              f"{m.depth * args.batches}")

        dm = ev.data_module
        in_vars, out_vars = dm.get_data_variables()
        loader = iter(dm.test_dataloader())
        batch = next(loader)
        loader.close()
        x = torch.from_numpy(batch[0]).cuda()
        y = torch.from_numpy(batch[1]).cuda()
        xm = x.to(next(ev.model.parameters()).dtype)
        with torch.no_grad():
            pred = ev.model(xm, in_vars, out_vars).float()
            set_attention_impl(ev.model, "xla")
            pred_plain = ev.model(xm, in_vars, out_vars).float()
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

        # 5. times
        phase("times")
        print(f"gpu: {smi}")
        timed = {}
        for dtype in (torch.bfloat16, torch.float32):
            for shape in SHAPES:
                b, n_q, n_k, h, d = shape
                q, k, v = make_qkv(b, n_q, n_k, h, d, dtype, gen)
                before = FLASH_FWD.launches
                ms_plain = cuda_ms(lambda: flash_attention_reference(q, k, v))
                ms_kernel = cuda_ms(lambda: flash_attention_fwd(q, k, v))
                ms_kernel2 = cuda_ms(lambda: flash_attention_fwd(q, k, v))
                ms_plain2 = cuda_ms(lambda: flash_attention_reference(q, k, v))
                check(FLASH_FWD.launches > before, "timing did not launch the kernel")
                kern = min(ms_kernel, ms_kernel2)
                plain = min(ms_plain, ms_plain2)
                tflops = attention_flops(b, n_q, n_k, h, d) / kern / 1e9
                timed[(dtype, shape)] = (kern, plain)
                print(f"  {str(dtype)[6:]:8s} B{b} Nq{n_q} Nk{n_k} H{h} d{d}: kernel "
                      f"{ms_kernel:.4f}/{ms_kernel2:.4f} ms ({tflops:.1f} TFLOP/s)  plain "
                      f"{ms_plain:.4f}/{ms_plain2:.4f} ms")
                del q, k, v

        step = make_eval_step(ev.model, in_vars, out_vars)
        ms_batch = cuda_ms(lambda: step(x, y))
        print(f"  slice: eval step (forward + clip) {ms_batch:.3f} ms per test batch of "
              f"{x.shape[0]} (median of 20); test() wall {test_s / args.batches:.4f} s per batch "
              f"over {args.batches} batches incl. loading and metrics")

    slice_shape = (torch.bfloat16, SHAPES[0])
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "orbit2_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "orbit2_tpu/ops/flash_attention.py:117",
        "launches": launches,
        "max_abs_err": errs[slice_shape],
        "ms": timed[slice_shape][0],
        "plain_ms": timed[slice_shape][1],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
