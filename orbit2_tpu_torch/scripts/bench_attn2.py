"""Where the flash forward's time goes on the card: the four attention probes
and the flash forward on the same q, k, v.

Usage: python -m orbit2_tpu_torch.scripts.bench_attn2 [--device cuda]

Counterpart of scripts/bench_attn2.py. The inputs are its make_inputs: q, k,
v drawn from numpy.random.default_rng(0) at B 8, N 2048, H 16, D 64 as
[B*H, N, D] bf16. One line per variant: name, ms (median of ITERS CUDA-event
timings after WARMUP calls) and TFLOP/s on the useful 4 BH N^2 D. The bound
shift is timed alone and with its preparation (`bound_shift_inputs`), which
the JAX script's timed function includes, and its max abs error against the
fp32 softmax follows. The flash forward reads the same tensors viewed as
[B, N, H, D], at scale D^-1/2 and without dropout. With --device cpu every
variant runs once and nothing is timed.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Optional

import numpy as np
import torch

from orbit2_tpu_torch.ops.attn_probes import (
    bound_shift,
    bound_shift_inputs,
    exp_noreduce,
    full_softmax,
    matmul_only,
    probe_flops,
    softmax_attention,
)
from orbit2_tpu_torch.ops.flash_attention import flash_attention_fwd

B, N, H, D = 8, 2048, 16, 64
ITERS, WARMUP = 30, 3  # timed calls (scripts/bench_attn2.py's 30) and warm-up calls


def make_inputs(b: int, n: int, h: int, d: int, device):
    """q, k, v [b*h, n, d] bf16 from numpy.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.normal(size=(b * h, n, d))).to(device, torch.bfloat16)
                 for _ in range(3))


def device_ms(fn: Callable, device: torch.device) -> Optional[float]:
    """Median ms of one call by CUDA events over ITERS calls after WARMUP;
    on the CPU one untimed call and None."""
    if device.type != "cuda":
        fn()
        return None
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(ITERS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(b: int, n: int, h: int, d: int, device="cuda"):
    """{"times": [(variant, ms or None)], "flops": useful flops,
    "bound_shift_err": max abs error against the fp32 softmax} at (b, n, h, d)."""
    device = torch.device(device)
    q, k, v = make_inputs(b, n, h, d, device)
    qs, bound = bound_shift_inputs(q, k)
    q4, k4, v4 = (t.view(b, h, n, d).transpose(1, 2) for t in (q, k, v))

    def prepared_bound_shift():
        qs_, bound_ = bound_shift_inputs(q, k)
        return bound_shift(qs_, k, v, bound_)

    variants = [
        ("matmul-only ceiling", lambda: matmul_only(q, k, v)),
        ("matmul+exp2 (no reductions)", lambda: exp_noreduce(q, k, v)),
        ("two-sweep full softmax", lambda: full_softmax(q, k, v)),
        ("bound-shift one-pass", lambda: bound_shift(qs, k, v, bound)),
        ("bound-shift + preparation", prepared_bound_shift),
        ("flash forward (K1)", lambda: flash_attention_fwd(q4, k4, v4)),
    ]
    times = [(name, device_ms(fn, device)) for name, fn in variants]
    got = bound_shift(qs, k, v, bound).float()
    err = (got - softmax_attention(q, k, v)).abs().max().item()
    return {"times": times, "flops": probe_flops(b * h, n, d), "bound_shift_err": err}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}; B {B} N {N} H {H} D {D} bf16", flush=True)
    res = run(B, N, H, D, device)
    for variant, ms in res["times"]:
        if ms is None:
            print(f"{variant:28s} not timed on {device.type}")
        else:
            print(f"{variant:28s} {ms:8.4f} ms {res['flops'] / ms / 1e9:6.1f} TF")
    print(f"   max abs err vs fp32 softmax: {res['bound_shift_err']:.2e}", flush=True)


if __name__ == "__main__":
    main()
