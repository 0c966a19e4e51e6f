"""Device-memory telemetry (counterpart of orbit2_tpu/utils/memory.py's
`device_memory_stats` and `log_memory`).

The JAX functions read the accelerator allocator's stats under the names
bytes_in_use, peak_bytes_in_use, bytes_limit and largest_alloc_size; here they
come from `torch.cuda.memory_stats` and the device's total memory, under the
same names (PyTorch keeps no largest allocation, so that key is absent, as
JAX leaves out a key its backend lacks), with the caching allocator's
reserved bytes beside them (what the reference prints,
torch.cuda.memory_reserved). The CPU keeps no allocator stats: None there.

JAX `plan_train_memory` lowers and compiles the XLA train step abstractly to
read the compiler's memory plan; a PyTorch program has no such whole-step
program to plan, so it is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Allocator stats of one device (default: the current CUDA device), or
    None where there are none (the CPU, or no card)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
    }


def log_memory(metrics, event: str = "memory", device=None, **extra) -> Optional[Dict]:
    """Emits one allocator snapshot to `metrics` (anything with
    `.log(event, **fields)`, as JAX's MetricsLogger); a no-op returning None
    where device_memory_stats has none."""
    stats = device_memory_stats(device)
    if stats is None:
        return None
    return metrics.log(event, **stats, **extra)
