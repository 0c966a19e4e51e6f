"""Batching + background prefetch.

A copy of orbit2_tpu/data/loader.py without its JAX device-staging helper:
a thread drains the sample pipeline and collates numpy batches ahead of the
consumer. Collation semantics match reference itermodule.py:451-506:
stack dict-of-variables -> [B, C, H, W], return (x, y, in_vars, out_vars),
with the 2m_temperature_extreme_mask split out when present, and lead times
appended as an extra input channel for continuous forecasting.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np


def _stack_vars(d: Dict[str, np.ndarray]) -> np.ndarray:
    t = np.stack(tuple(d.values()))
    if t.ndim == 4:  # (C, T, H, W) -> (T, C, H, W) for history inputs
        return np.swapaxes(t, 0, 1)
    return t


def collate(samples: List[tuple]) -> tuple:
    """reference collate_fn (itermodule.py:451-488)."""
    inp = np.stack([_stack_vars(s[0]) for s in samples])
    has_extreme_mask = "2m_temperature_extreme_mask" in samples[0][1]
    if not has_extreme_mask:
        out = np.stack([_stack_vars(s[1]) for s in samples])
        variables = list(samples[0][0].keys())
        out_variables = list(samples[0][1].keys())
        return inp, out, variables, out_variables
    out, mask = [], []
    for s in samples:
        out_dict = {k: v for k, v in s[1].items() if k != "2m_temperature_extreme_mask"}
        mask_dict = {
            k: v for k, v in s[1].items() if k == "2m_temperature_extreme_mask"
        }
        out.append(_stack_vars(out_dict))
        if mask_dict:
            mask.append(_stack_vars(mask_dict))
    out = np.stack(out)
    mask = np.stack(mask) if mask else None
    variables = list(samples[0][0].keys())
    out_variables = [k for k in samples[0][1] if k != "2m_temperature_extreme_mask"]
    return inp, out, mask, variables, out_variables


def collate_continuous(samples: List[tuple]) -> tuple:
    """reference collate_fn_continuous (itermodule.py:491-506)."""
    inp = np.stack([_stack_vars(s[0]) for s in samples])
    out = np.stack([_stack_vars(s[1]) for s in samples])
    lead_times = np.stack([s[2] for s in samples])
    b, t, _, h, w = inp.shape
    lt = np.broadcast_to(lead_times.reshape(b, 1, 1, 1, 1), (b, t, 1, h, w))
    inp = np.concatenate((inp, lt), axis=2)
    variables = list(samples[0][0].keys())
    out_variables = list(samples[0][1].keys())
    return inp, out, variables, out_variables


class BatchLoader:
    """Iterates collated numpy batches with a background prefetch thread."""

    _SENTINEL = object()

    def __init__(self, dataset, batch_size: int, drop_last: bool = False,
                 continuous: bool = False, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate = collate_continuous if continuous else collate
        self.prefetch = prefetch

    def _put(self, q: queue.Queue, stop: threading.Event, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, q: queue.Queue, stop: threading.Event):
        try:
            buf = []
            for sample in self.dataset:
                if stop.is_set():
                    return
                buf.append(sample)
                if len(buf) == self.batch_size:
                    if not self._put(q, stop, self.collate(buf)):
                        return
                    buf = []
            if buf and not self.drop_last:
                self._put(q, stop, self.collate(buf))
        except BaseException as e:  # surface worker errors in the consumer
            self._put(q, stop, e)
        finally:
            self._put(q, stop, self._SENTINEL)

    def __iter__(self) -> Iterator[tuple]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # consumer stopped (break / exception): unblock and end the
            # producer instead of leaking a thread per epoch
            stop.set()
            t.join(timeout=5)
