"""Measurement utilities (Hoefler & Belli-style: warm up, repeat, median).

Port of ``repro/core/util.py``.  torch launches CUDA work asynchronously, so
on a card each run is bracketed by CUDA events and the time is read after the
end event completes (the reference waits with ``block_until_ready``).
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch


def time_fn(
    fn: Callable[[], Any],
    repeats: int = 5,
    warmup: int = 1,
    max_seconds: float = 10.0,
    device: str | torch.device = "cuda",
) -> float:
    """Median time of ``fn`` in microseconds: device time between CUDA events
    for ``device='cuda'``, host wall time for the CPU."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    t_start = time.perf_counter()
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter_ns()
            fn()
            times.append((time.perf_counter_ns() - t0) / 1e3)
        if time.perf_counter() - t_start > max_seconds:
            break
    return float(np.median(times))
