"""What the kernels' launches share at run time: the current stream as the
pointer a C entry takes, the card's SM count, and the arrival counters of the
kernels that split a reduction across blocks."""
from __future__ import annotations

import contextlib
import functools

import torch


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as the pointer a kernel's C entry
    takes: torch's raw-stream query, the one Triton's launcher makes, which
    builds no ``torch.cuda.Stream`` object as ``current_stream`` does."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` where ``device`` is not the current
    device, else a context that does nothing: a kernel is launched on the
    current device, and entering the context costs the host more than the
    check."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# (device, stream) -> int32 arrival counters of the kernels that split a
# reduction across blocks (K1's K ranges, K3's split form); zero between
# launches, since the last block or program to arrive resets its own, so the
# kernels of one stream can share them.
_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for ``device``'s current stream."""
    key = (device, raw_stream(device))
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return cnt
