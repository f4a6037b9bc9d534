"""Device housekeeping on ``torch.cuda``: memory stats, cleanup, profiling
(counterpart of ``multimodal_colpali_tpu/utils/housekeeping.py``).

Equivalents of the reference's CUDA housekeeping (``get_less_used_gpu`` /
``free_memory``, functions.py:151-212) plus the structured tracing the
reference lacks: ``trace`` wraps a block in a profiler range and a
wall-clock measurement, and ``profile_to`` writes a profiler trace
directory. A CPU device has no allocator statistics, as JAX's CPU device
has none.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional, Sequence, Union

import torch

Device = Union[torch.device, int, str]


def _cuda(device: Optional[Device]) -> Optional[torch.device]:
    """The CUDA device ``device`` names (the current one for None), or None
    for a CPU device or where CUDA is unavailable."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else None
    dev = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    return dev if dev.type == "cuda" else None


def device_memory_stats(device: Optional[Device] = None) -> Dict[str, int]:
    """Allocation stats for one device (bytes): ``bytes_in_use`` and
    ``peak_bytes_in_use`` from the caching allocator (``memory_allocated`` /
    ``max_memory_allocated``), ``bytes_limit`` the card's memory. Empty for
    a CPU device."""
    dev = _cuda(device)
    if dev is None:
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}


def get_less_used_device(devices: Optional[Sequence[Device]] = None,
                         debug: bool = False) -> int:
    """Index of the device with the least allocated memory (reference
    get_less_used_gpu semantics over ``torch.cuda.device_count()`` cards;
    the CPU alone where there is no card)."""
    devs = list(devices) if devices else (
        [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        or [torch.device("cpu")])
    usage = {i: device_memory_stats(d).get("bytes_in_use", 0) for i, d in enumerate(devs)}
    best = min(usage, key=usage.get)
    if debug:
        print("Current allocated memory:", {f"{torch.device(devs[k]).type}:{k}": v
                                            for k, v in usage.items()})
        print("Suggested device:", best)
    return best


def free_memory(to_delete: List[object], debug: bool = False) -> None:
    """Drop references and return the cached device memory to the card.

    Callers pass the tensors themselves (unlike the reference's frame-locals
    hack, functions.py:195-212); the list is emptied, so tensors nothing
    else holds are freed, then ``gc`` runs and ``torch.cuda.empty_cache()``
    releases the allocator's cached blocks."""
    if debug:
        print("Before:", device_memory_stats().get("bytes_in_use"))
    to_delete.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if debug:
        print("After:", device_memory_stats().get("bytes_in_use"))


def live_arrays_bytes() -> int:
    """Bytes of live tensors on the current card
    (``torch.cuda.memory_allocated()``). Without CUDA it is 0: torch keeps
    no account of live CPU tensors, and the JAX package's count is of
    device arrays."""
    return int(torch.cuda.memory_allocated()) if torch.cuda.is_available() else 0


@contextlib.contextmanager
def trace(name: str, verbose: bool = True):
    """Wall-clock + profiler range around a block. The block's device work
    is timed only as far as the block waits for it (no synchronize here, as
    JAX's does not block)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[trace] {name}: {dt*1e3:.2f} ms")


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (TensorBoard's trace handler: one ``*.pt.trace.json`` a run); CUDA
    activity too where a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
