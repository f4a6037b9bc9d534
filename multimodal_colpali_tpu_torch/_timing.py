"""Device time of a call on the card, by CUDA events.

:func:`eager_ms` times calls as Python issues them; :func:`graph_ms` captures
them once as a CUDA graph and replays it, so a kernel shorter than its
Python launch is timed on the card, not by the host. ``chip_smoke.py``,
``maxsim_sweep`` and ``generation.paged_sweep`` time with these.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def cycle(fns: Sequence[Callable]) -> Callable:
    """A call that runs ``fns`` in turn, one per call (a graph captured over
    it reads each set of inputs in turn)."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def eager_ms(fn: Callable, iters: int) -> float:
    """Per-call ms of ``fn`` with CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable, iters: int) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured once as a CUDA
    graph, which is replayed once to warm up and then three times under
    CUDA events."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                       # warm-up on the capture stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    ms = eager_ms(graph.replay, 3) / iters
    del graph
    return ms
