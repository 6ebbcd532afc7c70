"""Timing on the card, shared by ``chip_smoke.py`` and ``tile_sweep``.

:func:`cuda_ms` launches the calls from Python between CUDA events, so a
small kernel's time is its wrapper's host time where that is the longer;
:func:`graph_ms` replays them from a CUDA graph, so it is device time only.
"""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms of one call of ``fn``: ``iters`` calls launched from Python
    between CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's launch
    overhead (the wrapper's Python) is not in the time."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up on a side stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)
