"""The benchmark's spans and the device trace of a traced window.

The drivers mark what the host does with ``span(name)`` (a
``torch.profiler.record_function``): ``window`` around the whole traced
window, and ``replay`` (the runner's call, its copy-in included),
``answers``, ``feed`` and ``step`` inside it.  ``traced()`` profiles the card (CUPTI, through
``torch.profiler``) and turns the raw events into a :class:`Trace`: the
device's kernels and copies, the spans and the host's other operations,
all on the profiler's clock.  The arithmetic is ``profile_serving``'s: busy
is the time some operation ran on the device (here the union of their
intervals), idle is the rest of the window.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

SPANS = ("window", "replay", "answers", "feed", "step")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    return torch.profiler.record_function(name)


@dataclass
class Trace:
    lo: int                                    # the window, ns
    hi: int
    kernels: List[Tuple[str, int, int]]        # (name, start, end)
    device: List[Tuple[str, int, int]]         # kernels, copies and fills
    spans: List[Tuple[str, int, int]]
    host_ops: List[Tuple[str, int, int]]       # the window's thread, sorted by start
    kinds: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def _clip(self, a: int, b: int) -> int:
        return max(0, min(b, self.hi) - max(a, self.lo))

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, self.lo), min(b, self.hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_s(self, patterns: Iterable[str], match: bool = True) -> float:
        """Seconds of the window's kernels whose names match any of
        ``patterns`` (``match=False``: match none of them)."""
        rx = re.compile("|".join(patterns), re.IGNORECASE)
        return sum(self._clip(a, b) for n, a, b in self.kernels
                   if bool(rx.search(n)) == match) / 1e9

    def span_s(self, name: str) -> List[float]:
        return [(b - a) / 1e9 for n, a, b in self.spans if n == name and self._clip(a, b)]

    @staticmethod
    def _innermost(events: List[Tuple[str, int, int]], starts: List[int], t: int,
                   default: str) -> str:
        i = bisect.bisect_right(starts, t)
        for n, a, b in reversed(events[max(0, i - 64):i]):
            if b >= t:
                return n
        return default

    def _name_at(self, t: int, inner, inner_starts, op_starts) -> str:
        where = self._innermost(inner, inner_starts, t, "window")
        return f"{where}:{self._innermost(self.host_ops, op_starts, t, 'python')}"

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time, and the ten
        longest idle stretches summed by what the host was doing."""
        ops: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            ops[n[:120]] += self._clip(a, b) / 1e9
        gaps: Dict[str, float] = defaultdict(float)
        inner = [s for s in self.spans if s[0] != "window"]
        where = ([s[1] for s in inner], [s[1] for s in self.host_ops])
        edge = self.lo
        for a, b in self.busy_intervals() + [(self.hi, self.hi)]:
            if a > edge:
                gaps[self._name_at((edge + a) // 2, inner, *where)] += (a - edge) / 1e9
            edge = max(edge, b)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}


def _events(prof) -> list:
    return prof.profiler.kineto_results.events()


def to_trace(prof) -> Optional[Trace]:
    cuda = torch.autograd.DeviceType.CUDA
    evs = _events(prof)
    windows = [e for e in evs if e.name() == "window" and e.device_type() != cuda]
    if not windows:
        return None
    w = windows[0]
    lo, hi, thread = w.start_ns(), w.start_ns() + w.duration_ns(), w.start_thread_id()
    kernels, device, spans, host = [], [], [], []
    kinds: Dict[str, int] = defaultdict(int)
    for e in evs:
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            kind = e.activity_type() if hasattr(e, "activity_type") else \
                "gpu_memcpy" if name.startswith("Memcpy") else \
                "gpu_memset" if name.startswith("Memset") else "kernel"
            kinds[kind] += 1
            if kind not in DEVICE_KINDS or name in SPANS:
                continue
            device.append((name, a, b))
            if kind == "kernel":
                kernels.append((name, a, b))
        elif name in SPANS:
            spans.append((name, a, b))
        elif e.start_thread_id() == thread and lo <= a <= hi:
            host.append((name, a, b))
    spans.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    return Trace(lo, hi, kernels, device, spans, host, dict(kinds))


@contextlib.contextmanager
def traced(on: bool, cuda: bool = True):
    """Profile the body when ``on`` (the card too when ``cuda``); the
    :class:`Trace` (or None) is in the yielded dict under ``"trace"`` once
    the body has ended."""
    box: Dict[str, Optional[Trace]] = {"trace": None}
    if not on:
        with span("window"):
            yield box
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with span("window"):
            yield box
        if cuda:
            torch.cuda.synchronize()
    box["trace"] = to_trace(prof)
