"""The per-layer metrics that read the program's own spans
(``benchmark/program_spans.py``): against hand-built traces on the CPU, in
a traced run of the shrunk cells, and on the card, where the spans of a
captured program are checked against the device's records on one clock.
Card-only tests are marked ``cuda``."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny_cells  # noqa: E402

from benchmark import cell, devtrace  # noqa: E402

SPAN_METRICS = {"stage_ms.serve": "captured.stage", "launch_ms.serve": "captured.launch",
                "prefetch_wait_ms.train": "prefetch.wait"}
MS = 1_000_000   # ns


def _metric(name):
    return cell.load_module(cell.HERE / "metrics" / f"{name}.py")


def _reading(trace, units):
    return cell.Reading(trace, units, 8, {}, {}, {})


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_span_metric_sums_its_clipped_spans_per_unit(metric):
    m = _metric(metric)
    assert m.SPAN == SPAN_METRICS[metric]
    other = [n for n in SPAN_METRICS.values() if n != m.SPAN][0]
    ops = [(m.SPAN, -1 * MS, 1 * MS),      # 1 ms inside the window
           (m.SPAN, 2 * MS, 4 * MS),       # 2 ms
           (m.SPAN, 9 * MS, 12 * MS),      # 1 ms
           (other, 0, 10 * MS), ("aten::copy_", 2 * MS, 3 * MS)]
    trace = devtrace.Trace(0, 10 * MS, [], [], [("replay", 0, 10 * MS)], ops)
    assert m.read(_reading(trace, 2)) == pytest.approx(2.0)
    assert m.read(_reading(trace, 4)) == pytest.approx(1.0)
    absent = devtrace.Trace(0, 10 * MS, [], [], [], [o for o in ops if o[0] != m.SPAN])
    assert m.read(_reading(absent, 2)) is None
    assert m.read(_reading(None, 2)) is None and m.read(None) is None
    assert m.read(_reading(trace, 0)) is None


class _Event:
    def __init__(self, name, start, end, thread=1, cuda=False, kind="cpu_op"):
        self._name, self._a, self._b, self._t = name, start, end, thread
        self._cuda, self._kind = cuda, kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def start_thread_id(self):
        return self._t

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def activity_type(self):
        return self._kind


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_span_metric_reads_the_window_thread_only(metric, monkeypatch):
    """Through ``devtrace.to_trace``: another thread's spans and the
    device's copy of a range (``gpu_user_annotation``) are not read, and
    the range never counts as device work."""
    span = SPAN_METRICS[metric]
    evs = [_Event("window", 0, 10 * MS),
           _Event(span, 1 * MS, 3 * MS),
           _Event(span, 2 * MS, 9 * MS, thread=2),
           _Event(span, 1 * MS, 3 * MS, cuda=True, kind="gpu_user_annotation"),
           _Event("sm90_kernel", 3 * MS, 4 * MS, cuda=True, kind="kernel")]
    monkeypatch.setattr(devtrace, "_events", lambda prof: evs)
    trace = devtrace.to_trace(None)
    assert [n for n, _, _ in trace.device] == [n for n, _, _ in trace.kernels] == ["sm90_kernel"]
    assert _metric(metric).read(_reading(trace, 1)) == pytest.approx(2.0)


def test_a_traced_cpu_run_reports_the_feeds_wait():
    """The shrunk training cell, traced: ``prefetch_wait_ms.train`` is
    reported and lies within the benchmark's own ``feed`` span around the
    same ``next()``.  The shrunk serving cell runs its program eagerly on
    the CPU, so its span metrics read nothing and are left out."""
    code, res, _ = tiny_cells.run("joint_finetune_f32-b32", trace=1)
    assert code == 0 and res["correct"]
    got = res["metrics"]
    assert 0 < got["prefetch_wait_ms.train"]["value"] <= got["feed_wait_ms.train"]["value"]
    code, res, _ = tiny_cells.run("joint_int8-b64", trace=1)
    assert code == 0 and res["correct"]
    assert not {"stage_ms.serve", "launch_ms.serve"} & set(res["metrics"])
    assert "serve_mfu" in res["metrics"]


REPLAY_SPANS = ["captured.wait", "captured.stage", "captured.copy_in", "captured.launch",
                "captured.copy_out"]


@pytest.mark.cuda
def test_the_programs_spans_on_the_card():
    """A captured program and the device feed under the benchmark's traced
    window on the card: each replay's five spans once each, in order,
    inside the caller's ``replay``; each replay's kernels (the graph's
    nodes) start after its ``captured.launch`` begins, so the host's ranges
    and the device's records share one clock; one ``prefetch.wait`` inside
    each ``feed``; no program span among the device's records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tumblr_emotions_torch.data.pipeline import DevicePrefetchIterator
    from tumblr_emotions_torch.utils import compile_opts

    dev = torch.device("cuda", torch.cuda.current_device())
    w = torch.randn(512, 512, device=dev)

    def body(x, lengths):
        return ((x.float() @ w).relu() * lengths.float()[:, None],)

    program = compile_opts.capture(body, options={"cuda_graph": "true"}, device=dev)
    x = np.random.default_rng(0).integers(0, 255, (256, 512), dtype=np.uint8)
    lengths = np.arange(256, dtype=np.int32)
    program(x, lengths)          # the capture, before the window
    feed = DevicePrefetchIterator(iter([{"image": x}] * 8), device=dev)
    replays = 6
    with devtrace.traced(True) as box:
        for _ in range(replays):
            with devtrace.span("replay"):
                out = program(x, lengths)
            with devtrace.span("answers"):
                out[0].cpu()
            with devtrace.span("feed"):
                next(feed)
    feed.close()
    tr = box["trace"]
    nodes = sum(program.kernel_nodes()[0]["kernels"].values())
    assert nodes >= 3

    ours = [op for op in tr.host_ops if op[0].startswith(("captured.", "prefetch."))]
    calls = [s for s in tr.spans if s[0] == "replay"]
    feeds = [s for s in tr.spans if s[0] == "feed"]
    assert len(calls) == len(feeds) == replays
    launches = []
    for _, a, b in calls:
        inside = [op for op in ours if a <= op[1] and op[2] <= b]
        assert [n for n, _, _ in inside] == REPLAY_SPANS
        assert all(p[2] <= q[1] for p, q in zip(inside, inside[1:]))   # one after another
        launches.append(inside[3][1])
    for _, a, b in feeds:
        assert [n for n, s, e in ours if a <= s and e <= b] == ["prefetch.wait"]
    assert len(ours) == 6 * replays
    starts = sorted(s for _, s, _ in tr.kernels if tr.lo <= s <= tr.hi)
    assert starts and starts[0] >= launches[0]
    bounds = launches + [tr.hi]
    per_replay = [sum(lo <= s < hi for s in starts) for lo, hi in zip(bounds, bounds[1:])]
    assert per_replay == [nodes] * replays
    device_names = {n for n, _, _ in tr.device} | {n for n, _, _ in tr.kernels}
    assert not {n for n in device_names if n.startswith(("captured.", "prefetch."))}
