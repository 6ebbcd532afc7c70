"""``utils/compile_opts.py`` (the port's ``tpu_jit`` role: one captured CUDA
graph per input signature, its options and ``autotune``) on the CPU, as
``tests/test_tooling.py`` holds the JAX package's ``compile_opts``.

On the CPU ``capture`` runs the program eagerly, so these tests hold the
options, their environment override, the signature cache's bookkeeping and
``autotune``'s sweep, cache and failures (timed by a fake clock); the
graphs themselves are held on the card (``tests/test_torch_cuda.py``).
"""

import json

import numpy as np
import pytest
import torch

from tumblr_emotions_torch.utils import compile_opts


def test_options_parse_and_unknown_names_are_refused():
    assert compile_opts.check_options({"cuda_graph": "TRUE"}) == {"cuda_graph": "true"}
    assert compile_opts.check_options({}) == {}
    with pytest.raises(ValueError, match="unknown option 'xla_tpu_scoped_vmem_limit_kib'"):
        compile_opts.capture(lambda x: x, options={"xla_tpu_scoped_vmem_limit_kib": "65536"},
                             device="cpu")
    with pytest.raises(ValueError, match="expected one of"):
        compile_opts.capture(lambda x: x, options={"cuda_graph": "maybe"}, device="cpu")
    f = compile_opts.capture(lambda x: x + 1, options={"cuda_graph": "false"}, device="cpu")
    assert f.options == {"cuda_graph": "false"} and not f.graphed


def test_environment_override(monkeypatch):
    """TET_TORCH_COMPILER_OPTIONS (the ``cli tune`` hint) overrides the
    default with the reference's JSON rules; the JAX package's
    TET_COMPILER_OPTIONS (XLA flags) is not read."""
    monkeypatch.delenv(compile_opts.ENV_VAR, raising=False)
    monkeypatch.setenv("TET_COMPILER_OPTIONS", '{"xla_tpu_scoped_vmem_limit_kib": "65536"}')
    assert compile_opts.default_options() == {"cuda_graph": "true"}
    assert compile_opts.capture(lambda x: x, device="cpu").options == {"cuda_graph": "true"}

    monkeypatch.setenv(compile_opts.ENV_VAR, '{"cuda_graph": false}')
    assert compile_opts.default_options() == {"cuda_graph": "False"}   # values coerced to str
    assert compile_opts.capture(lambda x: x, device="cpu").options == {"cuda_graph": "false"}
    monkeypatch.setenv(compile_opts.ENV_VAR, "{}")
    assert compile_opts.capture(lambda x: x, device="cpu").options == {}
    monkeypatch.setenv(compile_opts.ENV_VAR, '{"bogus": "1"}')
    with pytest.raises(ValueError, match="unknown option 'bogus'"):
        compile_opts.capture(lambda x: x, device="cpu")
    monkeypatch.setenv(compile_opts.ENV_VAR, "not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        compile_opts.default_options()
    monkeypatch.setenv(compile_opts.ENV_VAR, '["list"]')
    with pytest.raises(ValueError, match="JSON object"):
        compile_opts.default_options()


def test_capture_runs_eagerly_on_the_cpu():
    seen = []

    def f(x, y, z):
        seen.append((x.device, None if y is None else y.dtype, z))
        return x * 2, {"y": None if y is None else y + 1}

    g = compile_opts.capture(f, device="cpu")
    a, b = g(np.arange(4, dtype=np.float32), torch.ones(2, dtype=torch.int32), None)
    np.testing.assert_array_equal(a.numpy(), [0, 2, 4, 6])
    assert b["y"].tolist() == [2, 2]
    assert seen == [(torch.device("cpu"), torch.int32, None)]
    assert g._cache_size() == 0          # no graph on the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        if not torch.cuda.is_available():
            compile_opts.capture(f)      # the card by default


def test_signature_keys_shape_dtype_device_and_none():
    sig = compile_opts._signature
    a = sig([np.zeros((2, 3), np.uint8), None])
    assert a == (((2, 3), "torch.uint8", "host"), None)
    assert sig([torch.zeros(2, 3, dtype=torch.uint8), None]) == \
        (((2, 3), "torch.uint8", "cpu"), None)
    assert sig([np.zeros((2, 3), np.uint8), np.zeros(2, np.int32)]) != a
    assert sig([np.zeros((4, 3), np.uint8), None]) != a
    with pytest.raises(TypeError, match="tensors, arrays or None"):
        sig([3])


class FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: ``replay`` runs the recorded
    function on the static inputs; ``raw_cuda_graph`` is the graph itself."""

    def __init__(self, keep_graph=False):
        assert keep_graph      # ``kernel_nodes`` reads the kept graph
        self.fn = None
        self.instantiated = False

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated
        self.fn()

    def raw_cuda_graph(self):
        return self


def _fake_card(monkeypatch):
    """The graph bookkeeping of ``Captured`` on the CPU: streams, events,
    pinned buffers and capture are replaced by host stand-ins."""
    import contextlib

    class Ev:
        def record(self, *a):
            pass

        def synchronize(self):
            pass

    class Stream:
        def wait_stream(self, other):
            pass

        def wait_event(self, ev):
            pass

    recording = {}

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode=None):
        recording["g"] = g
        yield

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Ev)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: real_empty(*a, **k))
    return recording


def test_captured_bookkeeping_per_signature(monkeypatch):
    """One graph per signature; the first call answers from the warm-up,
    later calls from the replay over the static inputs; outputs are copies;
    ``kernel_nodes`` reads each graph's kernels and counts its replays."""
    rec = _fake_card(monkeypatch)
    monkeypatch.setattr(compile_opts, "_graph_kernels",
                        lambda raw: {"conv": 2, "pool": raw.n_pools})
    calls = []

    def body(x, y):
        calls.append(x.data_ptr())
        return (x * 2 if y is None else x + y,)

    cap = compile_opts.Captured(body, {"cuda_graph": "true"}, torch.device("cpu"))
    cap.graphed = True
    orig_capture = cap._capture

    def capture(key, args):
        out = orig_capture(key, args)
        g = cap._graphs[key]
        g.graph.fn = lambda: g.static_out[0].copy_(body(*g.static_in)[0])
        g.graph.n_pools = len(cap._graphs)
        return out

    cap._capture = capture
    x1 = np.arange(4, dtype=np.float32)
    out1 = cap(x1, None)
    assert cap._cache_size() == 1 and rec["g"] is cap._graphs[next(iter(cap._graphs))].graph
    assert len(calls) == 2     # the warm-up and the capture
    np.testing.assert_array_equal(out1[0].numpy(), x1 * 2)
    out2 = cap(np.full(4, 5, np.float32), None)   # a replay, same signature
    assert cap._cache_size() == 1 and cap.replays == 1
    np.testing.assert_array_equal(out2[0].numpy(), [10] * 4)
    np.testing.assert_array_equal(out1[0].numpy(), x1 * 2)   # the first answer kept
    assert out2[0].data_ptr() != cap._graphs[next(iter(cap._graphs))].static_out[0].data_ptr()
    cap(np.ones(4, np.float32), np.ones(4, np.float32))      # another signature
    cap(np.ones(4, np.float32), np.ones(4, np.float32))
    cap(np.ones(3, np.float32), None)
    assert cap._cache_size() == 3 and cap.replays == 2
    assert cap.kernel_nodes() == [{"kernels": {"conv": 2, "pool": n}, "replays": r}
                                  for n, r in ((1, 1), (2, 1), (3, 0))]


def test_captured_calls_show_as_spans_in_the_callers_range(monkeypatch):
    """Under a profiler: a signature's first call is ``captured.wait`` then
    ``captured.capture`` (its copies in nested there), each later call
    ``captured.wait``, ``stage``, ``copy_in``, ``launch``, ``copy_out``, each
    once and directly inside the caller's range, which ties one call's
    spans together; the lock is free again after each call."""
    _fake_card(monkeypatch)

    def body(x, y):
        return (x + y,)

    cap = compile_opts.Captured(body, {"cuda_graph": "true"}, torch.device("cpu"))
    cap.graphed = True
    orig_capture = cap._capture

    def capture(key, args):
        out = orig_capture(key, args)
        g = cap._graphs[key]
        g.graph.fn = lambda: g.static_out[0].copy_(body(*g.static_in)[0])
        return out

    cap._capture = capture
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(3):
            with torch.profiler.record_function("caller"):
                out = cap(np.full(4, k, np.float32), torch.ones(4))
    assert out[0].tolist() == [3.0] * 4
    ours = sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name() == "caller" or e.name().startswith("captured.")),
                  key=lambda e: (e.start_ns(), -e.end_ns()))

    def parent(e):
        outer = [o for o in ours if o is not e and o.start_ns() <= e.start_ns()
                 and e.end_ns() <= o.end_ns()]
        return min(outer, key=lambda o: o.end_ns() - o.start_ns()).name()

    got = [(e.name(), parent(e)) for e in ours if e.name() != "caller"]
    replay = [(f"captured.{n}", "caller") for n in ("wait", "stage", "copy_in", "launch",
                                                     "copy_out")]
    assert got == [("captured.wait", "caller"), ("captured.capture", "caller"),
                   ("captured.stage", "captured.capture"),
                   ("captured.copy_in", "captured.capture")] + replay + replay
    assert not cap._lock.locked()


def test_a_failed_wait_frees_the_lock(monkeypatch):
    """A wait that raises inside ``captured.wait`` (here the host's wait for
    the last copy out of staging) leaves the lock free, and the next call
    replays as before."""
    _fake_card(monkeypatch)

    def body(x):
        return (x * 2,)

    cap = compile_opts.Captured(body, {"cuda_graph": "true"}, torch.device("cpu"))
    cap.graphed = True
    orig_capture = cap._capture

    def capture(key, args):
        out = orig_capture(key, args)
        g = cap._graphs[key]
        g.graph.fn = lambda: g.static_out[0].copy_(body(*g.static_in)[0])
        return out

    cap._capture = capture
    cap(np.ones(4, np.float32))
    cap(np.ones(4, np.float32))
    (g,) = cap._graphs.values()

    def lost():
        raise RuntimeError("device lost")

    g.staged.synchronize = lost
    with pytest.raises(RuntimeError, match="device lost"):
        cap(np.ones(4, np.float32))
    assert not cap._lock.locked() and cap.replays == 1
    g.staged.synchronize = lambda: None
    assert cap(np.full(4, 3, np.float32))[0].tolist() == [6.0] * 4
    assert not cap._lock.locked() and cap.replays == 2


def _summing_card(monkeypatch):
    """A graphed ``Captured`` on the fake card whose body sums each row."""
    _fake_card(monkeypatch)

    def body(x):
        return (x.reshape(len(x), -1).sum(1, dtype=torch.int64),)

    cap = compile_opts.Captured(body, {"cuda_graph": "true"}, torch.device("cpu"))
    cap.graphed = True
    orig_capture = cap._capture

    def capture(key, args):
        out = orig_capture(key, args)
        g = cap._graphs[key]
        g.graph.fn = lambda: g.static_out[0].copy_(body(*g.static_in)[0])
        return out

    cap._capture = capture
    return cap, body


def _batch(rows, row_bytes, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (rows, row_bytes), np.uint8)


def _read_only(a):
    a.flags.writeable = False
    return a


# ~3 slices' worth in 7 rows: the slices cannot all hold the same rows
_ROW = compile_opts._SLICE_BYTES * 3 // 7 + 1


@pytest.mark.parametrize("make,sliced", [
    (lambda: _batch(7, _ROW), True),
    (lambda: _batch(7, compile_opts._SLICE_BYTES // 7), False),
    (lambda: _batch(1, 3 * compile_opts._SLICE_BYTES), False),
    (lambda: _batch(7, 2 * _ROW)[:, ::2], True),
    (lambda: _batch(7, _ROW)[::-1], True),
    (lambda: _read_only(_batch(7, _ROW)), True),
    (lambda: torch.from_numpy(_batch(7, _ROW)), True),
], ids=["sliced", "below-the-slice-size", "one-row", "strided", "negative-stride",
        "read-only", "torch-cpu"])
def test_host_inputs_are_staged_whole_or_in_row_slices(monkeypatch, make, sliced):
    """A host input reaches the graph's static buffer byte for byte, in row
    slices when it holds several slices' bytes and rows, else in one piece;
    ``split_stages`` counts the sliced calls (the capture's and the
    replay's) and no others; nothing warns, read-only input included."""
    import warnings

    cap, body = _summing_card(monkeypatch)
    a = make()
    pieces = compile_opts._row_slices(a)
    assert (len(pieces) > 1) == sliced
    if sliced:
        assert len({p.stop - p.start for p in pieces}) == 2   # uneven slices
        assert [p.start for p in pieces[1:]] == [p.stop for p in pieces[:-1]]
        assert pieces[0].start == 0 and pieces[-1].stop == len(a)
    first = 255 - np.asarray(a)       # the capture's call: other bytes
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cap(torch.from_numpy(first) if isinstance(a, torch.Tensor) else first)
        got = cap(a)
    want = torch.from_numpy(np.asarray(a).copy())
    (g,) = cap._graphs.values()
    assert torch.equal(g.static_in[0], want)
    assert torch.equal(got[0], body(want)[0])
    assert (cap.replays, cap.split_stages) == (1, 2 if sliced else 0)


def test_a_failed_staging_frees_the_lock(monkeypatch):
    """A copy that raises part-way through a sliced staging leaves the lock
    free and counts no sliced call; the next call stages and answers whole."""
    cap, body = _summing_card(monkeypatch)
    a = _batch(7, _ROW)
    cap(a)
    real = compile_opts._stage_rows
    n = {"copies": 0}

    def fails_second(stage, src, rows):
        n["copies"] += 1
        if n["copies"] == 2:
            raise RuntimeError("copy failed")
        real(stage, src, rows)

    monkeypatch.setattr(compile_opts, "_stage_rows", fails_second)
    with pytest.raises(RuntimeError, match="copy failed"):
        cap(255 - a)
    assert not cap._lock.locked() and (cap.replays, cap.split_stages) == (0, 1)
    monkeypatch.setattr(compile_opts, "_stage_rows", real)
    b = _batch(7, _ROW, seed=1)
    assert torch.equal(cap(b)[0], body(torch.from_numpy(b))[0])
    assert not cap._lock.locked() and (cap.replays, cap.split_stages) == (1, 2)


def test_autotune_skips_unknown_candidates_and_caches(tmp_path, monkeypatch, caplog):
    """Mirrors the reference's autotune tests: a candidate the port does not
    know is skipped and logged; the winner round-trips through the JSON
    cache without re-measuring; a custom candidate list gets its own key."""
    clock = iter(np.arange(0.0, 1000.0, 0.5))
    monkeypatch.setattr(compile_opts.time, "perf_counter", lambda: float(next(clock)))
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        return x * 2 + 1

    cache = str(tmp_path / "tune.json")
    args = (torch.arange(8.0),)
    cands = [{"cuda_graph": "false"}, {"xla_surely_not_a_real_flag": "1"}]
    seen = []
    with caplog.at_level("WARNING", "tumblr_emotions_torch"):
        best = compile_opts.autotune(f, args, steps=2, repeats=3, candidates=cands,
                                     cache_path=cache, on_result=lambda o, t: seen.append((o, t)))
    assert best == {"cuda_graph": "false"}
    assert any("skipped candidate" in r.message for r in caplog.records)
    # one timed candidate: warm-up + 3 windows of 2 calls; the fake clock
    # advances 0.5 s per reading, so each window is 0.5 s
    assert calls["n"] == 1 + 3 * 2 and seen == [({"cuda_graph": "false"}, 0.5)]
    stored = json.load(open(cache))
    (key,), = [list(stored)]
    assert key.startswith("f(torch.float32[8])#cands=")
    n = calls["n"]
    assert compile_opts.autotune(f, args, steps=2, repeats=3, candidates=cands,
                                 cache_path=cache) == best
    assert calls["n"] == n                # served from the cache
    # the default ladder under the same program key is another entry
    best2 = compile_opts.autotune(f, args, steps=1, repeats=1, cache_path=cache)
    assert best2 in compile_opts.DEFAULT_AUTOTUNE_CANDIDATES and calls["n"] > n
    assert len(json.load(open(cache))) == 2


def test_autotune_picks_the_median_fastest(monkeypatch):
    """Each candidate's time is the median of its windows."""
    times = {"false": [3.0, 1.0, 2.0], "true": [0.5, 9.0, 1.5]}   # medians 2.0, 1.5
    state = {"opt": None, "t": 0.0, "window": 0}

    def fake_capture(fn, options=None, device=None):
        state["opt"], state["window"] = options["cuda_graph"], 0
        return lambda *a: fn(*a)

    def perf_counter():
        return state["t"]

    def f(x):
        return x

    real_finish = compile_opts._finish

    def finish(dev):
        # the warm-up's finish opens nothing; each window's adds its time
        if state.get("timing"):
            state["t"] += times[state["opt"]][state["window"]]
            state["window"] += 1
        state["timing"] = True
        real_finish(dev)

    monkeypatch.setattr(compile_opts, "capture", fake_capture)
    monkeypatch.setattr(compile_opts, "_finish", finish)
    monkeypatch.setattr(compile_opts.time, "perf_counter", perf_counter)
    got = []

    def on_result(o, t):
        got.append((o["cuda_graph"], t))
        state["timing"] = False

    best = compile_opts.autotune(f, (torch.zeros(2),), steps=1, repeats=3,
                                 on_result=on_result)
    assert got == [("false", 2.0), ("true", 1.5)] and best == {"cuda_graph": "true"}


def test_autotune_raises_when_nothing_runs():
    with pytest.raises(RuntimeError, match="every candidate failed"):
        compile_opts.autotune(lambda x: x, (torch.zeros(2),), steps=1, repeats=1,
                              candidates=[{"xla_surely_not_a_real_flag": "1"}])

    def boom(x):
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="every candidate failed"):
        compile_opts.autotune(boom, (torch.zeros(2),), steps=1, repeats=1)


def test_captured_calls_from_many_threads_get_their_own_answers(monkeypatch):
    """The batcher's worker and other callers may call one runner at once:
    the lock keeps a caller's copy-in, replay and copy-out together, so
    every answer is its own input's (a lost race would hand one caller
    another's static outputs)."""
    import sys
    import threading

    _fake_card(monkeypatch)

    def body(x):
        return (x * 3 + 1,)

    cap = compile_opts.Captured(body, {"cuda_graph": "true"}, torch.device("cpu"))
    cap.graphed = True
    orig_capture = cap._capture

    def capture(key, args):
        out = orig_capture(key, args)
        g = cap._graphs[key]
        g.graph.fn = lambda: g.static_out[0].copy_(body(*g.static_in)[0])
        return out

    cap._capture = capture
    errors = []

    def worker(k):
        x = np.full(64, k, np.float32)
        for _ in range(30):
            got = cap(x)[0]
            if not torch.equal(got, torch.full((64,), 3.0 * k + 1)):
                errors.append((k, got[:3].tolist()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert cap._cache_size() == 1 and cap.replays == 16 * 30 - 1
