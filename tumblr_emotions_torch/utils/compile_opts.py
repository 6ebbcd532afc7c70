"""Run a program as one captured CUDA graph per input signature, with
options, their environment overrides and an autotuner: the served programs
and the trainer's steps.

The port's counterpart of ``tumblr_emotions_tpu/utils/compile_opts.py``.
The JAX package serves every program through ``tpu_jit``: one compiled XLA
program per input shape.  Here :func:`capture` plays that role: on the card
the first call of a signature runs the program eagerly as a warm-up, then
records it into one ``torch.cuda.CUDAGraph`` over static input buffers;
every later call copies its inputs in and replays the graph, one launch for
the whole program where eager PyTorch launches each kernel from Python.

The options are the port's own (the reference's are XLA flags):

- ``cuda_graph``: ``"true"`` (the card's default) captures the program,
  ``"false"`` launches it op by op from Python.

A graph replays the same kernels on the same operands as the eager program,
so every option leaves the answers bit-equal (the reference's standard for
its option ladder: bit-identical logits).  ``TET_TORCH_COMPILER_OPTIONS``
(a JSON object, e.g. the winner ``cli tune`` prints) overrides the default
for every served program; ``{}`` is the plain program, as in the reference.
The trainer's steps read ``TET_TORCH_TRAIN_COMPILER_OPTIONS`` instead
(:func:`train_default_options`, the counterpart of the reference's
``TET_TRAIN_COMPILER_OPTIONS``), with the same rules and options.  The JAX
package's ``TET_COMPILER_OPTIONS`` and ``TET_TRAIN_COMPILER_OPTIONS`` carry
XLA flags and are not read.

A train step updates state the program does not take as an input (the
parameters, the optimizer's moments, the BN statistics): its graph updates
those tensors in place at the addresses it was captured on, so a caller
that comes to hold the state elsewhere drops the graphs
(:meth:`Captured.clear`); its random draws come from ``generators``,
registered with every graph, so a replay draws from each generator's seed
and offset at the time of the replay.

A capture that fails raises: there is no quiet fallback to the eager
program, which would hide the graph's absence behind the same answers.

A graphed call's host work shows under a profiler as spans
(``utils/summaries.span``; nothing is recorded when no profiler runs), each
directly inside the caller's range, which ties the spans of one call
together: ``captured.wait`` (the lock, the stream's wait for the last
call's copies out, the host's wait for the last copy out of staging),
``captured.stage`` (host inputs into their pinned staging buffers, and the
copies to the card of a large input's row slices, each enqueued as soon as
its slice is staged), ``captured.copy_in`` (the other copies to the card and
their event), ``captured.launch`` (the graph's replay), ``captured.copy_out``
(the outputs' copies) and, on a signature's first call, ``captured.capture``
(warm-up, recording and instantiation).  None is inside the program: a span
there would be recorded once, at the capture, and never replayed.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tumblr_emotions_torch._device import resolve_device
from tumblr_emotions_torch.utils.summaries import span

log = logging.getLogger("tumblr_emotions_torch")

ENV_VAR = "TET_TORCH_COMPILER_OPTIONS"
TRAIN_ENV_VAR = "TET_TORCH_TRAIN_COMPILER_OPTIONS"
# Option name -> the values it takes.
OPTIONS: Dict[str, Sequence[str]] = {"cuda_graph": ("true", "false")}
DEFAULT_OPTIONS: Dict[str, str] = {"cuda_graph": "true"}
# The ladder ``autotune`` walks by default: the eager program, then the graph.
DEFAULT_AUTOTUNE_CANDIDATES: List[Dict[str, str]] = [
    {"cuda_graph": "false"}, {"cuda_graph": "true"}]


def default_options() -> Dict[str, str]:
    """The options :func:`capture` applies when none are passed:
    ``TET_TORCH_COMPILER_OPTIONS`` if set, else :data:`DEFAULT_OPTIONS`."""
    return _options_from_env(ENV_VAR, DEFAULT_OPTIONS)


def train_default_options() -> Dict[str, str]:
    """The options of the trainer's captured steps (``Trainer.compile``):
    ``TET_TORCH_TRAIN_COMPILER_OPTIONS`` if set, else :data:`DEFAULT_OPTIONS`
    (the serving variable does not reach them, as in the reference)."""
    return _options_from_env(TRAIN_ENV_VAR, DEFAULT_OPTIONS)


def _options_from_env(var: str, default: Dict[str, str]) -> Dict[str, str]:
    env = os.environ.get(var)
    if env is None:
        return dict(default)
    try:
        opts = json.loads(env)
    except ValueError as e:
        raise ValueError(f"{var} is not valid JSON: {env!r}") from e
    if not isinstance(opts, dict):
        raise ValueError(f"{var} must be a JSON object, got: {env!r}")
    return {str(k): str(v) for k, v in opts.items()}


def check_options(opts: Dict[str, str]) -> Dict[str, str]:
    """``opts`` with its values lower-cased; a ``ValueError`` for a name or
    a value the port does not know."""
    out = {}
    for name, value in opts.items():
        if name not in OPTIONS:
            raise ValueError(f"unknown option {name!r}; the port's options are "
                             f"{sorted(OPTIONS)}")
        value = str(value).lower()
        if value not in OPTIONS[name]:
            raise ValueError(f"option {name}={value!r}; expected one of {OPTIONS[name]}")
        out[name] = value
    return out


def _graph_kernels(raw_graph: int) -> Dict[str, int]:
    """The kernel nodes of a captured ``cudaGraph_t``, counted by the
    kernel's (mangled) function name, read through the driver API."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    class KernelParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ptr)] + [(f, ctypes.c_uint) for f in (
            "grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "smem")]
            + [("params", ptr), ("extra", ptr), ("kern", ptr), ("ctx", ptr)])

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed with CUresult {err}")

    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(ptr(raw_graph), None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    check(cu.cuGraphGetNodes(ptr(raw_graph), nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: Dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ptr(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:     # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = KernelParams(), ctypes.c_char_p()
        check(cu.cuGraphKernelNodeGetParams_v2(ptr(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        check(cu.cuFuncGetName(ctypes.byref(name), ptr(params.func)), "cuFuncGetName")
        counts[name.value.decode()] = counts.get(name.value.decode(), 0) + 1
    return counts


def _is_array(a) -> bool:
    return isinstance(a, (torch.Tensor, np.ndarray))


def _torch_dtype(a) -> torch.dtype:
    return a.dtype if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.empty(0, a.dtype)).dtype


def _signature(args) -> tuple:
    """Each input's shape, dtype and device (``host`` for numpy), or None."""
    sig = []
    for a in args:
        if a is None:
            sig.append(None)
        elif _is_array(a):
            where = str(a.device) if isinstance(a, torch.Tensor) else "host"
            sig.append((tuple(a.shape), str(_torch_dtype(a)), where))
        else:
            raise TypeError(f"captured programs take tensors, arrays or None, got "
                            f"{type(a).__name__}")
    return tuple(sig)


def _to_device(a, dev: torch.device):
    return None if a is None else torch.as_tensor(a).to(dev)


# A host input is staged in row slices of at least this many bytes, each
# slice's copy to the card enqueued as soon as the slice is in pinned memory,
# so that the card copies one slice while the host stages the next; a smaller
# input is staged in one piece.  On an H100's host (8 cores, 8 intra-op
# threads) a slice costs the host ~0.1 ms more than one piece, and hides the
# copy to the card of the slice before it (~0.45 ms for 23 MB): a served
# batch of 64 images of 347 px (23.1 MB) reached the card 0.15 ms sooner in
# two slices than in one, in three or five no sooner than in two, and batches
# of 5.8 and 11.6 MB no sooner in two than in one.
_SLICE_BYTES = 8 << 20


def _row_slices(a) -> list:
    """The pieces a host input is staged in: ``[...]`` (the whole input), or
    contiguous slices along axis 0 of at least :data:`_SLICE_BYTES` each."""
    nbytes = a.nbytes if isinstance(a, np.ndarray) else a.numel() * a.element_size()
    n = min(a.shape[0] if len(a.shape) else 1, nbytes // _SLICE_BYTES)
    if n < 2:
        return [...]
    rows = a.shape[0]
    return [slice(rows * k // n, rows * (k + 1) // n) for k in range(n)]


def _host_source(a):
    """A host input as a CPU tensor, which ATen copies across its intra-op
    threads with the interpreter lock released (a numpy copy runs on one
    thread, from as many Python threads as it is given); the numpy array
    itself where torch cannot view it: read-only (torch would warn that it
    cannot protect it), negative strides, strides of part of an element."""
    if isinstance(a, torch.Tensor) or not a.flags.writeable:
        return a
    try:
        return torch.from_numpy(a)
    except ValueError:
        return a


def _stage_rows(stage: torch.Tensor, src, rows) -> None:
    """``src[rows]`` into the pinned ``stage[rows]``."""
    if isinstance(src, np.ndarray):
        stage.numpy()[rows] = src[rows]
    else:
        stage[rows].copy_(src[rows])


def _map(out, fn):
    """``fn`` over every tensor of a (nested) tuple, list or dict."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_map(o, fn) for o in out)
    if isinstance(out, dict):
        return {k: _map(v, fn) for k, v in out.items()}
    return out


class _Graph:
    """One captured signature: the graph, its static inputs and outputs and
    the pinned staging buffers of host inputs."""

    def __init__(self, graph, static_in, static_out, staging):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.staging = staging
        self.staged = None   # event: the last copy out of the staging buffers
        self.replays = 0


class Captured:
    """``fn`` served through CUDA graphs on ``device`` (see :func:`capture`)."""

    def __init__(self, fn: Callable, options: Dict[str, str], device: torch.device,
                 inference: bool = True, generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.options = options
        self.device = device
        self.inference = inference
        self.generators = tuple(generators)
        self.graphed = device.type == "cuda" and options.get("cuda_graph") == "true"
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._capture_stream = None   # see _capture
        self._lock = threading.Lock()
        self._done = None     # event: the last call's copies out
        self.replays = 0      # graph launches
        self.split_stages = 0   # calls whose host inputs were staged in row slices

    def _cache_size(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph (the next call of each signature captures again)."""
        with self._lock:
            self._graphs.clear()

    def _mode(self):
        return torch.inference_mode() if self.inference else contextlib.nullcontext()

    def kernel_nodes(self) -> List[Dict[str, int]]:
        """Per captured signature, in capture order: its graph's kernel
        nodes by kernel function name (what each replay launches) and its
        replays, as ``{"kernels": {name: n}, "replays": r}``."""
        return [{"kernels": _graph_kernels(g.graph.raw_cuda_graph()), "replays": g.replays}
                for g in self._graphs.values()]

    def __call__(self, *args, key: Any = ()):
        if not self.graphed:
            with self._mode():
                return self.fn(*[_to_device(a, self.device) for a in args])
        key = (key, _signature(args))
        with contextlib.ExitStack() as held:
            with span("captured.wait"):
                held.enter_context(self._lock)
                stream = torch.cuda.current_stream(self.device)
                if self._done is not None:
                    stream.wait_event(self._done)
                g = self._graphs.get(key)
                if g is not None and g.staged is not None:
                    g.staged.synchronize()   # the last copy out of staging is done
            held.enter_context(self._mode())
            if g is None:
                with span("captured.capture"):
                    out = self._capture(key, args)
            else:
                self._copy_in(g, args)
                with span("captured.launch"):
                    g.graph.replay()
                g.replays += 1
                self.replays += 1
                with span("captured.copy_out"):
                    out = _map(g.static_out, torch.clone)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            return out

    def _copy_in(self, g: _Graph, args) -> None:
        """Each host input into its pinned staging buffer (``captured.stage``),
        then every input into the graph's static buffers, from staging
        without blocking the host (``captured.copy_in``).  An input of
        several row slices (:func:`_row_slices`) sends each slice to the card
        as soon as it is staged, inside ``captured.stage``."""
        sent = set()    # inputs whose slices are on their way to the card
        with span("captured.stage"):
            for i, (a, static, stage) in enumerate(zip(args, g.static_in, g.staging)):
                if stage is None:       # None, or an input on the card
                    continue
                src, pieces = _host_source(a), _row_slices(a)
                if len(pieces) == 1:
                    _stage_rows(stage, src, ...)
                    continue
                for rows in pieces:
                    _stage_rows(stage, src, rows)
                    static[rows].copy_(stage[rows], non_blocking=True)
                sent.add(i)
        with span("captured.copy_in"):
            host = False
            for i, (a, static, stage) in enumerate(zip(args, g.static_in, g.staging)):
                if a is None:
                    continue
                if stage is None:
                    static.copy_(a)
                else:
                    if i not in sent:
                        static.copy_(stage, non_blocking=True)
                    host = True
            if host:
                g.staged = torch.cuda.Event()
                g.staged.record(torch.cuda.current_stream(self.device))
        self.split_stages += bool(sent)

    def _stream_for_capture(self):
        """None (``torch.cuda.graph``'s own capture stream) where that stream
        is on this program's device, else a stream of the program's own
        there: torch's is made once per process, on the device current at
        the first capture, and a capture on another device cannot use it.
        (Every capture of one card's programs on torch's stream, as before
        several devices were served: a stream per program tripped the
        caching allocator's pool assert when the trainer captured anew.)"""
        dev = self.device
        default = getattr(torch.cuda.graph, "default_capture_stream", None)
        if (default.device == dev if default is not None else
                dev.type != "cuda" or dev.index == torch.cuda.current_device()):
            return None
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        return self._capture_stream

    def _capture(self, key: tuple, args):
        """Warm up on a side stream (every lazy per-geometry plan, constant
        and tensor map is made there, outside the capture), capture the
        graph, and answer the first call from the warm-up."""
        dev = self.device
        static_in, staging = [], []
        for a in args:
            if a is None:
                static_in.append(None)
                staging.append(None)
                continue
            static_in.append(torch.empty(tuple(a.shape), dtype=_torch_dtype(a), device=dev))
            on_host = not (isinstance(a, torch.Tensor) and a.device.type == "cuda")
            staging.append(torch.empty(tuple(a.shape), dtype=_torch_dtype(a),
                                       pin_memory=True) if on_host else None)
        g = _Graph(None, static_in, None, staging)
        self._copy_in(g, args)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = self.fn(*static_in)
        main.wait_stream(side)
        out = _map(warm, torch.clone)
        # the graph itself is kept beside its executable form, so that
        # ``kernel_nodes`` can read what it launches
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream_for_capture(),
                              capture_error_mode="thread_local"):
            g.static_out = self.fn(*static_in)
        graph.instantiate()
        g.graph = graph
        self._graphs[key] = g
        return out


def capture(fn: Callable, *, options: Optional[Dict[str, str]] = None,
            device="cuda", inference: bool = True,
            generators: Sequence[torch.Generator] = ()) -> Captured:
    """``fn`` (inputs: tensors, numpy arrays or None; outputs: tensors in
    tuples, lists or dicts) as one CUDA graph per input signature on
    ``device``: the counterpart of the reference's ``tpu_jit``.

    The signature is each input's shape, dtype and device, and which inputs
    are None.  The first call of a signature runs ``fn`` eagerly on a side
    stream (so every lazy plan and constant is built outside the capture)
    and answers from it, then captures the graph into the runner's memory
    pool; every later call copies its inputs into the static buffers (host
    inputs through a pinned staging buffer, copied there across ATen's
    intra-op threads, a large one in row slices that go on to the card while
    the next is staged: ``.split_stages`` counts such calls), replays the
    graph and returns copies of its outputs, so a later replay cannot
    overwrite an answer a caller still holds.  Calls are serialised by a
    lock.  The kernel wrappers count the warm-up's launches, not the
    capture's (it records them) nor a replay's; ``.kernel_nodes()`` reads
    each graph's kernels and replays.

    ``key`` (a keyword of the call, hashable) adds to the signature what
    else the graph depends on (a train step's batch names).  ``inference``: run ``fn`` under
    ``torch.inference_mode`` (the served programs); False for a program
    that runs autograd or whose outputs feed tensors outside it (the
    trainer's steps).  ``generators``: the generators ``fn`` draws from,
    registered with each graph, so that a replay draws from each one's seed
    and offset at the time of the replay (reseed one before a call to
    repeat the eager call's draws), not the capture's.

    ``options`` default to :func:`default_options`; an unknown option is a
    ``ValueError``.  On the CPU (which the caller asks for), or with
    ``cuda_graph`` off, ``fn`` runs eagerly on the inputs moved to
    ``device``.  ``._cache_size()`` counts the graphs.
    """
    opts = check_options(default_options() if options is None else options)
    return Captured(fn, opts, resolve_device(device), inference, generators)


def _finish(device: torch.device) -> None:
    """Wait for the card's work (a candidate's calls)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _arg_device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device("cuda")


def autotune(fn: Callable, example_args: Sequence[Any], *,
             candidates: Optional[Sequence[Dict[str, str]]] = None,
             steps: int = 8, repeats: int = 3,
             cache_path: Optional[str] = None,
             key: Optional[str] = None,
             on_result: Optional[Callable[[Dict[str, str], float], None]] = None,
             device=None, **capture_kwargs) -> Dict[str, str]:
    """Time each candidate option set for ``fn`` on ``example_args`` and
    return the fastest, with the reference's semantics.

    Walks ``candidates`` (default :data:`DEFAULT_AUTOTUNE_CANDIDATES`): each
    is served through :func:`capture` (``device``: the card, or the first
    tensor argument's device), called once (warm-up and capture), then timed
    over ``repeats`` windows of ``steps`` calls, each window ended by a
    synchronise; its time is the windows' median.  ``capture_kwargs`` go
    to :func:`capture` (a train step's: ``inference=False`` and its
    ``generators``).  A candidate with an
    unknown option, or whose first call raises, is skipped and logged.
    ``on_result(options, seconds)`` gets each timed candidate.

    With ``cache_path`` the winner is kept in a JSON file under ``key``
    (default: the function's name and its arguments' signature; a given
    candidate list adds its digest), written atomically, so a program pays
    the sweep once per shape.  ``RuntimeError`` if no candidate runs.
    """
    cands = list(DEFAULT_AUTOTUNE_CANDIDATES if candidates is None else candidates)
    dev = resolve_device(device) if device is not None else _arg_device(example_args)
    if key is None:
        sig = ",".join(f"{getattr(a, 'dtype', type(a).__name__)}{list(getattr(a, 'shape', []))}"
                       for a in example_args)
        key = f"{getattr(fn, '__name__', 'fn')}({sig})"
    if candidates is not None:
        # A custom list must not be served a winner cached from another sweep.
        digest = hashlib.md5(json.dumps(cands, sort_keys=True).encode()).hexdigest()[:10]
        key = f"{key}#cands={digest}"

    cache: Dict[str, Dict[str, str]] = {}
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
        if key in cache:
            return dict(cache[key])

    best: Optional[Dict[str, str]] = None
    best_t = float("inf")
    for opts in cands:
        try:
            program = capture(fn, options=opts, device=dev, **capture_kwargs)
            program(*example_args)
            _finish(dev)
        except Exception as e:  # noqa: BLE001 -- a candidate that cannot run
            log.warning("autotune: skipped candidate %s (%s: %s)", json.dumps(opts),
                        type(e).__name__, e)
            continue
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(steps):
                program(*example_args)
            _finish(dev)
            times.append(time.perf_counter() - t0)
        t = sorted(times)[len(times) // 2]
        if on_result is not None:
            on_result(dict(opts), t)
        if t < best_t:
            best, best_t = dict(opts), t
        del program
    if best is None:
        raise RuntimeError("autotune: every candidate failed to run")

    if cache_path:
        cache[key] = best
        tmp = f"{cache_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, cache_path)
    return best
