"""Scalar summaries for TensorBoard and a profiler hook, without TF or clu.

Port of ``tumblr_emotions_tpu/utils/summaries.py``.  The reference writes
its scalars through ``clu.metric_writers`` (TF's event writer) and traces a
window of steps with ``jax.profiler``.  Here:

* :class:`SummaryWriter` writes the event file itself: TFRecord framing
  (``data/records.TFRecordWriter``, masked crc32c) around hand-encoded
  ``Event`` protos, a first event with ``file_version: "brain.Event:2"``,
  then one event per scalar holding one ``Summary.Value``: the tag, a
  scalar ``DT_FLOAT`` tensor and the ``scalars`` plugin's metadata, as
  ``tf.summary.scalar`` writes it, so TensorBoard reads back the tags,
  steps and values the reference's writer gives for the same calls;
* :class:`ProfilerHook` traces steps ``[start, start + num)`` with
  ``torch.profiler`` (the card's kernels included) and writes a Chrome
  trace under ``logdir``; each traced step is a ``train_step <n>`` range;
* :func:`span` marks a stretch of the program's host work as a profiler
  range, and costs a check of a flag when no profiler runs.  The program's
  spans: ``captured.wait``, ``captured.stage``, ``captured.copy_in``,
  ``captured.launch``, ``captured.copy_out`` and ``captured.capture``
  (``utils/compile_opts.Captured``), ``trainer.bind`` (the trainer's
  captured steps), ``prefetch.wait`` (``data/pipeline.
  DevicePrefetchIterator``) and ``dp.allreduce`` (each all-reduce issued
  from Python, ``parallel/distributed.all_reduce_``).  Being profiler
  ranges, they share the clock of the card's trace, nest, and show in
  ``fit``'s Chrome trace and in any
  other profiled stretch.  The benchmark reads ``captured.stage``,
  ``captured.launch`` and ``prefetch.wait``; its own spans
  (``benchmark/devtrace.SPANS``) have other names.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

import torch

from tumblr_emotions_torch.data.records import _len_delimited as _field
from tumblr_emotions_torch.data.records import _read_varint, _varint

log = logging.getLogger("tumblr_emotions_torch")

_DT_FLOAT = 1
_DATA_CLASS_SCALAR = 1

_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range ``name`` over the ``with`` block it opens.  With no
    profiler running it is one shared ``contextlib.nullcontext()``: nothing
    is allocated or formatted.  The spans of one step or batch are tied
    together by the caller's range they nest in.

    The range is an operator's record (``_RecordFunctionFast``), not
    ``torch.profiler.record_function``'s user annotation: the profiler
    mirrors a user annotation onto the card as a record spanning the
    kernels launched inside it, which a device trace then counts as device
    work (a ``captured.launch`` annotation read as 1.4 s of "kernels" in a
    3-s window on an H100)."""
    if not _profiling():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def _event(step: int, wall_time: float, body: bytes) -> bytes:
    """``Event``: wall_time (1, double), step (2, int64), then ``body``."""
    return b"\x09" + struct.pack("<d", wall_time) + b"\x10" + _varint(step) + body


def scalar_event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    """An ``Event`` holding ``summary { value { tag, tensor, metadata } }``."""
    tensor = (b"\x08" + _varint(_DT_FLOAT) + _field(2, b"")
              + _field(4, struct.pack("<f", value)))
    metadata = _field(1, _field(1, b"scalars")) + b"\x20" + _varint(_DATA_CLASS_SCALAR)
    summary_value = _field(1, tag.encode()) + _field(8, tensor) + _field(9, metadata)
    return _event(step, wall_time, _field(5, _field(1, summary_value)))


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: ints for
    varints, bytes for the rest."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def read_scalars(path: str) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value)]} of the scalar summaries in the event file at
    ``path`` (tensor or ``simple_value`` scalars), in file order."""
    from tumblr_emotions_torch.data.records import read_tfrecords

    out: Dict[str, List[Tuple[int, float]]] = {}
    for record in read_tfrecords(path):
        ev = {n: v for n, _, v in _fields(record)}
        for n, _, value in _fields(ev.get(5, b"")):
            if n != 1:
                continue
            v = {k: x for k, _, x in _fields(value)}
            if 8 in v:
                scalar = struct.unpack("<f", dict((k, x) for k, _, x in _fields(v[8]))[4])[0]
            else:
                scalar = struct.unpack("<f", v[2])[0]
            out.setdefault(v[1].decode(), []).append((int(ev.get(2, 0)), scalar))
    return out


class SummaryWriter:
    """``write_scalars(step, {tag: value})`` into one TensorBoard event file
    under ``logdir`` (created at the first write); nothing when ``logdir``
    is empty."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: Optional[str] = None
        self._file = None

    def _writer(self):
        if self._file is None:
            from tumblr_emotions_torch.data.records import TFRecordWriter

            os.makedirs(self.logdir, exist_ok=True)
            now = time.time()
            self.path = os.path.join(self.logdir, "events.out.tfevents.%d.%s.%d.0.v2" % (
                int(now), socket.gethostname(), os.getpid()))
            self._file = TFRecordWriter(self.path)
            self._file.write(_event(0, now, _field(3, b"brain.Event:2")))
        return self._file

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.logdir:
            return
        w = self._writer()
        for tag, value in scalars.items():
            w.write(scalar_event(int(step), tag, float(value), time.time()))

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class ProfilerHook:
    """Trace steps ``[start_step, start_step + num_steps)`` (1-based, the
    step a ``train_step`` call completes) with ``torch.profiler``; call
    :meth:`maybe_start` before a step and :meth:`maybe_stop` after it.  The
    trace goes to ``trace_path`` under ``logdir``."""

    def __init__(self, logdir: str, start_step: int = 0, num_steps: int = 3,
                 rank: Optional[int] = None):
        self.logdir = logdir
        self.start_step = start_step
        self.num_steps = num_steps
        self.trace_path: Optional[str] = None
        if logdir and start_step > 0:
            last = start_step + num_steps - 1
            suffix = "" if rank is None else f".proc{rank}"
            self.trace_path = os.path.join(
                logdir, f"trace_steps_{start_step}-{last}{suffix}.json")
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.trace_path and self._prof is None and step == self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            log.info("profiler trace started at step %d -> %s", step, self.trace_path)

    def step_range(self, step: int):
        """A ``train_step <step>`` range in the trace while tracing."""
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"train_step {step}")

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.start_step + self.num_steps - 1:
            self.stop_if_active()
            log.info("profiler trace stopped at step %d", step)

    def stop_if_active(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
