"""Host input pipeline: TFRecord or ArrayRecord shards in grain's order, C++
JPEG decode, a resumable batch iterator (in-process or over worker
processes) and a prefetching feed to the card.

Port of ``tumblr_emotions_tpu/data/pipeline.py`` without grain:

  record_source: TFRecordIndex (random access into TFRecord shards through
    an offset index) or ArrayRecordSource (grain's ``ArrayRecordDataSource``:
    one global index over the sorted ``.arrayrecord`` shards)
    -> RecordOrder (grain's MapDataset chain: ``[shard_index::shard_count]``,
       ``.shuffle(seed)`` by ``data/index_shuffle.py``, ``.repeat(num_epochs)``
       with a new permutation per epoch, ``.batch(batch_size)`` across epoch
       boundaries), so the batches are the reference's, record for record
    -> RecordBatches (decode + PIL-bilinear resize of each batch in one call
       of the port's C++ decoder pool; ``get_state``/``set_state`` over the
       position, so a run resumes at the exact record; ``worker_count = N``
       assembles the batches in N spawned processes, worker ``w`` batches
       ``w, w+N, ...``, as grain's ``mp_prefetch`` splits them)
    -> DevicePrefetchIterator (a producer thread keeps ``depth`` batches on
       the card, copied from pinned host memory on a side stream)

Static shapes throughout: every batch is [B, host_size, host_size, 3] uint8
plus label/weight (and token/length) arrays; with ``drop_remainder=False``
the last batch is padded with weight-0 rows.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import multiprocessing
import os
import pickle
import queue
import struct
import sys
import threading
import time
import traceback
import weakref
from multiprocessing import shared_memory
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from tumblr_emotions_torch.data import jpeg
from tumblr_emotions_torch.data import records as records_lib
from tumblr_emotions_torch.data.index_shuffle import shuffled_indices
from tumblr_emotions_torch.data.vocab import Vocabulary
from tumblr_emotions_torch.utils.summaries import span

class TFRecordIndex:
    """Random access into sharded TFRecord files via an offset index.

    One streaming pass per shard records (offset, length) of every record,
    cached next to the shard as ``.idx`` (int64 pairs, written atomically),
    the same file the reference reads and writes.  A pattern such as
    ``train-*`` also matches those caches: they are not shards, and are
    left out.
    """

    def __init__(self, pattern: str, use_cache: bool = True):
        self.paths = sorted(p for p in glob.glob(pattern)
                            if not p.endswith(".idx") and ".idx.tmp." not in p)
        if not self.paths:
            raise FileNotFoundError(f"no records match {pattern}")
        per_file = []
        for fi, path in enumerate(self.paths):
            arr = self._index_one(path, use_cache)
            fcol = np.full((len(arr), 1), fi, np.int64)
            per_file.append(np.hstack([fcol, arr]))
        self._entries = np.vstack(per_file)  # [N, 3] int64 (file, offset, length)
        self._files: Dict[int, Any] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _index_one(path: str, use_cache: bool) -> np.ndarray:
        """[n, 2] int64 (offset, length) for one shard."""
        idx_path = path + ".idx"
        if use_cache and os.path.exists(idx_path) and \
                os.path.getmtime(idx_path) >= os.path.getmtime(path):
            return np.fromfile(idx_path, dtype=np.int64).reshape(-1, 2)
        entries = []
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            off = 0
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                (length,) = struct.unpack("<Q", header)
                if off + 12 + length + 4 > size:
                    # A truncated trailing record (an interrupted copy) fails
                    # here, as read_tfrecords does, not inside a train step.
                    raise IOError(f"truncated record at offset {off} of {path}")
                entries.append((off + 12, length))
                off += 12 + length + 4
                f.seek(off)
        arr = np.asarray(entries, np.int64).reshape(-1, 2)
        if use_cache:
            # Atomic: a kill mid-write must not leave a truncated .idx newer
            # than the shard (it would pass the mtime check forever).
            tmp = f"{idx_path}.tmp.{os.getpid()}"
            try:
                arr.tofile(tmp)
                os.replace(tmp, idx_path)
            except OSError:
                pass  # read-only data dir: skip the cache
        return arr

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i: int) -> bytes:
        fi, off, ln = (int(v) for v in self._entries[int(i)])
        f = self._files.get(fi)  # one handle per file, opened lazily; pread is thread-safe
        if f is None:
            with self._lock:
                f = self._files.get(fi)
                if f is None:
                    f = open(self.paths[fi], "rb")
                    self._files[fi] = f
        return os.pread(f.fileno(), ln, off)


class ArrayRecordSource:
    """Random access over the ``.arrayrecord`` shards ``pattern`` matches, as
    grain's ``ArrayRecordDataSource`` over the sorted paths: record ``i`` of
    one global index, the shards laid end to end."""

    def __init__(self, pattern: str):
        self.paths = records_lib.shard_paths(pattern)
        self._readers = [records_lib.ArrayRecordReader(p) for p in self.paths]
        self._starts = np.cumsum([0] + [len(r) for r in self._readers])

    def __len__(self) -> int:
        return int(self._starts[-1])

    def __getitem__(self, i: int) -> bytes:
        i = int(i)
        if not 0 <= i < len(self):
            raise IndexError(f"record {i} of {len(self)}")
        f = int(np.searchsorted(self._starts, i, side="right")) - 1
        return self._readers[f][i - int(self._starts[f])]


def record_source(pattern: str):
    """The random-access source of ``pattern``'s records: ArrayRecord shards
    when it names ``.arrayrecord`` files, else TFRecord shards."""
    if ".arrayrecord" in pattern:
        return ArrayRecordSource(pattern)
    return TFRecordIndex(pattern)


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 32
    host_size: int = 347          # decoded+resized host image side
    max_len: int = 50
    shuffle: bool = True
    seed: int = 0
    num_epochs: Optional[int] = None
    drop_remainder: bool = True
    decode_threads: int = 8
    dct_method: str = "islow"
    worker_count: int = 0          # batch-assembling worker processes (0: in-process)
    shard_index: int = 0           # this host's shard (multi-host DP)
    shard_count: int = 1


def _host_resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """Fixed-size host resize for batch assembly: PIL's ``Image.BILINEAR``
    resize to ``size`` x ``size`` of a uint8 RGB image, bit for bit, without
    PIL (``data/jpeg.resize_bilinear``).  An image already that size is
    returned as it is."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    return jpeg.resize_bilinear(img, size, size)


class RecordOrder:
    """The record order of the reference's ``grain.MapDataset`` chain over
    ``n`` records: ``source[shard_index::shard_count]``, then (``shuffle``)
    position ``i`` of epoch ``e`` -> ``index_shuffle(i, L-1, (seed+e) %
    2**32, rounds=4)`` with ``L`` the shard's length, repeated for
    ``num_epochs`` (None: without end).  ``total`` is the number of
    positions (``sys.maxsize`` without end, as grain's length)."""

    def __init__(self, n: int, cfg: PipelineConfig):
        if cfg.shard_count < 1 or not 0 <= cfg.shard_index < cfg.shard_count:
            raise ValueError(f"shard {cfg.shard_index} of {cfg.shard_count}")
        if cfg.num_epochs is not None and cfg.num_epochs <= 0:
            raise ValueError(f"num_epochs must be positive, but got {cfg.num_epochs}")
        if cfg.shuffle and not 0 <= cfg.seed < 2 ** 32:
            raise ValueError(f"seed must be an integer between 0 and 2**32-1 (got {cfg.seed})")
        self.n = n
        self.cfg = cfg
        self.start, _, self.step = slice(cfg.shard_index, None, cfg.shard_count).indices(n)
        self.length = len(range(self.start, n, self.step))   # records per epoch
        if cfg.num_epochs is None:
            self.total = sys.maxsize if self.length else 0
        else:
            self.total = cfg.num_epochs * self.length

        self._epoch_perm: Dict[int, np.ndarray] = {}

    def permutation(self, epoch: int) -> np.ndarray:
        """Epoch ``epoch``'s order of the shard's records (cached for the
        last two epochs used)."""
        perm = self._epoch_perm.get(epoch)
        if perm is None:
            perm = shuffled_indices(np.arange(self.length), self.length - 1,
                                    int((self.cfg.seed + epoch) % 2 ** 32))
            self._epoch_perm = {e: p for e, p in self._epoch_perm.items() if e == epoch - 1}
            self._epoch_perm[epoch] = perm
        return perm

    def records(self, positions) -> np.ndarray:
        """Source record index of each global position (int64 array)."""
        pos = np.asarray(positions, np.int64)
        epoch, i = np.divmod(pos, self.length)
        if self.cfg.shuffle:
            i = i.copy()
            for e in np.unique(epoch):
                sel = epoch == e
                i[sel] = self.permutation(int(e))[i[sel]]
        return self.start + i * self.step


def _parse_meta(raw: bytes, vocab: Optional[Vocabulary],
                cfg: PipelineConfig) -> Dict[str, Any]:
    """Record -> example dict with the image still as JPEG bytes (decode
    happens per batch through the C++ thread pool: see ``batches``)."""
    post = records_lib.example_to_post(raw)
    out: Dict[str, Any] = {
        "image_bytes": post["image"],
        "label": np.int32(post["label"]),
        "weight": np.int32(1),
    }
    if vocab is not None:  # image-only consumers need no text branch
        tokens, length = vocab.encode(post["text"], cfg.max_len)
        out["tokens"] = tokens
        out["lengths"] = np.int32(length)
    return out


class RecordDataset:
    """Random access over the examples in the reference's order
    (``make_dataset``): item ``i`` is the example dict at global position
    ``i``, its image decoded and resized on the host."""

    def __init__(self, pattern: str, vocab: Optional[Vocabulary], cfg: PipelineConfig):
        self.source = record_source(pattern)
        self.order = RecordOrder(len(self.source), cfg)
        self.vocab, self.cfg = vocab, cfg

    def __len__(self) -> int:
        return self.order.total

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if not 0 <= i < len(self):
            raise IndexError(i)
        rec = int(self.order.records([i])[0]) % self.order.n
        out = _parse_meta(self.source[rec], self.vocab, self.cfg)
        img = jpeg.decode(out.pop("image_bytes"), dct_method=self.cfg.dct_method)
        out["image"] = _host_resize_uint8(img, self.cfg.host_size)
        return out


def make_dataset(pattern: str, vocab: Optional[Vocabulary], cfg: PipelineConfig
                 ) -> RecordDataset:
    """Random-access dataset of model-ready example dicts (unbatched), one
    decode per item; ``batches`` decodes whole batches through the C++ pool
    instead: use that for throughput."""
    return RecordDataset(pattern, vocab, cfg)


def _pad_to_static(batch: Dict[str, np.ndarray], batch_size: int
                   ) -> Dict[str, np.ndarray]:
    """Pad a short final batch to the static ``batch_size`` with zero rows
    and ``weight=0``, so the eval step sees one shape; eval metrics mask on
    weight (as the CSV path, ``csv_dataset.text_batches``, does)."""
    n = int(next(iter(batch.values())).shape[0])
    if n == batch_size:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        pad = np.zeros((batch_size - n,) + v.shape[1:], v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    return out


class RecordBatches:
    """The batch iterator ``batches`` returns: batch ``b`` holds global
    positions ``[b*B, min((b+1)*B, total))`` of :class:`RecordOrder` (grain
    batches after the repeat, across epoch boundaries).

    ``get_state()`` is the position of the next batch the consumer takes,
    ``{"epoch", "index"}`` (index within the shard's epoch); ``set_state``
    resumes there, at the exact record.  With ``cfg.worker_count = N > 0``
    the batches are assembled by N worker processes (:class:`_WorkerPool`),
    started at the first ``next`` from the position then, restarted there
    by ``set_state``, and stopped by :meth:`close`, at the end, or when the
    iterator is dropped; the batches are byte for byte those of N = 0.
    """

    def __init__(self, pattern: str, vocab: Optional[Vocabulary], cfg: PipelineConfig):
        if cfg.worker_count < 0:
            raise ValueError(f"worker_count must be >= 0, got {cfg.worker_count}")
        self.pattern, self.cfg, self.vocab = pattern, cfg, vocab
        self.source = record_source(pattern)
        self.order = RecordOrder(len(self.source), cfg)
        bs, total = cfg.batch_size, self.order.total
        self.num_batches = total // bs if cfg.drop_remainder else math.ceil(total / bs)
        self._next = 0
        self._pool: Optional[_WorkerPool] = None
        self._pool_finalizer = None

    def __iter__(self):
        return self

    def _position(self) -> int:
        return min(self._next * self.cfg.batch_size, self.order.total)

    def get_state(self) -> Dict[str, int]:
        epoch, index = divmod(self._position(), max(self.order.length, 1))
        return {"epoch": int(epoch), "index": int(index)}

    def set_state(self, state: Dict[str, int]) -> None:
        pos = int(state["epoch"]) * self.order.length + int(state["index"])
        bs = self.cfg.batch_size
        if pos % bs and pos != self.order.total:
            raise ValueError(f"iterator state {state} is not on a batch boundary "
                             f"(batch size {bs})")
        self.close()
        self._next = -(-pos // bs)

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._next >= self.num_batches:
            self.close()
            raise StopIteration
        if self.cfg.worker_count > 0:
            if self._pool is None:
                self._pool = _WorkerPool(self.pattern, self.vocab, self.cfg, self._next,
                                         self.num_batches)
                self._pool_finalizer = weakref.finalize(self, self._pool.close)
            try:
                batch = self._pool.take(self._next)
            except BaseException:
                self.close()  # a worker's error, or an interrupt: no process left
                raise
        else:
            batch = self.batch(self._next)
        self._next += 1
        return batch

    def close(self) -> None:
        """Stop the worker processes, if any (a later ``next`` starts them anew)."""
        if self._pool_finalizer is not None:
            self._pool_finalizer()
        self._pool = self._pool_finalizer = None

    def batch(self, b: int) -> Dict[str, np.ndarray]:
        """Batch ``b``, assembled in this process."""
        cfg = self.cfg
        start = b * cfg.batch_size
        stop = min(start + cfg.batch_size, self.order.total)
        recs = self.order.records(np.arange(start, stop)) % self.order.n
        examples = [_parse_meta(self.source[int(r)], self.vocab, cfg) for r in recs]
        batch = self._assemble(examples)
        return batch if cfg.drop_remainder else _pad_to_static(batch, cfg.batch_size)

    def _assemble(self, examples) -> Dict[str, np.ndarray]:
        s = self.cfg.host_size
        image = np.empty((len(examples), s, s, 3), np.uint8)
        errors = jpeg.decode_resize_batch([e["image_bytes"] for e in examples], s, image,
                                          num_threads=self.cfg.decode_threads,
                                          dct_method=self.cfg.dct_method)
        bad = [i for i, e in enumerate(errors) if e is not None]
        if bad:
            raise ValueError(f"JPEG decode failed for {len(bad)} images (first index "
                             f"{bad[0]}: {errors[bad[0]]})")
        out = {"image": image}
        for k in examples[0]:
            if k != "image_bytes":
                out[k] = np.stack([e[k] for e in examples])
        return out


def _unlink(name: str) -> None:
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    shm.close()
    shm.unlink()


def _from_shared(name: str, shape) -> np.ndarray:
    """The uint8 images a worker left in shared memory ``name``, copied out;
    the segment is removed."""
    shm = shared_memory.SharedMemory(name=name)
    try:
        view = np.ndarray(shape, np.uint8, buffer=shm.buf)
        out = view.copy()
        del view
        return out
    finally:
        shm.close()
        shm.unlink()


def _worker_main(pattern: str, vocab: Optional[Vocabulary], cfg: PipelineConfig,
                 first: int, step: int, num_batches: int, out: "multiprocessing.Queue",
                 stop, parent_pid: int) -> None:
    """A worker process: batches ``first, first+step, ...`` into ``out`` as
    ("batch", (b, the batch but its images, the shared-memory segment
    holding them, their shape)), or ("error", exception) once and stop.
    The images, most of a batch's bytes, go through shared memory: through
    the queue's pipe they cost more than their decode.  It stops when
    ``stop`` is set or its parent is gone, removing a segment it could not
    hand over."""
    def put(item) -> bool:
        while not stop.is_set() and os.getppid() == parent_pid:
            try:
                out.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        out.cancel_join_thread()  # exit at once: nobody reads what is buffered
        return False

    try:
        it = RecordBatches(pattern, vocab, dataclasses.replace(cfg, worker_count=0))
        for b in range(first, num_batches, step):
            batch = it.batch(b)
            image = batch.pop("image")
            shm = shared_memory.SharedMemory(create=True, size=image.nbytes)
            view = np.ndarray(image.shape, np.uint8, buffer=shm.buf)
            view[...] = image
            del view
            shm.close()
            if not put(("batch", (b, batch, shm.name, image.shape))):
                _unlink(shm.name)
                return
    except Exception as e:  # noqa: BLE001 -- re-raised in the parent
        e.add_note(f"in pipeline worker {os.getpid()}:\n{traceback.format_exc()}")
        try:
            pickle.dumps(e)
        except Exception:  # noqa: BLE001 -- an exception that does not pickle
            e = RuntimeError(f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
        put(("error", e))


class _WorkerPool:
    """``cfg.worker_count`` processes of the ``spawn`` context (a child never
    sees the parent's CUDA state): worker ``w`` assembles batches ``start + w,
    start + w + N, ...`` with ``cfg.decode_threads`` decode threads each,
    into a queue of its own two batches deep (the images in shared memory);
    :meth:`take` returns them in order.  A worker's exception is raised by ``take``; a worker that dies
    without one raises ``RuntimeError``."""

    def __init__(self, pattern: str, vocab: Optional[Vocabulary], cfg: PipelineConfig,
                 start: int, num_batches: int):
        ctx = multiprocessing.get_context("spawn")
        self._start, self._n = start, cfg.worker_count
        self._stop = ctx.Event()
        self._queues = [ctx.Queue(maxsize=2) for _ in range(self._n)]
        self._procs: List = []
        try:
            for w, q in enumerate(self._queues):
                p = ctx.Process(target=_worker_main, daemon=True,
                                name=f"tet-pipeline-worker-{w}",
                                args=(pattern, vocab, cfg, start + w, self._n, num_batches,
                                      q, self._stop, os.getpid()))
                p.start()
                self._procs.append(p)
        except BaseException:
            self.close()
            raise

    def take(self, b: int) -> Dict[str, np.ndarray]:
        w = (b - self._start) % self._n
        q, proc = self._queues[w], self._procs[w]
        while True:
            try:
                kind, payload = q.get(timeout=0.5)
                break
            except queue.Empty:
                if not proc.is_alive():
                    try:
                        kind, payload = q.get(timeout=0.5)  # what it sent before exiting
                        break
                    except queue.Empty:
                        raise RuntimeError(f"pipeline worker {w} exited (code "
                                           f"{proc.exitcode}) before batch {b}") from None
        if kind == "error":
            raise payload
        got, batch, name, shape = payload
        batch = {"image": _from_shared(name, shape), **batch}
        if got != b:
            raise RuntimeError(f"pipeline worker {w} sent batch {got}, expected {b}")
        return batch

    def close(self) -> None:
        """Stop every worker and wait for it (draining its queue, so it can
        exit); one that does not exit within 10 s is terminated."""
        self._stop.set()
        deadline = time.monotonic() + 10
        while any(p.is_alive() for p in self._procs) and time.monotonic() < deadline:
            for q in self._queues:
                try:
                    while True:
                        kind, payload = q.get_nowait()
                        if kind == "batch":
                            _unlink(payload[2])
                except (queue.Empty, OSError, EOFError):
                    pass
            for p in self._procs:
                p.join(timeout=0.05)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in self._queues:
            q.close()
            q.cancel_join_thread()


def batches(pattern: str, vocab: Optional[Vocabulary], cfg: PipelineConfig
            ) -> RecordBatches:
    """Batched numpy iterator over ``pattern``'s records (TFRecord or
    ArrayRecord shards) in the reference's order: JPEG decode and resize
    per batch through the C++ decoder's thread pool (``cfg.decode_threads``),
    in ``cfg.worker_count`` worker processes or in this one.  With ``drop_remainder=False``
    every batch, the last included, has ``cfg.batch_size`` rows (short
    remainders are zero-padded with weight-0 rows)."""
    return RecordBatches(pattern, vocab, cfg)


class DevicePrefetchIterator:
    """A background thread keeps ``depth`` batches on ``device``, so host
    decode overlaps the card's work; with exact-record checkpointing.

    On the card each batch is copied into pinned host memory and to the
    card on a side stream; the consumer's stream waits for the copy.  The
    producer runs ahead of training, so it ships the iterator state taken
    right after pulling each batch, and ``get_state()`` returns that of the
    last batch the trainer consumed: what must be restored.  A producer
    error is raised on the consumer, never taken for the end of input.

    ``state_source`` is the resumable iterator underneath ``batches``
    (default: ``batches`` itself when it has ``get_state``).  ``set_state``
    is only valid before iteration starts.

    Under a profiler each ``next()`` is one ``prefetch.wait`` span
    (``utils/summaries.span``) on the consumer's thread: the wait for the
    producer's next batch and the consumer stream's wait for its copy.
    """

    _END = object()

    def __init__(self, batches: Iterable[Dict[str, Any]], device="cuda", depth: int = 2,
                 state_source=None):
        from tumblr_emotions_torch._device import resolve_device

        if state_source is None and hasattr(batches, "get_state"):
            state_source = batches
        self.device = resolve_device(device)
        self._batches = batches
        self._state_source = state_source
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._consumed_state = None
        self._thread: Optional[threading.Thread] = None
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)

    # -- resumable-iterator protocol (plugs into save/restore_iterator_state)

    def get_state(self):
        if self._consumed_state is not None:
            return self._consumed_state
        if self._state_source is not None:
            return self._state_source.get_state()
        raise ValueError("no resumable iterator underneath this prefetcher")

    def set_state(self, state) -> None:
        if self._thread is not None:
            raise RuntimeError("set_state after iteration started: restore "
                               "the underlying iterator before wrapping")
        if self._state_source is None:
            raise ValueError("no resumable iterator underneath this prefetcher")
        self._state_source.set_state(state)

    # -- iteration -----------------------------------------------------------

    def _to_device(self, batch: Dict[str, Any]):
        """(batch on the device, the event its copy records or None)."""
        if self._stream is None:
            return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                host = torch.as_tensor(v)
                if host.device.type == "cpu":
                    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                    pinned.copy_(host)
                    host = pinned
                out[k] = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            for batch in self._batches:
                st = (self._state_source.get_state()
                      if self._state_source is not None else None)
                if not self._put((*self._to_device(batch), st)):
                    return
            self._put(self._END)
        except BaseException as e:  # noqa: BLE001 -- a decode/IO failure
            self._put(e)            # must not look like clean end-of-input

    def __iter__(self):
        return self

    def __next__(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer, daemon=True,
                                            name="tet-device-prefetch")
            self._thread.start()
        with span("prefetch.wait"):
            item = self._queue.get()
            if item is self._END:
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self.close()
                raise item
            batch, done, st = item
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for t in batch.values():
                    t.record_stream(stream)
        if st is not None:
            self._consumed_state = st
        return batch

    def close(self) -> None:
        """Stop the producer and drop buffered batches, so device memory
        frees at once (an abandoned iterator's producer notices within
        0.2 s)."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break


# ---------------------------------------------------------------------------
# Input-pipeline checkpointing: the iterator's position, saved beside each
# checkpoint, so training resumes at the exact record.
# ---------------------------------------------------------------------------

def save_iterator_state(iterator, path: str) -> None:
    """Persist an iterator's position as JSON, atomically: a crash
    mid-write must not leave a truncated state file that poisons the next
    resume."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(iterator.get_state(), f)
    os.replace(tmp, path)


def restore_iterator_state(iterator, path: str) -> bool:
    """Restore a previously saved position; returns False if no state file."""
    if not os.path.exists(path):
        return False
    with open(path) as f:
        iterator.set_state(json.load(f))
    return True
