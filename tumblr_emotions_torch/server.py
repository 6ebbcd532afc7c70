"""Online serving: a micro-batching HTTP front end over the port's served
programs.

Port of ``tumblr_emotions_tpu/server.py``.  ``BatchedPredictor`` coalesces
concurrent posts into fixed-size device batches for a runner from
:func:`tumblr_emotions_torch.ops.serving.build_forward`;
``EmotionHTTPServer`` puts a stdlib threaded HTTP front on it:

    POST /predict?text=...   body = JPEG bytes -> {"top": ..., "probs": ...}
    GET  /healthz            liveness, the runner's torch device, card count
    GET  /stats              request/batch counters, occupancy, latency pctls

- **Static shapes.**  Every runner call has ``batch_size`` rows; a partial
  batch is padded (pad rows are sliced off before responding, their text
  length is 1).
- **Host decode off the device path.**  The batcher thread decodes and
  resizes a batch's JPEGs in one threaded call of the port's own decoder
  (``data/jpeg.decode_resize_batch``: libjpeg-turbo's decode and PIL's
  bilinear resize, bit for bit) into one reused host buffer; request
  threads only enqueue.
- **Latency bound.**  Requests are coalesced until the batch is full or
  ``max_delay_ms`` has passed since the first one waiting.

The runner copies the host buffer to the card and its probabilities come
back to the host (``.cpu()``), which waits for the batch's work, the copy
included, before the buffer is refilled for the next batch.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from tumblr_emotions_torch.config import EMOTIONS
from tumblr_emotions_torch.data import jpeg as jpeg_lib
from tumblr_emotions_torch.data.vocab import Vocabulary


@dataclass
class _Request:
    image: Optional[bytes]
    text: Optional[str]
    future: Future
    t_enqueue: float = field(default_factory=time.perf_counter)


class PredictorOverloaded(RuntimeError):
    """Raised by ``submit`` when the bounded request queue is full: the
    server sheds load at once (HTTP 503 with ``Retry-After``) instead of
    queueing request bodies without bound."""


class ServerStats:
    """Thread-safe serving counters and a bounded latency reservoir."""

    def __init__(self, reservoir: int = 2048):
        self._lock = threading.Lock()
        self.requests = 0
        self.responses = 0
        self.errors = 0
        self.rejected = 0
        self.batches = 0
        self.batched_rows = 0
        self._lat = deque(maxlen=reservoir)

    def record_batch(self, n_rows: int, latencies: Sequence[float],
                     n_errors: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.batched_rows += n_rows
            self.responses += n_rows
            self.errors += n_errors
            self._lat.extend(latencies)

    def record_errors(self, n_errors: int) -> None:
        """Errors outside a successful device batch (runner failures),
        counted without bumping the batch and occupancy counters a second
        time: ``_run_batch`` may already have recorded its batch."""
        with self._lock:
            self.errors += n_errors

    def record_request(self) -> None:
        with self._lock:
            self.requests += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def snapshot(self, batch_size: int) -> Dict:
        with self._lock:
            lat = sorted(self._lat)
            pct = (lambda p: round(lat[min(len(lat) - 1,
                                           int(p * len(lat)))] * 1e3, 2)
                   ) if lat else (lambda p: None)
            return {
                "requests": self.requests,
                "responses": self.responses,
                "errors": self.errors,
                "rejected": self.rejected,
                "batches": self.batches,
                "mean_batch_occupancy": round(
                    self.batched_rows / max(self.batches, 1) / batch_size, 3),
                "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                               "p99": pct(0.99)},
            }


def _host_probs(probs) -> np.ndarray:
    """The runner's probabilities as a host f32 array; a tensor on the card
    is copied back, which waits for its batch's work."""
    if isinstance(probs, torch.Tensor):
        return probs.detach().float().cpu().numpy()
    return np.asarray(probs, np.float32)


class BatchedPredictor:
    """Coalesce concurrent predict calls into fixed-size device batches.

    ``runner(image_u8 [B,S,S,3], tokens [B,T], lengths [B]) -> probs [B,C]``
    is a served program (``ops.serving.build_forward``); ``tokens`` and
    ``lengths`` are None for image-only models, ``image_u8`` is None for
    text-only ones.  ``submit`` never blocks on the device: it returns a
    Future resolved by the batcher thread.  ``/healthz`` reports the
    runner's ``device`` (``build_forward`` sets it; the host otherwise).
    A runner over several devices (``runner.devices``) splits each batch
    over them, so ``batch_size`` must be a multiple of their number: any
    other is refused here, before the first request.
    """

    def __init__(self, runner: Callable, batch_size: int, *,
                 host_size: int = 347,
                 needs_image: bool = True,
                 vocab: Optional[Vocabulary] = None,
                 max_len: int = 50,
                 max_delay_ms: float = 5.0,
                 decode_threads: int = 8,
                 max_queue: Optional[int] = None,
                 emotions: Sequence[str] = EMOTIONS):
        if needs_image is False and vocab is None:
            raise ValueError("text-only serving needs a vocabulary")
        n_dev = len(getattr(runner, "devices", ()) or (None,))
        if int(batch_size) % n_dev:
            raise ValueError(f"serve batch size {batch_size} does not split over the "
                             f"runner's {n_dev} devices: use a multiple of {n_dev}")
        self.runner = runner
        self.device = torch.device(getattr(runner, "device", "cpu"))
        self.batch_size = int(batch_size)
        self.host_size = int(host_size)
        self.needs_image = needs_image
        self.vocab = vocab
        self.max_len = int(max_len)
        self.max_delay = float(max_delay_ms) / 1e3
        self.decode_threads = int(decode_threads)
        self.emotions = list(emotions)
        self.stats = ServerStats()
        self._image_buf: Optional[np.ndarray] = None
        self._token_buf: Optional[np.ndarray] = None
        self._length_buf: Optional[np.ndarray] = None
        # Bounded: under sustained overload submit() fast-fails with
        # PredictorOverloaded; default capacity 8 device batches.
        self.max_queue = (8 * self.batch_size if max_queue is None
                          else int(max_queue))
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=self.max_queue)
        self._stop = threading.Event()
        # Serializes submit()'s closed-check and put against close(): without
        # it a submitter past the check could enqueue after close() drained
        # the queue, and its future would hang until the client's timeout.
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tet-batcher")
        self._thread.start()

    # -- client side ---------------------------------------------------------

    def submit(self, image: Optional[bytes] = None,
               text: Optional[str] = None) -> Future:
        """Enqueue one post; the Future resolves to
        ``{"top": emotion, "probs": {emotion: p, ...}}``.

        Raises :class:`PredictorOverloaded` when the bounded queue is full
        and ``RuntimeError`` after ``close()``."""
        if self.needs_image and image is None:
            raise ValueError("this model serves images; image bytes required")
        if self.vocab is not None and not self.needs_image and text is None:
            raise ValueError("text-only model; text required")
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("predictor is closed")
            try:
                self._queue.put_nowait(
                    _Request(image=image, text=text, future=fut))
            except queue.Full:
                self.stats.record_rejected()
                raise PredictorOverloaded(
                    f"request queue full ({self.max_queue} waiting); "
                    "retry after backoff") from None
        self.stats.record_request()
        return fut

    def predict(self, image: Optional[bytes] = None,
                text: Optional[str] = None, timeout: float = 60.0) -> Dict:
        return self.submit(image, text).result(timeout=timeout)

    def close(self) -> None:
        with self._submit_lock:
            self._stop.set()
        self._thread.join(timeout=5.0)
        # Fail queued requests at once; the lock above guarantees no new put
        # lands after the drain.
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if not r.future.done():
                r.future.set_exception(RuntimeError("predictor closed"))

    # -- batcher thread ------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.perf_counter() + self.max_delay
            while len(items) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(items)
            except BaseException as e:  # never kill the batcher thread
                # record_batch is the last statement of every _run_batch
                # path, so this batch was never recorded: count the newly
                # failed futures and the per-image decode failures once.
                failed = 0
                for r in items:
                    if not r.future.done():
                        r.future.set_exception(e)
                        failed += 1
                    elif (r.future.cancelled()
                          or r.future.exception() is not None):
                        failed += 1
                self.stats.record_errors(failed)

    def _decode(self, items: List[_Request], out: np.ndarray) -> List[bool]:
        """Decode each request's JPEG and resize it to ``host_size`` into
        ``out[i]``, in one threaded call; a bad image fails its own future
        (``ValueError``), not the batch.  Returns which rows hold an image."""
        errors = jpeg_lib.decode_resize_batch([r.image for r in items], self.host_size,
                                              out, num_threads=self.decode_threads)
        for r, err in zip(items, errors):
            if err is not None:
                r.future.set_exception(ValueError(f"bad image: {err}"))
        return [err is None for err in errors]

    def _run_batch(self, items: List[_Request]) -> None:
        B, S = self.batch_size, self.host_size
        n_errors = 0
        image_b = tokens_b = lengths_b = None
        if self.needs_image:
            # One host buffer, reused every batch: the batcher is one thread
            # and _host_probs below waits for the runner's work on the
            # batch (its copy of this buffer to the card included), so the
            # buffer is never refilled while that copy may still read it.
            # Stale pad rows are harmless: their outputs are sliced off.
            if self._image_buf is None:
                self._image_buf = np.zeros((B, S, S, 3), np.uint8)
            image_b = self._image_buf
            ok = self._decode(items, image_b)
            keep = [i for i, good in enumerate(ok) if good]
            n_errors = len(items) - len(keep)
            live = [items[i] for i in keep]
            if keep != list(range(len(keep))):
                image_b[:len(keep)] = image_b[keep]     # live rows first
        else:
            live = list(items)
        if not live:
            self.stats.record_batch(0, [], n_errors)
            return

        n = len(live)
        if self.vocab is not None:
            if self._token_buf is None:
                self._token_buf = np.zeros((B, self.max_len), np.int32)
                self._length_buf = np.zeros((B,), np.int32)
            tokens_b, lengths_b = self._token_buf, self._length_buf
            toks, lens = self.vocab.encode_batch(
                [r.text or "" for r in live], self.max_len)
            tokens_b[:n], lengths_b[:n] = toks, lens
            lengths_b[n:] = 1  # pad rows: avoid 0-length edge paths

        probs = _host_probs(self.runner(image_b, tokens_b, lengths_b))[:n]
        now = time.perf_counter()
        lats = []
        for row, req in zip(probs, live):
            order = np.argsort(-row)
            req.future.set_result({
                "top": self.emotions[int(order[0])],
                "probs": {self.emotions[i]: round(float(row[i]), 5)
                          for i in order},
            })
            lats.append(now - req.t_enqueue)
        self.stats.record_batch(n, lats, n_errors)


# -- HTTP front end ----------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    predictor: BatchedPredictor  # set by EmotionHTTPServer
    request_timeout: float = 60.0
    max_body_bytes: int = 32 * 1024 * 1024  # cap attacker-controlled reads

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload: Dict,
              extra_headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _health(self) -> Dict:
        dev = self.predictor.device
        out = {"status": "ok", "platform": dev.type, "device": str(dev),
               "devices": torch.cuda.device_count()}
        if dev.type == "cuda":
            out["name"] = torch.cuda.get_device_name(dev)
        return out

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, self._health())
        elif path == "/stats":
            self._json(200, self.predictor.stats.snapshot(
                self.predictor.batch_size))
        else:
            self._json(404, {"error": f"no route {path}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/predict":
            self._json(404, {"error": f"no route {url.path}"})
            return
        length = int(self.headers.get("Content-Length") or 0)
        if length > self.max_body_bytes:
            self._json(413, {"error": f"body too large ({length} bytes; "
                                      f"max {self.max_body_bytes})"})
            return
        body = self.rfile.read(length) if length else b""
        text = (parse_qs(url.query).get("text", [None])[0]
                or self.headers.get("X-Text"))
        image = body if body else None
        try:
            result = self.predictor.predict(image=image, text=text,
                                            timeout=self.request_timeout)
            self._json(200, result)
        except PredictorOverloaded as e:
            self._json(503, {"error": str(e)}, {"Retry-After": "1"})
        except ValueError as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — request-scoped failure
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


class EmotionHTTPServer(ThreadingHTTPServer):
    """Threaded HTTP server over a :class:`BatchedPredictor`.

    ``port=0`` binds an ephemeral port; ``server_address`` reports the bound
    one.  Concurrent POSTs coalesce into device batches through the
    predictor's batcher thread.
    """

    daemon_threads = True
    # The listen backlog.  socketserver's default of 5 (the reference's)
    # drops or resets the connections of a burst beyond it, whose clients
    # retry a second later: 64 concurrent posts then reached the batcher a
    # few at a time (46.8 posts/s on the H100 machine, batches of ~10).
    request_queue_size = 1024

    def __init__(self, predictor: BatchedPredictor, host: str = "0.0.0.0",
                 port: int = 8080, request_timeout: float = 60.0):
        handler = type("BoundHandler", (_Handler,), {
            "predictor": predictor, "request_timeout": request_timeout})
        super().__init__((host, port), handler)
        self.predictor = predictor

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="tet-http")
        t.start()
        return t

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        self.predictor.close()
