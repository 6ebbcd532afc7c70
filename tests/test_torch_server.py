"""The port's serving front end (``tumblr_emotions_torch/server.py``): every
behaviour ``tests/test_server.py`` checks of the reference, with a fake
runner, and the port's ``BatchedPredictor`` over its parity runner against
the JAX package's over its own, on the same JPEG bytes and captions."""

import io
import json
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import Future
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu import server as jserver
from tumblr_emotions_tpu.data import vocab as jvocab
from tumblr_emotions_tpu.ops import serving as jserving
from tumblr_emotions_tpu.parallel.mesh import create_mesh
from tumblr_emotions_tpu.train.trainer import build_model as jax_build_model
from tumblr_emotions_torch import EMOTIONS, convert
from tumblr_emotions_torch import config as tconfig
from tumblr_emotions_torch.data import vocab as tvocab
from tumblr_emotions_torch.data.vocab import Vocabulary
from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model
from tumblr_emotions_torch.ops.serving import build_forward
from tumblr_emotions_torch.server import (BatchedPredictor, EmotionHTTPServer,
                                          PredictorOverloaded, _Request)

torch.set_num_threads(2)
FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def _jpeg_bytes(seed: int = 0, size: int = 64) -> bytes:
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _fake_runner(calls=None, seen=None):
    """Deterministic stand-in for a served program: probs from mean pixel
    and token count; ``seen`` keeps each call's lengths."""
    def run(image, tokens, lengths):
        if calls is not None:
            calls.append(0 if image is None else int(image.shape[0]))
        if seen is not None and lengths is not None:
            seen.append(np.array(lengths))
        B = image.shape[0] if image is not None else tokens.shape[0]
        logits = np.zeros((B, len(EMOTIONS)), np.float32)
        if image is not None:
            logits[:, 0] = image.reshape(B, -1).mean(axis=1) / 255.0
        if tokens is not None:
            logits[:, 1] = (tokens > 0).sum(axis=1)
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
    return run


def _tiny_vocab():
    toks = ["<pad>", "<oov>", "happy", "sad", "dog", "cat"]
    return Vocabulary(token_to_id={t: i for i, t in enumerate(toks)}, id_to_token=list(toks))


def test_batched_predictor_coalesces_concurrent_requests():
    calls = []
    p = BatchedPredictor(_fake_runner(calls), batch_size=8, host_size=32,
                         max_delay_ms=60.0, decode_threads=2)
    try:
        futs = [p.submit(image=_jpeg_bytes(i)) for i in range(10)]
        results = [f.result(timeout=30) for f in futs]
    finally:
        p.close()
    assert len(results) == 10
    for r in results:
        assert r["top"] in EMOTIONS
        assert abs(sum(r["probs"].values()) - 1.0) < 1e-3
        vals = list(r["probs"].values())
        assert vals == sorted(vals, reverse=True)
        assert all(v == round(v, 5) for v in vals)
    snap = p.stats.snapshot(8)
    assert snap["responses"] == 10 and snap["batches"] < 10
    assert max(calls) == 8 and set(calls) == {8}  # always the fixed batch shape
    assert snap["latency_ms"]["p50"] is not None


def test_bad_jpeg_fails_its_request_only():
    p = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, max_delay_ms=40.0)
    try:
        good = [p.submit(image=_jpeg_bytes(i)) for i in range(2)]
        bad = p.submit(image=b"definitely not a jpeg")
        for f in good:
            assert f.result(timeout=30)["top"] in EMOTIONS
        with pytest.raises(ValueError, match="bad image"):
            bad.result(timeout=30)
    finally:
        p.close()
    assert p.stats.snapshot(4)["errors"] == 1


def test_a_bad_row_leaves_the_live_rows_their_own_images():
    """The rows after a failed decode move up: each answer is its image's."""
    datas = [_jpeg_bytes(1), b"\xff\xd8 broken", _jpeg_bytes(2, size=48)]
    with_bad = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32,
                                max_delay_ms=200.0)
    alone = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, max_delay_ms=1.0)
    try:
        futs = [with_bad.submit(image=d) for d in datas]
        got = [futs[0].result(timeout=30), futs[2].result(timeout=30)]
        want = [alone.predict(image=datas[0]), alone.predict(image=datas[2])]
    finally:
        with_bad.close()
        alone.close()
    assert got == want


def test_text_and_joint_payloads():
    vocab = _tiny_vocab()
    pj = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, vocab=vocab,
                          max_len=8, max_delay_ms=20.0)
    try:
        assert pj.predict(image=_jpeg_bytes(3), text="happy dog", timeout=30)["top"] in EMOTIONS
    finally:
        pj.close()
    pt = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, needs_image=False,
                          vocab=vocab, max_len=8, max_delay_ms=20.0)
    try:
        assert pt.predict(text="sad cat", timeout=30)["top"] in EMOTIONS
        with pytest.raises(ValueError):
            pt.predict(timeout=5)  # text required
    finally:
        pt.close()
    pi = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, max_delay_ms=20.0)
    try:
        with pytest.raises(ValueError):
            pi.submit(text="no image")
    finally:
        pi.close()
    with pytest.raises(ValueError):
        BatchedPredictor(_fake_runner(), batch_size=4, needs_image=False)


def test_pad_rows_have_length_one():
    seen = []
    p = BatchedPredictor(_fake_runner(seen=seen), batch_size=4, host_size=32,
                         needs_image=False, vocab=_tiny_vocab(), max_len=8, max_delay_ms=1.0)
    try:
        p.predict(text="", timeout=30)
    finally:
        p.close()
    assert seen[0].tolist() == [0, 1, 1, 1]


def _post(url: str, body: bytes, headers=None):
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_http_server_routes_and_concurrency():
    p = BatchedPredictor(_fake_runner(), batch_size=8, host_size=32, max_delay_ms=40.0)
    srv = EmotionHTTPServer(p, host="127.0.0.1", port=0)
    srv.serve_background()
    host, port = srv.server_address
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "platform": "cpu", "device": "cpu",
                          "devices": torch.cuda.device_count()}
        results, errs = [], []

        def _one(i):
            try:
                results.append(_post(base + "/predict", _jpeg_bytes(i)))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=_one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs and len(results) == 6
        for status, payload in results:
            assert status == 200 and payload["top"] in EMOTIONS
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["responses"] >= 6 and 0 < stats["mean_batch_occupancy"] <= 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/predict", b"")               # no body -> 400
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/predict", b"\xff\xd8 not a jpeg")
        assert e.value.code == 400 and "bad image" in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/other", b"x")
        assert e.value.code == 404
    finally:
        srv.close()


def test_http_server_takes_a_burst_of_connections():
    """96 clients connect at once: every post is answered (socketserver's
    default listen backlog of 5 drops or resets most of such a burst)."""
    p = BatchedPredictor(_fake_runner(), batch_size=32, host_size=32, max_delay_ms=50.0)
    srv = EmotionHTTPServer(p, host="127.0.0.1", port=0)
    srv.serve_background()
    base = "http://%s:%d" % srv.server_address[:2]
    start, results, errs = threading.Barrier(96), [], []

    def one(i):
        start.wait()
        try:
            results.append(_post(base + "/predict", _jpeg_bytes(i % 4, size=24)))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(96)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        srv.close()
    assert not errs and len(results) == 96
    assert p.stats.snapshot(32)["batches"] < 96


def test_http_text_via_query_and_header():
    p = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, vocab=_tiny_vocab(),
                         max_len=8, max_delay_ms=20.0)
    srv = EmotionHTTPServer(p, host="127.0.0.1", port=0)
    srv.serve_background()
    host, port = srv.server_address
    base = f"http://{host}:{port}"
    try:
        status, payload = _post(base + "/predict?text=happy%20dog", _jpeg_bytes(1))
        assert status == 200 and payload["top"] in EMOTIONS
        status, payload = _post(base + "/predict", _jpeg_bytes(2), headers={"X-Text": "sad cat"})
        assert status == 200 and payload["top"] in EMOTIONS
    finally:
        srv.close()


def test_close_drains_queue_and_rejects_new_submits():
    p = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, max_delay_ms=5.0,
                         decode_threads=1)
    p.close()
    fut: Future = Future()
    p._queue.put(_Request(image=_jpeg_bytes(), text=None, future=fut))
    p.close()  # idempotent; drains the straggler
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=1.0)
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(image=_jpeg_bytes())


def test_http_rejects_oversized_body():
    p = BatchedPredictor(_fake_runner(), batch_size=4, host_size=32, max_delay_ms=5.0,
                         decode_threads=1)
    server = EmotionHTTPServer(p, host="127.0.0.1", port=0)
    server.serve_background()
    try:
        host, port = server.server_address[:2]
        req = urllib.request.Request(f"http://{host}:{port}/predict", method="POST")
        req.add_header("Content-Length", str(1 << 33))  # 8 GB claim
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 413
        assert "too large" in json.loads(e.value.read())["error"]
    finally:
        server.close()


def test_runner_failure_is_visible_in_stats():
    def bad_runner(image, tokens, lengths):
        raise RuntimeError("device fell over")

    p = BatchedPredictor(bad_runner, batch_size=4, host_size=32, max_delay_ms=200.0,
                         decode_threads=1)
    try:
        fut = p.submit(image=_jpeg_bytes())
        bad = p.submit(image=b"junk")     # same batch: fails its decode
        with pytest.raises(RuntimeError, match="fell over"):
            fut.result(timeout=10)
        with pytest.raises(ValueError):
            bad.result(timeout=10)
        deadline = time.perf_counter() + 5
        while time.perf_counter() < deadline and p.stats.snapshot(4)["errors"] < 2:
            time.sleep(0.01)
        snap = p.stats.snapshot(4)
        assert snap["errors"] == 2 and snap["batches"] == 0, snap   # counted once each
    finally:
        p.close()


def test_overload_fast_fails_and_queue_stays_bounded():
    started, release = threading.Event(), threading.Event()

    def stalling_runner(image, tokens, lengths):
        started.set()
        assert release.wait(30), "test never released the runner"
        return _fake_runner()(image, tokens, lengths)

    p = BatchedPredictor(stalling_runner, batch_size=1, host_size=32, max_delay_ms=1.0,
                         decode_threads=1, max_queue=2)
    try:
        jpg = _jpeg_bytes()
        f_running = p.submit(image=jpg)
        assert started.wait(10)
        queued = [p.submit(image=jpg) for _ in range(2)]
        rejected = 0
        for _ in range(5):
            try:
                p.submit(image=jpg)
            except PredictorOverloaded:
                rejected += 1
        assert rejected == 5 and p._queue.qsize() <= 2
        assert p.stats.snapshot(1)["rejected"] == 5
        release.set()
        assert f_running.result(timeout=30)["top"] in EMOTIONS
        for f in queued:
            assert f.result(timeout=30)["top"] in EMOTIONS
    finally:
        release.set()
        p.close()


def test_http_overload_returns_503_with_retry_after():
    started, release = threading.Event(), threading.Event()

    def stalling_runner(image, tokens, lengths):
        started.set()
        assert release.wait(30)
        return _fake_runner()(image, tokens, lengths)

    p = BatchedPredictor(stalling_runner, batch_size=1, host_size=32, max_delay_ms=1.0,
                         decode_threads=1, max_queue=1)
    server = EmotionHTTPServer(p, host="127.0.0.1", port=0)
    server.serve_background()
    try:
        host, port = server.server_address[:2]
        jpg = _jpeg_bytes()
        f_running = p.submit(image=jpg)
        assert started.wait(10)
        p.submit(image=jpg)
        req = urllib.request.Request(f"http://{host}:{port}/predict", data=jpg, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 503 and e.value.headers.get("Retry-After") == "1"
        assert "queue full" in json.loads(e.value.read())["error"]
        release.set()
        assert f_running.result(timeout=30)["top"] in EMOTIONS
    finally:
        release.set()
        server.close()


def test_a_torch_runner_on_the_card_or_host_is_read_back():
    """A runner returning a torch tensor (the port's build_forward) is read
    back to the host; /healthz reports the runner's device."""
    def run(image, tokens, lengths):
        return torch.softmax(torch.from_numpy(image.reshape(image.shape[0], -1)[:, :15]
                                              .astype(np.float32)), -1)

    run.device = torch.device("cpu")
    p = BatchedPredictor(run, batch_size=2, host_size=8, max_delay_ms=1.0)
    try:
        r = p.predict(image=_jpeg_bytes(4))
        assert r["top"] in EMOTIONS and p.device.type == "cpu"
    finally:
        p.close()


# ---------------------------------------------------------------------------
# Against the JAX server, on the parity runners
# ---------------------------------------------------------------------------

IMAGE, HOST = 139, 160
V, D = 120, 16
CAPTIONS = ["so happy today #love", "sad sad rain", "", "calm dog and a happy cat",
            "annoyed at everything", "excited!!"]
# Both programs run the f32 slim model on the same decoded, resized bytes
# (the decoders and resizes agree bit for bit): the probabilities agree to
# the f32 parity budget, far inside the responses' 5-decimal rounding.
PROB_ATOL = 2e-5


def _configs(model):
    base = {"image": "fused_inference", "text": "text_only", "joint": "joint_finetune"}[model]
    kw = dict(image=dict(image_size=IMAGE, depth_multiplier=0.25),
              text=dict(vocab_size=V, embed_dim=D))
    out = []
    for mod in (jconfig, tconfig):
        c = mod.get_preset(base)
        c = c.replace(image=c.image.replace(**kw["image"]), text=c.text.replace(**kw["text"]),
                      train=c.train.replace(precision_mode="parity"))
        out.append(c)
    return out


def _state(cfg, seed=11):
    model = build_model(cfg, device="meta")
    init = {"image": inception_v3, "text": text_model, "joint": joint_model}[cfg.model]
    return init.init_state(model, seed)


@pytest.mark.parametrize("model", ["image", "text", "joint"])
def test_batched_predictor_matches_the_jax_server(model):
    jcfg, cfg = _configs(model)
    state = _state(cfg)
    variables = convert.to_variables(state)
    jm, jfwd = jax_build_model(jcfg)
    jrun = jserving.build_forward(jcfg, types.SimpleNamespace(forward=jfwd, model=jm), variables,
                                  create_mesh(devices=jax.devices()[:1]), engine="parity")
    run = build_forward(cfg, state, engine="parity", device="cpu")
    needs_image = model != "text"
    jv = jvocab.build_vocabulary(CAPTIONS * 2, max_size=V) if model != "image" else None
    tv = tvocab.build_vocabulary(CAPTIONS * 2, max_size=V) if model != "image" else None
    kw = dict(batch_size=4, host_size=HOST, needs_image=needs_image, max_len=8,
              max_delay_ms=50.0, decode_threads=2)
    jp = jserver.BatchedPredictor(lambda i, t, l: np.asarray(jrun(
        None if i is None else jnp.asarray(i), None if t is None else jnp.asarray(t),
        None if l is None else jnp.asarray(l))), vocab=jv, **kw)
    tp = BatchedPredictor(run, vocab=tv, **kw)
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))[:6]
    posts = [((FIXTURES / n).read_bytes() if needs_image else None, c)
             for n, c in zip(names, CAPTIONS)]
    try:
        want = [f.result(timeout=120) for f in [jp.submit(i, t) for i, t in posts]]
        got = [f.result(timeout=120) for f in [tp.submit(i, t) for i, t in posts]]
    finally:
        jp.close()
        tp.close()
    for g, w in zip(got, want):
        assert g["top"] == w["top"]
        assert max(abs(g["probs"][e] - w["probs"][e]) for e in EMOTIONS) <= PROB_ATOL


def test_cut_arithmetic_and_undecodable_posts_get_the_jax_servers_answers():
    """One batch mixing a JPEG cut inside its scan, one without EOI, an
    arithmetic-coded one, an undecodable one and a good one: each post gets
    the reference server's answer (the same probabilities, or "bad image"
    where both decoders refuse the body)."""
    jcfg, cfg = _configs("image")
    state = _state(cfg)
    jm, jfwd = jax_build_model(jcfg)
    jrun = jserving.build_forward(jcfg, types.SimpleNamespace(forward=jfwd, model=jm),
                                  convert.to_variables(state),
                                  create_mesh(devices=jax.devices()[:1]), engine="parity")
    run = build_forward(cfg, state, engine="parity", device="cpu")
    kw = dict(batch_size=8, host_size=HOST, needs_image=True, max_len=8, max_delay_ms=200.0,
              decode_threads=3)
    jp = jserver.BatchedPredictor(lambda i, t, l: np.asarray(jrun(jnp.asarray(i), None, None)),
                                  **kw)
    tp = BatchedPredictor(run, **kw)
    names = ["corrupt/progressive_420_cut30.jpg", "corrupt/baseline_422_no_eoi.jpg",
             "arith/progressive_420_161x97.jpg", "corrupt/refused_cut_in_headers.jpg",
             "corrupt/restart4_420_rst_removed.jpg", "baseline_444_64x48.jpg"]
    bodies = [(FIXTURES / n).read_bytes() for n in names]

    def answers(pred):
        futs = [pred.submit(image=b) for b in bodies]
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=120))
            except ValueError as e:
                out.append(str(e))
        return out

    try:
        want, got = answers(jp), answers(tp)
    finally:
        jp.close()
        tp.close()
    for name, g, w in zip(names, got, want):
        if name.startswith("corrupt/refused"):
            assert isinstance(w, str) and isinstance(g, str) and g.startswith("bad image"), (g, w)
            continue
        assert isinstance(g, dict) and isinstance(w, dict), (name, g, w)
        assert g["top"] == w["top"], name
        assert max(abs(g["probs"][e] - w["probs"][e]) for e in EMOTIONS) <= PROB_ATOL, name
    assert tp.stats.snapshot(8)["errors"] == 1
