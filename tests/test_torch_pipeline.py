"""The port's record pipeline against the JAX package's grain pipeline:
grain's index_shuffle, the batches (record for record, array-equal) over
TFRecord and ArrayRecord shards, the .idx cache, resume at the exact
batch, the worker processes (against grain's ``mp_prefetch``), the device
prefetcher and the CSV text batches."""

import contextlib
import dataclasses
import gc
import itertools
import random
import signal
import threading
from pathlib import Path

import numpy as np
import pytest
from grain._src.python.experimental.index_shuffle.python import (
    index_shuffle_module as grain_index_shuffle)

from tumblr_emotions_torch.data import csv_dataset as tcsv
from tumblr_emotions_torch.data import pipeline as tp
from tumblr_emotions_torch.data import records as trec
from tumblr_emotions_torch.data.index_shuffle import index_shuffle, shuffled_indices
from tumblr_emotions_torch.data.vocab import Vocabulary as TVocab
from tumblr_emotions_tpu.data import csv_dataset as jcsv
from tumblr_emotions_tpu.data import pipeline as jp
from tumblr_emotions_tpu.data.vocab import Vocabulary as JVocab
from tumblr_emotions_tpu.data.vocab import build_vocabulary

FIXTURES = Path(__file__).parent / "data" / "jpeg"
N_POSTS = 23
WORDS = ["happy", "sad", "love", "rain", "sun", "tired", "wow", "calm", "day"]


def _texts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(0, 9))) for _ in range(n)]


@pytest.fixture
def data(tmp_path):
    """23 posts of fixture JPEGs in 3 TFRecord shards, and the vocabulary
    in both packages' types."""
    jpegs = sorted(FIXTURES.glob("*.jpg"))
    texts = _texts(N_POSTS)
    exs = [trec.post_to_example(jpegs[i % len(jpegs)].read_bytes(), texts[i], i % 15,
                                post_id=str(i)) for i in range(N_POSTS)]
    trec.write_sharded_tfrecords(exs, str(tmp_path), "train", 3)
    v = build_vocabulary(texts, min_freq=1)
    return (str(tmp_path / "train-*.tfrecord"), JVocab(v.token_to_id, v.id_to_token),
            TVocab(v.token_to_id, v.id_to_token))


def _sweep():
    rnd = random.Random(0)
    cases = []
    maxes = [0, 1, 2, 3, 5, 100, 255, 256, 257, 46_204, 65_535, 65_536, 65_537,
             2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 40 + 3,
             2 ** 62, 2 ** 64 - 1]
    for m in maxes:
        for seed in (0, 1, 52, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1, rnd.randrange(2 ** 32)):
            for i in sorted({0, m, m // 2, rnd.randrange(m + 1)}):
                cases.append((i, m, seed))
    return cases


def test_index_shuffle_equals_grains_compiled_module():
    cases = _sweep()
    for rounds in (4, 6):
        for (m, seed), group in itertools.groupby(cases, key=lambda c: c[1:]):
            idx = [i for i, _, _ in group]
            want = [grain_index_shuffle.index_shuffle(i, max_index=m, seed=seed, rounds=rounds)
                    for i in idx]
            assert [index_shuffle(i, m, seed, rounds) for i in idx[:1]] == want[:1]
            if m < 2 ** 62:
                assert shuffled_indices(idx, m, seed, rounds).tolist() == want, (m, seed)
            else:
                assert [index_shuffle(i, m, seed, rounds) for i in idx] == want, (m, seed)
    # the numpy form, a whole epoch at once
    for n, seed in ((1, 3), (2, 0), (23, 7), (1000, 2 ** 32 - 1), (70_001, 9)):
        got = shuffled_indices(np.arange(n), n - 1, seed)
        assert sorted(got.tolist()) == list(range(n))
        idx = range(0, n, max(1, n // 97))
        assert [int(got[i]) for i in idx] == [
            grain_index_shuffle.index_shuffle(i, max_index=n - 1, seed=seed, rounds=4)
            for i in idx]


CONFIGS = {
    "shuffled": dict(),
    "in_order": dict(shuffle=False),
    "one_epoch": dict(num_epochs=1),
    "two_epochs": dict(num_epochs=2, seed=5),
    "two_shards": dict(shard_index=1, shard_count=2, num_epochs=2),
    "padded": dict(num_epochs=1, drop_remainder=False, shuffle=False),
    "padded_two_epochs": dict(num_epochs=2, drop_remainder=False),
    "seed_2**32-1": dict(num_epochs=3, seed=2 ** 32 - 1),
}


@pytest.mark.parametrize("consumer", ["joint", "image"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batches_equal_the_reference_pipeline(data, name, consumer):
    pattern, jv, tv = data
    kw = dict(batch_size=4, host_size=37, max_len=6, decode_threads=2, **CONFIGS[name])
    jv, tv = (jv, tv) if consumer == "joint" else (None, None)
    want = jp.batches(pattern, jv, jp.PipelineConfig(**kw))
    got = tp.batches(pattern, tv, tp.PipelineConfig(**kw))
    n = 0
    for a in want:
        b = next(got)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n += 1
        if n == 20:
            break
    if kw.get("num_epochs") is not None:
        assert next(got, None) is None and n < 20
    if not kw.get("drop_remainder", True):
        assert b["weight"].min() == 0       # the last batch is padded


@pytest.mark.parametrize("method", ["islow", "ifast", "float"])
def test_dct_methods_and_cut_jpegs_give_the_reference_batches(tmp_path, method):
    """``PipelineConfig.dct_method`` "ifast" and "float" work, and records
    holding a JPEG cut inside its scan, one without EOI and arithmetic-coded
    ones are assembled as the reference assembles them: the batches'
    bytes are the reference pipeline's."""
    names = ["corrupt/progressive_420_cut30.jpg", "corrupt/restart4_420_cut75.jpg",
             "corrupt/baseline_422_no_eoi.jpg", "arith/seq_420_96x80.jpg",
             "arith/progressive_420_161x97.jpg", "baseline_420_403x301.jpg"]
    texts = _texts(12, seed=6)
    exs = [trec.post_to_example((FIXTURES / names[i % len(names)]).read_bytes(), texts[i],
                                i % 15, post_id=str(i)) for i in range(12)]
    trec.write_sharded_tfrecords(exs, str(tmp_path), "train", 2)
    pattern = str(tmp_path / "train-*.tfrecord")
    kw = dict(batch_size=4, host_size=41, max_len=6, decode_threads=3, num_epochs=1,
              dct_method=method)
    want = list(jp.batches(pattern, None, jp.PipelineConfig(**kw)))
    got = list(tp.batches(pattern, None, tp.PipelineConfig(**kw)))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    item = tp.make_dataset(pattern, None, tp.PipelineConfig(**kw))[0]
    np.testing.assert_array_equal(item["image"], jp.make_dataset(
        pattern, None, jp.PipelineConfig(**kw))[0]["image"])


def test_make_dataset_items_equal_the_reference(data):
    pattern, jv, tv = data
    kw = dict(batch_size=4, host_size=37, max_len=6, num_epochs=2)
    want = jp.make_dataset(pattern, jv, jp.PipelineConfig(**kw))
    got = tp.make_dataset(pattern, tv, tp.PipelineConfig(**kw))
    assert len(got) == len(want) == 2 * N_POSTS
    for i in (0, 5, N_POSTS, 2 * N_POSTS - 1):
        a, b = want[i], got[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_text_batches_equal_the_reference(tmp_path):
    texts = _texts(30, seed=4)
    v = build_vocabulary(texts, min_freq=1)
    jposts = [jcsv.Post(t, i % 15, str(i)) for i, t in enumerate(texts)]
    tposts = [tcsv.Post(t, i % 15, str(i)) for i, t in enumerate(texts)]
    for kw in (dict(shuffle=True, seed=3, num_epochs=2), dict(shuffle=False, num_epochs=1,
                                                              drop_remainder=False)):
        want = list(jcsv.text_batches(jposts, JVocab(v.token_to_id, v.id_to_token), 8, 5, **kw))
        got = list(tcsv.text_batches(tposts, TVocab(v.token_to_id, v.id_to_token), 8, 5, **kw))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    p = tmp_path / "posts.csv"
    p.write_text("id,text,emotion\n1,so happy,#Happy\n2,meh,bored\n3,skip,nope\n")
    assert [vars(x) for x in tcsv.load_posts_csv(str(p))] == \
        [vars(x) for x in jcsv.load_posts_csv(str(p))]


def test_idx_cache_is_shared_by_both_packages(data, tmp_path):
    pattern, _, _ = data
    shard = sorted(Path(pattern).parent.glob("train-*.tfrecord"))[0]
    t = tp.TFRecordIndex(str(shard))                 # the port writes the cache
    idx = Path(str(shard) + ".idx")
    assert idx.exists()
    j = jp.TFRecordIndex(str(shard))                 # the reference reads it
    assert [t[i] for i in range(len(t))] == [j[i] for i in range(len(j))]
    cached = idx.read_bytes()
    idx.unlink()
    jp.TFRecordIndex(str(shard))                     # the reference writes it
    assert idx.read_bytes() == cached
    assert [tp.TFRecordIndex(str(shard))[i] for i in range(len(t))] == \
        [t[i] for i in range(len(t))]
    # a pattern like train-* also matches the caches: they are left out
    assert tp.TFRecordIndex(str(shard.parent / "train-*")).paths == t.paths + sorted(
        str(p) for p in shard.parent.glob("train-*.tfrecord"))[1:]


def test_set_state_resumes_at_the_exact_batch(data, tmp_path):
    pattern, _, tv = data
    cfg = tp.PipelineConfig(batch_size=4, host_size=37, max_len=6, num_epochs=3, seed=2)
    straight = list(tp.batches(pattern, tv, cfg))
    it = tp.batches(pattern, tv, cfg)
    for _ in range(7):                               # across the first epoch boundary
        next(it)
    state_file = str(tmp_path / "pos.json")
    tp.save_iterator_state(it, state_file)
    assert it.get_state() == {"epoch": 1, "index": 28 - N_POSTS}
    resumed = tp.batches(pattern, tv, cfg)
    assert tp.restore_iterator_state(resumed, state_file)
    assert not tp.restore_iterator_state(resumed, str(tmp_path / "none.json"))
    rest = list(resumed)
    assert len(rest) == len(straight) - 7
    for a, b in zip(straight[7:], rest):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="batch boundary"):
        resumed.set_state({"epoch": 0, "index": 3})


def test_device_prefetch_reports_the_consumed_position(data):
    pattern, _, tv = data
    cfg = tp.PipelineConfig(batch_size=4, host_size=37, max_len=6, num_epochs=1,
                            shuffle=False)
    src = tp.batches(pattern, tv, cfg)
    pf = tp.DevicePrefetchIterator(src, device="cpu", depth=3)
    assert pf.get_state() == {"epoch": 0, "index": 0}
    first = next(pf)
    assert str(first["image"].device) == "cpu" and first["image"].shape == (4, 37, 37, 3)
    deadline = threading.Event()
    deadline.wait(0.5)                               # let the producer run ahead
    assert src.get_state()["index"] > 4              # produced beyond the consumed
    assert pf.get_state() == {"epoch": 0, "index": 4}
    with pytest.raises(RuntimeError, match="after iteration started"):
        pf.set_state({"epoch": 0, "index": 0})
    assert sum(1 for _ in pf) == N_POSTS // 4 - 1
    pf.close()


def test_device_prefetch_is_one_wait_span_a_next():
    """Under a profiler each ``next()``, the last (end of input) too, is one
    ``prefetch.wait`` range on the consumer's thread."""
    import torch

    pf = tp.DevicePrefetchIterator(iter([{"x": np.zeros(2)}] * 3), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("consumer"):
            assert len(list(pf)) == 3
    events = prof.profiler.kineto_results.events()
    (consumer,) = [e for e in events if e.name() == "consumer"]
    waits = [e for e in events if e.name() == "prefetch.wait"]
    assert len(waits) == 4
    assert {e.start_thread_id() for e in waits} == {consumer.start_thread_id()}


def test_device_prefetch_reraises_producer_errors():
    def broken():
        yield {"x": np.zeros(2)}
        raise IOError("disk gone")

    pf = tp.DevicePrefetchIterator(broken(), device="cpu")
    next(pf)
    with pytest.raises(IOError, match="disk gone"):
        next(pf)
    with pytest.raises(ValueError, match="no resumable"):
        tp.DevicePrefetchIterator(iter([]), device="cpu").get_state()


def test_refused_pipeline_options(data, ar_data):
    """The options the port once refused run: ``worker_count = 2`` gives the
    in-process batches, and an ``.arrayrecord`` pattern reads the records
    of the TFRecords they were written from."""
    pattern, _, tv = data
    cfg = dict(batch_size=4, host_size=37, max_len=6, num_epochs=1)
    with time_limit(WORKER_TEST_S):
        _assert_same_batches(list(tp.batches(pattern, tv, tp.PipelineConfig(worker_count=2,
                                                                             **cfg))),
                             list(tp.batches(pattern, tv, tp.PipelineConfig(**cfg))))
    ar = tp.record_source(ar_data[0])
    tf = tp.record_source(pattern)
    assert isinstance(ar, tp.ArrayRecordSource) and isinstance(tf, tp.TFRecordIndex)
    assert sorted(ar[i] for i in range(len(ar))) == sorted(tf[i] for i in range(len(tf)))


@pytest.fixture
def ar_data(data, tmp_path):
    """The ``data`` fixture's records as 3 ArrayRecord shards, written by
    the port, beside a copy written by the reference's writer."""
    from tumblr_emotions_tpu.data import records as jrec

    pattern, jv, tv = data
    exs = list(trec.read_sharded(pattern))
    trec.write_sharded_arrayrecords(exs, str(tmp_path / "port"), "train", 3)
    jrec.write_sharded_arrayrecords(exs, str(tmp_path / "ref"), "train", 3)
    return str(tmp_path / "port" / "train-*.arrayrecord"), \
        str(tmp_path / "ref" / "train-*.arrayrecord"), jv, tv


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_arrayrecord_batches_equal_the_reference_pipeline(ar_data, name, writer):
    """``batches`` over .arrayrecord shards (written by either package)
    against the reference's grain pipeline over its ArrayRecordDataSource,
    byte for byte, and against the port's own batches over the TFRecords."""
    port_pat, ref_pat, jv, tv = ar_data
    pattern = port_pat if writer == "port" else ref_pat
    kw = dict(batch_size=4, host_size=37, max_len=6, decode_threads=2, **CONFIGS[name])
    want = list(itertools.islice(jp.batches(pattern, jv, jp.PipelineConfig(**kw)), 12))
    got = list(itertools.islice(tp.batches(pattern, tv, tp.PipelineConfig(**kw)), 12))
    _assert_same_batches(got, want)


# Each worker test runs under its own time limit: a hung worker fails the
# test instead of using up the run.
WORKER_TEST_S = 120


@contextlib.contextmanager
def time_limit(seconds: float):
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expired(signum, frame):
        raise TimeoutError(f"over the test's limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.mark.parametrize("workers", [2, 4])
def test_workers_equal_the_reference_mp_prefetch_and_in_process(data, workers):
    pattern, jv, tv = data
    kw = dict(batch_size=4, host_size=37, max_len=6, decode_threads=2, num_epochs=2, seed=3)
    with time_limit(WORKER_TEST_S):
        want = list(jp.batches(pattern, jv, jp.PipelineConfig(worker_count=2, **kw)))
        it = tp.batches(pattern, tv, tp.PipelineConfig(worker_count=workers, **kw))
        got = list(it)
        in_process = list(tp.batches(pattern, tv, tp.PipelineConfig(**kw)))
    _assert_same_batches(got, want)
    _assert_same_batches(got, in_process)
    assert it._pool is None      # the end of the batches stopped the workers


def _workers_of(it):
    return list(it._pool._procs)


def test_workers_resume_at_a_mid_epoch_state(data):
    pattern, _, tv = data
    cfg = tp.PipelineConfig(batch_size=4, host_size=37, max_len=6, num_epochs=3, seed=2,
                            worker_count=2, decode_threads=2)
    with time_limit(WORKER_TEST_S):
        straight = list(tp.batches(pattern, tv, dataclasses.replace(cfg, worker_count=0)))
        it = tp.batches(pattern, tv, cfg)
        for _ in range(3):                           # 12 of the epoch's 23 records
            next(it)
        state = it.get_state()
        assert state == {"epoch": 0, "index": 12}
        resumed = tp.batches(pattern, tv, cfg)
        resumed.set_state(state)
        rest = list(resumed)
        # set_state on a running iterator restarts its workers there
        first = _workers_of(it)
        it.set_state({"epoch": 1, "index": 5})              # position 28: batch 7
        assert not any(p.is_alive() for p in first)
        again = [next(it) for _ in range(2)]
        it.close()
    _assert_same_batches(rest, straight[3:])
    _assert_same_batches(again, straight[7:9])


def test_workers_leave_no_process_after_close_or_an_error(data, tmp_path):
    pattern, _, tv = data
    cfg = tp.PipelineConfig(batch_size=4, host_size=37, max_len=6, worker_count=2,
                            decode_threads=2)
    with time_limit(WORKER_TEST_S):
        it = tp.batches(pattern, tv, cfg)        # closed
        next(it)
        procs = _workers_of(it)
        it.close()
        assert procs and not any(p.is_alive() for p in procs)
        it = tp.batches(pattern, tv, cfg)        # dropped
        next(it)
        procs = _workers_of(it)
        del it
        gc.collect()
        for p in procs:
            p.join(timeout=15)
        assert not any(p.is_alive() for p in procs)
        # a record a worker cannot decode: its error is raised here
        bad = [trec.post_to_example(b"not a jpeg", "sad", 3, post_id="x")] * 8
        trec.write_sharded_tfrecords(bad, str(tmp_path), "bad", 1)
        it = tp.batches(str(tmp_path / "bad-*.tfrecord"), tv, cfg)
        with pytest.raises(ValueError, match="JPEG decode failed"):
            next(it)
        assert it._pool is None


def test_text_batches_resume_at_the_exact_batch():
    texts = _texts(30, seed=5)
    v = build_vocabulary(texts, min_freq=1)
    posts = [tcsv.Post(t, i % 15, str(i)) for i, t in enumerate(texts)]
    tv = TVocab(v.token_to_id, v.id_to_token)
    straight = list(tcsv.text_batches(posts, tv, 8, 5, seed=3, num_epochs=4))
    it = tcsv.text_batches(posts, tv, 8, 5, seed=3, num_epochs=4)
    for _ in range(5):                               # into the second epoch
        next(it)
    resumed = tcsv.text_batches(posts, tv, 8, 5, seed=3, num_epochs=4)
    resumed.set_state(it.get_state())
    rest = list(resumed)
    assert len(rest) == len(straight) - 5
    for a, b in zip(straight[5:], rest):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="no batch"):
        tcsv.text_batches(posts[:3], tv, 8, 5)
