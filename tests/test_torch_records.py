"""The port's record IO (TFRecord framing, tf.Example, the C++ crc32c) and
dataset converter against the JAX package's and TF's, byte for byte."""

import csv
import glob
import os
import shutil
from pathlib import Path

import google_crc32c
import numpy as np
import pytest
import tensorflow as tf
from hypothesis import given, settings
from hypothesis import strategies as st

from tumblr_emotions_torch.data import convert as tconvert
from tumblr_emotions_torch.data import records as trec
from tumblr_emotions_torch.utils import crc32c
from tumblr_emotions_tpu.data import convert as jconvert
from tumblr_emotions_tpu.data import records as jrec

FIXTURES = Path(__file__).parent / "data" / "jpeg"


def _write(mod, path, payloads):
    with mod.TFRecordWriter(str(path)) as w:
        for p in payloads:
            w.write(p)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 65, 4096, 100_003])
def test_crc32c_equals_google_crc32c(n):
    data = np.random.RandomState(n).bytes(n)
    want = int.from_bytes(google_crc32c.Checksum(data).digest(), "big")
    assert crc32c.value(data) == want
    assert crc32c.library().crc32c_extend_tables(0, data, n) == want   # the table loop
    assert crc32c.extend(crc32c.value(data[:n // 3]), data[n // 3:]) == want
    assert crc32c.value(np.frombuffer(data, np.uint8)) == want
    assert crc32c.unmask(crc32c.masked(data)) == want


def test_frames_and_examples_byte_equal_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    payloads = [b"", b"x"] + [jrec.post_to_example(rng.bytes(rng.randint(1, 900)),
                                                   f"post {i} #happy", i % 15,
                                                   post_id=f"id{i}") for i in range(20)]
    _write(jrec, tmp_path / "j.tfrecord", payloads)
    _write(trec, tmp_path / "t.tfrecord", payloads)
    assert (tmp_path / "j.tfrecord").read_bytes() == (tmp_path / "t.tfrecord").read_bytes()
    assert list(trec.read_tfrecords(str(tmp_path / "j.tfrecord"))) == payloads
    assert list(jrec.read_tfrecords(str(tmp_path / "t.tfrecord"))) == payloads
    for p in payloads[2:]:
        assert trec.example_to_post(p) == jrec.example_to_post(p)
    assert trec.post_to_example(b"\xff\xd8", "so happy", 8, post_id="7") == \
        jrec.post_to_example(b"\xff\xd8", "so happy", 8, post_id="7")
    jp = jrec.write_sharded_tfrecords(payloads, str(tmp_path / "js"), "train", 3)
    tp = trec.write_sharded_tfrecords(payloads, str(tmp_path / "ts"), "train", 3)
    assert [Path(p).name for p in jp] == [Path(p).name for p in tp]
    assert all(Path(a).read_bytes() == Path(b).read_bytes() for a, b in zip(jp, tp))
    assert list(trec.read_sharded(str(tmp_path / "js" / "train-*"))) == \
        list(jrec.read_sharded(str(tmp_path / "js" / "train-*")))


_value = st.one_of(
    st.lists(st.binary(max_size=300), min_size=1, max_size=4),
    st.lists(st.integers(-2 ** 63, 2 ** 63 - 1), min_size=1, max_size=4),
    st.lists(st.floats(width=32, allow_nan=False), min_size=1, max_size=4),
    st.text(max_size=40))


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(min_size=1, max_size=30), _value, min_size=1, max_size=5))
def test_example_codec_fuzz_equals_reference(feats):
    data = trec.encode_example(feats)
    assert data == jrec.encode_example(feats)
    assert trec.decode_example(data) == jrec.decode_example(data)
    parsed = tf.train.Example.FromString(data)   # TF accepts the bytes
    assert set(parsed.features.feature.keys()) == set(feats)


def test_tf_reads_port_records_and_port_reads_tf_records(tmp_path):
    ex = trec.post_to_example(b"jpegbytes", "caption", 3, post_id="a1")
    _write(trec, tmp_path / "t.tfrecord", [ex, b"two"])
    assert [r.numpy() for r in tf.data.TFRecordDataset(str(tmp_path / "t.tfrecord"))] == \
        [ex, b"two"]
    parsed = tf.io.parse_single_example(ex, {
        "image/encoded": tf.io.FixedLenFeature([], tf.string),
        "text": tf.io.FixedLenFeature([], tf.string),
        "label": tf.io.FixedLenFeature([], tf.int64)})
    assert parsed["text"].numpy() == b"caption" and int(parsed["label"]) == 3
    p = str(tmp_path / "tf.tfrecord")
    with tf.io.TFRecordWriter(p) as w:
        w.write(b"one")
        w.write(ex)
    assert list(trec.read_tfrecords(p)) == [b"one", ex]


@pytest.mark.parametrize("where", ["length_crc", "data", "data_crc", "truncated"])
def test_corruption_is_detected(tmp_path, where):
    p = tmp_path / "c.tfrecord"
    _write(trec, p, [b"hello world"])
    raw = bytearray(p.read_bytes())
    if where == "truncated":
        raw = raw[:-3]
    else:
        raw[{"length_crc": 9, "data": 14, "data_crc": -1}[where]] ^= 0x01
    p.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        list(trec.read_tfrecords(str(p)))


def test_arrayrecord_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="6\\(d'\\)"):
        list(trec.read_sharded(str(tmp_path / "train-*.arrayrecord")))
    with pytest.raises(NotImplementedError, match="array_record"):
        tconvert.convert("x.csv", "", str(tmp_path), record_format="arrayrecord")


def _posts_dir(tmp_path):
    """A posts CSV over the fixture JPEGs, with a missing image, a corrupt
    one, an emotion-name row and a row without an image column value."""
    images = tmp_path / "images"
    images.mkdir()
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    for n in names:
        shutil.copy(FIXTURES / n, images / n)
    (images / "bad.jpg").write_bytes(b"not a jpeg at all")
    rng = np.random.RandomState(3)
    words = ["happy", "sad", "love", "rain", "sun", "tired", "wow", "calm", "day"]
    with open(tmp_path / "posts.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "label", "image"])
        for i in range(48):
            w.writerow([f"p{i}", " ".join(rng.choice(words, rng.randint(1, 9))),
                        rng.randint(15), names[i % len(names)]])
        w.writerow(["missing", "where is it", 2, "nope.jpg"])
        w.writerow(["corrupt", "broken", 4, "bad.jpg"])
    return tmp_path / "posts.csv", images


def test_convert_output_is_byte_equal_to_the_reference(tmp_path):
    csv_path, images = _posts_dir(tmp_path)
    kw = dict(num_shards=3, valid_fraction=0.3, min_freq=1)
    want = jconvert.convert(str(csv_path), str(images), str(tmp_path / "j"), **kw)
    got = tconvert.convert(str(csv_path), str(images), str(tmp_path / "t"), **kw)
    assert got == want and got["skipped"] == 2 and got["validation"] > 0
    jfiles = sorted(os.listdir(tmp_path / "j"))
    assert jfiles == sorted(os.listdir(tmp_path / "t"))
    assert "labels.txt" in jfiles and "vocab.txt" in jfiles
    for name in jfiles:
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name
    assert len(glob.glob(str(tmp_path / "t" / "train-*.tfrecord"))) == 3
