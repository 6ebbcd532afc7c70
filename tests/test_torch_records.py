"""The port's record IO (TFRecord framing, tf.Example, the C++ crc32c,
ArrayRecord shards with their HighwayHash and zstd) and dataset converter
against the JAX package's, TF's and array_record's, byte for byte or
record for record."""

import csv
import glob
import os
import shutil
from pathlib import Path

import google_crc32c
import grain
import numpy as np
import pytest
import tensorflow as tf
from array_record.python.array_record_module import ArrayRecordReader as RefReader
from array_record.python.array_record_module import ArrayRecordWriter as RefWriter
from hypothesis import given, settings
from hypothesis import strategies as st

from tumblr_emotions_torch.data import convert as tconvert
from tumblr_emotions_torch.data import records as trec
from tumblr_emotions_torch.utils import crc32c, highwayhash, zstd
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
    """ArrayRecord shards, once refused, round trip: the port's
    ``write_sharded_arrayrecords`` read by the reference's
    ``read_sharded_arrayrecords`` and the reference's read by the port's,
    record for record, with records over 64 KiB; brotli and snappy chunks
    stay refused, by name."""
    exs = _records(23, seed=1)
    trec.write_sharded_arrayrecords(exs, str(tmp_path / "t"), "train", 3)
    jrec.write_sharded_arrayrecords(exs, str(tmp_path / "j"), "train", 3)
    for d in ("t", "j"):
        pattern = str(tmp_path / d / "train-*.arrayrecord")
        assert list(trec.read_sharded_arrayrecords(pattern)) == \
            list(jrec.read_sharded_arrayrecords(pattern)) == [
                exs[i] for shard in range(3) for i in range(shard, len(exs), 3)]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for kind in ("brotli", "snappy"):
        path = str(tmp_path / f"{kind}.arrayrecord")
        w = RefWriter(path, f"group_size:1,{kind}")
        w.write(b"x" * 100)
        w.close()
        with pytest.raises(NotImplementedError, match=kind):
            trec.ArrayRecordReader(path).read()
        with pytest.raises(NotImplementedError, match=kind):
            trec.ArrayRecordWriter(str(tmp_path / "w.arrayrecord"), kind)


def _records(n, seed=0):
    """``n`` seeded records: empty, short, compressible and random ones, a
    third of them over 65,536 bytes, so their chunks cross block headers."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        size = [0, 7, 300, 40_000, 65_536 - 109, 70_000, 140_001][i % 7]
        out.append(rng.bytes(size) if i % 2 else bytes([i % 251]) * size)
    return out


def test_highwayhash_is_the_published_function_and_riegelis_hashes():
    """The published test vectors (key 0..31), and every header and data
    hash of a file the reference's writer wrote."""
    key = (0x0706050403020100, 0x0F0E0D0C0B0A0908, 0x1716151413121110, 0x1F1E1D1C1B1A1918)
    assert [highwayhash.hash64(bytes(range(i)), key) for i in range(3)] == [
        0x907A56DE22C26E53, 0x7EAB43AAC7CDDD78, 0xB8D0569AB0B53D62]


def test_highwayhash_verifies_a_reference_written_file(tmp_path):
    import struct

    path = tmp_path / "r.arrayrecord"
    w = RefWriter(str(path), "group_size:1")
    for r in _records(7, seed=2):
        w.write(r)
    w.close()
    data = path.read_bytes()
    checked = 0
    for b in range(0, len(data), trec.BLOCK):                 # every block header
        h, prev, nxt = struct.unpack("<QQQ", data[b:b + 24])
        assert h == highwayhash.hash64(data[b + 8:b + 24])
        checked += 1
    reader = trec.ArrayRecordReader(str(path))
    counts = reader.verify()                                  # every chunk
    assert counts == {"s": 1, "r": 9, "p": 2} and checked == len(data) // trec.BLOCK


@pytest.mark.parametrize("options", ["group_size:1", "group_size:3", "",
                                     "group_size:2,uncompressed",
                                     "group_size:1,zstd:1,window_log:18"])
def test_arrayrecord_files_read_both_ways(tmp_path, options):
    """Each package's writer read by the other's reader and by grain's
    ``ArrayRecordDataSource``, record for record, by index and in order."""
    recs = _records(15, seed=3)
    port, ref = str(tmp_path / "p.arrayrecord"), str(tmp_path / "r.arrayrecord")
    with trec.ArrayRecordWriter(port, options) as w:
        for r in recs:
            w.write(r)
    w = RefWriter(ref, options)
    for r in recs:
        w.write(r)
    w.close()
    idx = list(range(len(recs)))
    assert trec.ArrayRecordReader(ref).read() == recs
    assert trec.ArrayRecordReader(port).read(idx[::-1]) == recs[::-1]
    assert list(RefReader(port).read(idx)) == recs
    source = grain.sources.ArrayRecordDataSource([port, ref])
    assert len(source) == 2 * len(recs)
    assert [source[i] for i in range(len(source))] == recs + recs
    assert trec.ArrayRecordReader(port).writer_options == \
        trec.ArrayRecordReader(ref).writer_options


def test_arrayrecord_files_are_byte_equal_but_for_small_footers(tmp_path):
    """With three or more records the port's file is the reference's byte
    for byte (same libzstd parameters, fed 64 KiB at a time, as riegeli
    feeds it); a footer of one or two entries the reference compresses with
    its size hint and without the size in the frame, which only its frame
    header shows."""
    recs = _records(9, seed=4)
    for n, equal in ((3, True), (9, True), (2, False)):
        port, ref = str(tmp_path / f"p{n}"), str(tmp_path / f"r{n}")
        with trec.ArrayRecordWriter(port) as w:
            for r in recs[:n]:
                w.write(r)
        w = RefWriter(ref, "group_size:1")
        for r in recs[:n]:
            w.write(r)
        w.close()
        assert (Path(port).read_bytes() == Path(ref).read_bytes()) is equal, n
        assert trec.ArrayRecordReader(port).read() == trec.ArrayRecordReader(ref).read()


@pytest.mark.parametrize("where", ["chunk_header", "chunk_data", "data_past_a_block"])
def test_a_flipped_byte_is_refused_by_both(tmp_path, where):
    path = tmp_path / "f.arrayrecord"
    with trec.ArrayRecordWriter(str(path)) as w:
        w.write(b"small record " * 20)
        w.write(np.random.RandomState(5).bytes(100_000))
    raw = bytearray(path.read_bytes())
    # the first record's chunk begins at 64, after the signature chunk; the
    # second's data crosses the block header at 65,536
    raw[{"chunk_header": 64 + 20, "chunk_data": 64 + 40 + 10,
         "data_past_a_block": trec.BLOCK + 24 + 100}[where]] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        trec.ArrayRecordReader(str(path)).read()
    with pytest.raises(RuntimeError, match="hash mismatch"):
        reader = RefReader(str(path))
        reader.read(list(range(reader.num_records())))


def test_zstd_frames_decode_to_their_size():
    data = np.random.RandomState(6).bytes(200_000) + bytes(100_000)
    frame = zstd.compress(data)
    assert frame[:4] == b"\x28\xb5\x2f\xfd" and zstd.decompress(frame, len(data)) == data
    with pytest.raises(ValueError):
        zstd.decompress(frame, len(data) - 1)
    assert zstd.version().count(".") == 2


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


def test_convert_arrayrecord_output_holds_the_references_records(tmp_path):
    """``record_format="arrayrecord"``: the reference converter's shard names,
    labels and vocabulary byte for byte, and the same records in each shard."""
    csv_path, images = _posts_dir(tmp_path)
    kw = dict(num_shards=3, valid_fraction=0.3, min_freq=1, record_format="arrayrecord")
    want = jconvert.convert(str(csv_path), str(images), str(tmp_path / "j"), **kw)
    got = tconvert.convert(str(csv_path), str(images), str(tmp_path / "t"), **kw)
    assert got == want and got["validation"] > 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert sum(n.endswith(".arrayrecord") for n in names) == 6
    for name in names:
        j, t = tmp_path / "j" / name, tmp_path / "t" / name
        if name.endswith(".arrayrecord"):
            assert trec.ArrayRecordReader(str(t)).read() == \
                list(RefReader(str(j)).read(list(range(RefReader(str(j)).num_records()))))
        else:
            assert j.read_bytes() == t.read_bytes(), name
