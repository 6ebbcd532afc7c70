"""Record IO: TFRecord framing and tf.Example protos, without TensorFlow.

Port of ``tumblr_emotions_tpu/data/records.py``; every byte it writes, and
every crc it checks, equals the reference's:

* TFRecord framing: an 8-byte length, its masked CRC-32C, the payload and
  the payload's masked CRC-32C.  The crc is the port's own C++
  (``utils/crc32c.py``); the reference takes it from ``google_crc32c``.
* tf.Example is hand-encoded protobuf (varint and length-delimited fields
  only), so datasets the reference converted and datasets written here are
  byte-compatible with TF's readers and each other.

The Example schema is the reference converter's (``image/encoded``,
``image/format``, ``text``, ``label``, ``id``).  ArrayRecord shards need the
``array_record`` package, which the port does not use: an ``.arrayrecord``
pattern is refused.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple, Union

import numpy as np

from tumblr_emotions_torch.utils import crc32c

ARRAYRECORD_LEFT = ("ArrayRecord shards (.arrayrecord) are not ported: they need the "
                    "array_record package (ROADMAP Queue 1, item 6(d'))")


def refuse_arrayrecord(pattern: str) -> None:
    if ".arrayrecord" in pattern:
        raise NotImplementedError(ARRAYRECORD_LEFT)


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def _masked_crc(data: bytes) -> int:
    return crc32c.masked(data)


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw records from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise IOError(f"{path}: truncated length header")
            (length,) = struct.unpack("<Q", header)
            crc_bytes = f.read(4)
            if len(crc_bytes) != 4:  # keep the documented IOError contract
                raise IOError(f"{path}: truncated length crc")
            (length_crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and length_crc != _masked_crc(header):
                raise IOError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) != length:
                raise IOError(f"{path}: truncated record")
            crc_bytes = f.read(4)
            if len(crc_bytes) != 4:
                raise IOError(f"{path}: truncated data crc")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and data_crc != _masked_crc(data):
                raise IOError(f"{path}: corrupt data crc")
            yield data


# ---------------------------------------------------------------------------
# tf.Example wire format (hand-rolled protobuf, no TF dependency)
#
# message BytesList { repeated bytes value = 1; }
# message FloatList { repeated float value = 1 [packed=true]; }
# message Int64List { repeated int64 value = 1 [packed=true]; }
# message Feature  { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
#                            Int64List int64_list = 3; } }
# message Features { map<string, Feature> feature = 1; }
# message Example  { Features features = 1; }
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


FeatureValue = Union[bytes, str, int, float,
                     Sequence[bytes], Sequence[int], Sequence[float], np.ndarray]


def _encode_feature(value: FeatureValue) -> bytes:
    if isinstance(value, (bytes, str)):
        value = [value]
    elif isinstance(value, (int, np.integer)):
        value = [int(value)]
    elif isinstance(value, (float, np.floating)):
        value = [float(value)]
    elif isinstance(value, np.ndarray):
        value = value.tolist()
    value = list(value)
    if not value:
        raise ValueError("empty feature")
    first = value[0]
    if isinstance(first, str):
        value = [v.encode("utf-8") for v in value]
        first = value[0]
    if isinstance(first, bytes):
        inner = b"".join(_len_delimited(1, v) for v in value)
        return _len_delimited(1, inner)  # Feature.bytes_list
    if isinstance(first, (int, np.integer)):
        packed = b"".join(
            _varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in value)
        inner = _len_delimited(1, packed)
        return _len_delimited(3, inner)  # Feature.int64_list
    if isinstance(first, (float, np.floating)):
        packed = struct.pack(f"<{len(value)}f", *value)
        inner = _len_delimited(1, packed)
        return _len_delimited(2, inner)  # Feature.float_list
    raise TypeError(f"unsupported feature type {type(first)}")


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Dict -> serialized tf.train.Example bytes."""
    feats = bytearray()
    for name, value in sorted(features.items()):
        entry = (_len_delimited(1, name.encode("utf-8"))
                 + _len_delimited(2, _encode_feature(value)))
        feats += _len_delimited(1, entry)  # Features.feature map entry
    return bytes(_len_delimited(1, bytes(feats)))  # Example.features


def _decode_list(payload: bytes, kind: int):
    pos = 0
    out: List = []
    end = len(payload)
    while pos < end:
        tag, pos = _read_varint(payload, pos)
        field, wire = tag >> 3, tag & 7
        if kind == 1:  # BytesList: repeated bytes value=1
            ln, pos = _read_varint(payload, pos)
            out.append(payload[pos:pos + ln])
            pos += ln
        elif kind == 2:  # FloatList
            if wire == 2:  # packed
                ln, pos = _read_varint(payload, pos)
                out.extend(struct.unpack(f"<{ln // 4}f", payload[pos:pos + ln]))
                pos += ln
            else:  # unpacked fixed32
                out.extend(struct.unpack("<f", payload[pos:pos + 4]))
                pos += 4
        else:  # Int64List
            if wire == 2:
                ln, pos = _read_varint(payload, pos)
                stop = pos + ln
                while pos < stop:
                    v, pos = _read_varint(payload, pos)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
            else:
                v, pos = _read_varint(payload, pos)
                if v >= 1 << 63:
                    v -= 1 << 64
                out.append(v)
    return out


def decode_example(data: bytes) -> Dict[str, List]:
    """Serialized tf.train.Example -> {name: list of bytes/int/float}."""
    out: Dict[str, List] = {}
    pos = 0
    tag, pos = _read_varint(data, pos)
    if tag >> 3 != 1:
        raise ValueError("not an Example proto")
    ln, pos = _read_varint(data, pos)
    features = data[pos:pos + ln]

    fpos = 0
    while fpos < len(features):
        tag, fpos = _read_varint(features, fpos)
        ln, fpos = _read_varint(features, fpos)
        entry = features[fpos:fpos + ln]
        fpos += ln
        # map entry: key=1 (string), value=2 (Feature)
        epos = 0
        name = None
        feature = b""
        while epos < len(entry):
            tag, epos = _read_varint(entry, epos)
            ln2, epos = _read_varint(entry, epos)
            payload = entry[epos:epos + ln2]
            epos += ln2
            if tag >> 3 == 1:
                name = payload.decode("utf-8")
            else:
                feature = payload
        if name is None:
            continue
        # Feature: oneof bytes_list=1 / float_list=2 / int64_list=3
        if feature:
            tag, p = _read_varint(feature, 0)
            kind = tag >> 3
            ln3, p = _read_varint(feature, p)
            inner = feature[p:p + ln3]
            out[name] = _decode_list(inner, kind)
        else:
            out[name] = []
    return out


# ---------------------------------------------------------------------------
# Emotion-post schema (reference converter keys, SURVEY.md §2a #2)
# ---------------------------------------------------------------------------

def post_to_example(image_bytes: bytes, text: str, label: int,
                    image_format: str = "jpg", post_id: str = "") -> bytes:
    return encode_example({
        "image/encoded": image_bytes,
        "image/format": image_format,
        "text": text,
        "label": label,
        "id": post_id,
    })


def example_to_post(data: bytes) -> Dict:
    ex = decode_example(data)
    return {
        "image": ex["image/encoded"][0] if ex.get("image/encoded") else b"",
        "format": (ex["image/format"][0].decode()
                   if ex.get("image/format") else "jpg"),
        "text": ex["text"][0].decode("utf-8") if ex.get("text") else "",
        "label": int(ex["label"][0]) if ex.get("label") else -1,
        "id": ex["id"][0].decode() if ex.get("id") else "",
    }


def write_sharded_tfrecords(examples: Iterable[bytes], out_dir: str,
                            basename: str, num_shards: int) -> List[str]:
    """Round-robin shard writer in the reference converter's layout
    (``<basename>-00000-of-00005.tfrecord``).  Writers are opened one at a
    time under try/finally so a failing constructor (disk full, bad path)
    cannot leak the handles already opened."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"{basename}-{i:05d}-of-{num_shards:05d}.tfrecord")
             for i in range(num_shards)]
    writers: List[TFRecordWriter] = []
    try:
        for p in paths:
            writers.append(TFRecordWriter(p))
        for i, ex in enumerate(examples):
            writers[i % num_shards].write(ex)
    finally:
        for w in writers:
            w.close()
    return paths


def read_sharded(pattern: str, verify_crc: bool = True) -> Iterator[bytes]:
    refuse_arrayrecord(pattern)
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no records match {pattern}")
    for p in paths:
        yield from read_tfrecords(p, verify_crc=verify_crc)
