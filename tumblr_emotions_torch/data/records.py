"""Record IO: TFRecord framing and tf.Example protos, without TensorFlow.

Port of ``tumblr_emotions_tpu/data/records.py``; every byte it writes, and
every crc it checks, equals the reference's:

* TFRecord framing: an 8-byte length, its masked CRC-32C, the payload and
  the payload's masked CRC-32C.  The crc is the port's own C++
  (``utils/crc32c.py``); the reference takes it from ``google_crc32c``.
* tf.Example is hand-encoded protobuf (varint and length-delimited fields
  only), so datasets the reference converted and datasets written here are
  byte-compatible with TF's readers and each other.

* ArrayRecord shards are riegeli records files as ``array_record`` lays
  them out, read and written here without either package: 64 KiB blocks,
  each opened by a 24-byte block header; a signature chunk; one simple
  chunk per group of records (zstd through ``utils/zstd.py``, or none);
  the footer chunk (``RiegeliFooterMetadata`` and one ``ArrayRecordFooter``
  per chunk), padding to the block boundary, and the ``RiegeliPostscript``
  chunk in the last block.  Every block and chunk header carries its
  HighwayHash-64 (``utils/highwayhash.py``), checked on every read.

The Example schema is the reference converter's (``image/encoded``,
``image/format``, ``text``, ``label``, ``id``).
"""

from __future__ import annotations

import glob
import os
import struct
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from tumblr_emotions_torch.utils import crc32c, highwayhash, zstd


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


def _write_sharded(examples: Iterable[bytes], out_dir: str, basename: str,
                   num_shards: int, ext: str, make_writer) -> List[str]:
    """Round-robin shard writer in the reference converter's layout
    (``<basename>-00000-of-00005.<ext>``).  Writers are opened one at a
    time under try/finally so a failing constructor (disk full, bad path)
    cannot leak the handles already opened."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"{basename}-{i:05d}-of-{num_shards:05d}.{ext}")
             for i in range(num_shards)]
    writers: List = []
    try:
        for p in paths:
            writers.append(make_writer(p))
        for i, ex in enumerate(examples):
            writers[i % num_shards].write(ex)
    finally:
        for w in writers:
            w.close()
    return paths


def write_sharded_tfrecords(examples: Iterable[bytes], out_dir: str,
                            basename: str, num_shards: int) -> List[str]:
    """``<basename>-00000-of-00005.tfrecord`` shards, round robin."""
    return _write_sharded(examples, out_dir, basename, num_shards, "tfrecord",
                          TFRecordWriter)


def shard_paths(pattern: str) -> List[str]:
    """The files ``pattern`` matches, sorted (the reference reads shards in that order)."""
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no records match {pattern}")
    return paths


def read_sharded(pattern: str, verify_crc: bool = True) -> Iterator[bytes]:
    for p in shard_paths(pattern):
        yield from read_tfrecords(p, verify_crc=verify_crc)


# ---------------------------------------------------------------------------
# ArrayRecord: riegeli records files (riegeli's records_format.md) in
# array_record's layout (its cpp/layout.proto)
# ---------------------------------------------------------------------------

BLOCK = 1 << 16            # riegeli's block size
BLOCK_HEADER = 24          # header hash, previous_chunk, next_chunk
CHUNK_HEADER = 40          # header hash, data size, data hash, type|records<<8, decoded size
_POSTSCRIPT_MAGIC = 0x71930E704FDAE05E
# Chunk types and the compression bytes of a simple chunk.
_SIGNATURE, _SIMPLE, _PADDING, _TRANSPOSED = ord("s"), ord("r"), ord("p"), ord("t")
_COMPRESSION_NAMES = {0: "none", ord("z"): "zstd", ord("b"): "brotli", ord("s"): "snappy"}


def _add_with_overhead(pos: int, length: int) -> int:
    """The file position after ``length`` bytes of chunk content laid down
    from ``pos``, a block header skipped at every block boundary crossed
    (one ending exactly at a boundary stops there)."""
    if length == 0:
        return pos
    if pos % BLOCK == 0:
        pos += BLOCK_HEADER
    room = BLOCK - pos % BLOCK
    if length <= room:
        return pos + length
    full, rest = divmod(length - room, BLOCK - BLOCK_HEADER)
    return pos + room + full * BLOCK + (BLOCK_HEADER + rest if rest else 0)


def _chunk_end(begin: int, data_size: int, num_records: int) -> int:
    """Where the chunk that begins at ``begin`` ends and the next begins:
    after its content, and at least ``num_records`` bytes on, out of any
    block header."""
    least = begin + num_records
    if 0 < least % BLOCK < BLOCK_HEADER:
        least += BLOCK_HEADER - least % BLOCK
    return max(_add_with_overhead(begin, CHUNK_HEADER + data_size), least)


def _block_header(previous_chunk: int, next_chunk: int) -> bytes:
    body = struct.pack("<QQ", previous_chunk, next_chunk)
    return struct.pack("<Q", highwayhash.hash64(body)) + body


def _proto_fields(buf: bytes) -> Dict[int, object]:
    """The varint (int) and length-delimited (bytes) fields of a protobuf
    message, by field number (the last value of a repeated field)."""
    out: Dict[int, object] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        if tag & 7 == 0:
            out[tag >> 3], pos = _read_varint(buf, pos)
        elif tag & 7 == 2:
            ln, pos = _read_varint(buf, pos)
            out[tag >> 3] = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unexpected protobuf wire type {tag & 7}")
    return out


def _varint_field(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value)


def _unzstd(block: bytes) -> bytes:
    """A riegeli compressed block: its decoded size as a varint, then zstd."""
    size, pos = _read_varint(block, 0)
    return zstd.decompress(block[pos:], size)


class _WriterOptions:
    """array_record's writer options (``"group_size:1"``, ``"zstd:3"``,
    ``"uncompressed"``, ...), and their canonical string, the one the
    reference's writer stores in the footer."""

    def __init__(self, options: str):
        self.group_size, self.level, self.window_log = 65536, 3, 20
        self.compression = "zstd"
        for item in filter(None, (o.strip() for o in options.split(","))):
            key, _, value = item.partition(":")
            if key == "group_size":
                self.group_size = int(value)
            elif key == "zstd":
                self.compression, self.level = "zstd", int(value or 3)
            elif key == "window_log":
                self.window_log = int(value)
            elif key == "uncompressed":
                self.compression = "none"
            elif key in ("transpose", "pad_to_block_boundary") and value == "false":
                pass
            elif key == "max_parallelism":
                int(value)  # the port writes from one thread
            elif key in ("brotli", "snappy", "transpose", "pad_to_block_boundary"):
                raise NotImplementedError(
                    f"ArrayRecord writer option {item!r} is not supported: the port "
                    "writes zstd or uncompressed chunks, not transposed, unpadded "
                    "(ROADMAP Queue 3)")
            else:
                raise ValueError(f"unknown ArrayRecord writer option {item!r}")
        if self.group_size < 1:
            raise ValueError(f"group_size must be positive, got {self.group_size}")
        comp = (f"zstd:{self.level},window_log:{self.window_log}"
                if self.compression == "zstd" else "uncompressed")
        self.canonical = (f"group_size:{self.group_size},transpose:false,"
                          f"pad_to_block_boundary:false,{comp},max_parallelism:1")


class ArrayRecordWriter:
    """Writes one ArrayRecord file as the reference's ``ArrayRecordWriter(path,
    options)`` does: ``group_size`` records per chunk, each chunk's sizes and
    values compressed apart (zstd at ``zstd:<level>`` and ``window_log``, the
    default ``zstd:3,window_log:20``, or ``uncompressed``), the footer and the
    postscript on :meth:`close`."""

    def __init__(self, path: str, options: str = "group_size:1"):
        self._opts = _WriterOptions(options)
        self._f = open(path, "wb")
        self._pos = 0
        self._group: List[bytes] = []
        self._footers: List[bytes] = []
        self._num_records = 0
        self._write_chunk(_SIGNATURE, b"", 0, 0)

    def _write_chunk(self, chunk_type: int, data: bytes, num_records: int,
                     decoded_size: int) -> None:
        body = struct.pack("<QQQQ", len(data), highwayhash.hash64(data),
                           chunk_type | (num_records << 8), decoded_size)
        content = struct.pack("<Q", highwayhash.hash64(body)) + body + data
        begin = self._pos
        end = _chunk_end(begin, len(data), num_records)
        out = bytearray()
        pos, i = begin, 0
        while pos < end:
            if pos % BLOCK == 0:
                out += _block_header(pos - begin, end - pos)
                pos += BLOCK_HEADER
            take = min(BLOCK - pos % BLOCK, end - pos)
            piece = content[i:i + take]
            out += piece + bytes(take - len(piece))  # zeros up to the end past the content
            i += len(piece)
            pos += take
        self._f.write(out)
        self._pos = end

    def _write_simple(self, records: List[bytes], compress: bool = True) -> int:
        """One simple chunk of ``records``, compressed as the options say
        unless ``compress`` is False; returns where it begins."""
        sizes = b"".join(_varint(len(r)) for r in records)
        values = b"".join(records)
        if compress and self._opts.compression == "zstd":
            sizes, values = (_varint(len(b)) + zstd.compress(b, self._opts.level,
                                                             self._opts.window_log)
                             for b in (sizes, values))
            comp = b"z"
        else:
            comp = b"\0"
        begin = self._pos
        self._write_chunk(_SIMPLE, comp + _varint(len(sizes)) + sizes + values,
                          len(records), sum(len(r) for r in records))
        return begin

    def _pad_to_block(self) -> None:
        length = -self._pos % BLOCK
        if length == 0:
            return
        if length < CHUNK_HEADER:
            length += BLOCK - BLOCK_HEADER
        self._write_chunk(_PADDING, bytes(length - CHUNK_HEADER), 0, 0)

    def write(self, record: bytes) -> None:
        self._group.append(bytes(record))
        if len(self._group) == self._opts.group_size:
            self._flush_group()

    def _flush_group(self) -> None:
        if self._group:
            decoded = sum(len(r) for r in self._group)
            begin = self._write_simple(self._group)
            self._footers.append(_varint_field(1, begin) + _varint_field(2, decoded)
                                 + _varint_field(3, len(self._group)))
            self._num_records += len(self._group)
            self._group = []

    def close(self) -> None:
        if self._f is None:
            return
        try:
            self._flush_group()
            meta = (_varint_field(1, 1) + _varint_field(2, len(self._footers))
                    + _varint_field(3, self._num_records)
                    + _len_delimited(4, self._opts.canonical.encode()))
            footer_offset = self._write_simple([_len_delimited(1, meta)] + self._footers)
            self._pad_to_block()
            postscript = (_varint_field(1, footer_offset)
                          + _varint_field(2, _POSTSCRIPT_MAGIC))
            self._write_simple([postscript] * 3, compress=False)   # three copies, as array_record
            self._pad_to_block()
        finally:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArrayRecordReader:
    """Random access into one ArrayRecord file, as the reference's
    ``ArrayRecordReader``: :meth:`num_records`, :meth:`read` of a list of
    indices, item access.  The postscript in the last block locates the
    footer, whose per-chunk entries locate every record.  Every header
    and every chunk's data is checked against its HighwayHash, and a
    mismatch raises ``IOError``; chunks compressed with brotli or snappy,
    or transposed, raise ``NotImplementedError`` naming it."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")  # closed by close(), or with the object
        size = os.fstat(self._f.fileno()).st_size
        if size < BLOCK or size % BLOCK:
            raise IOError(f"{path}: not an ArrayRecord file ({size} bytes, not a "
                          f"whole number of {BLOCK}-byte blocks)")
        head = self._chunk_header(0)
        if head[0] != _SIGNATURE:
            raise IOError(f"{path}: no riegeli signature chunk")
        post = _proto_fields(self._records(size - BLOCK)[0])
        if post.get(2) != _POSTSCRIPT_MAGIC:
            raise IOError(f"{path}: bad ArrayRecord postscript magic")
        footer = self._records(int(post[1]))
        meta = _proto_fields(_proto_fields(footer[0]).get(1, b""))
        chunks = [_proto_fields(f) for f in footer[1:]]
        if len(chunks) != meta.get(2, 0):
            raise IOError(f"{path}: footer lists {len(chunks)} chunks, metadata "
                          f"{meta.get(2, 0)}")
        self.writer_options = meta.get(4, b"").decode()
        self._offsets = np.array([c.get(1, 0) for c in chunks], np.int64)
        counts = np.array([c.get(3, 0) for c in chunks], np.int64)
        self._starts = np.concatenate([[0], np.cumsum(counts)])
        if int(self._starts[-1]) != meta.get(3, 0):
            raise IOError(f"{path}: chunks hold {int(self._starts[-1])} records, "
                          f"metadata {meta.get(3, 0)}")
        self._cached: Tuple[int, Optional[List[bytes]]] = (-1, None)
        self._lock = threading.Lock()

    def _pread(self, n: int, pos: int) -> bytes:
        raw = os.pread(self._f.fileno(), n, pos)
        if len(raw) != n:
            raise IOError(f"{self.path}: truncated at {pos + len(raw)}")
        return raw

    def _content(self, begin: int, length: int, chunk_end: Optional[int] = None) -> bytes:
        """``length`` bytes of chunk content from ``begin``, the block headers
        between them dropped; with ``chunk_end``, each of those is checked
        (its hash, and its distances to the chunk's begin and end)."""
        end = _add_with_overhead(begin, length)
        raw = self._pread(end - begin, begin)
        out = bytearray()
        pos = begin
        while pos < end:
            if pos % BLOCK == 0:
                hdr = raw[pos - begin:pos - begin + BLOCK_HEADER]
                if chunk_end is not None:
                    h, prev, nxt = struct.unpack("<QQQ", hdr)
                    if h != highwayhash.hash64(hdr[8:]):
                        raise IOError(f"{self.path}: corrupt block header at {pos}")
                    if (prev, nxt) != (pos - begin, chunk_end - pos):
                        raise IOError(f"{self.path}: block header at {pos} does not "
                                      f"frame the chunk at {begin}")
                pos += BLOCK_HEADER
            take = min(BLOCK - pos % BLOCK, end - pos)
            out += raw[pos - begin:pos - begin + take]
            pos += take
        return bytes(out)

    def _chunk_header(self, begin: int) -> Tuple[int, int, int, int, int]:
        """(type, num_records, data_size, data_hash, decoded_size), the header hash checked."""
        hdr = self._content(begin, CHUNK_HEADER)
        h, data_size, data_hash, tn, decoded = struct.unpack("<QQQQQ", hdr)
        if h != highwayhash.hash64(hdr[8:]):
            raise IOError(f"{self.path}: corrupt chunk header at {begin}")
        return tn & 0xFF, tn >> 8, data_size, data_hash, decoded

    def _records(self, begin: int) -> List[bytes]:
        """The records of the simple chunk at ``begin``."""
        ctype, n, data_size, data_hash, decoded = self._chunk_header(begin)
        if ctype == _TRANSPOSED:
            raise NotImplementedError(f"{self.path}: transposed chunks are not "
                                      "supported (ROADMAP Queue 3)")
        if ctype != _SIMPLE:
            raise IOError(f"{self.path}: chunk at {begin} has type {ctype:#x}, not "
                          "a simple chunk")
        data = self._content(begin, CHUNK_HEADER + data_size,
                             _chunk_end(begin, data_size, n))[CHUNK_HEADER:]
        if highwayhash.hash64(data) != data_hash:
            raise IOError(f"{self.path}: corrupt chunk data at {begin}")
        comp = data[0]
        if comp not in (0, ord("z")):
            raise NotImplementedError(
                f"{self.path}: {_COMPRESSION_NAMES.get(comp, hex(comp))} compression "
                "is not supported: the port reads zstd and uncompressed chunks "
                "(ROADMAP Queue 3)")
        ln, pos = _read_varint(data, 1)
        sizes, values = data[pos:pos + ln], data[pos + ln:]
        if comp:
            sizes, values = _unzstd(sizes), _unzstd(values)
        lengths, pos = [], 0
        for _ in range(n):
            k, pos = _read_varint(sizes, pos)
            lengths.append(k)
        if pos != len(sizes) or sum(lengths) != len(values) or len(values) != decoded:
            raise IOError(f"{self.path}: chunk at {begin} does not hold its {n} records")
        out, pos = [], 0
        for k in lengths:
            out.append(values[pos:pos + k])
            pos += k
        return out

    def verify(self) -> Dict[str, int]:
        """Walk every chunk of the file from its start, checking each
        header's and each chunk's data hash and every block header; returns
        the number of chunks of each type (``IOError`` at the first fault)."""
        size = os.fstat(self._f.fileno()).st_size
        counts: Dict[str, int] = {}
        pos = 0
        while pos < size:
            ctype, n, data_size, data_hash, _ = self._chunk_header(pos)
            end = _chunk_end(pos, data_size, n)
            data = self._content(pos, CHUNK_HEADER + data_size, end)[CHUNK_HEADER:]
            if highwayhash.hash64(data) != data_hash:
                raise IOError(f"{self.path}: corrupt chunk data at {pos}")
            counts[chr(ctype)] = counts.get(chr(ctype), 0) + 1
            pos = end
        if pos != size:
            raise IOError(f"{self.path}: the last chunk ends at {pos}, past the file's "
                          f"{size} bytes")
        return counts

    def num_records(self) -> int:
        return int(self._starts[-1])

    def __len__(self) -> int:
        return self.num_records()

    def __getitem__(self, i: int) -> bytes:
        i = int(i)
        if not 0 <= i < len(self):
            raise IndexError(f"record {i} of {len(self)} in {self.path}")
        c = int(np.searchsorted(self._starts, i, side="right")) - 1
        with self._lock:  # one decoded chunk kept: a group's records are read together
            cached_c, recs = self._cached
            if cached_c != c:
                recs = self._records(int(self._offsets[c]))
                self._cached = (c, recs)
        return recs[i - int(self._starts[c])]

    def read(self, indices: Optional[Sequence[int]] = None) -> List[bytes]:
        """The records at ``indices`` (default: all, in order)."""
        if indices is None:
            indices = range(len(self))
        return [self[i] for i in indices]

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getstate__(self):  # sent to pipeline workers: reopened there
        state = self.__dict__.copy()
        state.update(_f=None, _lock=None, _cached=(-1, None))
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._f = open(self.path, "rb")


def write_sharded_arrayrecords(examples: Iterable[bytes], out_dir: str,
                               basename: str, num_shards: int) -> List[str]:
    """``<basename>-00000-of-00005.arrayrecord`` shards, round robin, each
    written with the reference's options (``group_size:1``, zstd:3)."""
    return _write_sharded(examples, out_dir, basename, num_shards, "arrayrecord",
                          lambda p: ArrayRecordWriter(p, "group_size:1"))


def read_sharded_arrayrecords(pattern: str) -> Iterator[bytes]:
    """Every record of the shards ``pattern`` matches, in sorted path order."""
    for p in shard_paths(pattern):
        with ArrayRecordReader(p) as reader:
            for i in range(len(reader)):
                yield reader[i]
