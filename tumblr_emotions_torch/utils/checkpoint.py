"""Checkpoints without TensorFlow: TF's V2 tensor-bundle format, TF's V1
checkpoints (read), the slim warm start and export, and the trainer's step
checkpoints.

Port of ``tumblr_emotions_tpu/utils/checkpoint.py`` (which reads and writes
through TF) and of the reference trainer's orbax checkpoints, on one codec:

- A tensor bundle is ``<prefix>.index``, a LevelDB-format table, and
  ``<prefix>.data-00000-of-00001``, the tensors' bytes back to back in key
  order.  The table maps the empty key to a ``BundleHeaderProto`` and each
  tensor name to a ``BundleEntryProto`` (dtype, shape, offset, size,
  masked CRC-32C of the bytes).  The table's blocks hold prefix-compressed
  keys with a restart point every 16 keys, a trailer (type 0, masked crc of
  the block and type) and end at 256 KiB; the index block holds one
  shortest-separator key per data block, and the file ends with a 48-byte
  footer (two block handles, padding, the magic number).  TF writes its
  tables uncompressed; a compressed block is refused.  The crc is the C++
  of ``utils/crc32c.py``.
- A V1 checkpoint (slim's released checkpoints, e.g. ``inception_v3.ckpt``)
  is one table per shard file (``model.ckpt``, or ``model.ckpt-00000-of-
  00002`` and its siblings): the empty key holds a ``SavedTensorSlices``
  whose ``meta`` names each tensor's shape, dtype and slices; every other
  entry is a ``SavedTensorSlices`` whose ``data`` is one slice of one
  tensor, a ``TensorProto`` with its values in the typed ``*_val`` fields
  (or ``tensor_content``).  :class:`V1Reader` reassembles sliced
  (partitioned) variables into whole tensors, which ``tf.train.
  load_checkpoint`` refuses.  :func:`load_checkpoint` tells the formats
  apart as ``tf.train.load_checkpoint`` does: V2 where ``<prefix>.index``
  exists, else the V1 files the path matches as a glob pattern.
- ``load_slim_checkpoint`` / ``merge_pretrained`` / ``save_as_slim_checkpoint``
  are the reference's warm start (from either format) and export, in the
  port's state-dict names and layouts (``convert.to_port_leaf`` /
  ``to_jax_leaf``).
- :class:`CheckpointManager` keeps one directory per step under the
  checkpoint dir (written to a temporary name and renamed, so a crash never
  leaves half a checkpoint), holding a bundle of ``params/...``,
  ``batch_stats/...``, ``opt_state/...`` and ``step`` under the JAX tree's
  names, with a ``checkpoint`` state file so ``tf.train.load_checkpoint``
  reads the directory.  Nothing is pickled.
"""

from __future__ import annotations

import collections
import glob
import os
import re
import shutil
import struct
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tumblr_emotions_torch import convert
from tumblr_emotions_torch.utils import crc32c

# ---------------------------------------------------------------------------
# protobuf wire format (varint, length-delimited, fixed32)
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


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _field_varint(field: int, v: int) -> bytes:
    return _varint(field << 3) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of each field of a message: ints for varints
    and fixed32, bytes for length-delimited."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            v, pos = bytes(buf[pos:pos + n]), pos + n
        elif wire == 5:
            v, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif wire == 1:
            v, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, v


# ---------------------------------------------------------------------------
# LevelDB-format table (TF's tensorflow/core/lib/io/table)
# ---------------------------------------------------------------------------

BLOCK_SIZE = 256 * 1024
RESTART_INTERVAL = 16
TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_LEN = 48
_BLOCK_TRAILER = 5


class _BlockBuilder:
    def __init__(self, restart_interval: int):
        self.interval = restart_interval
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last_key = b""
        self.empty = True

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter < self.interval:
            n = min(len(self.last_key), len(key))
            while shared < n and self.last_key[shared] == key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        self.buf += (_varint(shared) + _varint(len(key) - shared) + _varint(len(value))
                     + key[shared:] + value)
        self.last_key = key
        self.counter += 1
        self.empty = False

    def size_estimate(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def finish(self) -> bytes:
        return bytes(self.buf) + struct.pack(f"<{len(self.restarts) + 1}I", *self.restarts,
                                             len(self.restarts))


def _shortest_separator(start: bytes, limit: bytes) -> bytes:
    """LevelDB's bytewise FindShortestSeparator."""
    n = min(len(start), len(limit))
    i = 0
    while i < n and start[i] == limit[i]:
        i += 1
    if i < n and start[i] < 0xFF and start[i] + 1 < limit[i]:
        return start[:i] + bytes([start[i] + 1])
    return start


def _short_successor(key: bytes) -> bytes:
    """LevelDB's bytewise FindShortSuccessor."""
    for i, b in enumerate(key):
        if b != 0xFF:
            return key[:i] + bytes([b + 1])
    return key


def _handle(offset: int, size: int) -> bytes:
    return _varint(offset) + _varint(size)


def write_table(f, items: Iterable[Tuple[bytes, bytes]]) -> None:
    """Write ``items`` (keys in strictly increasing bytewise order) as an
    uncompressed table, as TF's ``table::TableBuilder`` writes it."""
    offset = 0

    def write_block(block: _BlockBuilder) -> Tuple[int, int]:
        nonlocal offset
        contents = block.finish()
        crc = crc32c.mask(crc32c.extend(crc32c.value(contents), b"\x00"))
        f.write(contents)
        f.write(b"\x00" + struct.pack("<I", crc))
        handle = (offset, len(contents))
        offset += len(contents) + _BLOCK_TRAILER
        return handle

    data, index = _BlockBuilder(RESTART_INTERVAL), _BlockBuilder(1)
    pending: Optional[Tuple[int, int]] = None
    last = None
    for key, value in items:
        if last is not None and key <= last:
            raise ValueError(f"table keys out of order: {key!r} after {last!r}")
        if pending is not None:
            index.add(_shortest_separator(last, key), _handle(*pending))
            pending = None
        last = key
        data.add(key, value)
        if data.size_estimate() >= BLOCK_SIZE:
            pending = write_block(data)
            data = _BlockBuilder(RESTART_INTERVAL)
    if not data.empty:
        pending = write_block(data)
    meta = write_block(_BlockBuilder(RESTART_INTERVAL))
    if pending is not None:
        index.add(_short_successor(last), _handle(*pending))
    idx = write_block(index)
    footer = _handle(*meta) + _handle(*idx)
    f.write(footer + b"\x00" * (40 - len(footer)) + struct.pack("<Q", TABLE_MAGIC))


def _read_block(buf: bytes, offset: int, size: int) -> List[Tuple[bytes, bytes]]:
    if offset + size + _BLOCK_TRAILER > len(buf):
        raise IOError(f"table block at offset {offset}: beyond the end of the file")
    contents = buf[offset:offset + size]
    kind = buf[offset + size]
    (stored,) = struct.unpack_from("<I", buf, offset + size + 1)
    if crc32c.unmask(stored) != crc32c.extend(crc32c.value(contents), bytes([kind])):
        raise IOError(f"table block at offset {offset}: crc mismatch")
    if kind != 0:
        raise ValueError(f"table block at offset {offset} is compressed (type {kind}); "
                         "only uncompressed tables (as TF writes them) are read")
    (n_restarts,) = struct.unpack_from("<I", contents, len(contents) - 4)
    end = len(contents) - 4 * (n_restarts + 1)
    out, pos, key = [], 0, b""
    while pos < end:
        shared, pos = _read_varint(contents, pos)
        non_shared, pos = _read_varint(contents, pos)
        vlen, pos = _read_varint(contents, pos)
        key = key[:shared] + contents[pos:pos + non_shared]
        pos += non_shared
        out.append((key, contents[pos:pos + vlen]))
        pos += vlen
    return out


def read_table(buf: bytes) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of a table file's bytes, in key order."""
    if len(buf) < FOOTER_LEN or struct.unpack_from("<Q", buf, len(buf) - 8)[0] != TABLE_MAGIC:
        raise IOError("not a table file (bad footer magic)")
    footer = buf[len(buf) - FOOTER_LEN:]
    _, pos = _read_varint(footer, 0)
    _, pos = _read_varint(footer, pos)              # the (empty) metaindex block
    off, pos = _read_varint(footer, pos)
    size, pos = _read_varint(footer, pos)
    out = []
    for _, handle in _read_block(buf, off, size):
        boff, p = _read_varint(handle, 0)
        bsize, _ = _read_varint(handle, p)
        out.extend(_read_block(buf, boff, bsize))
    return out


# ---------------------------------------------------------------------------
# Tensor bundle
# ---------------------------------------------------------------------------

# TF DataType enum values (types.proto).
_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3,
           np.dtype(np.uint8): 4, np.dtype(np.int16): 5, np.dtype(np.int8): 6,
           np.dtype(np.int64): 9, np.dtype(np.bool_): 10, np.dtype(np.uint16): 17,
           np.dtype(np.float16): 19, np.dtype(np.uint32): 22, np.dtype(np.uint64): 23}
_NP_OF = {v: k for k, v in _DTYPES.items()}
DATA_SUFFIX = ".data-00000-of-00001"
STATE_FILE = "checkpoint"

Entry = collections.namedtuple("Entry", "dtype shape shard offset size crc")


def _header() -> bytes:
    # num_shards 1, little endian (0, omitted), version { producer: 1 }
    return _field_varint(1, 1) + _field_bytes(3, _field_varint(1, 1))


def _entry(dtype: int, shape: Sequence[int], offset: int, size: int, crc: int) -> bytes:
    dims = b"".join(_field_bytes(2, _field_varint(1, d) if d else b"") for d in shape)
    out = _field_varint(1, dtype) + _field_bytes(2, dims)
    if offset:
        out += _field_varint(4, offset)
    if size:
        out += _field_varint(5, size)
    return out + b"\x35" + struct.pack("<I", crc)


def _parse_entry(name: str, value: bytes) -> Entry:
    e = {"dtype": 0, "shape": (), "shard": 0, "offset": 0, "size": 0, "crc": None}
    for field, v in _fields(value):
        if field == 1:
            e["dtype"] = v
        elif field == 2:
            dims = []
            for f2, dim in _fields(v):
                if f2 == 2:
                    dims.append(next((s for f3, s in _fields(dim) if f3 == 1), 0))
                elif f2 == 3 and v:
                    raise ValueError(f"{name}: tensor of unknown rank")
            e["shape"] = tuple(dims)
        elif field == 3:
            e["shard"] = v
        elif field == 4:
            e["offset"] = v
        elif field == 5:
            e["size"] = v
        elif field == 6:
            e["crc"] = v
        elif field == 7:
            raise ValueError(f"{name}: partitioned (sliced) variables are not read")
    return Entry(**e)


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> int:
    """Write ``tensors`` ({name: array}) as the tensor bundle ``prefix``
    (``.index`` and one data shard); returns the data bytes written."""
    names = sorted(tensors, key=lambda n: n.encode())
    entries = [(b"", _header())]
    offset = 0
    with open(prefix + DATA_SUFFIX, "wb") as f:
        for name in names:
            arr = np.asarray(tensors[name], order="C")
            if arr.dtype not in _DTYPES:
                raise ValueError(f"{name}: dtype {arr.dtype} has no tensor-bundle type")
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            f.write(arr.reshape(-1).view(np.uint8).data)
            entries.append((name.encode(), _entry(_DTYPES[arr.dtype], arr.shape, offset,
                                                  arr.nbytes, crc32c.masked(arr.reshape(-1)))))
            offset += arr.nbytes
    with open(prefix + ".index", "wb") as f:
        write_table(f, entries)
    return offset


def _write_state_file(directory: str, name: str) -> None:
    with open(os.path.join(directory, STATE_FILE), "w") as f:
        f.write(f'model_checkpoint_path: "{name}"\nall_model_checkpoint_paths: "{name}"\n')


def resolve_prefix(path: str) -> str:
    """A checkpoint's prefix from a prefix, a V2 bundle's ``.index`` file or
    a directory holding a ``checkpoint`` state file (as
    ``tf.train.load_checkpoint``): a V2 bundle's where ``<prefix>.index``
    exists, else a V1 file pattern that matches at least one file."""
    if os.path.isdir(path):
        state = os.path.join(path, STATE_FILE)
        if not os.path.exists(state):
            raise FileNotFoundError(f"{path}: no '{STATE_FILE}' file in the directory")
        m = re.search(r'model_checkpoint_path:\s*"([^"]*)"', open(state).read())
        if m is None:
            raise ValueError(f"{state}: no model_checkpoint_path")
        p = m.group(1)
        return p if os.path.isabs(p) else os.path.join(path, p)
    if path.endswith(".index"):
        path = path[:-len(".index")]
    if not os.path.exists(path + ".index") and not glob.glob(path):
        raise FileNotFoundError(f"no checkpoint at {path}: neither a V2 bundle "
                                f"({path}.index) nor V1 files matching it")
    return path


def load_checkpoint(path: str):
    """A reader of the checkpoint at ``path`` (:func:`resolve_prefix`):
    :class:`BundleReader` for a V2 bundle, :class:`V1Reader` for V1 files,
    chosen as ``tf.train.load_checkpoint`` chooses."""
    prefix = resolve_prefix(path)
    return BundleReader(prefix) if os.path.exists(prefix + ".index") else V1Reader(prefix)


class BundleReader:
    """Reads a tensor bundle (the counterpart of ``tf.train.load_checkpoint``)."""

    def __init__(self, path: str):
        self.prefix = resolve_prefix(path)
        if not os.path.exists(self.prefix + ".index"):
            raise FileNotFoundError(f"no tensor bundle at {self.prefix} ({self.prefix}.index "
                                    "missing; load_checkpoint reads V1 files)")
        with open(self.prefix + ".index", "rb") as f:
            table = read_table(f.read())
        if not table or table[0][0] != b"":
            raise IOError(f"{self.prefix}.index: no bundle header")
        header = dict(_fields(table[0][1]))
        self.num_shards = header.get(1, 1)
        if header.get(2, 0) != 0:
            raise ValueError(f"{self.prefix}: a big-endian bundle is not read")
        self.entries = {k.decode(): _parse_entry(k.decode(), v) for k, v in table[1:]}

    def keys(self) -> List[str]:
        return list(self.entries)

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: list(e.shape) for k, e in self.entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries.get(name)
        if e is None:
            raise KeyError(f"{name} not in {self.prefix}")
        if e.dtype not in _NP_OF:
            raise ValueError(f"{name}: TF dtype {e.dtype} is not read")
        path = f"{self.prefix}.data-{e.shard:05d}-of-{self.num_shards:05d}"
        buf = bytearray(e.size)
        with open(path, "rb") as f:
            f.seek(e.offset)
            if f.readinto(buf) != e.size:
                raise IOError(f"{path}: truncated data for {name}")
        if e.crc is not None and crc32c.masked(buf) != e.crc:
            raise IOError(f"{path}: crc mismatch for {name}")
        return np.frombuffer(buf, _NP_OF[e.dtype].newbyteorder("<")).astype(
            _NP_OF[e.dtype], copy=False).reshape(e.shape)


# ---------------------------------------------------------------------------
# V1 checkpoints (tensorflow/core/util/saved_tensor_slice.proto)
# ---------------------------------------------------------------------------

# TF dtype -> the TensorProto field its values are saved in by the V1 writer
# (saved_tensor_slice_util.h) and how that field is encoded.
_V1_FIELDS = {1: (5, "<f4"), 2: (6, "<f8"), 3: (7, "varint"), 4: (7, "varint"),
              5: (7, "varint"), 6: (7, "varint"), 9: (10, "varint"), 10: (11, "varint"),
              17: (7, "varint"), 19: (13, "varint")}
_V1Slice = collections.namedtuple("_V1Slice", "extents data")


def _v1_extents(msg: bytes) -> Tuple[Tuple[int, Optional[int]], ...]:
    """A TensorSliceProto's extents, ``(start, length)`` each; a length of
    None spans the whole dimension."""
    out = []
    for field, ext in _fields(msg):
        if field == 1:
            e = dict(_fields(ext))
            out.append((_signed(e.get(1, 0)), _signed(e[2]) if 2 in e else None))
    return tuple(out)


def _signed(v: int) -> int:
    """A varint read as a two's-complement int64."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _v1_values(name: str, dtype: int, proto: bytes) -> np.ndarray:
    """The flat values of a V1 slice's TensorProto."""
    if dtype not in _V1_FIELDS:
        raise ValueError(f"{name}: TF dtype {dtype} is not read from a V1 checkpoint")
    want, enc = _V1_FIELDS[dtype]
    np_dtype = _NP_OF[dtype]
    content, vals = None, []
    for field, v in _fields(proto):
        if field == 4:
            content = v
        elif field == want:
            if isinstance(v, bytes) and enc != "varint":      # packed fixed-width
                vals.append(np.frombuffer(v, enc))
            elif isinstance(v, bytes):                          # packed varints
                pos, packed = 0, []
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    packed.append(_signed(x))
                vals.append(np.asarray(packed, np.int64))
            else:                                               # one unpacked value
                vals.append(np.asarray([struct.unpack("<f", struct.pack("<I", v))[0]
                                        if enc == "<f4" else _signed(v)]))
    if content is not None:
        return np.frombuffer(content, np_dtype.newbyteorder("<")).astype(np_dtype)
    flat = np.concatenate(vals) if vals else np.zeros(0, np_dtype)
    if dtype == 19:                     # half: the bits, in an int
        return flat.astype(np.uint16).view(np.float16)
    return flat.astype(np_dtype)


class V1Reader:
    """Reads a TF V1 checkpoint: every file ``pattern`` matches (one, or
    the shards of a sharded save), with the interface of
    :class:`BundleReader`."""

    def __init__(self, pattern: str):
        self.prefix = pattern
        files = sorted(glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no V1 checkpoint files match {pattern}")
        self.meta: Dict[str, Tuple[Tuple[int, ...], int, int]] = {}
        self.slices: Dict[str, List[_V1Slice]] = collections.defaultdict(list)
        for path in files:
            with open(path, "rb") as f:
                table = read_table(f.read())
            for key, value in table:
                for field, msg in _fields(value):
                    if field == 1 and key == b"":
                        self._read_meta(msg)
                    elif field == 2:
                        s = dict(_fields(msg))
                        self.slices[s[1].decode()].append(
                            _V1Slice(_v1_extents(s.get(2, b"")), s.get(3, b"")))

    def _read_meta(self, msg: bytes) -> None:
        """A shard's ``SavedTensorSliceMeta``: each tensor's shape, dtype
        and how many slices this shard lists (summed over the shards)."""
        for field, tensor in _fields(msg):
            if field != 1:
                continue
            t = dict(_fields(tensor))
            name = t[1].decode()
            dims = [next((s for f3, s in _fields(d) if f3 == 1), 0)
                    for f2, d in _fields(t.get(2, b"")) if f2 == 2]
            n_slices = sum(1 for f, _ in _fields(tensor) if f == 4)
            self.meta[name] = (tuple(dims), t.get(3, 0),
                               self.meta.get(name, ((), 0, 0))[2] + n_slices)

    def keys(self) -> List[str]:
        return list(self.meta)

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: list(m[0]) for k, m in self.meta.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self.meta:
            raise KeyError(f"{name} not in {self.prefix}")
        shape, dtype, n_slices = self.meta[name]
        if dtype not in _NP_OF:
            raise ValueError(f"{name}: TF dtype {dtype} is not read")
        parts = self.slices.get(name, [])
        if len(parts) != n_slices:
            raise IOError(f"{self.prefix}: {name} has {len(parts)} of its {n_slices} slices")
        out = np.zeros(shape, _NP_OF[dtype])
        covered = np.zeros(shape, bool)
        for part in parts:
            ext = part.extents or ((0, None),) * len(shape)
            if len(ext) != len(shape):
                raise ValueError(f"{name}: a slice of rank {len(ext)} in a tensor of rank "
                                 f"{len(shape)}")
            region = tuple(slice(0, d) if n is None else slice(a, a + n)
                           for (a, n), d in zip(ext, shape))
            vals = _v1_values(name, dtype, part.data)
            if vals.size != covered[region].size or covered[region].any():
                raise ValueError(f"{name}: a slice of {vals.size} values does not fit "
                                 f"{region} or overlaps another")
            out[region] = vals.reshape(covered[region].shape)
            covered[region] = True
        if not covered.all():
            raise IOError(f"{self.prefix}: {name} is not covered by its slices")
        return out


# ---------------------------------------------------------------------------
# slim warm start and export (the reference's functions, in port names)
# ---------------------------------------------------------------------------

# Optimizer slot / bookkeeping variables to ignore in slim checkpoints.
_SKIP_SUBSTRINGS = ("RMSProp", "Momentum", "Adam", "ExponentialMovingAverage",
                    "global_step", "beta1_power", "beta2_power")
_STAT_LEAVES = ("moving_mean", "moving_variance")


def load_slim_checkpoint(ckpt_path: str, root_scope: str = "InceptionV3",
                         exclude_scopes: Sequence[str] = ()) -> Dict[str, Dict]:
    """Read a TF name-based checkpoint -> ``{"params": {name: tensor},
    "batch_stats": {name: tensor}}``, names relative to ``root_scope``
    (``Conv2d_1a_3x3/weights``, ...), tensors in the port's layout (conv
    weights OIHW).

    Keys outside ``root_scope`` and optimizer slots are skipped; so are
    scopes in ``exclude_scopes``, matched on path-segment boundaries (as
    slim's ``get_variables_to_restore(exclude=...)``: excluding ``Logits``
    keeps ``AuxLogits``).  Reads V2 bundles and V1 checkpoints
    (:func:`load_checkpoint`)."""
    reader = load_checkpoint(ckpt_path)
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    prefix = root_scope + "/"
    for key in sorted(reader.get_variable_to_shape_map()):
        if not key.startswith(prefix):
            continue
        if any(s in key for s in _SKIP_SUBSTRINGS):
            continue
        rel = key[len(prefix):]
        if any(rel == ex or rel.startswith(ex + "/") or f"/{ex}/" in rel
               or rel.endswith("/" + ex) for ex in exclude_scopes):
            continue
        path = tuple(rel.split("/"))
        col = "batch_stats" if path[-1] in _STAT_LEAVES else "params"
        out[col][rel] = convert.to_port_leaf(path, reader.get_tensor(key))
    return out


def is_stat(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in _STAT_LEAVES


def merge_pretrained(state: Dict[str, torch.Tensor], pretrained: Dict[str, Dict],
                     subtree: Optional[str] = None,
                     require_all_used: bool = True) -> Dict[str, torch.Tensor]:
    """A copy of the port state dict ``state`` with the values of
    ``pretrained`` (from :func:`load_slim_checkpoint`) put in.

    ``subtree``: the scope the pretrained names sit under in the model (e.g.
    ``"InceptionV3"`` for the joint model's tower).  Names match the
    state-dict keys with ``.`` read as ``/``.  A shape mismatch raises; with
    ``require_all_used`` a pretrained leaf that matches nothing raises too
    (naming drift is caught, not ignored)."""
    out = dict(state)
    by_name = {k.replace(".", "/"): k for k in state}
    for col in ("params", "batch_stats"):
        missing = []
        for name, value in pretrained.get(col, {}).items():
            full = f"{subtree}/{name}" if subtree else name
            key = by_name.get(full)
            if key is None or is_stat(key) != (col == "batch_stats"):
                missing.append(full)
                continue
            if tuple(state[key].shape) != tuple(value.shape):
                raise ValueError(f"{col}/{full}: checkpoint shape {tuple(value.shape)} != "
                                 f"model shape {tuple(state[key].shape)}")
            out[key] = torch.as_tensor(value).to(dtype=state[key].dtype,
                                                 device=state[key].device)
        if require_all_used and missing:
            raise ValueError(
                f"{len(missing)} pretrained {col} leaves matched no model "
                f"parameter (e.g. {missing[0]}); wrong model or root scope?")
    return out


def save_as_slim_checkpoint(state: Dict[str, torch.Tensor], ckpt_path: str,
                            root_scope: str = "InceptionV3") -> str:
    """Write a port state dict as a TF name-based checkpoint under
    ``root_scope`` (conv weights HWIO), the inverse of the warm start, and
    the ``checkpoint`` state file beside it; returns ``ckpt_path``."""
    tensors = {f"{root_scope}/{k.replace('.', '/')}": convert.to_jax_leaf(k, t)
               for k, t in state.items()}
    directory = os.path.dirname(os.path.abspath(ckpt_path))
    os.makedirs(directory, exist_ok=True)
    write_bundle(ckpt_path, tensors)
    _write_state_file(directory, os.path.basename(ckpt_path))
    return ckpt_path


# ---------------------------------------------------------------------------
# The optimizer state under the optax tree's names
# ---------------------------------------------------------------------------

EmptyState = collections.namedtuple("EmptyState", [])
MaskedNode = collections.namedtuple("MaskedNode", [])
ScaleByRmsState = collections.namedtuple("ScaleByRmsState", ["nu"])
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState", ["count"])
TraceState = collections.namedtuple("TraceState", ["trace"])
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
MaskedState = collections.namedtuple("MaskedState", ["inner_state"])
PartitionState = collections.namedtuple("PartitionState", ["inner_states"])

_PLACEHOLDER = np.zeros(0, np.float32)


def _nest(keys: Iterable[str], leaf) -> Dict:
    tree: Dict = {}
    for k in keys:
        node = tree
        *levels, last = k.split(".")
        for p in levels:
            node = node.setdefault(p, {})
        node[last] = leaf(k)
    return tree


def optax_template(t, param_keys: Sequence[str], trainable: Sequence[str]):
    """The shape of the reference trainer's optax state (``make_optimizer``)
    for the port's ``TrainConfig`` ``t``, with named tuples of optax's names
    and fields: the tree ``convert.opt_state_to_optax`` fills."""
    on = set(trainable)
    moments = _nest(param_keys, lambda k: _PLACEHOLDER if k in on or not t.trainable_scopes
                    else MaskedNode())
    lr = ScaleByScheduleState(np.int32(0))   # the reference's lr is always a schedule
    if t.optimizer == "rmsprop":
        inner = (ScaleByRmsState(moments), lr, TraceState(moments))
    elif t.optimizer == "adam":
        inner = (ScaleByAdamState(np.int32(0), moments, moments), lr)
    else:
        inner = (TraceState(moments) if t.momentum else EmptyState(), lr)
    if t.grad_clip_norm > 0:
        inner = (EmptyState(), inner)
    if t.trainable_scopes:
        inner = PartitionState({"train": MaskedState(inner),
                                "freeze": MaskedState(EmptyState())})
    return inner


def flatten_tree(node, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, object]]:
    """("a/0/nu/...", leaf) of a tree of named tuples (by field), tuples (by
    index) and dicts (by sorted key), as jax's key paths name them."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            yield from flatten_tree(getattr(node, f), prefix + (f,))
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield from flatten_tree(v, prefix + (str(i),))
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from flatten_tree(node[k], prefix + (k,))
    else:
        yield "/".join(prefix), node


def fill_tree(node, value, prefix: Tuple[str, ...] = ()):
    """``node`` with each leaf replaced by ``value(its flattened name)``."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[fill_tree(getattr(node, f), value, prefix + (f,))
                            for f in node._fields])
    if isinstance(node, (tuple, list)):
        return type(node)(fill_tree(v, value, prefix + (str(i),)) for i, v in enumerate(node))
    if isinstance(node, dict):
        return {k: fill_tree(v, value, prefix + (k,)) for k, v in node.items()}
    return value("/".join(prefix))


# ---------------------------------------------------------------------------
# Step checkpoints
# ---------------------------------------------------------------------------

class CheckpointManager:
    """One tensor bundle per step, ``<directory>/<step>/checkpoint.*``,
    keeping the newest ``max_to_keep`` steps.  A step is written under a
    temporary name and renamed into place, so a crash leaves either the
    whole checkpoint or none."""

    PREFIX = "checkpoint"

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, self.PREFIX + ".index")):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tensors: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Write ``tensors`` as step ``step``; returns its data ``bytes`` and
        the ``seconds`` the write took."""
        t0 = time.perf_counter()
        final = self.step_dir(step)
        tmp = os.path.join(self.directory, f".{int(step)}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        nbytes = write_bundle(os.path.join(tmp, self.PREFIX), tensors)
        _write_state_file(tmp, self.PREFIX)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for s in self.all_steps()[:-self.max_to_keep or None]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
        return {"bytes": nbytes, "seconds": time.perf_counter() - t0}

    def reader(self, step: int) -> BundleReader:
        return BundleReader(os.path.join(self.step_dir(step), self.PREFIX))
