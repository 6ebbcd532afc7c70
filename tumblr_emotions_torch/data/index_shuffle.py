"""grain's ``index_shuffle``: the permutation behind ``MapDataset.shuffle``.

The reference's record order comes from ``grain.MapDataset.shuffle``, which
maps position ``i`` of epoch ``e`` to record ``index_shuffle(i,
max_index=n-1, seed=(seed+e) % 2**32, rounds=4)``.  grain computes it in
C++ (``grain/_src/python/experimental/index_shuffle``); the pure-Python
fallback shipped beside it is a different (md5) permutation.  This module
reproduces the C++ function, which is a Simon block cipher with cycle
walking:

- the block is ``b = max(16, even_up(ceil(log2(max_index))))`` bits (the
  log of ``max_index`` in double precision, as ``std::log2`` takes it), two
  halves of ``w = b/2`` bits, the high half ``x`` and the low half ``y``;
- the round keys are ``rounds`` words of ``std::seed_seq{seed}.generate``
  (the C++ standard's algorithm, written out below), each cut to ``w`` bits;
- each pair of rounds is ``x ^= f(y) ^ k[i]; y ^= f(x) ^ k[i+1]`` with
  ``f(z) = rotl(z,2) ^ (rotl(z,1) & rotl(z,8))`` on ``w`` bits;
- the cipher is applied again while the result exceeds ``max_index``, so
  the map is a permutation of ``[0, max_index]`` (``max_index == 0`` gives 0).

:func:`index_shuffle` is the scalar function; :func:`shuffled_indices` maps
an array of positions with numpy at once.
"""

from __future__ import annotations

import functools
import math
from typing import List

import numpy as np

_M32 = 0xFFFFFFFF
MIN_BLOCK_BITS = 16
TABLE_BITS = 20        # blocks up to this many bits are walked through a table


def seed_seq_generate(seeds: List[int], n: int) -> List[int]:
    """``std::seed_seq(seeds).generate`` into ``n`` 32-bit words ([rand.util.seedseq])."""
    v, s = [x & _M32 for x in seeds], len(seeds)
    b = [0x8B8B8B8B] * n
    if n == 0:
        return b
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def T(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * T(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        if k == 0:
            r2 = r1 + s
        elif k <= s:
            r2 = r1 + k % n + v[k - 1]
        else:
            r2 = r1 + k % n
        r2 &= _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * T((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _half_bits(max_index: int) -> int:
    bits = int(math.ceil(math.log2(float(max_index))))
    bits += bits % 2
    return max(bits, MIN_BLOCK_BITS) // 2


def _check(max_index: int, seed: int, rounds: int) -> None:
    if max_index < 0 or max_index >= 1 << 64:
        raise ValueError(f"max_index {max_index} out of the uint64 range")
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    if seed < 0 or seed > _M32:
        raise ValueError(f"seed must be a uint32, got {seed}")


def _simon(x, y, keys, w: int, rot):
    """The Simon rounds on half blocks (Python ints or uint64 arrays)."""
    for i in range(0, len(keys), 2):
        x = x ^ rot(y) ^ keys[i]
        y = y ^ rot(x) ^ keys[i + 1]
    return x, y


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = 4) -> int:
    """The position of ``index`` under grain's permutation of ``[0, max_index]``."""
    _check(max_index, seed, rounds)
    if max_index == 0:
        return 0
    if max_index < 1 << 62:
        return int(shuffled_indices([index], max_index, seed, rounds)[0])
    w = _half_bits(max_index)
    mask = (1 << w) - 1
    keys = [k & mask for k in seed_seq_generate([seed], rounds)]

    def rotl(z, d):
        return ((z << d) & mask) | (z >> (w - d))

    def f(z):
        return rotl(z, 2) ^ (rotl(z, 1) & rotl(z, 8))

    v = index
    while True:
        x, y = _simon((v >> w) & mask, v & mask, keys, w, f)
        v = (x << w) | y
        if v <= max_index:
            return v


@functools.lru_cache(maxsize=4)
def _walked(w: int, seed: int, rounds: int, max_index: int) -> np.ndarray:
    """The walked cipher of every value of a ``2w``-bit block: the first of
    ``c(v), c(c(v)), ...`` that is at most ``max_index``, found by pointer
    doubling over the block's cipher table ``c`` (a walk of thousands of
    steps takes ~log2 of that); values whose cycle never comes back to
    ``[0, max_index]`` are left on a value above it, never looked up."""
    mask, sw = np.uint64((1 << w) - 1), np.uint64(w)
    keys = [np.uint64(k & ((1 << w) - 1)) for k in seed_seq_generate([seed], rounds)]
    dom = np.arange(1 << (2 * w), dtype=np.uint64)
    x, y = _simon((dom >> sw) & mask, dom & mask, keys, w, _round_fn(w, mask))
    jump = ((x << sw) | y).astype(np.int64)
    done = jump <= max_index
    for _ in range(2 * w + 1):
        todo = np.nonzero(~done)[0]
        if done[:max_index + 1].all():
            break
        nxt = jump[todo]
        jump[todo] = jump[nxt]
        done[todo] = done[nxt]
    jump.flags.writeable = False
    return jump


def _round_fn(w: int, mask):
    """Simon's ``f`` on ``w``-bit uint64 arrays."""
    def rotl(z, d):
        return ((z << np.uint64(d)) & mask) | (z >> np.uint64(w - d))

    return lambda z: rotl(z, 2) ^ (rotl(z, 1) & rotl(z, 8))


def shuffled_indices(indices, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """:func:`index_shuffle` of every entry of ``indices`` (int64 array), with numpy."""
    _check(max_index, seed, rounds)
    idx = np.asarray(indices, np.int64)
    if max_index == 0:
        return np.zeros_like(idx)
    if max_index >= 1 << 62:
        return np.array([index_shuffle(int(i), max_index, seed, rounds) for i in idx.ravel()],
                        np.int64).reshape(idx.shape)
    w = _half_bits(max_index)
    mask = np.uint64((1 << w) - 1)
    keys = [np.uint64(k & ((1 << w) - 1)) for k in seed_seq_generate([seed], rounds)]
    sw = np.uint64(w)
    f = _round_fn(w, mask)
    v = idx.astype(np.uint64).ravel()
    if 2 * w <= TABLE_BITS and (1 << 2 * w) > 64 * (max_index + 1):
        # A small block over few records: a block of 2**16 over 23 records
        # takes thousands of steps to walk.
        return _walked(w, seed, rounds, max_index)[v.astype(np.int64)].reshape(idx.shape)
    out = np.empty_like(v)
    todo = np.arange(v.size)
    while todo.size:
        x, y = _simon((v[todo] >> sw) & mask, v[todo] & mask, keys, w, f)
        v[todo] = (x << sw) | y
        done = v[todo] <= np.uint64(max_index)
        out[todo[done]] = v[todo[done]]
        todo = todo[~done]
    return out.astype(np.int64).reshape(idx.shape)
