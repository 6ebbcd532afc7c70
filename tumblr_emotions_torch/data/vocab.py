"""Tokenizer and vocabulary: post text -> fixed-length id sequences.

A copy of the pure-Python part of ``tumblr_emotions_tpu/data/vocab.py`` (the
port imports nothing of the JAX package): lowercase word tokenization, a
frequency-cutoff vocabulary with reserved PAD=0 and OOV=1 ids, and
pad/truncate to ``max_len`` with an explicit length, so the text branch sees
static shapes; and the pretrained-embedding loaders (GloVe or word2vec
text, or a ``.npy`` matrix).  :func:`synthetic_ids` makes seeded id batches
for runs on random weights.
"""

from __future__ import annotations

import collections
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD_TOKEN = "<pad>"
OOV_TOKEN = "<unk>"
PAD_ID = 0
OOV_ID = 1

# Letter/digit runs and apostrophes, lowercased.
_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> List[str]:
    """Lowercase word tokenizer; strips URLs and '#' from hashtags."""
    text = text.lower()
    text = re.sub(r"https?://\S+", " ", text)
    text = text.replace("#", " ")
    return _TOKEN_RE.findall(text)


@dataclass
class Vocabulary:
    """token <-> id mapping with reserved PAD=0 and OOV=1 ids."""

    token_to_id: Dict[str, int]
    id_to_token: List[str]

    @property
    def size(self) -> int:
        return len(self.id_to_token)

    def lookup(self, token: str) -> int:
        return self.token_to_id.get(token, OOV_ID)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, int]:
        """text -> (ids [max_len] int32, true length clipped to max_len)."""
        toks = tokenize(text)[:max_len]
        ids = np.full((max_len,), PAD_ID, np.int32)
        for i, t in enumerate(toks):
            ids[i] = self.lookup(t)
        return ids, len(toks)

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), max_len), PAD_ID, np.int32)
        lengths = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            ids[i], lengths[i] = self.encode(t, max_len)
        return ids, lengths

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for tok in self.id_to_token:
                f.write(tok + "\n")

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            toks = [line.rstrip("\n") for line in f]
        if toks[:2] != [PAD_TOKEN, OOV_TOKEN]:
            raise ValueError(
                f"{path} is not a vocab file (must start with {PAD_TOKEN}, {OOV_TOKEN})")
        return cls({t: i for i, t in enumerate(toks)}, toks)


def build_vocabulary(texts: Iterable[str], max_size: int = 50_000,
                     min_freq: int = 2) -> Vocabulary:
    """Frequency-cutoff vocabulary over tokenized texts, most frequent first."""
    counter: collections.Counter = collections.Counter()
    for text in texts:
        counter.update(tokenize(text))
    toks = [PAD_TOKEN, OOV_TOKEN]
    for tok, freq in counter.most_common():
        if freq < min_freq or len(toks) >= max_size:
            break
        toks.append(tok)
    return Vocabulary({t: i for i, t in enumerate(toks)}, toks)


def load_glove_embeddings(path: str, vocab: Vocabulary, embed_dim: int,
                          seed: int = 0, scale: float = 0.1) -> np.ndarray:
    """Load GloVe-format text vectors ("word v1 v2 ...") into a [V, D] matrix.

    Words present in the file get their pretrained vector; PAD gets zeros;
    every other row (OOV included) keeps a seeded random-normal init, the
    reference's embedding-matrix warm start.
    """
    rng = np.random.RandomState(seed)
    matrix = rng.normal(0.0, scale, size=(vocab.size, embed_dim)).astype(np.float32)
    matrix[PAD_ID] = 0.0
    with open(path, "rb") as f:
        for raw in f:
            parts = raw.rstrip(b"\n").split(b" ")
            # word2vec text format has a "count dim" header line; skip it.
            if len(parts) == 2 and parts[0].isdigit():
                continue
            word = parts[0].decode("utf-8", errors="ignore")
            idx = vocab.token_to_id.get(word)
            if idx is None or idx == PAD_ID:
                continue
            vec = np.asarray(parts[1:], dtype=np.float32)
            if vec.shape[0] != embed_dim:
                raise ValueError(
                    f"embedding dim mismatch: file has {vec.shape[0]}, want {embed_dim}")
            matrix[idx] = vec
    return matrix


def load_embeddings(path: str, vocab: Vocabulary, embed_dim: int,
                    seed: int = 0) -> np.ndarray:
    """Dispatch on file type: a .npy matrix (must be [V, D]) or GloVe text."""
    if path.endswith(".npy"):
        matrix = np.load(path).astype(np.float32)
        if matrix.shape != (vocab.size, embed_dim):
            raise ValueError(
                f"embedding matrix {matrix.shape} != ({vocab.size}, {embed_dim})")
        return matrix
    return load_glove_embeddings(path, vocab, embed_dim, seed=seed)


def synthetic_ids(rng: np.random.RandomState, batch: int, max_len: int, vocab_size: int
                  ) -> np.ndarray:
    """A seeded [batch, max_len] int32 id batch shaped as ``encode_batch``
    makes them: lengths from 0 to max_len (row 0 all pad, row 1 full when
    batch > 1), ids drawn from the non-reserved range, PAD past each
    length."""
    lengths = rng.randint(0, max_len + 1, batch)
    lengths[:2] = (0, max_len)[:batch]
    ids = rng.randint(OOV_ID + 1, vocab_size, (batch, max_len)).astype(np.int32)
    ids[np.arange(max_len)[None, :] >= lengths[:, None]] = PAD_ID
    return ids
