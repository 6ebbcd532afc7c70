"""Small CSV post dataset: the scraped-posts CSV format.

Port of ``tumblr_emotions_tpu/data/csv_dataset.py``: the scraper writes post
text and metadata as CSV rows; the text-only model trains straight off such
a CSV (``text_batches`` shuffles with numpy's ``RandomState(seed)``, as the
reference does, so both give the same batches, and its iterator is
resumable: a stopped run resumes at the exact batch).  Columns
(header required): ``text`` and one of ``label`` (int) / ``emotion`` (name);
optional ``id`` and ``image`` (path to the downloaded image file).
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from tumblr_emotions_torch.config import EMOTIONS
from tumblr_emotions_torch.data.vocab import Vocabulary


@dataclasses.dataclass
class Post:
    text: str
    label: int
    post_id: str = ""
    image_path: str = ""


def load_posts_csv(path: str,
                   emotions: Sequence[str] = EMOTIONS) -> List[Post]:
    label_of = {name: i for i, name in enumerate(emotions)}
    posts: List[Post] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            if "label" in row and row["label"] not in (None, ""):
                label = int(row["label"])
            elif "emotion" in row:
                emotion = row["emotion"].strip().lstrip("#").lower()
                if emotion not in label_of:
                    continue
                label = label_of[emotion]
            else:
                raise ValueError(f"{path}: need a 'label' or 'emotion' column")
            posts.append(Post(text=row.get("text", ""), label=label,
                              post_id=row.get("id", ""),
                              image_path=row.get("image", "")))
    return posts


class TextBatches:
    """The batches ``text_batches`` yields, as a resumable iterator:
    ``get_state()`` is ``{"epoch", "index"}`` of the next batch (the epoch
    and its first row in the epoch's order), and ``set_state`` resumes
    there, replaying the earlier epochs' permutations of the seeded
    ``RandomState`` so every later batch is the one a run that never
    stopped gets."""

    def __init__(self, posts: Sequence[Post], vocab: Vocabulary, batch_size: int,
                 max_len: int, shuffle: bool = True, seed: int = 0,
                 num_epochs: Optional[int] = None, drop_remainder: bool = True):
        self.tokens, self.lengths = vocab.encode_batch([p.text for p in posts], max_len)
        self.labels = np.asarray([p.label for p in posts], np.int32)
        self.n = len(posts)
        self.batch_size, self.shuffle, self.seed = batch_size, shuffle, seed
        self.num_epochs, self.drop_remainder = num_epochs, drop_remainder
        stop = self.n - batch_size + 1 if drop_remainder else self.n
        if num_epochs is None and stop <= 0:
            raise ValueError(f"{self.n} posts give no batch of {batch_size}: an endless "
                             "run would never yield one")
        self.set_state({"epoch": 0, "index": 0})

    def get_state(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "index": self._start}

    def set_state(self, state: Dict[str, int]) -> None:
        self._rng = np.random.RandomState(self.seed)
        if self.shuffle:
            for _ in range(int(state["epoch"])):
                self._rng.permutation(self.n)
        self._epoch, self._start, self._order = int(state["epoch"]), int(state["index"]), None

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        stop = self.n - bs + 1 if self.drop_remainder else self.n
        while self.num_epochs is None or self._epoch < self.num_epochs:
            if self._order is None:
                self._order = (self._rng.permutation(self.n) if self.shuffle
                               else np.arange(self.n))
            if self._start < max(stop, 0):
                idx = self._order[self._start:self._start + bs]
                self._start += bs
                weight = np.ones((len(idx),), np.int32)
                if len(idx) < bs:
                    pad = bs - len(idx)
                    idx = np.concatenate([idx, np.zeros((pad,), idx.dtype)])
                    weight = np.concatenate([weight, np.zeros((pad,), np.int32)])
                return {"tokens": self.tokens[idx], "lengths": self.lengths[idx],
                        "label": self.labels[idx], "weight": weight}
            self._epoch, self._start, self._order = self._epoch + 1, 0, None
        raise StopIteration


def text_batches(posts: Sequence[Post], vocab: Vocabulary, batch_size: int,
                 max_len: int, shuffle: bool = True, seed: int = 0,
                 num_epochs: Optional[int] = None,
                 drop_remainder: bool = True) -> TextBatches:
    """Epochs of {tokens, lengths, label, weight} numpy batches, each epoch
    in the order of ``RandomState(seed)``'s next permutation (the
    reference's batches), from a resumable iterator (:class:`TextBatches`).

    Static shapes: every batch has exactly ``batch_size`` rows.  With
    ``drop_remainder=False`` the final partial batch is padded and its
    padding rows carry ``weight == 0`` (the eval loop masks them out).
    """
    return TextBatches(posts, vocab, batch_size, max_len, shuffle, seed, num_epochs,
                       drop_remainder)
