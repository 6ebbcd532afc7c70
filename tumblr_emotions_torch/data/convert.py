"""Dataset converter: posts CSV + image files -> sharded TFRecords (or
ArrayRecords) + labels file + vocab.

Port of ``tumblr_emotions_tpu/data/convert.py``, whose output files it
writes byte for byte: for each CSV row
read the image bytes, build a tf.Example {image/encoded, image/format, text,
label, id}, round-robin into shards, and write the label file alongside.
Corrupt/missing images are skipped with a count (best-effort, like research
scrapers produce); the JPEG header is checked by the port's own decoder
(``data/jpeg.decode_size``).  Also emits train/valid splits by hash of post id so the
split is stable across re-runs.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, List, Sequence

from tumblr_emotions_torch.config import EMOTIONS
from tumblr_emotions_torch.data import jpeg as jpeg_lib
from tumblr_emotions_torch.data import records as records_lib
from tumblr_emotions_torch.data.csv_dataset import load_posts_csv
from tumblr_emotions_torch.data.vocab import build_vocabulary

log = logging.getLogger("tumblr_emotions_torch")


def _split_of(post_id: str, valid_fraction: float) -> str:
    h = int(hashlib.md5(post_id.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF
    return "validation" if h < valid_fraction else "train"


def convert(csv_path: str, images_dir: str, out_dir: str,
            num_shards: int = 5, valid_fraction: float = 0.1,
            emotions: Sequence[str] = EMOTIONS,
            vocab_size: int = 50_000, min_freq: int = 2,
            verify_decode: bool = True,
            record_format: str = "tfrecord") -> Dict[str, int]:
    """Returns {"train": n, "validation": n, "skipped": n}.

    ``record_format``: ``"tfrecord"`` or ``"arrayrecord"`` (the same Examples
    in the same shards, as ``.arrayrecord`` files)."""
    writers = {"tfrecord": records_lib.write_sharded_tfrecords,
               "arrayrecord": records_lib.write_sharded_arrayrecords}
    if record_format not in writers:
        raise ValueError(f"unknown record_format {record_format!r}")
    posts = load_posts_csv(csv_path, emotions=emotions)
    os.makedirs(out_dir, exist_ok=True)

    buckets: Dict[str, List[bytes]] = {"train": [], "validation": []}
    texts: List[str] = []
    skipped = 0
    for p in posts:
        # CSV "image" column, or the scraper's <id>.jpg convention when the
        # column is absent.
        img_path = p.image_path or (f"{p.post_id}.jpg" if p.post_id else "")
        if img_path and not os.path.isabs(img_path):
            img_path = os.path.join(images_dir, img_path)
        try:
            with open(img_path, "rb") as f:
                data = f.read()
            if verify_decode:
                jpeg_lib.decode_size(data)  # header sanity, cheap
        except (OSError, ValueError, TypeError):
            skipped += 1
            continue
        texts.append(p.text)
        ex = records_lib.post_to_example(data, p.text, p.label,
                                         post_id=p.post_id)
        buckets[_split_of(p.post_id or p.text, valid_fraction)].append(ex)

    for split, exs in buckets.items():
        if exs:
            writers[record_format](exs, out_dir, split, num_shards)
    with open(os.path.join(out_dir, "labels.txt"), "w") as f:
        for name in emotions:
            f.write(name + "\n")
    vocab = build_vocabulary(texts, max_size=vocab_size, min_freq=min_freq)
    vocab.save(os.path.join(out_dir, "vocab.txt"))

    counts = {k: len(v) for k, v in buckets.items()}
    counts["skipped"] = skipped
    log.info("converted: %s", counts)
    return counts
