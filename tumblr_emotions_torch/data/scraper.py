"""Tumblr emotion-hashtag scraper.

The port's own copy of ``tumblr_emotions_tpu/data/scraper.py``: query the
Tumblr API per emotion hashtag (``pytumblr``), keep the posts that have
both a photo and a caption, write a posts CSV and download the images into
the layout ``cli convert-dataset`` reads (``--csv <out>/posts.csv
--images-dir <out>/images``).  The API client is injectable: any object
with a ``tagged(tag, before=...) -> list[post-dict]`` method (a pytumblr
client where the package and the network are present, a fake in the
tests), and so is the image fetch.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from tumblr_emotions_torch.config import EMOTIONS

log = logging.getLogger("tumblr_emotions_torch")


@dataclasses.dataclass
class ScrapedPost:
    post_id: str
    emotion: str
    text: str
    image_url: str
    timestamp: int


def make_pytumblr_client(consumer_key: str, consumer_secret: str = "",
                         oauth_token: str = "", oauth_secret: str = ""):
    """A pytumblr client; needs the ``pytumblr`` package (and the network
    to use it)."""
    try:
        import pytumblr  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "pytumblr is not installed in this environment; pass a custom "
            "client to scrape_emotion() instead") from e
    return pytumblr.TumblrRestClient(consumer_key, consumer_secret,
                                     oauth_token, oauth_secret)


def _extract(post: Dict, emotion: str) -> Optional[ScrapedPost]:
    """Keep photo posts that carry both an image and a caption/summary."""
    if post.get("type") != "photo":
        return None
    photos = post.get("photos") or []
    if not photos:
        return None
    url = (photos[0].get("original_size") or {}).get("url", "")
    text = post.get("caption") or post.get("summary") or ""
    # strip naive HTML from captions
    import re

    text = re.sub(r"<[^>]+>", " ", text).strip()
    if not url or not text:
        return None
    return ScrapedPost(post_id=str(post.get("id", "")), emotion=emotion,
                       text=text, image_url=url,
                       timestamp=int(post.get("timestamp", 0)))


def scrape_emotion(client, emotion: str, max_posts: int = 1000,
                   sleep_s: float = 0.0) -> List[ScrapedPost]:
    """Page backwards through client.tagged(emotion) like the reference."""
    posts: List[ScrapedPost] = []
    before: Optional[int] = None
    while len(posts) < max_posts:
        batch = client.tagged(emotion, before=before) if before is not None \
            else client.tagged(emotion)
        if not batch:
            break
        for raw in batch:
            sp = _extract(raw, emotion)
            if sp is not None:
                posts.append(sp)
                if len(posts) >= max_posts:
                    break
        before = int(batch[-1].get("timestamp", 0)) or None
        if before is None:
            break
        if sleep_s:
            time.sleep(sleep_s)
    return posts


def write_posts_csv(posts: Sequence[ScrapedPost], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["id", "emotion", "text", "image_url", "timestamp",
                           "image"])
        w.writeheader()
        for p in posts:
            image_rel = os.path.join(p.emotion, f"{p.post_id}.jpg")
            w.writerow({"id": p.post_id, "emotion": p.emotion, "text": p.text,
                        "image_url": p.image_url, "timestamp": p.timestamp,
                        "image": image_rel})


def download_images(posts: Sequence[ScrapedPost], out_dir: str,
                    fetch: Optional[Callable[[str], bytes]] = None) -> int:
    """Download each post's image to <out_dir>/<emotion>/<id>.jpg.

    ``fetch`` is injectable (tests use a fake); defaults to urllib (network).
    Corrupt/failed downloads are skipped with a warning, like the
    reference's best-effort scraper.
    """
    if fetch is None:
        from urllib.request import urlopen

        def fetch(url: str) -> bytes:  # pragma: no cover - needs network
            with urlopen(url, timeout=30) as r:
                return r.read()

    ok = 0
    for p in posts:
        dest = os.path.join(out_dir, p.emotion, f"{p.post_id}.jpg")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        try:
            data = fetch(p.image_url)
            with open(dest, "wb") as f:
                f.write(data)
            ok += 1
        except Exception as e:  # best-effort, like the reference
            log.warning("failed to fetch %s: %s", p.image_url, e)
    return ok


def scrape_all(client, emotions: Sequence[str] = EMOTIONS,
               max_posts_per_emotion: int = 1000, out_dir: str = ".",
               fetch: Optional[Callable[[str], bytes]] = None) -> str:
    """Full dataset build: scrape every emotion tag, write CSV + images."""
    all_posts: List[ScrapedPost] = []
    for emotion in emotions:
        got = scrape_emotion(client, emotion, max_posts_per_emotion)
        log.info("scraped %d posts for #%s", len(got), emotion)
        all_posts.extend(got)
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "posts.csv")
    write_posts_csv(all_posts, csv_path)
    download_images(all_posts, os.path.join(out_dir, "images"), fetch=fetch)
    return csv_path
