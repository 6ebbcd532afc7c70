"""The port's tooling commands against the JAX package's on the CPU: the
parity gate (goldens cross both packages), the circumplex analysis and its
report, ``cli analyze``, the scraper and its dataset layout, ``cli scrape``
and ``cli tune``."""

import contextlib
import csv
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from tumblr_emotions_tpu import analysis as janalysis
from tumblr_emotions_tpu import cli as jcli
from tumblr_emotions_tpu.data import convert as jconvert
from tumblr_emotions_tpu.data import scraper as jscraper
from tumblr_emotions_torch import analysis as tanalysis
from tumblr_emotions_torch import cli as tcli
from tumblr_emotions_torch.config import EMOTIONS
from tumblr_emotions_torch.data import convert as tconvert
from tumblr_emotions_torch.data import scraper as tscraper
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.utils import checkpoint as ck

FIXTURES = Path(__file__).parent / "data" / "jpeg"
# The parity gate's own budget (the reference's 1e-4 logit contract).
PARITY_TOL = 1e-4


def _run(main, argv, rc=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == rc
    return out.getvalue()


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

PARITY_FLAGS = ["--depth-multiplier", "0.25", "--min-depth", "8"]


@pytest.fixture(scope="module")
def slim_ckpt(tmp_path_factory):
    """A 7-class slim checkpoint with an aux head at depth 0.25 (min depth
    8) on seeded weights, and two preprocessed 139 px images."""
    d = tmp_path_factory.mktemp("parity")
    model = InceptionV3(num_classes=7, depth_multiplier=0.25, min_depth=8, image_size=139,
                        device="meta")
    path = ck.save_as_slim_checkpoint(init_state(model, 3), str(d / "small.ckpt"))
    images = str(d / "imgs.npz")
    np.savez(images, images=np.random.RandomState(0).uniform(-1, 1, (2, 139, 139, 3))
             .astype(np.float32))
    return path, images, d


def test_parity_goldens_cross_both_packages(slim_ckpt):
    """Goldens the JAX ``parity --save-goldens`` writes pass the port's gate
    on the CPU, and the port's pass the JAX gate, within the 1e-4 budget."""
    ckpt, images, d = slim_ckpt
    jg, tg = str(d / "jax_goldens.npz"), str(d / "port_goldens.npz")
    _run(jcli.main, ["parity", "--warmstart", ckpt, "--images", images, "--save-goldens", jg,
                     *PARITY_FLAGS])
    _run(tcli.main, ["parity", "--warmstart", ckpt, "--images", images, "--save-goldens", tg,
                     *PARITY_FLAGS, "--device", "cpu"])
    assert sorted(np.load(tg).files) == sorted(np.load(jg).files) == ["images", "logits"]
    port = json.loads(_run(tcli.main, ["parity", "--warmstart", ckpt, "--goldens", jg,
                                       *PARITY_FLAGS, "--device", "cpu"]).splitlines()[-1])
    ref = json.loads(_run(jcli.main, ["parity", "--warmstart", ckpt, "--goldens", tg,
                                      *PARITY_FLAGS]).splitlines()[-1])
    for report in (port, ref):
        assert report["pass"] is True and report["num_classes"] == 7
        assert report["num_examples"] == 2 and report["max_abs_diff"] <= PARITY_TOL
    assert set(port) == set(ref)


def test_parity_fails_on_wrong_goldens(slim_ckpt):
    ckpt, images, d = slim_ckpt
    good = str(d / "self.npz")
    _run(tcli.main, ["parity", "--warmstart", ckpt, "--images", images, "--save-goldens", good,
                     *PARITY_FLAGS, "--device", "cpu"])
    data = dict(np.load(good))
    data["logits"] = data["logits"] + 0.01
    bad = str(d / "bad.npz")
    np.savez(bad, **data)
    report = json.loads(_run(tcli.main, ["parity", "--warmstart", ckpt, "--goldens", bad,
                                         *PARITY_FLAGS, "--device", "cpu"], rc=1)
                        .splitlines()[-1])
    assert report["pass"] is False and report["max_abs_diff"] > 0.009
    with pytest.raises(SystemExit, match="--save-goldens needs --images"):
        tcli.main(["parity", "--warmstart", ckpt, "--save-goldens", bad, "--device", "cpu"])


def test_parity_preprocesses_raw_goldens(slim_ckpt):
    """A ``raw`` uint8 goldens file goes through the eval preprocessing (to
    299 px, so the checkpoint has no 139 px aux head; none is inferred)."""
    _, _, d = slim_ckpt
    model = InceptionV3(num_classes=7, depth_multiplier=0.25, min_depth=8,
                        create_aux_logits=False, device="meta")
    ckpt = ck.save_as_slim_checkpoint(init_state(model, 4), str(d / "no_aux.ckpt"))
    raw = str(d / "raw.npz")
    np.savez(raw, raw=np.random.RandomState(1).randint(0, 256, (1, 170, 160, 3))
             .astype(np.uint8))
    goldens = str(d / "raw_goldens.npz")
    _run(tcli.main, ["parity", "--warmstart", ckpt, "--images", raw, "--save-goldens", goldens,
                     *PARITY_FLAGS, "--device", "cpu"])
    assert np.load(goldens)["logits"].shape == (1, 7)
    report = json.loads(_run(tcli.main, ["parity", "--warmstart", ckpt, "--goldens", goldens,
                                         *PARITY_FLAGS, "--device", "cpu"]).splitlines()[-1])
    assert report["max_abs_diff"] == 0.0


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def _seeded_probs(n=300, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 15, n)
    logits = rng.randn(n, 15)
    logits[np.arange(n), labels] += 1.5
    logits[::7, (labels[::7] + 2) % 15] += 4.0     # planted confusions
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return probs.astype(np.float32), labels


def test_analysis_equals_the_reference(tmp_path):
    probs, labels = _seeded_probs()
    want, got = janalysis.circumplex(probs, labels), tanalysis.circumplex(probs, labels)
    assert got == want
    assert tanalysis.format_circumplex(got) == janalysis.format_circumplex(want)
    assert tanalysis.angular_order(got["coords"]) == janalysis.angular_order(want["coords"])
    ex_j = janalysis.qualitative_examples(probs, labels, k=3)
    ex_t = tanalysis.qualitative_examples(probs, labels, k=3)
    assert ex_t == ex_j and ex_t["confusions"][0]["count"] >= 2
    lookup = lambda i: f"post {i}"   # noqa: E731
    assert tanalysis.format_examples(ex_t, lookup) == janalysis.format_examples(ex_j, lookup)
    pj = janalysis.write_examples_report(ex_j, str(tmp_path / "j.md"), lookup=lookup)
    pt = tanalysis.write_examples_report(ex_t, str(tmp_path / "t.md"), lookup=lookup)
    assert Path(pt).read_bytes() == Path(pj).read_bytes()
    x = np.random.RandomState(2).randn(20, 6)
    for a, b in zip(tanalysis.pca(x, 3), janalysis.pca(x, 3)):
        np.testing.assert_array_equal(a, b)


def test_plot_circumplex_needs_matplotlib(tmp_path, monkeypatch):
    probs, labels = _seeded_probs()
    res = tanalysis.circumplex(probs, labels)
    p = tanalysis.plot_circumplex(res, str(tmp_path / "circ.png"))
    assert os.path.getsize(p) > 10_000
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        tanalysis.plot_circumplex(res, str(tmp_path / "again.png"))


def test_cli_analyze_on_a_text_checkpoint(tmp_path):
    rows = ["id,text,emotion"]
    for emotion in EMOTIONS:
        for k in range(4):
            rows.append(f"{emotion}{k},feeling {emotion} right now,{emotion}")
    posts = tmp_path / "posts.csv"
    posts.write_text("\n".join(rows) + "\n")
    vocab, ckpt = str(tmp_path / "v.txt"), str(tmp_path / "ckpt")
    common = ["--preset", "text_only", "--csv", str(posts), "--vocab", vocab,
              "--checkpoint-dir", ckpt, "--max-len", "8", "--device", "cpu"]
    _run(tcli.main, ["build-vocab", "--csv", str(posts), "--out", vocab, "--min-freq", "1"])
    _run(tcli.main, ["train", *common, "--steps", "20", "--batch-size", "16",
                     "--learning-rate", "0.05"])
    report = tmp_path / "examples.md"
    out = _run(tcli.main, ["analyze", *common, "--examples", str(report), "--top-k", "2"])
    assert "PCA of per-emotion mean predictions" in out and f"wrote {report}" in out
    md = report.read_text()
    for emotion in EMOTIONS:
        assert f"## {emotion}" in md
    assert "Confusion pairs" in md and "feeling" in md   # post texts resolved
    assert "(overall accuracy" in out


# ---------------------------------------------------------------------------
# scraper
# ---------------------------------------------------------------------------

class FakeTumblrClient:
    """Pages of fake posts per tag, as pytumblr's ``tagged`` returns them
    (the reference test's fake)."""

    def __init__(self, pages=2, per_page=4):
        self.pages, self.per_page = pages, per_page

    def tagged(self, tag, before=None):
        page = 0 if before is None else (10_000 - before)
        if page >= self.pages:
            return []
        posts = []
        for i in range(self.per_page):
            pid = page * self.per_page + i
            posts.append({
                "id": f"{tag}-{pid}",
                "type": "photo" if pid % 5 != 4 else "text",
                "timestamp": 10_000 - page - 1,
                "caption": f"<p>feeling so {tag} today {pid}</p>" if pid % 4 != 3 else "",
                "photos": [{"original_size": {"url": f"http://x/{tag}/{pid}.jpg"}}],
            })
        return posts


def _fixture_fetch():
    names = sorted(FIXTURES.glob("*.jpg"))

    def fetch(url):
        if url.endswith("/1.jpg"):
            raise OSError("unreachable")           # a failed download is skipped
        return names[sum(map(ord, url)) % len(names)].read_bytes()

    return fetch


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*"))
            if p.is_file()}


def test_scrape_all_and_convert_dataset_equal_the_reference(tmp_path):
    emotions = ("happy", "sad", "calm")
    paths = {}
    for name, lib in (("jax", jscraper), ("port", tscraper)):
        paths[name] = lib.scrape_all(FakeTumblrClient(), emotions=emotions,
                                     max_posts_per_emotion=5, out_dir=str(tmp_path / name),
                                     fetch=_fixture_fetch())
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
    assert (tmp_path / "port" / "images" / "happy" / "happy-0.jpg").exists()
    counts = {}
    for name, conv in (("jax", jconvert), ("port", tconvert)):
        counts[name] = conv.convert(paths[name], str(tmp_path / name / "images"),
                                    str(tmp_path / f"{name}_records"), num_shards=2,
                                    valid_fraction=0.25, emotions=EMOTIONS, min_freq=1)
    assert counts["jax"] == counts["port"] and counts["port"]["skipped"] == 3
    assert counts["port"]["train"] + counts["port"]["validation"] > 0
    assert _tree(tmp_path / "jax_records") == _tree(tmp_path / "port_records")


def test_scrape_emotion_pages_and_filters():
    got = tscraper.scrape_emotion(FakeTumblrClient(pages=3), "happy", max_posts=100)
    want = jscraper.scrape_emotion(FakeTumblrClient(pages=3), "happy", max_posts=100)
    assert [vars(p) for p in got] == [vars(p) for p in want] and got
    assert all("<p>" not in p.text for p in got)
    assert len(tscraper.scrape_emotion(FakeTumblrClient(pages=3), "sad", max_posts=2)) == 2


def test_cli_scrape(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="pytumblr is not installed"):
        tcli.main(["scrape", "--consumer-key", "k", "--out", str(tmp_path / "none")])
    monkeypatch.setattr(tscraper, "make_pytumblr_client", lambda *a: FakeTumblrClient(1, 3))
    real = tscraper.scrape_all
    monkeypatch.setattr(tscraper, "scrape_all",
                        lambda client, **kw: real(client, fetch=_fixture_fetch(), **kw))
    out = _run(tcli.main, ["scrape", "--consumer-key", "k", "--max-posts", "2", "--out",
                           str(tmp_path / "s")])
    assert out.strip() == f"wrote {tmp_path / 's' / 'posts.csv'}"
    with open(tmp_path / "s" / "posts.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 * len(EMOTIONS)
    assert rows[0]["image"] == f"{EMOTIONS[0]}/{EMOTIONS[0]}-0.jpg"


# ---------------------------------------------------------------------------
# tune
# ---------------------------------------------------------------------------

TUNE = ["tune", "--engine", "int8", "--batch-size", "2", "--image-size", "40", "--steps", "1",
        "--repeats", "1", "--depth-multiplier", "0.25", "--device", "cpu"]


def test_cli_tune_measures_then_serves_from_its_cache(tmp_path):
    cache = str(tmp_path / "tune.json")
    first = json.loads(_run(tcli.main, [*TUNE, "--cache", cache]).splitlines()[-1])
    assert set(first) == {"engine", "batch_size", "best_options", "best_images_per_sec",
                          "candidates_measured", "from_cache", "apply_hint", "results"}
    assert first["candidates_measured"] == 2 and first["from_cache"] is False
    assert first["best_options"] in ({"cuda_graph": "false"}, {"cuda_graph": "true"})
    assert first["apply_hint"] == ("export TET_TORCH_COMPILER_OPTIONS="
                                   f"'{json.dumps(first['best_options'])}'")
    assert list(json.load(open(cache))) == ["serving/int8/b2"]
    again = json.loads(_run(tcli.main, [*TUNE, "--cache", cache]).splitlines()[-1])
    assert again["from_cache"] is True and again["best_options"] == first["best_options"]
    assert again["best_images_per_sec"] is None and again["results"] == []


def test_cli_tune_refuses_bad_candidates_and_the_train_step(tmp_path):
    bad = tmp_path / "cands.json"
    bad.write_text('{"cuda_graph": "true"}')
    with pytest.raises(SystemExit, match="must hold a JSON list"):
        tcli.main([*TUNE, "--candidates", str(bad), "--cache", ""])
    with pytest.raises(SystemExit, match="must hold a JSON list"):
        tcli.main([*TUNE, "--step", "train", "--candidates", str(bad), "--cache", ""])
