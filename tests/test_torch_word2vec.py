"""The port's SGNS word2vec trainer against the JAX package's on the CPU:
the host sampler's batches from one seed, the trained matrix after 50
steps, and ``cli train-embeddings`` feeding ``cli train --embeddings``."""

import contextlib
import csv
import io

import numpy as np
import pytest
import torch

from tumblr_emotions_tpu.data import vocab as jvocab
from tumblr_emotions_tpu.data import word2vec as jw2v
from tumblr_emotions_torch import cli as tcli
from tumblr_emotions_torch.data import vocab as tvocab
from tumblr_emotions_torch.data import word2vec as tw2v

# 50 SGD steps of the same batches from the same init: the gathers'
# gradients sum repeated ids in another order (a scatter-add in XLA,
# F.embedding's fixed order here), so the matrices agree to f32 rounding.
MATRIX_TOL = 1e-5


def _texts(n=150, vocab=58, seed=0):
    """A seeded corpus of ~``vocab`` words with a Zipf-like frequency."""
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(rng.choice(words, rng.randint(3, 12), p=p)) for _ in range(n)]


def _vocabs(texts):
    return (jvocab.build_vocabulary(texts, min_freq=1),
            tvocab.build_vocabulary(texts, min_freq=1))


def test_pair_sampler_draws_the_reference_batches():
    texts = _texts()
    jv, tv = _vocabs(texts)
    assert jv.id_to_token == tv.id_to_token
    cfg_j = jw2v.Word2VecConfig(batch_size=64, num_negatives=5, window=5, seed=3)
    cfg_t = tw2v.Word2VecConfig(batch_size=64, num_negatives=5, window=5, seed=3)
    it_j = jw2v.PairSampler(jw2v.corpus_ids(texts, jv), jv.size, cfg_j).batches()
    it_t = tw2v.PairSampler(tw2v.corpus_ids(texts, tv), tv.size, cfg_t).batches()
    for _ in range(20):
        for a, b in zip(next(it_j), next(it_t)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_fifty_steps_match_train_word2vec():
    texts = _texts()
    jv, tv = _vocabs(texts)
    kw = dict(embed_dim=16, batch_size=64, num_steps=50, learning_rate=0.5, seed=1)
    want = jw2v.train_word2vec(texts, jv, jw2v.Word2VecConfig(**kw))
    losses = []
    got = tw2v.train_word2vec(texts, tv, tw2v.Word2VecConfig(**kw), device="cpu",
                              on_step=lambda i, loss: losses.append(float(loss)))
    assert got.shape == want.shape == (tv.size, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got[0], 0.0)
    # the run moved the matrix (from its (rand - 0.5) / D init) and the loss fell
    init = (np.random.RandomState(1).rand(tv.size, 16) - 0.5) / 16
    assert np.abs(want[1:] - init[1:]).max() > 10 * MATRIX_TOL
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    np.testing.assert_allclose(got, want, atol=MATRIX_TOL, rtol=0)


def test_sgns_loss_matches_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    w_in = rng.normal(0, 0.3, (20, 8)).astype(np.float32)
    w_out = rng.normal(0, 0.3, (20, 8)).astype(np.float32)
    c, x, n = rng.randint(1, 20, 32), rng.randint(1, 20, 32), rng.randint(1, 20, (32, 5))
    want = float(jw2v._sgns_loss((jnp.asarray(w_in), jnp.asarray(w_out)), c, x, n))
    got = float(tw2v.sgns_loss(*(torch.from_numpy(a) for a in (w_in, w_out, c, x, n))))
    assert got == pytest.approx(want, abs=1e-6)


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(argv) == 0
    return out.getvalue()


def test_train_embeddings_feeds_train(tmp_path):
    texts = _texts(60)
    posts = tmp_path / "posts.csv"
    with open(posts, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "label"])
        for i, t in enumerate(texts):
            w.writerow([f"p{i}", t, i % 15])
    vocab = tmp_path / "vocab.txt"
    _run(["build-vocab", "--csv", str(posts), "--out", str(vocab), "--min-freq", "1"])
    npy = tmp_path / "w2v.npy"
    out = _run(["train-embeddings", "--csv", str(posts), "--vocab", str(vocab), "--out",
                str(npy), "--embed-dim", "12", "--steps", "5", "--device", "cpu"])
    v = tvocab.Vocabulary.load(str(vocab))
    m = np.load(npy)
    assert f"wrote {m.shape}" in out and m.shape == (v.size, 12)
    np.testing.assert_array_equal(m[0], 0.0)
    _run(["train", "--preset", "text_only", "--csv", str(posts), "--vocab", str(vocab),
          "--embeddings", str(npy), "--batch-size", "8", "--steps", "2", "--max-len", "12",
          "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu"])
    from tumblr_emotions_torch.utils import checkpoint as ck

    step = ck.CheckpointManager(str(tmp_path / "ck")).reader(2)
    table = [n for n in step.keys() if n.endswith("WordEmbedding/embeddings")
             and n.startswith("params/")]
    assert len(table) == 1 and step.get_tensor(table[0]).shape == (v.size, 12)
