"""Skip-gram word2vec (SGNS) trainer on the card.

Port of ``tumblr_emotions_tpu/data/word2vec.py``: the text branch can start
from word vectors trained on the post captions themselves (the paper's
alternative to public GloVe vectors).  Pair generation and unigram^0.75
negative sampling run on the host in numpy, making the same
``RandomState`` calls in the same order as the reference, so one seed gives
the same batches; the SGNS loss (gathers, a ``[B,K,D]`` batched product,
``logsigmoid``), its gradient (autograd) and plain SGD under the
reference's linear learning-rate decay run on ``device``.  The result is a
[V, D] matrix for ``--embeddings x.npy`` (``data/vocab.load_embeddings``).

The sampler is pure Python by design (it must draw what the reference
draws), so a run is host-bound.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tumblr_emotions_torch._device import full_f32, resolve_device
from tumblr_emotions_torch.data.vocab import PAD_ID, Vocabulary, tokenize

log = logging.getLogger("tumblr_emotions_torch")


@dataclasses.dataclass
class Word2VecConfig:
    embed_dim: int = 200
    window: int = 5
    num_negatives: int = 5
    learning_rate: float = 0.025
    batch_size: int = 1024
    num_steps: int = 20_000
    subsample_t: float = 1e-4   # frequent-word subsampling threshold
    seed: int = 0


def corpus_ids(texts: Sequence[str], vocab: Vocabulary) -> List[np.ndarray]:
    """Tokenized posts -> list of id arrays (OOV mapped, PAD never emitted)."""
    out = []
    for t in texts:
        ids = np.asarray([vocab.lookup(w) for w in tokenize(t)], np.int32)
        if ids.size:
            out.append(ids)
    return out


class PairSampler:
    """Host-side skip-gram pair + negative sampler (unigram^0.75)."""

    def __init__(self, sentences: List[np.ndarray], vocab_size: int,
                 cfg: Word2VecConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        counts = np.zeros(vocab_size, np.float64)
        for s in sentences:
            np.add.at(counts, s, 1.0)
        total = counts.sum()
        # Frequent-word subsampling keep-probability (word2vec's heuristic).
        freq = counts / max(total, 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            keep = np.sqrt(cfg.subsample_t / np.maximum(freq, 1e-12))
        self.keep = np.clip(keep, 0.0, 1.0)
        self.keep[PAD_ID] = 0.0
        noise = counts ** 0.75
        noise[PAD_ID] = 0.0
        self.noise = noise / noise.sum()
        self.sentences = sentences

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        cfg = self.cfg
        centers: List[int] = []
        contexts: List[int] = []
        while True:
            for s in self.sentences:
                s = s[self.rng.rand(len(s)) < self.keep[s]]
                for i, c in enumerate(s):
                    w = self.rng.randint(1, cfg.window + 1)
                    for j in range(max(0, i - w), min(len(s), i + w + 1)):
                        if j != i:
                            centers.append(c)
                            contexts.append(s[j])
                    while len(centers) >= cfg.batch_size:
                        b = cfg.batch_size
                        neg = self.rng.choice(
                            len(self.noise), size=(b, cfg.num_negatives),
                            p=self.noise)
                        yield (np.asarray(centers[:b], np.int32),
                               np.asarray(contexts[:b], np.int32),
                               neg.astype(np.int32))
                        del centers[:b], contexts[:b]


def sgns_loss(w_in: torch.Tensor, w_out: torch.Tensor, centers: torch.Tensor,
              contexts: torch.Tensor, negatives: torch.Tensor) -> torch.Tensor:
    """The SGNS objective: -(mean log sigmoid(v.u+) + mean sum_k log
    sigmoid(-v.u_k)).  The rows are gathered by ``F.embedding``, whose
    gradient sums a repeated id's rows in a fixed order on the CPU."""
    v = F.embedding(centers.long(), w_in)                  # [B, D]
    u_pos = F.embedding(contexts.long(), w_out)            # [B, D]
    u_neg = F.embedding(negatives.long(), w_out)           # [B, K, D]
    pos = (v * u_pos).sum(-1)                              # [B]
    neg = torch.bmm(u_neg, v.unsqueeze(-1)).squeeze(-1)    # [B, K]
    return -(F.logsigmoid(pos).mean() + F.logsigmoid(-neg).sum(-1).mean())


def learning_rate(cfg: Word2VecConfig, step: int) -> float:
    """optax ``linear_schedule(lr, lr * 0.01, num_steps)`` at ``step``, in
    its arithmetic: ``(init - end) * (1 - step / num_steps) + end`` with the
    difference taken in double and everything else in f32."""
    end = cfg.learning_rate * 0.01
    count = np.float32(min(max(step, 0), cfg.num_steps))
    frac = np.float32(1.0) - count / np.float32(cfg.num_steps)
    return float(np.float32(cfg.learning_rate - end) * frac + np.float32(end))


def train_word2vec(texts: Sequence[str], vocab: Vocabulary,
                   cfg: Optional[Word2VecConfig] = None, device="cuda",
                   on_step=None) -> np.ndarray:
    """Train SGNS on the corpus; returns the input-embedding matrix [V, D]
    (the PAD row zeroed).  ``on_step(i, loss_tensor)`` is called after each
    step (the loss stays on the device)."""
    cfg = cfg or Word2VecConfig()
    dev = resolve_device(device)
    rng = np.random.RandomState(cfg.seed)
    V = vocab.size
    w_in = torch.from_numpy(((rng.rand(V, cfg.embed_dim) - 0.5) / cfg.embed_dim)
                            .astype(np.float32)).to(dev).requires_grad_()
    w_out = torch.zeros(V, cfg.embed_dim, dtype=torch.float32, device=dev,
                        requires_grad=True)
    sampler = PairSampler(corpus_ids(texts, vocab), V, cfg)
    it = sampler.batches()
    for i in range(cfg.num_steps):
        centers, contexts, negatives = (torch.from_numpy(a).to(dev) for a in next(it))
        with full_f32(), torch.enable_grad():
            loss = sgns_loss(w_in, w_out, centers, contexts, negatives)
            g_in, g_out = torch.autograd.grad(loss, (w_in, w_out))
        lr = learning_rate(cfg, i)
        with torch.no_grad():
            w_in.sub_(g_in * lr)
            w_out.sub_(g_out * lr)
        if on_step is not None:
            on_step(i, loss.detach())
        if (i + 1) % max(cfg.num_steps // 10, 1) == 0:
            log.info("word2vec step %d/%d loss %.4f", i + 1, cfg.num_steps,
                     float(loss.detach()))
    matrix = w_in.detach().cpu().numpy().copy()
    matrix[PAD_ID] = 0.0
    return matrix
