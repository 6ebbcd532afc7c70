"""Text branch: embedding lookup -> aggregate -> dense softmax head.

Port of ``tumblr_emotions_tpu/models/text_model.py``.  Post
text arrives as fixed-length id sequences ``[B, T]`` with an explicit
length per row (pad id 0); the ids are looked up in a ``[V, D]`` embedding
matrix, the rows past each length are zeroed, and the sequence is
aggregated by a masked mean, a sum or an LSTM before the Dense head.

Parameter names are the JAX package's (``WordEmbedding/embeddings``,
``RNN.OptimizedLSTMCell_0.{ii,if,ig,io,hi,hf,hg,ho}``, ``TextHidden``,
``TextLogits``), so ``convert.py`` maps the flax tree by string alone.  The
f32 path runs with TF32 off, as the reference runs in full f32.  The model
has no batch norm and no dropout, so train mode computes what eval mode
does; the bf16 model's Denses train on f32 master weights
(``layers._Bf16Linear``).

``dtype=torch.bfloat16`` is the JAX package's bf16 (perf) model: the
table is cast to bf16 before the lookup, the masked sum is accumulated in
f32 and rounded (``jnp.sum``'s upcast), the mean divides in bf16, the
Denses follow ``models/layers.Dense``; the LSTM's Denses and gate inputs
are bf16 while its carry stays f32 (flax's carry is made in the f32 param
dtype, and bf16 times f32 promotes to f32), so its feature is f32; where
a bf16 value meets the carry, the jitted reference keeps it unrounded
(``_sigmoid_low``), and so does the port.

Two behaviours of the reference are kept because the served answers depend
on them:

- the lookup is ``jnp.take`` in mode ``"fill"``: an id in ``[-V, 0)`` wraps
  to ``id + V``, an id outside ``[-V, V)`` gives a row of NaN (which the
  mask's multiply by 0 keeps NaN); the port never raises on such an id and
  never indexes out of bounds on the card;
- the LSTM returns flax ``nn.RNN``'s carry at step ``length - 1`` of a run
  over all T steps, indexed as JAX indexes: a length of 0 reads step -1,
  i.e. the carry after the last step (of zero inputs, the rows being
  masked), and a length beyond T reads the last step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tumblr_emotions_torch._device import full_f32, resolve_device
from tumblr_emotions_torch.models.layers import Dense, bf16_linear, train_logits

GATES = ("i", "f", "g", "o")   # flax OptimizedLSTMCell's gate order (torch's too)
AGGREGATORS = ("mean", "sum", "rnn")
EMBEDDINGS = "WordEmbedding/embeddings"


def take_fill(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` in mode ``"fill"``: rows of
    ``table`` for ids in ``[-V, V)`` (negative ids wrap), NaN rows for any
    other id.  The rows are gathered by ``F.embedding``, whose gradient is
    summed in a fixed order (that of ``table[ids]`` on the CPU is not, so
    two runs of one step would differ in the last bits)."""
    V = table.shape[0]
    ids = ids.long()
    rows = F.embedding(torch.where(ids < 0, ids + V, ids).clamp(0, V - 1), table)
    valid = ((ids >= -V) & (ids < V)).unsqueeze(-1)
    return torch.where(valid, rows, torch.full((), float("nan"), dtype=table.dtype,
                                               device=table.device))


def _sigmoid_low(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of a bf16 array as the jitted reference computes it:
    ``1 / (1 + exp(-z))`` with the exp and the sum rounded to bf16 and the
    quotient left in f32 (the gates that meet the f32 carry are never
    rounded; the input gate is rounded by its caller)."""
    return 1.0 / (torch.exp(-z).to(z.dtype) + 1).float()


class LSTMAggregator(nn.Module):
    """flax ``nn.RNN(nn.OptimizedLSTMCell(hidden))`` over embedded tokens,
    returning the final ``h`` of each row (see the module docstring for
    which step that is).  Gates i, f, g, o: ``c' = f*c + i*g``, ``h' =
    o*tanh(c')``, sigmoid gates, tanh activations; the input Denses have no
    bias, the hidden ones do."""

    def __init__(self, embed_dim: int, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        cell = nn.Module()
        for g in GATES:
            cell.add_module(f"i{g}", Dense(embed_dim, hidden, use_bias=False, device=device))
            cell.add_module(f"h{g}", Dense(hidden, hidden, device=device))
        self.OptimizedLSTMCell_0 = cell

    def forward(self, emb: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        B, T, _ = emb.shape
        dense = self.OptimizedLSTMCell_0._modules
        w_i = torch.cat([dense[f"i{g}"].kernel for g in GATES])     # [4H, D]
        w_h = torch.cat([dense[f"h{g}"].kernel for g in GATES])     # [4H, H]
        b_h = torch.cat([dense[f"h{g}"].bias for g in GATES])
        d = self.dtype
        if d == torch.float32:
            x = F.linear(emb, w_i)                                   # all steps at once
        else:
            x = bf16_linear(emb, w_i, round_weight_grad=False).to(d)
        h = c = torch.zeros(B, self.hidden, device=emb.device)
        hs = []
        for t in range(T):
            # flax: dense_h (with its bias) + dense_i, per gate.
            if d == torch.float32:
                i, f, g, o = (F.linear(h, w_h, b_h) + x[:, t]).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                pre = (bf16_linear(h, w_h, round_weight_grad=False).to(d) + b_h.to(d)) + x[:, t]
                i, f, g, o = pre.chunk(4, dim=-1)
                i, g = _sigmoid_low(i).to(d).float(), torch.tanh(g).float()
                c = _sigmoid_low(f) * c + i * g
                h = _sigmoid_low(o) * torch.tanh(c)
            hs.append(h)
        last = lengths.long() - 1
        last = torch.where(last < 0, last + T, last).clamp(0, T - 1)
        return torch.stack(hs, dim=1)[torch.arange(B, device=emb.device), last]


class TextEmotionModel(nn.Module):
    """Vocab-lookup text classifier over the emotion labels.

    ``num_classes=0`` builds the text feature only, without ``TextHidden``
    and ``TextLogits``: the joint model's ``Text`` branch, whose tree has no
    heads.  ``feature_dim`` is the width of :meth:`represent`'s output.
    """

    def __init__(self, vocab_size: int, embed_dim: int, num_classes: int = 15,
                 aggregator: str = "mean", rnn_hidden: int = 256, hidden_dim: int = 0,
                 pad_id: int = 0, dtype=torch.float32, device="cuda"):
        super().__init__()
        if aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {aggregator!r}; expected one of {AGGREGATORS}")
        dev = resolve_device(device)
        self.aggregator = aggregator
        self.pad_id = pad_id
        self.dtype = dtype
        self.num_classes = num_classes
        self.register_parameter(EMBEDDINGS, nn.Parameter(
            torch.zeros(vocab_size, embed_dim, device=dev)))
        self.RNN = (LSTMAggregator(embed_dim, rnn_hidden, dtype=dtype, device=dev)
                    if aggregator == "rnn" else None)
        self.feature_dim = rnn_hidden if aggregator == "rnn" else embed_dim
        feat = self.feature_dim
        self.TextHidden = None
        self.TextLogits = None
        if num_classes > 0:
            if hidden_dim > 0:
                self.TextHidden = Dense(feat, hidden_dim, dtype=dtype, device=dev)
                feat = hidden_dim
            self.TextLogits = Dense(feat, num_classes, dtype=dtype, device=dev)
        self.eval()

    def represent(self, token_ids, lengths=None) -> torch.Tensor:
        """[B, T] int ids -> [B, F] text feature (the joint model's input), f32
        (bf16 from the bf16 model's mean and sum)."""
        table = getattr(self, EMBEDDINGS)
        token_ids = torch.as_tensor(token_ids, device=table.device)
        if lengths is None:
            lengths = (token_ids != self.pad_id).sum(-1)
        lengths = torch.as_tensor(lengths, device=table.device)
        with full_f32():
            emb = take_fill(table.to(self.dtype), token_ids)
            T = emb.shape[1]
            mask = torch.arange(T, device=emb.device)[None, :] < lengths[:, None]
            emb = emb * mask[..., None].to(emb.dtype)
            if self.aggregator == "rnn":
                return self.RNN(emb, lengths)
            total = emb.float().sum(dim=1).to(emb.dtype)
            if self.aggregator == "mean":
                return total / lengths.clamp_min(1).to(emb.dtype)[:, None]
            return total

    def forward(self, token_ids, lengths=None, generator=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (logits, end_points: TextFeature, TextHidden, Logits,
        Predictions).  ``generator`` is unused: the model draws nothing."""
        if self.TextLogits is None:
            raise ValueError("built with num_classes=0: call represent() for the feature")
        feat = self.represent(token_ids, lengths)
        end_points = {"TextFeature": feat}
        with full_f32():
            if self.TextHidden is not None:
                feat = torch.relu(self.TextHidden(feat))
                end_points["TextHidden"] = feat
            pre = self.TextLogits.unrounded(feat)
        logits = train_logits(pre, self)
        end_points["Logits"] = logits
        end_points["Predictions"] = torch.softmax(pre, dim=-1)
        return logits, end_points


def dense_init(shapes: Dict[str, Tuple[int, ...]], rng: np.random.RandomState
               ) -> Dict[str, torch.Tensor]:
    """Seeded random values, made with numpy, for the embedding and Dense
    leaves ``shapes`` names: the embedding N(0, 0.1) (flax's init), Dense
    kernels N(0, 1/fan_in) (flax's lecun_normal scale), biases N(0, 0.1)
    (flax starts them at zero; random ones exercise the LSTM's and the
    heads' bias terms)."""
    state = {}
    for key, shape in shapes.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "kernel":
            a = rng.normal(0.0, np.sqrt(1.0 / shape[1]), shape)
        elif leaf in (EMBEDDINGS, "bias"):
            a = rng.normal(0.0, 0.1, shape)
        else:
            raise ValueError(f"no initialiser for {key!r}")
        state[key] = torch.from_numpy(a.astype(np.float32))
    return state


def init_state(model: TextEmotionModel, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights with the text model's shapes and names."""
    return dense_init({k: tuple(t.shape) for k, t in model.state_dict().items()},
                      np.random.RandomState(seed))
