"""Weight bridge: the JAX package's variable tree <-> the port's state dict.

The JAX package keeps ``{"params": ..., "batch_stats": ...}``, nested dicts
of arrays (numpy after ``jax.device_get``) whose first level is the slim
scope, e.g. ``params["Mixed_5b/Branch_0/Conv2d_0a_1x1"]["BatchNorm"]["beta"]``.
The port's modules are named by the same scopes (torch allows ``/`` in a
module name), so each level of the tree is one ``.``-separated part of the
state-dict key and no per-layer table is needed:

    params/Mixed_5b/Branch_0/Conv2d_0a_1x1/weights   [kh,kw,Cin,Cout] HWIO
      <-> "Mixed_5b/Branch_0/Conv2d_0a_1x1.weights"   [Cout,Cin,kh,kw] OIHW
    params/.../BatchNorm/beta             <-> "....BatchNorm.beta"             (parameter)
    batch_stats/.../BatchNorm/moving_mean <-> "....BatchNorm.moving_mean"      (buffer)
    params/JointLogits/kernel             <-> "JointLogits.kernel"  [in,out] <-> [out,in]
    params/Text/WordEmbedding/embeddings  <-> "Text.WordEmbedding/embeddings"  (one leaf)

The text and joint trees hold flax Dense layers (``kernel``, ``bias``; the
LSTM's gates at ``Text/RNN/OptimizedLSTMCell_0/{ii,if,ig,io}/kernel`` and
``{hi,hf,hg,ho}/{kernel,bias}``) and the embedding matrix, a leaf whose
name holds a ``/``; the joint tree nests the image tower under
``InceptionV3``.  Conv ``weights`` are transposed HWIO <-> OIHW and Dense
``kernel`` [in,out] <-> [out,in] (``F.linear``'s layout); everything else is
copied unchanged, in its own dtype, so a round trip is exact.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_STATS = ("moving_mean", "moving_variance")


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def to_state(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree -> port state dict (CPU tensors)."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            if any("." in p for p in path):
                raise ValueError(f"'.' in variable path {path}")
            arr = np.asarray(leaf)
            if path[-1] == "weights":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif path[-1] == "kernel":
                arr = arr.T                      # [in,out] -> [out,in]
            state[".".join(path)] = torch.from_numpy(np.array(arr, order="C"))  # a copy
    return state


def to_variables(state: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """Port state dict -> JAX ``{"params", "batch_stats"}`` tree of numpy arrays."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        path = key.split(".")
        arr = t.detach().cpu().numpy()
        if path[-1] == "weights":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif path[-1] == "kernel":
            arr = arr.T                      # [out,in] -> [in,out]
        node = out["batch_stats" if path[-1] in _STATS else "params"]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out
