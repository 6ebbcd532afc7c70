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

The optimizer state goes both ways too (:func:`opt_state_to_optax`,
:func:`opt_state_from_optax`), between the port's dict (``train/optim.py``:
``count`` and per-leaf ``nu``/``trace``/``mu``) and the optax state tree of
the reference's optimizer, matched by field name: ``ScaleByRmsState.nu``,
``TraceState.trace``, ``ScaleByAdamState.{count,mu,nu}``,
``ScaleByScheduleState.count``, inside the ``chain`` tuples and, with frozen
scopes, the ``PartitionState``/``MaskedState`` wrapping whose frozen leaves
are ``MaskedNode``s.  optax is not imported: the tree is walked by its
named-tuple fields, and the optax tree to fill is given as a template.
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


def to_port_leaf(path: Tuple[str, ...], leaf) -> torch.Tensor:
    """One JAX leaf at tree ``path`` -> the port's tensor (a CPU copy)."""
    if any("." in p for p in path):
        raise ValueError(f"'.' in variable path {path}")
    arr = np.asarray(leaf)
    if path[-1] == "weights":
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif path[-1] == "kernel":
        arr = arr.T                      # [in,out] -> [out,in]
    return torch.from_numpy(np.array(arr, order="C"))  # a copy


def to_jax_leaf(key: str, t: torch.Tensor) -> np.ndarray:
    """The port's tensor at state-dict ``key`` -> the JAX leaf (numpy)."""
    arr = t.detach().cpu().numpy()
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weights":
        arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif leaf == "kernel":
        arr = arr.T                      # [out,in] -> [in,out]
    return np.ascontiguousarray(arr)


def to_state(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree -> port state dict (CPU tensors)."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            state[".".join(path)] = to_port_leaf(path, leaf)
    return state


def to_variables(state: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """Port state dict -> JAX ``{"params", "batch_stats"}`` tree of numpy arrays."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        path = key.split(".")
        node = out["batch_stats" if path[-1] in _STATS else "params"]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = to_jax_leaf(key, t)
    return out


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------

_MOMENTS = ("mu", "nu", "trace")


def _is_record(node) -> bool:
    """An optax state record (a named tuple); ``MaskedNode`` and
    ``EmptyState`` are records without fields."""
    return isinstance(node, tuple) and hasattr(node, "_fields")


def opt_state_from_optax(tree) -> Dict:
    """optax state tree (arrays) -> the port's optimizer state: ``count``
    and each moment as ``{state-dict key: CPU tensor}``, frozen
    (``MaskedNode``) leaves left out."""
    out: Dict = {}

    def visit(node):
        if _is_record(node):
            for field in node._fields:
                v = getattr(node, field)
                if field in _MOMENTS:
                    out[field] = {".".join(path): to_port_leaf(path, leaf)
                                  for path, leaf in _leaves(v) if not _is_record(leaf)}
                elif field == "count":
                    c = int(np.asarray(v))
                    if out.setdefault("count", c) != c:
                        raise ValueError(f"optax counts disagree: {out['count']} != {c}")
                else:
                    visit(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                visit(v)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)

    visit(tree)
    return out


def opt_state_to_optax(opt_state: Dict, template):
    """The port's optimizer state -> the optax state tree shaped like
    ``template`` (the reference trainer's ``tx.init(params)`` or any state
    of that optimizer), with numpy leaves."""

    def moment(tree, values, path=()):
        if isinstance(tree, dict):
            return {k: moment(v, values, path + (k,)) for k, v in tree.items()}
        if _is_record(tree):                 # a frozen leaf's MaskedNode
            return tree
        key = ".".join(path)
        return to_jax_leaf(key, values[key])

    def fill(node):
        if _is_record(node):
            vals = []
            for field in node._fields:
                v = getattr(node, field)
                if field in _MOMENTS:
                    vals.append(moment(v, opt_state[field]))
                elif field == "count":
                    vals.append(np.asarray(opt_state["count"], np.asarray(v).dtype))
                else:
                    vals.append(fill(v))
            return type(node)(*vals)
        if isinstance(node, (tuple, list)):
            return type(node)(fill(v) for v in node)
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return node

    return fill(template)
