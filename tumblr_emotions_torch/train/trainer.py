"""Training and evaluation, on one card or one card per process.

Port of ``tumblr_emotions_tpu/train/trainer.py`` (``Trainer(cfg,
preprocess=...)`` -> ``init_state`` -> ``fit`` -> ``evaluate``).  One train step is: the batch to the card, the train
distortions (``preprocess="train"``), the forward in train mode (batch
statistics, dropout), the loss, the backward by autograd and the optimizer
update; the BN moving statistics move in place during the forward.  The
reference's step is one jitted XLA program whose backward is XLA's autodiff
of the same modules.

The loss is slim's: mean softmax cross-entropy, ``aux_loss_weight`` (0.4) x
the cross-entropy of ``AuxLogits`` in train mode, and TF-style L2, ``wd *
sum(w^2) / 2`` over conv and dense kernels (state-dict keys ending in
``.weights`` or ``.kernel``), not over biases, batch norm or the embedding.

The state is held outside the model: :class:`TrainState` carries the
model's state dict (parameters and BN moving statistics) and the optimizer
state, and every step runs the model on it with
``torch.func.functional_call``; the step updates it in place (the
reference donates its state).  Parameters outside ``trainable_scopes`` do
not require gradients and are never updated; the tower still runs in train
mode, so its BN statistics move (as the reference's frozen tower does).

Each step's randomness (the train distortions and dropout) is drawn from a
generator seeded by ``(cfg.train.seed, step)`` at that step, as the
reference draws from ``fold_in(rng, state.step)``: a run stopped at step k
and resumed from its checkpoint computes what a run that never stopped
computes.

Checkpoints: ``checkpoint_manager`` keeps one tensor bundle per step under
``cfg.train.checkpoint_dir`` (``utils/checkpoint.py``: the parameters, BN
statistics and optimizer state under the JAX tree's names, and the step),
``fit`` saves every ``checkpoint_every`` steps and at the end, with the
input iterator's position beside each (``input_iterator_<step>.json``), and
``restore_latest`` / ``restore_input_iterator`` resume at the exact record;
``evaluate_continuously`` scores each new checkpoint as it appears.

Compiled steps (:meth:`Trainer.compile`, the role of the reference's
``tpu_jit`` of both steps): on the card each train and eval step runs as
one captured CUDA graph per input signature (``utils/compile_opts.py``),
bit-equal to the step launched op by op.  The graph updates the state's
tensors in place at the addresses it was captured on; a TrainState whose
tensors sit elsewhere (``restore``, ``init_state``, a warm start) is
captured anew.  The per-update learning rate and bias corrections are its
inputs (``Optimizer.scalars``), and its draws come from
``Trainer.generator``, registered with the graph and reseeded before each
step.  ``TET_TORCH_TRAIN_COMPILER_OPTIONS='{"cuda_graph": "false"}'`` runs
the steps op by op; so do the CPU and a gloo group (its collectives stage
through the host).  Every step runs cuDNN's deterministic algorithms
(``_device.deterministic_convs``), so a step computes the same on every
run: captured or not, resumed or not.  Under a profiler a captured step's
host work before its replay (the update's scalars, the state's addresses,
the batch's order) is the ``trainer.bind`` span, the program's spans
(``utils/compile_opts.py``) nested in it.

Parity mode (f32): the whole step, forward, backward and update, runs
with TF32 off (``_device.full_f32``), as the reference runs
``precision="highest"``.  Perf mode (bf16): the bf16 models of
``models/layers.py`` on f32 master weights; the loss, the optimizer and
the train distortions stay f32 (the distortions with TF32 off in both
modes).

Data parallel (``parallel/mesh.py``): with a process group each process
holds the whole state and its rows of each global batch, and the step keeps
the reference's global-batch semantics under pjit.  One process has no
group (``create_mesh``) and runs the plain step, as the reference runs
plain jit on a one-device mesh.  The step's train
distortions and dropout masks are drawn for the global batch from the
step's seed and each process keeps its rows; batch norm's statistics are
all-reduced (with their gradients); each process's loss is its share of the
global mean cross-entropy plus aux term, with L2 counted once (divided by
the number of processes), so the gradients summed over the processes are
the global loss's; the summed gradients update every process's copy of the
state alike; the logged loss and accuracy are global.  ``evaluate`` runs in
lockstep: every process steps through as many batches as the longest shard
(the shorter pad with weight-0 copies of their last batch) and each
batch's statistics are summed over the group.  Process 0 writes the
checkpoint bundle, every process its own input position
(``input_iterator_<step>.proc<r>.json``), with barriers around the save.

``fit`` writes ``train/*`` and ``eval/*`` scalars to a TensorBoard event
file under ``cfg.train.log_dir`` (process 0) and traces steps
``[profile_start_step, profile_start_step + profile_num_steps)`` with the
profiler hook (``utils/summaries.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import logging
import os
import re
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from tumblr_emotions_torch import convert
from tumblr_emotions_torch._device import deterministic_convs, full_f32, resolve_device
from tumblr_emotions_torch.config import Config
from tumblr_emotions_torch.data import pipeline
from tumblr_emotions_torch.data import preprocessing as pp
from tumblr_emotions_torch.models import build_model
from tumblr_emotions_torch.models.layers import set_data_parallel
from tumblr_emotions_torch.parallel import distributed
from tumblr_emotions_torch.parallel import mesh as mesh_lib
from tumblr_emotions_torch.train.optim import Optimizer, learning_rate
from tumblr_emotions_torch.utils import checkpoint as ckpt_lib
from tumblr_emotions_torch.utils import compile_opts
from tumblr_emotions_torch.utils import metrics as metrics_lib
from tumblr_emotions_torch.utils.summaries import ProfilerHook, SummaryWriter, span

log = logging.getLogger("tumblr_emotions_torch")

EMBEDDINGS = "WordEmbedding/embeddings"


@dataclasses.dataclass
class TrainState:
    """``step``: updates applied; ``state``: the model's state dict on the
    trainer's device (trainable parameters require gradients); ``opt_state``:
    the optimizer state (``train/optim.py``)."""

    step: int
    state: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]


def _weak(method: Callable) -> Callable:
    """``method`` through a weak reference to its object."""
    ref = weakref.WeakMethod(method)
    return lambda *args: ref()(*args)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s draws (the reference's ``fold_in(rng, step)``)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def parse_scopes(trainable_scopes: str) -> Tuple[str, ...]:
    return tuple(s.strip() for s in trainable_scopes.split(",") if s.strip())


def path_in_scopes(key: str, scopes: Tuple[str, ...]) -> bool:
    """slim-style scope matching on path-segment boundaries, on a state-dict
    key: its ``.``-separated levels become ``/`` (module names already hold
    ``/``), so ``Logits`` matches ``InceptionV3/Logits/Conv2d_1c_1x1/...``
    but neither ``AuxLogits`` nor ``JointLogits``."""
    joined = key.replace(".", "/")
    return any(f"/{s}/" in f"/{joined}/" for s in scopes)


def stop_frozen_gradients(state: Dict[str, torch.Tensor], param_keys: Iterable[str],
                          trainable_scopes: str) -> List[str]:
    """Set ``requires_grad`` on the parameters inside ``trainable_scopes``
    (all of them when it is empty) and clear it on the others; returns the
    trainable keys.  Autograd then computes no gradient for a frozen leaf
    (the reference's ``lax.stop_gradient``)."""
    scopes = parse_scopes(trainable_scopes)
    trainable = []
    for k in param_keys:
        on = not scopes or path_in_scopes(k, scopes)
        state[k].requires_grad_(on)
        if on:
            trainable.append(k)
    return trainable


def l2_leaves(state: Dict[str, torch.Tensor]) -> List[str]:
    """The keys TF-style L2 covers: conv ``weights`` and dense ``kernel``
    leaves (the LSTM's too, and a joint model's unused tower ``Logits``)."""
    return [k for k in state if k.rsplit(".", 1)[-1] in ("weights", "kernel")]


def l2_regularization(state: Dict[str, torch.Tensor], weight_decay: float) -> torch.Tensor:
    """``weight_decay * sum(||w||^2 / 2)`` over :func:`l2_leaves`."""
    ws = [state[k] for k in l2_leaves(state)]
    if weight_decay <= 0 or not ws:
        return torch.zeros((), device=next(iter(state.values())).device)
    return weight_decay * (0.5 * torch.stack([(w * w).sum() for w in ws]).sum())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduce: bool = True) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long(), reduction="mean" if reduce else "none")


class Trainer:
    """Runs the train and eval steps of ``cfg``'s model on ``device``
    (default ``"cuda"``, which raises without a card).

    ``preprocess``: None (``batch["image"]`` is model-ready, NHWC f32 in
    [-1, 1]), ``"train"`` (uint8 -> the train distortions in train steps,
    the eval preprocessing in eval steps) or ``"eval"`` (uint8 -> the eval
    preprocessing).  A batch is a dict of arrays or tensors: ``image``,
    ``tokens``, ``lengths``, ``label`` and, for eval, an optional 0/1
    ``weight`` that masks padding rows.

    ``mesh``: the data-parallel mesh (default ``parallel.create_mesh`` of
    ``cfg.mesh`` over the active process group: no group for one process);
    each batch given to a step is then this process's rows of the global
    batch (``cfg.train.batch_size`` rows per process).  A mesh with a group
    takes the collective path, also for one process.
    """

    def __init__(self, cfg: Config, preprocess: Optional[str] = None, device="cuda",
                 mesh: Optional[mesh_lib.Mesh] = None):
        if preprocess not in (None, "train", "eval"):
            raise ValueError(f"preprocess must be None, 'train' or 'eval', got {preprocess!r}")
        self.cfg = cfg
        self.preprocess = preprocess
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_lib.create_mesh(cfg.mesh)
        self.group, self.rank, self.world = self.mesh.group, self.mesh.rank, self.mesh.data
        self.optimizer = Optimizer(cfg.train)
        # The model only gives the computation: its tensors stay on the meta
        # device, and every step runs it on a TrainState's tensors.
        self.model = build_model(cfg, device="meta")
        if self.group is not None:
            set_data_parallel(self.model, self.group, self.rank, self.world)
        self.param_keys = [k for k, _ in self.model.named_parameters()]
        self.state_keys = list(self.model.state_dict())
        self._ckpt_mgr: Optional[ckpt_lib.CheckpointManager] = None
        self.last_save: Optional[Dict[str, float]] = None
        self.last_trace: Optional[str] = None
        # compile(): the steps fit and evaluate run, the mode and the
        # generator every step draws from
        self._compiled_train: Optional[Callable] = None
        self._compiled_eval: Optional[Callable] = None
        self.step_mode: Optional[str] = None
        self.generator: Optional[torch.Generator] = None
        self._programs: Dict[str, compile_opts.Captured] = {}
        self._bound_keys: Dict[str, tuple] = {}
        self._bound: Optional[Tuple[TrainState, Tuple[str, ...]]] = None
        # the all-reduces of the last train step run op by op or recorded
        # into a graph (None without a group)
        self.collectives: Optional[distributed.CollectiveCount] = None

    # -- initialization ----------------------------------------------------

    def init_state(self, state: Dict[str, Any],
                   embedding_matrix: Optional[np.ndarray] = None) -> TrainState:
        """A fresh TrainState from a state dict of the model (tensors or
        arrays, e.g. from ``convert.to_state`` or a model's ``init_state``),
        copied to the device; ``embedding_matrix`` replaces every
        ``WordEmbedding/embeddings`` leaf."""
        if sorted(state) != sorted(self.state_keys):
            missing = sorted(set(self.state_keys) - set(state))
            extra = sorted(set(state) - set(self.state_keys))
            raise ValueError(f"state does not fit the {self.cfg.model!r} model: "
                             f"missing {missing[:5]}, unexpected {extra[:5]}")
        st = {k: self._copy(v) for k, v in state.items()}
        if embedding_matrix is not None:
            hits = [k for k in st if k.endswith(EMBEDDINGS)]
            if not hits:
                raise ValueError("model has no WordEmbedding/embeddings parameter")
            for k in hits:
                if tuple(st[k].shape) != tuple(embedding_matrix.shape):
                    raise ValueError(f"embedding shape {embedding_matrix.shape} != "
                                     f"{tuple(st[k].shape)}")
                st[k] = self._copy(embedding_matrix)
        trainable = stop_frozen_gradients(st, self.param_keys, self.cfg.train.trainable_scopes)
        return TrainState(step=0, state=st,
                          opt_state=self.optimizer.init({k: st[k] for k in trainable}))

    def _copy(self, v) -> torch.Tensor:
        t = v.detach() if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        return t.to(self.device, copy=True)

    def trainable_keys(self, state: TrainState) -> List[str]:
        return [k for k in self.param_keys if state.state[k].requires_grad]

    # -- the steps -----------------------------------------------------------

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch on the device, by non-blocking copies (from pinned
        memory they overlap the card's work)."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _numerics(self):
        """The model's numerics: cuDNN's deterministic algorithms; TF32 off
        in parity mode; in perf mode the bf16 layers decide (their convs
        run TF32 on bf16 values, exactly)."""
        stack = contextlib.ExitStack()
        stack.enter_context(deterministic_convs())
        if self.cfg.train.precision_mode == "parity":
            stack.enter_context(full_f32())
        return stack

    def _all_reduce(self, t: torch.Tensor, kind: str = "other") -> torch.Tensor:
        """``t`` summed over the process group (itself without one);
        ``kind`` as ``distributed.counting`` files it."""
        return t if self.group is None else distributed.all_reduce_(t, self.group, kind)

    def _maybe_preprocess(self, batch: Dict[str, torch.Tensor], train: bool,
                          generator: Optional[torch.Generator],
                          draws: Optional[pp.TrainDraws]) -> Dict[str, torch.Tensor]:
        if self.preprocess is None or "image" not in batch:
            return batch
        image = batch["image"]
        size = self.cfg.image.image_size
        if self.preprocess == "train" and train:
            if draws is None:
                # the global batch's draws; this process keeps its rows
                n, h, w, _ = image.shape
                rows = self.mesh.rows(n)
                draws = pp.draw_train(generator, n * self.world, (h, w),
                                      device=image.device).rows(rows)
            image = pp.apply_train(image, draws, size, size,
                                   resize_method=self.cfg.data.resize_method)
        else:
            image = pp.preprocess_for_eval(
                image, size, size, central_fraction=self.cfg.data.eval_central_crop,
                resize_method=self.cfg.data.resize_method)
        return dict(batch, image=image)

    def _model_args(self, batch: Dict[str, torch.Tensor]) -> Tuple:
        if self.cfg.model == "text":
            return (batch["tokens"], batch.get("lengths"))
        if self.cfg.model == "image":
            return (batch["image"],)
        return (batch["image"], batch["tokens"], batch.get("lengths"))

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[pp.TrainDraws] = None) -> Tuple[TrainState, Dict]:
        """One update of ``state`` (in place) from ``batch``; returns the
        state and ``{"loss", "accuracy"}`` as tensors on the device (read
        them back only when needed: that waits for the step).  The train
        distortions and the dropout draw from ``generator`` (on the
        device); ``draws`` gives the distortions' draws instead.  The step's
        three stages are the methods below."""
        scalars = self.optimizer.device_scalars(state.opt_state["count"], self.device)
        metrics = self.train_step_on_device(state, batch, generator, draws, scalars)
        state.opt_state["count"] += 1
        return TrainState(state.step + 1, state.state, state.opt_state), metrics

    def train_step_on_device(self, state: TrainState, batch: Dict[str, Any],
                             generator: Optional[torch.Generator],
                             draws: Optional[pp.TrainDraws],
                             scalars: torch.Tensor) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` with the optimizer's per-update values
        ``scalars`` given (``Optimizer.scalars``, a float32 tensor on the
        device) and no host work: what a captured step records.  Returns
        the metrics; leaves ``state.step`` and the optimizer's count to the
        caller.  Under data parallelism the all-reduces it issues are
        counted into ``collectives`` (``distributed.counting``)."""
        with distributed.counting() as count:
            batch = self.train_inputs(batch, generator, draws)
            loss, logits, grads = self.loss_and_grads(state, batch, generator)
            with self._numerics():
                self.optimizer.apply({k: state.state[k] for k in grads}, grads,
                                     state.opt_state, scalars)
            acc = (logits.to(self.model.dtype).argmax(-1) == batch["label"].long()).float().mean()
            if self.group is not None:
                # loss is this process's share of the global loss already
                loss, acc = self._all_reduce(torch.stack([loss, acc / self.world]),
                                             "statistics").unbind()
        if self.group is not None:
            self.collectives = count
        return {"loss": loss, "accuracy": acc}

    def train_inputs(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                     draws: Optional[pp.TrainDraws] = None) -> Dict[str, torch.Tensor]:
        """The batch on the device, with the train distortions applied."""
        with full_f32():
            return self._maybe_preprocess(self._to_device(batch), True, generator, draws)

    def loss_and_grads(self, state: TrainState, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The forward in train mode (the BN moving statistics move in
        place), the loss, and by autograd the gradient of every trainable
        leaf: ``(loss, logits, {key: grad})``, TF32 off throughout in parity
        mode.  Under data parallelism the loss is this process's share of
        the global loss and the gradients are summed over the group."""
        cfg = self.cfg
        params = {k: state.state[k] for k in self.trainable_keys(state)}
        with self._numerics(), torch.enable_grad():
            self.model.train()
            logits, end_points = functional_call(self.model, state.state,
                                                 self._model_args(batch),
                                                 {"generator": generator})
            label = batch["label"]
            loss = cross_entropy(logits, label)
            if "AuxLogits" in end_points:
                loss = loss + cfg.image.aux_loss_weight * cross_entropy(
                    end_points["AuxLogits"], label)
            loss = (loss + l2_regularization(state.state, cfg.train.weight_decay)) / self.world
            # A leaf the loss does not reach (the joint model's unused tower
            # Logits bias) has a zero gradient, as jax.grad gives it.
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if self.group is not None:
            flat = self._all_reduce(torch.cat([g.reshape(-1) for g in grads.values()]),
                                    "gradient")
            grads = dict(zip(grads, (f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads.values()]), grads.values()))))
        return loss.detach(), logits.detach(), grads

    def apply_gradients(self, state: TrainState, grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer update of the leaves in ``grads``, in place."""
        with self._numerics():
            self.optimizer.update({k: state.state[k] for k in grads}, grads, state.opt_state)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's metric statistics (``metrics.batch_stats``) and its
        pad-masked ``loss_sum`` (cross-entropy plus the per-example-constant
        L2 term, scaled by the weighted count), on the device; under data
        parallelism, summed over the process group."""
        with full_f32():
            batch = self._maybe_preprocess(self._to_device(batch), False, None, None)
        with self._numerics():
            self.model.eval()
            logits, _ = functional_call(self.model, state.state, self._model_args(batch))
            w = batch.get("weight")
            stats = metrics_lib.batch_stats(logits, batch["label"], self.cfg.image.num_classes,
                                            weights=w)
            per_ex = cross_entropy(logits, batch["label"], reduce=False)
            w = torch.ones_like(per_ex) if w is None else w.float()
            l2 = l2_regularization(state.state, self.cfg.train.weight_decay)
            stats["loss_sum"] = (per_ex * w).sum() + l2 * stats["count"].float()
        if self.group is not None:
            keys = list(stats)
            flat = self._all_reduce(torch.cat([stats[k].double().reshape(-1) for k in keys]),
                                    "statistics")
            parts = flat.split([stats[k].numel() for k in keys])
            stats = {k: p.view_as(stats[k]).to(stats[k].dtype) for k, p in zip(keys, parts)}
        return stats

    @torch.no_grad()
    def predict_step(self, state: TrainState, batch: Dict[str, Any]) -> torch.Tensor:
        """The batch's probabilities (the model's ``Predictions``) from the
        eval-mode forward :meth:`eval_step` runs, on the device."""
        with full_f32():
            batch = self._maybe_preprocess(self._to_device(batch), False, None, None)
        with self._numerics():
            self.model.eval()
            _, end_points = functional_call(self.model, state.state, self._model_args(batch))
        return end_points["Predictions"]

    # -- compiled steps ------------------------------------------------------

    def compile(self) -> "Trainer":
        """Decide how ``fit`` and ``evaluate`` run their steps, as the
        reference's ``compile`` jits both: ``_compiled_train(state, batch,
        generator)`` and ``_compiled_eval(state, batch)``, each one captured
        CUDA graph per input signature (``utils/compile_opts.capture``,
        ``TET_TORCH_TRAIN_COMPILER_OPTIONS``), or :meth:`train_step` and
        :meth:`eval_step` op by op.  Captured iff the device is the card,
        the options' ``cuda_graph`` is true and there is no group or an NCCL
        one (gloo stages its collectives through the host); the mode is in
        ``step_mode``.  ``generator`` (on the device) is the one the
        captured train step draws from: ``fit`` reseeds it before each step.
        A capture that fails raises."""
        opts = compile_opts.check_options(compile_opts.train_default_options())
        why = []
        if self.device.type != "cuda":
            why.append(f"device {self.device}")
        if opts.get("cuda_graph") != "true":
            why.append(f"{compile_opts.TRAIN_ENV_VAR} {opts}")
        if self.group is not None and torch.distributed.get_backend(self.group) != "nccl":
            why.append(f"a {torch.distributed.get_backend(self.group)} group")
        self.step_mode = "eager" if why else "captured"
        self.generator = torch.Generator(device=self.device)
        self._programs, self._bound_keys = {}, {}
        if not why:
            # The programs (and the steps below) hold the trainer weakly: a
            # trainer let go frees its graphs' memory then, not at the next
            # garbage collection.
            self._programs["train"] = compile_opts.capture(
                _weak(self._captured_train), options=opts, device=self.device,
                inference=False, generators=(self.generator,))
            self._programs["eval"] = compile_opts.capture(
                _weak(self._captured_eval), options=opts, device=self.device, inference=False)
        log.info("train and eval steps: %s%s", self.step_mode,
                 f" ({', '.join(why)})" if why else " (one CUDA graph per input signature)")
        self._compiled_train, self._compiled_eval = _weak(self._run_train), _weak(self._run_eval)
        return self

    def _run_train(self, state: TrainState, batch: Dict[str, Any],
                   generator: torch.Generator) -> Tuple[TrainState, Dict]:
        program = self._programs.get("train")
        if program is None:
            return self.train_step(state, batch, generator)
        if generator is not self.generator:
            raise ValueError("the captured train step draws from trainer.generator")
        metrics = self._call("train", state, batch)
        state.opt_state["count"] += 1
        return TrainState(state.step + 1, state.state, state.opt_state), metrics

    def _run_eval(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if "eval" not in self._programs:
            return self.eval_step(state, batch)
        return self._call("eval", state, batch)

    def _call(self, which: str, state: TrainState, batch: Dict[str, Any]):
        """Run a captured step on ``state``: its graphs were captured on the
        addresses of the tensors it updates or reads (the state dict, and
        for the train step the optimizer's moments and which leaves train),
        so a state held elsewhere drops them and is captured anew.  The
        train step also takes the update's host scalars
        (``Optimizer.scalars``).  All of it is the ``trainer.bind`` span
        (``utils/summaries.span``), the program's own spans nested in it."""
        with span("trainer.bind"):
            tensors = list(state.state.values())
            extra = []
            if which == "train":
                tensors += [v for m in self.optimizer.moments
                            for v in state.opt_state[m].values()]
                extra.append(self.optimizer.scalars(state.opt_state["count"]))
            bound = tuple((t.data_ptr(), t.requires_grad) for t in tensors)
            if bound != self._bound_keys.get(which):
                self._programs[which].clear()
                self._bound_keys[which] = bound
            names = tuple(sorted(batch))
            self._bound = (state, names)   # read by the program while it is captured
            return self._programs[which](*[batch[k] for k in names], *extra, key=names)

    def _captured_train(self, *args) -> Dict[str, torch.Tensor]:
        state, names = self._bound
        return self.train_step_on_device(state, dict(zip(names, args[:-1])), self.generator,
                                         None, args[-1])

    def _captured_eval(self, *args) -> Dict[str, torch.Tensor]:
        state, names = self._bound
        return self.eval_step(state, dict(zip(names, args)))

    # -- loops ---------------------------------------------------------------

    def fit(self, state: TrainState, batches: Iterable[Dict[str, Any]],
            num_steps: Optional[int] = None,
            eval_batches: Optional[Callable[[], Iterable]] = None,
            input_iterator=None) -> TrainState:
        """Train for ``num_steps`` (default ``cfg.train.num_steps``) or until
        ``batches`` ends, logging loss, accuracy, examples/s (of the global
        batch) and the learning rate every ``log_every`` steps (the only
        reads of the card's results) and writing them as ``train/*``
        scalars (process 0).  Step ``s`` draws from a generator on the
        device seeded by ``step_seed(cfg.train.seed, s)``.

        With a checkpoint manager (``checkpoint_manager()``), the state is
        saved every ``checkpoint_every`` steps and at the end, and
        ``eval_batches()`` (a fresh pass over the eval split) is evaluated
        at each save and at the end (``eval/*`` scalars).  ``input_iterator``
        (a resumable iterator underneath ``batches``) has its position saved
        beside each checkpoint, so a restart resumes at the exact record.
        The profiler hook traces steps ``[profile_start_step,
        profile_start_step + profile_num_steps)`` into a Chrome trace
        under ``log_dir`` (its path in ``last_trace``).  The steps are
        :meth:`compile`'s."""
        if self._compiled_train is None:
            self.compile()
        t = self.cfg.train
        num_steps = t.num_steps if num_steps is None else num_steps
        gen = self.generator
        it = iter(batches)
        writer = SummaryWriter(t.log_dir if self.rank == 0 else "")
        profiler = ProfilerHook(t.log_dir or os.path.join(t.checkpoint_dir, "trace"),
                                t.profile_start_step, t.profile_num_steps,
                                rank=self.rank if self.world > 1 else None)
        self.last_trace = profiler.trace_path
        step = last_step = state.step
        last_t = time.perf_counter()
        try:
            for _ in range(num_steps):
                try:
                    batch = next(it)
                except StopIteration:
                    log.info("input exhausted at step %d", step)
                    break
                gen.manual_seed(step_seed(t.seed, step))
                profiler.maybe_start(step + 1)
                with profiler.step_range(step + 1):
                    state, m = self._compiled_train(state, batch, gen)
                step += 1
                profiler.maybe_stop(step)
                if step % t.log_every == 0:
                    loss, acc = float(m["loss"]), float(m["accuracy"])
                    now = time.perf_counter()
                    ips = t.batch_size * self.world * (step - last_step) / max(now - last_t, 1e-9)
                    lr = learning_rate(t, step)
                    if self.rank == 0:
                        log.info("step %d loss %.4f acc %.3f (%.1f ex/s, lr %.3g)", step, loss,
                                 acc, ips, lr)
                    writer.write_scalars(step, {"train/loss": loss, "train/accuracy": acc,
                                                "train/examples_per_sec": ips,
                                                "train/learning_rate": lr})
                    last_t, last_step = now, step
                if self._ckpt_mgr is not None and step % t.checkpoint_every == 0:
                    self.save_checkpoint(state, input_iterator=input_iterator)
                    if eval_batches is not None:
                        self._eval_and_log(state, eval_batches, step, writer)
        finally:
            profiler.stop_if_active()
            writer.flush()
        if self._ckpt_mgr is not None:
            self.save_checkpoint(state, input_iterator=input_iterator)
        if eval_batches is not None:
            self._eval_and_log(state, eval_batches, step, writer)
        writer.close()
        return state

    def _eval_and_log(self, state: TrainState, eval_batches: Callable[[], Iterable],
                      step: int, writer: SummaryWriter) -> Dict:
        summary = self.evaluate(state, eval_batches())
        if self.rank == 0:
            log.info("eval @ step %d: accuracy %.4f loss %.4f (n=%d)", step,
                     summary.get("accuracy", 0.0), summary.get("loss", 0.0),
                     summary.get("count", 0))
        writer.write_scalars(step, {"eval/accuracy": float(summary.get("accuracy", 0.0)),
                                    "eval/loss": float(summary.get("loss", 0.0))})
        writer.flush()
        return summary

    def evaluate(self, state: TrainState, batches: Iterable[Dict[str, Any]],
                 class_names=None) -> Dict:
        """Streaming evaluation: each batch's statistics are added on the
        device and read back once, at the end.  Returns
        ``metrics.summarize`` plus the mean ``loss`` over the weighted
        examples.  Under data parallelism each process passes its own shard
        and the statistics are the whole split's (lockstep, see
        :meth:`lockstep_local_batches`).  The steps are :meth:`compile`'s."""
        if self._compiled_eval is None:
            self.compile()
        if self.group is not None:
            batches = self.lockstep_local_batches(batches)
        total = None
        loss_sum = torch.zeros((), dtype=torch.float64, device=self.device)
        for batch in batches:
            stats = self._compiled_eval(state, batch)
            loss_sum += stats.pop("loss_sum").double()
            total = stats if total is None else metrics_lib.merge_stats(total, stats)
        if total is None:
            return {"accuracy": 0.0, "count": 0}
        total = {k: v.cpu() for k, v in total.items()}
        count = int(total["count"])
        if count == 0:
            return {"accuracy": 0.0, "count": 0}
        summary = metrics_lib.summarize(total, class_names)
        summary["loss"] = float(loss_sum) / count
        return summary

    def lockstep_local_batches(self, batches: Iterable[Dict[str, Any]]) -> List[Dict]:
        """This process's eval batches, each with a ``weight`` leaf, padded
        to the longest shard's count with weight-0 copies of the last batch:
        every process must run the collective eval step as many times.  A
        zero-weight batch adds nothing to any statistic."""
        local = []
        for b in batches:
            if "weight" not in b:
                b = dict(b, weight=np.ones(len(b["label"]), np.int32))
            local.append(b)
        n_max = max(distributed.all_gather_int(len(local), self.group, self.device))
        if len(local) < n_max:
            if not local:
                raise ValueError(
                    "multi-host sharded eval: this process's record shard produced zero "
                    f"batches while another produced {n_max}; shard the eval split so "
                    "every process gets at least one batch, or evaluate unsharded")
            w = local[-1]["weight"]
            pad = dict(local[-1], weight=torch.zeros_like(w) if torch.is_tensor(w)
                       else np.zeros_like(w))
            local.extend([pad] * (n_max - len(local)))
        return local

    def evaluate_continuously(self, state: TrainState, batches_fn: Callable[[], Iterable],
                              class_names=None, interval_secs: float = 30.0,
                              max_step: Optional[int] = None,
                              timeout_secs: Optional[float] = None,
                              _sleep=time.sleep) -> Iterator[Tuple[int, Dict]]:
        """slim ``evaluation_loop`` semantics: poll the checkpoint dir,
        evaluate every new checkpoint as it appears (writing ``eval/*``
        scalars), and stop once the evaluated step reaches ``max_step``
        (default ``cfg.train.num_steps``) or no new checkpoint arrives
        within ``timeout_secs`` (wall clock).  ``batches_fn()`` gives a
        fresh pass over the eval split per evaluation.  Yields ``(step,
        summary)``.  Under data parallelism process 0's poll decides for
        every process (which step, whether to stop), so all evaluate the
        same checkpoint in lockstep."""
        mgr = self.checkpoint_manager()
        stop_step = max_step if max_step is not None else self.cfg.train.num_steps
        writer = SummaryWriter(self.cfg.train.log_dir if self.rank == 0 else "")
        last_evaluated = -1
        deadline = time.monotonic() + timeout_secs if timeout_secs is not None else None
        while True:
            step = mgr.latest_step()
            expired = deadline is not None and time.monotonic() >= deadline
            if self.group is not None:
                step, expired = self._from_process_0(-1 if step is None else step, int(expired))
                step = None if step < 0 else step
            restored = None
            if step is not None and step > last_evaluated:
                try:
                    restored = self.restore(state, step)
                except (OSError, ValueError) as e:  # vanished or unreadable meanwhile
                    log.warning("checkpoint %d not restorable: %s", step, e)
                if self.group is not None and self._all_reduce(torch.tensor(
                        [float(restored is None)], device=distributed.collective_device(
                            self.group, self.device))).item():
                    restored = None       # one process could not read it: none evaluates
            if restored is None:
                # No new checkpoint, or it vanished or is unreadable: honour
                # the deadline (not reset: a corrupt latest checkpoint must
                # still time out) and back off.
                if expired:
                    log.info("eval loop: no new checkpoint after %.0fs, stopping",
                             timeout_secs)
                    writer.close()
                    return
                _sleep(interval_secs)
                continue
            if timeout_secs is not None:
                deadline = time.monotonic() + timeout_secs
            summary = self.evaluate(restored, batches_fn(), class_names=class_names)
            last_evaluated = restored.step
            log.info("eval @ step %d: accuracy %.4f loss %.4f", last_evaluated,
                     summary.get("accuracy", 0.0), summary.get("loss", 0.0))
            writer.write_scalars(last_evaluated, {
                "eval/accuracy": float(summary.get("accuracy", 0.0)),
                "eval/loss": float(summary.get("loss", 0.0))})
            writer.flush()
            yield last_evaluated, summary
            if last_evaluated >= stop_step:
                log.info("eval loop: reached final step %d", last_evaluated)
                writer.close()
                return

    def _from_process_0(self, *values: int) -> List[int]:
        """Process 0's ``values`` on every process."""
        t = torch.tensor(values, dtype=torch.int64,
                         device=distributed.collective_device(self.group, self.device))
        if self.rank != 0:
            t.zero_()
        return [int(v) for v in self._all_reduce(t).tolist()]

    # -- checkpoints ---------------------------------------------------------

    def checkpoint_manager(self, directory: Optional[str] = None) -> ckpt_lib.CheckpointManager:
        if self._ckpt_mgr is None:
            self._ckpt_mgr = ckpt_lib.CheckpointManager(
                directory or self.cfg.train.checkpoint_dir, self.cfg.train.keep_checkpoints)
        return self._ckpt_mgr

    def _optax_template(self, state: TrainState):
        return ckpt_lib.optax_template(self.cfg.train, self.param_keys,
                                       self.trainable_keys(state))

    def state_tensors(self, state: TrainState) -> Dict[str, np.ndarray]:
        """The TrainState as named host arrays under the JAX tree's names:
        ``params/<scope>/...`` and ``batch_stats/...`` in the JAX layouts,
        ``opt_state/...`` as the optax tree's leaves, ``step`` (int32)."""
        out = {"step": np.asarray(state.step, np.int32)}
        for k, t in state.state.items():
            col = "batch_stats" if ckpt_lib.is_stat(k) else "params"
            out[f"{col}/{k.replace('.', '/')}"] = convert.to_jax_leaf(k, t)
        tree = convert.opt_state_to_optax(state.opt_state, self._optax_template(state))
        out.update({"opt_state/" + name: np.asarray(v)
                    for name, v in ckpt_lib.flatten_tree(tree)})
        return out

    def save_checkpoint(self, state: TrainState, input_iterator=None) -> None:
        """Save ``state`` as its step's checkpoint (once per step), after
        the input position: a crash between the two writes leaves at worst
        an orphan position file (pruned later), never a checkpoint beside a
        stale position.  ``last_save`` keeps the data ``bytes``, the
        ``seconds`` of the whole save (the copy to the host included) and
        the bundle's ``write_seconds``.  Under data parallelism every
        process writes its own input position, then process 0 the bundle
        (the state is the same on every process), between barriers."""
        mgr = self.checkpoint_manager()
        if input_iterator is not None and hasattr(input_iterator, "get_state"):
            pipeline.save_iterator_state(input_iterator, self._input_state_path(state.step))
        self._barrier()
        if self.rank == 0 and state.step not in mgr.all_steps():
            t0 = time.perf_counter()
            saved = mgr.save(state.step, self.state_tensors(state))
            self.last_save = {"bytes": saved["bytes"], "write_seconds": saved["seconds"],
                              "seconds": time.perf_counter() - t0}
            log.info("checkpoint @ step %d: %d bytes in %.3f s (written in %.3f s)",
                     state.step, saved["bytes"], self.last_save["seconds"], saved["seconds"])
        self._barrier()
        self._prune_input_states()

    def _barrier(self) -> None:
        if self.group is not None:
            distributed.barrier(self.group, self.device)

    def _proc_suffix(self) -> str:
        return f".proc{self.rank}" if self.world > 1 else ""

    def _input_state_path(self, step: int) -> str:
        """The input-position file of ``step`` (this process's own under
        data parallelism: each checkpoints its shard's position)."""
        return os.path.join(self.checkpoint_manager().directory,
                            f"input_iterator_{int(step)}{self._proc_suffix()}.json")

    def _prune_input_states(self) -> None:
        """Drop this process's position files whose step the manager no
        longer keeps."""
        mgr = self.checkpoint_manager()
        keep = set(mgr.all_steps())
        pat = re.compile(r"input_iterator_(\d+)%s\.json$" % re.escape(self._proc_suffix()))
        for p in glob.glob(os.path.join(mgr.directory, "input_iterator_*.json")):
            m = pat.search(p)
            if m and int(m.group(1)) not in keep:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def restore_input_iterator(self, iterator, step: Optional[int] = None) -> bool:
        """Restore the input position saved with the checkpoint at ``step``
        (default: the latest).  False when there is none or the iterator is
        not resumable (e.g. a plain generator)."""
        if iterator is None or not hasattr(iterator, "set_state"):
            return False
        if step is None:
            step = self.checkpoint_manager().latest_step()
        return step is not None and pipeline.restore_iterator_state(
            iterator, self._input_state_path(step))

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        """Resume: the latest checkpoint in the shape of ``state`` (a
        TrainState of this trainer, e.g. a fresh ``init_state``) on the
        trainer's device, or None when there is no checkpoint.  An
        unreadable checkpoint raises (OSError or ValueError)."""
        step = self.checkpoint_manager().latest_step()
        return None if step is None else self.restore(state, step)

    def restore(self, state: TrainState, step: int) -> TrainState:
        """The checkpoint of ``step`` in the shape of ``state``; raises when
        it is gone or unreadable."""
        reader = self.checkpoint_manager().reader(step)

        def read(name: str, like: np.ndarray) -> np.ndarray:
            arr = reader.get_tensor(name)
            if arr.shape != like.shape:
                raise ValueError(f"checkpoint {name}: shape {arr.shape} != {like.shape}")
            return arr

        st = {}
        for k, t in state.state.items():
            col = "batch_stats" if ckpt_lib.is_stat(k) else "params"
            arr = read(f"{col}/{k.replace('.', '/')}", convert.to_jax_leaf(k, t))
            st[k] = convert.to_port_leaf(tuple(k.split(".")), arr).to(
                self.device, t.dtype).requires_grad_(t.requires_grad)
        like = dict(ckpt_lib.flatten_tree(
            convert.opt_state_to_optax(state.opt_state, self._optax_template(state))))
        tree = ckpt_lib.fill_tree(self._optax_template(state),
                                  lambda n: read("opt_state/" + n, np.asarray(like[n])))
        opt = convert.opt_state_from_optax(tree)
        restored_step = int(reader.get_tensor("step"))
        opt_state: Dict[str, Any] = {"count": opt.get("count", restored_step)}
        for m in self.optimizer.moments:
            opt_state[m] = {k: v.to(self.device) for k, v in opt[m].items()}
        return TrainState(step=restored_step, state=st, opt_state=opt_state)
