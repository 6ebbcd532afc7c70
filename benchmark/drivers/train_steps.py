"""Training steps of the port's compiled trainer, fed from host batches.

The program is ``train/trainer.Trainer(cfg, preprocess="train")`` after
``compile()``: each step (the train distortions on the card, the forward
and backward in the configuration's precision, the optimizer update) is
one captured CUDA graph, called as ``Trainer.fit`` calls it, with the
trainer's generator reseeded before each step.  The rows come from a pool
of distinct host batches through ``data/pipeline.DevicePrefetchIterator``.
Set-up builds the trainer and drives it through its first
``check_steps`` steps (the first captures the graph), reading what the
check needs: each step's loss, the first gradient's magnitudes from the
RMSProp state after step 1 (``nu = (1 - decay) g^2`` from zero), and the
parameters' change after the last.  The window runs the steps
after them; ``train_examples_s`` is the rows of the steps launched in the
window over the seconds until the last of them finished.

After the window the program is freed and the float32 reference runs the
same first steps from the same weights, batches and step seeds
(``compare.train_gaps``).
"""

from __future__ import annotations

import gc
import itertools
import time

import torch

from benchmark import cell, compare, devtrace, traffic, weights
from benchmark.reference import train as ref_train


PREFETCH_DEPTH = 2   # batches the device feed keeps ahead, unless the traffic says


def step_seed(seed: int, step: int) -> int:
    return traffic.seed_of(seed, "steps", step)


def trainer(ctx, cfg):
    from tumblr_emotions_torch.train.trainer import Trainer

    return Trainer(cfg, preprocess=ctx.config["preprocess"], device=ctx.device).compile()


def feed(ctx, pool):
    from tumblr_emotions_torch.data.pipeline import DevicePrefetchIterator

    return DevicePrefetchIterator(itertools.cycle(pool), device=ctx.device,
                                  depth=ctx.traffic.get("prefetch_depth", PREFETCH_DEPTH))


def program_steps(ctx, pool, phases=None):
    """The trainer, its state and feed after the first ``check_steps``
    steps, and what they read: ``(trainer, state, feed, generator,
    {"loss", "grad_abs", "change"})``: each step's loss, the first
    gradient's magnitudes read from the RMSProp state after step 1 (``nu =
    (1 - decay) g^2`` from zero) and the parameters' change after the last
    step, the leaves' tensors on the host."""
    t = ctx.traffic
    dev = ctx.device
    phases = {} if phases is None else phases
    tr = trainer(ctx, cfg=cell.port_config(ctx.config))
    state = tr.init_state(weights.make(traffic.seed_of(ctx.seed, "weights"), dev,
                                       **cell.model_sizes(ctx.config)))
    phases["trainer_weights"] = time.perf_counter() - ctx.started
    keys = tr.trainable_keys(state)
    start = {k: state.state[k].detach().clone() for k in keys}
    batches = feed(ctx, pool)
    gen = tr.generator
    losses, grad_abs = [], None
    decay = cell.hyper(ctx.config)["rmsprop_decay"]
    for step in range(1, t["check_steps"] + 1):
        gen.manual_seed(step_seed(ctx.seed, step))
        state, m = tr._compiled_train(state, next(batches), gen)
        losses.append(m["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases[f"step{step}"] = time.perf_counter() - ctx.started
        if grad_abs is None:
            nu = state.opt_state["nu"]
            grad_abs = {k: (nu[k] / (1.0 - decay)).sqrt().cpu() for k in keys}
    change = {k: (state.state[k].detach() - start[k]).cpu() for k in keys}
    prog = {"loss": [float(v) for v in losses], "grad_abs": grad_abs, "change": change}
    return tr, state, batches, gen, prog


def reference_steps(ctx, pool, **kw):
    """The float32 reference over the same first steps (``kw``: a control's
    ``quant`` or ``rows``)."""
    t = ctx.traffic
    dev = ctx.device
    params = weights.make(traffic.seed_of(ctx.seed, "weights"), dev,
                          **cell.model_sizes(ctx.config))
    on_dev = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
              for b in itertools.islice(itertools.cycle(pool), t["check_steps"])]
    seeds = [step_seed(ctx.seed, s) for s in range(1, t["check_steps"] + 1)]
    return ref_train.run_steps(params, on_dev, seeds, cell.hyper(ctx.config), **kw)


def run(ctx) -> cell.Outcome:
    t = ctx.traffic
    dev = ctx.device
    phases = {"start": time.perf_counter() - ctx.started}
    pool = traffic.pool(ctx.seed, t, dev)
    phases["traffic"] = time.perf_counter() - ctx.started
    tr, state, batches, gen, prog = program_steps(ctx, pool, phases)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.started

    seconds = min(ctx.seconds, t["trace_seconds"]) if ctx.trace else ctx.seconds
    step = t["check_steps"]
    with devtrace.traced(ctx.trace, dev.type == "cuda") as box:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with devtrace.span("feed"):
                batch = next(batches)
            step += 1
            gen.manual_seed(step_seed(ctx.seed, step))
            with devtrace.span("step"):
                state, m = tr._compiled_train(state, batch, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    done = step - t["check_steps"]
    batches.close()
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del tr, state, batch, m, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(ctx, pool)
    limits = ctx.workload["limits"]
    checks = {name: (value, limits[name], where)
              for name, (value, where) in compare.train_gaps(prog, ref).items()
              if name in limits}
    rows = t["batch"]
    reading = cell.Reading(box["trace"], done, rows, {}, ctx.config, ctx.workload) \
        if ctx.trace else None
    return cell.Outcome({"train_examples_s": done * rows / (t1 - t0), "setup_s": setup_s},
                        done * rows, 0, checks, memory, reading, phases)
