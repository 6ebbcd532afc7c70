"""Data-parallel train steps of the port's compiled trainer: one process a
card, over NCCL (over gloo on the CPU).

``run.py``'s process is rank 0 on ``cuda:0``; it starts ranks 1 to n - 1
itself (this module run as a script, ``--child``), rank r on ``cuda:r``, and
the n processes (the traffic's ``processes``) meet through a file in a fresh
directory under the temporary directory.  Every rank runs ``train_steps``'
``program_steps`` unchanged: ``Trainer(cfg, preprocess="train")`` on the
group's mesh (batch norm's statistics are the global batch's, all-reduced
with their gradients; the train distortions and dropout are drawn for the
global batch and each rank keeps its rows; the gradient is all-reduced),
``compile()`` (one CUDA graph a step, its collectives inside), then the
first ``check_steps`` steps through ``_compiled_train`` as ``fit`` calls it.
Each rank feeds ``DevicePrefetchIterator`` from its own rows of a pool of
global batches (``traffic.pool`` at ``batch x processes`` rows: rank r holds
rows ``[r*batch, (r+1)*batch)`` of each, so every rank's pool is distinct).

The window runs steps back to back on every rank.  Rank 0 decides when it
ends: before each step it tells the others, over a gloo group of its own,
whether to run it (a message between the hosts; no rank waits for a card).
``train_examples_s`` is the global rows of the steps launched in the window
over the seconds until the last of them finished on rank 0's card.  Only
rank 0 traces its window and returns the outcome; its counters are the
trainer's count of one step's all-reduces (``Trainer.collectives``, absent
in a program without it).  Before the window every rank sends rank 0 the
change of its state over the first steps, leaf by leaf (``compare_dp.
rank_gaps``: the processes must hold the same state).  After the window
every rank leaves the group; rank 0 frees the program and runs the float32
reference over the first global batches on its card (``reference_dp``), for
``compare_dp``.

A rank that fails, or a run that is not over by its deadline, ends every
process with an error: no process is left waiting on a peer that is gone.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cell, compare_dp, devtrace, reference_dp, traffic, weights  # noqa: E402
from benchmark.drivers import train_steps  # noqa: E402

# Seconds a run may take beyond its window before every process is ended:
# set-up (imports, the group, weights, traffic, three steps and the capture)
# takes well under a minute on four H100s, the reference under half of one.
DEADLINE_S = 420.0
CHILD = "benchmark.drivers.train_dp_steps"   # the module a rank > 0 runs


def global_pool(ctx, dev):
    """The pool of global batches (``processes x batch`` rows each)."""
    t = ctx.traffic
    return traffic.pool(ctx.seed, dict(t, batch=t["batch"] * t["processes"]), dev)


def rows_of(pool, rank: int, rows: int):
    """A copy of rank ``rank``'s rows of each global batch (the pool's
    arrays are views of one block of host memory: a view would keep all of
    it)."""
    part = slice(rank * rows, (rank + 1) * rows)
    return [{k: v[part].copy() for k, v in b.items()} for b in pool]


def device_of(ctx, rank: int) -> torch.device:
    dev = ctx.device
    return torch.device("cuda", rank) if dev.type == "cuda" else dev


def join(address: str, rank: int, world: int, dev: torch.device):
    """Join the group (NCCL between cards, gloo on the CPU) and open the
    gloo group the window's messages go through."""
    from tumblr_emotions_torch.parallel import distributed

    distributed.init_group(address, world, rank, device=dev)
    return torch.distributed.new_group(backend="gloo")


def counters_of(tr) -> dict:
    """The trainer's count of one step's all-reduces, flat; ``{}`` where
    the program keeps none."""
    c = getattr(tr, "collectives", None)
    if c is None:
        return {}
    out = {"allreduces": c.total()}
    for kind in c.calls:
        out[f"allreduces.{kind}"] = c.calls[kind]
        out[f"allreduce_bytes.{kind}"] = c.bytes[kind]
    return out


def digests(ctx, ctl, state, world: int):
    """Every process's ``compare_dp.change_digest`` of its state after the
    first steps, on every process (process 0's first)."""
    start = weights.make(traffic.seed_of(ctx.seed, "weights"), ctx.device,
                         **cell.model_sizes(ctx.config))
    mine = torch.tensor(compare_dp.change_digest(state.state, start), dtype=torch.float64)
    out = [torch.zeros_like(mine) for _ in range(world)]
    torch.distributed.all_gather(out, mine, group=ctl)
    return [t.tolist() for t in out]


def steps(ctx, rank, ctl, tr, state, batches, gen):
    """The window: steps until rank 0 says stop.  Returns (steps done,
    seconds from the first launch until rank 0's card finished)."""
    step = ctx.traffic["check_steps"]
    go = torch.zeros(1, dtype=torch.int32)
    t0 = time.perf_counter()
    while True:
        if rank == 0:
            go[0] = int(time.perf_counter() - t0 < ctx.seconds)
        torch.distributed.broadcast(go, 0, group=ctl)
        if not go[0]:
            break
        with devtrace.span("feed"):
            batch = next(batches)
        step += 1
        gen.manual_seed(train_steps.step_seed(ctx.seed, step))
        with devtrace.span("step"):
            state, _ = tr._compiled_train(state, batch, gen)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return step - ctx.traffic["check_steps"], time.perf_counter() - t0


def leave():
    torch.distributed.destroy_process_group()


def child_main(argv=None) -> int:
    """A rank above 0: set-up, the check steps and the window, untraced."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", required=True)
    args = ap.parse_args(argv)
    a = json.loads(args.child)
    torch.set_num_threads(a["threads"])
    dev = torch.device(a["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ctx = cell.Ctx(a["name"], a["workload"], a["workload"]["config_file"], a["seed"],
                   a["seconds"], False, dev, time.perf_counter())
    ctl = join(a["address"], a["rank"], a["world"], dev)
    pool = rows_of(global_pool(ctx, dev), a["rank"], ctx.traffic["batch"])
    tr, state, batches, gen, _ = train_steps.program_steps(ctx, pool)
    digests(ctx, ctl, state, a["world"])
    steps(ctx, a["rank"], ctl, tr, state, batches, gen)
    batches.close()
    del tr, state, batches, gen
    gc.collect()
    leave()
    return 0


class Ranks:
    """Ranks 1 to n - 1 as child processes, watched: if one fails, or the
    run outlives its deadline, every child is killed and this process exits
    with an error."""

    def __init__(self, ctx, world: int, address: str, workdir: str):
        self.procs, self.logs = [], []
        self.deadline = time.monotonic() + ctx.seconds + DEADLINE_S
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                    "LOCAL_WORLD_SIZE"):
            env.pop(var, None)
        for rank in range(1, world):
            spec = {"name": ctx.name, "workload": ctx.workload, "seed": ctx.seed,
                    "seconds": ctx.seconds, "device": str(device_of(ctx, rank)),
                    "rank": rank, "world": world, "address": address,
                    "threads": torch.get_num_threads()}
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w+b")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", CHILD, "--child", json.dumps(spec)], cwd=str(ROOT),
                env=env, stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._watching, daemon=True)
        self._watch.start()

    def _tail(self, i: int) -> str:
        log = self.logs[i]
        log.flush()
        log.seek(0)
        return log.read().decode(errors="replace")[-3000:]

    def _fail(self, why: str) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        print(f"train_dp_steps: {why}", file=sys.stderr, flush=True)
        for i in range(len(self.procs)):
            print(f"--- rank {i + 1} ---\n{self._tail(i)}", file=sys.stderr, flush=True)
        os._exit(1)

    def _watching(self) -> None:
        while not self._stop.wait(0.5):
            for i, p in enumerate(self.procs):
                if p.poll() not in (None, 0):
                    self._fail(f"rank {i + 1} exited with {p.returncode}")
            if time.monotonic() > self.deadline:
                self._fail("the run outlived its deadline")

    def wait(self) -> None:
        """Wait for every child to finish cleanly (within the deadline)."""
        while any(p.poll() is None for p in self.procs):
            time.sleep(0.05)
        self.close()

    def close(self) -> None:
        self._stop.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


def run(ctx) -> cell.Outcome:
    t = ctx.traffic
    world, rows = t["processes"], t["batch"]
    dev = ctx.device
    phases = {"start": time.perf_counter() - ctx.started}
    with tempfile.TemporaryDirectory(prefix="train_dp_") as work:
        address = f"file://{os.path.join(work, 'rendezvous')}"
        ranks = Ranks(ctx, world, address, work)
        try:
            ctl = join(address, 0, world, dev)
            phases["group"] = time.perf_counter() - ctx.started
            pool = global_pool(ctx, dev)
            mine = rows_of(pool, 0, rows)
            # the reference's global batches; the rest of the pool is freed
            pool = [{k: v.copy() for k, v in b.items()} for b in pool[:t["check_steps"]]]
            phases["traffic"] = time.perf_counter() - ctx.started
            tr, state, batches, gen, prog = train_steps.program_steps(ctx, mine, phases)
            counters = dict(counters_of(tr), processes=world)
            ranks_alike = compare_dp.rank_gaps(digests(ctx, ctl, state, world),
                                               sorted(state.state))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            setup_s = time.perf_counter() - ctx.started
            seconds = min(ctx.seconds, t["trace_seconds"]) if ctx.trace else ctx.seconds
            window = cell.Ctx(ctx.name, ctx.workload, ctx.config, ctx.seed, seconds,
                              ctx.trace, dev, ctx.started)
            with devtrace.traced(ctx.trace, dev.type == "cuda") as box:
                done, elapsed = steps(window, 0, ctl, tr, state, batches, gen)
            batches.close()
            memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
            del tr, state, batches, gen
            gc.collect()
            leave()
            ranks.wait()
        finally:
            ranks.close()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_dp.reference_steps(ctx, pool)
    limits = ctx.workload["limits"]
    checks = {name: (value, limits[name], where)
              for name, (value, where) in dict(compare_dp.train_gaps(prog, ref),
                                               **ranks_alike).items()
              if name in limits}
    reading = cell.Reading(box["trace"], done, rows, counters, ctx.config, ctx.workload) \
        if ctx.trace else None
    return cell.Outcome({"train_examples_s": done * rows * world / elapsed, "setup_s": setup_s},
                        done * rows * world, 0, checks, memory, reading, phases)


if __name__ == "__main__":
    sys.exit(child_main())
