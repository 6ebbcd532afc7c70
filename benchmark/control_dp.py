"""The controls of the data-parallel cell's comparison, at the cell's size.

    python3 benchmark/control_dp.py --workload <cell> --seeds 1,2,3 [--control <kind>]

Each seed makes the cell's weights and traffic as ``run.py`` does.  Kinds:

- ``bf16_masters``, the configuration's ``control`` (the default): bf16
  without float32 master weights.  The float32 reference over the global
  batch with its weights held in bf16: made so, and rounded to bf16 before
  each step's loss (the last step's update is left unrounded); one card.
- ``fp8``, the configuration's ``compute_control``: a compute precision
  below bf16.  The reference with e4m3 operands of every conv and dense
  layer and e5m2 gradients, each scaled per tensor
  (``reference/model.Quant``); one card.
- ``local_statistics``: a whole run of ``run.py`` (``--seconds 1``) with
  every process's batch norms taking the statistics of its own rows alone
  (no all-reduce), every process of the cell;
- ``dropped_rank``: a whole run with rank 0's gradient left out of the
  all-reduce (its flat gradient zeroed before the sum);
- ``sound``: the same run unbroken.

The reference kinds are compared with the float32 reference as
``compare_dp`` compares the program; the runs print the numbers ``run.py``
compared.  One JSON line a seed.  A comparison whose controls read under
its limits could not fail a program that lost its updates, computed in a
lower precision, or lost its global statistics or a rank's gradient.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import cell, compare_dp, reference_dp, weights  # noqa: E402
from benchmark.drivers import train_dp_steps  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402

REFERENCE = ("bf16_masters", "fp8")
RUNS = ("local_statistics", "dropped_rank", "sound")
FAULT_VAR = "CONTROL_DP_FAULT"     # the fault a child process of a run applies


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


@contextlib.contextmanager
def bf16_masters():
    """The reference's weights made in bf16 and rounded to it before each
    step's loss."""
    real_make, real_loss = weights.make, ref_train.loss

    def make(*args, **kwargs):
        return {k: _bf16(v) for k, v in real_make(*args, **kwargs).items()}

    def loss(params, *args, **kwargs):
        with torch.no_grad():
            for k in ref_train.trainable_keys(params):
                params[k].copy_(_bf16(params[k]))
        return real_loss(params, *args, **kwargs)

    with mock.patch.object(weights, "make", make), mock.patch.object(ref_train, "loss", loss):
        yield


def reference(ctx, kind: str) -> dict:
    pool = train_dp_steps.global_pool(ctx, ctx.device)[:ctx.traffic["check_steps"]]
    ref = reference_dp.reference_steps(ctx, pool)
    if kind == "bf16_masters":
        with bf16_masters():
            low = reference_dp.reference_steps(ctx, pool)
    else:
        low = reference_dp.reference_steps(ctx, pool, quant=ref_model.Quant(kind))
    return {k: v for k, (v, _) in compare_dp.train_gaps(low, ref).items()}


@contextlib.contextmanager
def local_statistics():
    """Each batch norm of the trainer's model on its process's rows alone."""
    from tumblr_emotions_torch.models.layers import SlimBatchNorm
    from tumblr_emotions_torch.train import trainer

    real = trainer.set_data_parallel

    def set_data_parallel(model, group=None, rank=0, world=1):
        real(model, group, rank, world)
        for m in model.modules():
            if isinstance(m, SlimBatchNorm):
                m.group = None

    with mock.patch.object(trainer, "set_data_parallel", set_data_parallel):
        yield


@contextlib.contextmanager
def dropped_rank(rank: int = 0):
    """Rank ``rank``'s flat gradient zeroed before the all-reduce sums it."""
    from tumblr_emotions_torch.parallel import distributed

    real = distributed.all_reduce_

    def all_reduce_(t, group=None, kind="other"):
        if kind == "gradient" and torch.distributed.get_rank(group) == rank:
            t.zero_()
        return real(t, group, kind)

    with mock.patch.object(distributed, "all_reduce_", all_reduce_):
        yield


def fault(kind: str):
    return {"local_statistics": local_statistics, "dropped_rank": dropped_rank}.get(
        kind, contextlib.nullcontext)()


def whole_run(name: str, seed: int, kind: str, device=None) -> dict:
    """The numbers ``run.py`` compares, from a run of it with the fault
    ``kind`` (or ``sound``) in every process it applies to."""
    from benchmark import run as run_mod

    out = io.StringIO()
    with fault(kind), mock.patch.object(train_dp_steps, "CHILD", "benchmark.control_dp"), \
            mock.patch.dict(os.environ, {FAULT_VAR: kind}), contextlib.redirect_stdout(out):
        code = run_mod.main(["--workload", name, "--seed", str(seed), "--seconds", "1"],
                            device=device)
    lines = out.getvalue().strip().splitlines()
    if code or not lines:
        raise RuntimeError(f"run.py exited with {code}")
    return {k: v["value"] for k, v in json.loads(lines[-1])["checks"].items()}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=REFERENCE + RUNS, default=None)
    args = ap.parse_args(argv)
    wl = cell.workload(args.workload)
    kind = args.control or wl["config_file"]["control"]
    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if kind in RUNS:
            got = whole_run(args.workload, seed, kind, None if device.type == "cuda" else device)
        else:
            ctx = cell.Ctx(args.workload, wl, wl["config_file"], seed, 0.0, False, device,
                           STARTED)
            got = reference(ctx, kind)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": kind,
                          "numbers": got, "limits": wl["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:       # a rank above 0 of a whole run, with its fault
        with fault(os.environ.get(FAULT_VAR, "sound")):
            sys.exit(train_dp_steps.child_main())
    sys.exit(main())
