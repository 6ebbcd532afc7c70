"""The controls of the benchmark's comparisons, on the card at the cell's size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--fault <fault>]

Each seed makes the cell's weights and traffic as ``run.py`` does and puts
the float32 reference, computed in the next precision below the
configuration's (its file's ``control``), in the program's place: int4 for
the int8 served engine (per-tensor activations calibrated on the cell's
calibration images, per-channel weights over the BN-folded kernels), TF32
for float32 training with TF32 off.  The numbers ``run.py`` holds against
the cell's limits are printed per seed, as one JSON line each.

``--fault`` plants a fault instead.  Training: ``half_batch``, the
reference's loss taken over the first half of each batch's rows.
Serving: a whole run of ``run.py`` (``--seconds 1``) with the served
program's answers broken where they are produced: ``stale`` (each batch
gets the last batch's answers), ``rolled`` (each answer goes to the next
post), ``half`` (the first half of the batch's answers stand for the
whole); ``sound`` is the same run unbroken.  A comparison whose control
reads under its limit on every seed could not fail a lower-precision
program.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import cell, compare, traffic, weights  # noqa: E402
from benchmark.drivers import serve_batches, train_steps  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import preprocess as ref_pre  # noqa: E402

SERVED_FAULTS = ("sound", "stale", "rolled", "half")


def serving(ctx, quant_kind: str) -> dict:
    """The lower-precision reference against the float32 one over as many
    posts as a run compares, the pool's longest caption among them."""
    t, im, data = ctx.traffic, ctx.config["image"], ctx.config["data"]
    dev = ctx.device
    params = weights.make(traffic.seed_of(ctx.seed, "weights"), dev,
                          **cell.model_sizes(ctx.config))
    pool = traffic.pool(ctx.seed, t, dev)
    kw = dict(depth_multiplier=im["depth_multiplier"], num_classes=im["num_classes"],
              eps=im["bn_epsilon"])
    q = ref_model.Quant(quant_kind)
    with ref_model.exact_f32(), torch.no_grad():
        calib = ref_pre.eval_images(traffic.images(ctx.seed, "calibration",
                                                   t["calibration_images"], t["image_hw"], dev,
                                                   traffic.style(t)),
                                    im["image_size"], data["eval_central_crop"])
        ref_model.Tower(params, quant=q, **kw)(calib)
        q.calibrating = False
        longest = int(np.argmax([b["lengths"].max() for b in pool]))
        order = [longest] + [i for i in range(len(pool)) if i != longest]
        got, want = [], []
        for i in order[:max(1, t["check_posts"] // t["batch"])]:
            b = {k: torch.from_numpy(v).to(dev) for k, v in pool[i].items()}
            x = ref_pre.eval_images(b["image"], im["image_size"], data["eval_central_crop"])
            for side, quant in ((got, q), (want, None)):
                out = ref_model.joint_forward(params, x, b["tokens"], b["lengths"], quant=quant,
                                              **kw)
                side.append(out["Predictions"].double().cpu().numpy())
    return compare.logit_gaps(np.concatenate(got), np.concatenate(want))


def served_fault(fault: str):
    """A patch of the serving driver's ``build`` whose runner breaks its
    answers as ``fault`` says (``sound``: none)."""
    real = serve_batches.build

    def build(*args):
        runner = real(*args)
        last = {}

        def broken(image, tokens, lengths):
            out = runner(image, tokens, lengths)
            b = out.shape[0]
            if fault == "stale":
                out, last["out"] = last.get("out", out), out
            elif fault == "rolled":
                out = out.roll(1, 0)
            elif fault == "half":
                out = torch.cat([out[:b // 2], out[:b - b // 2]])
            return out

        broken.program = runner.program
        return broken

    return mock.patch.object(serve_batches, "build", build)


def served_run(name: str, seed: int, fault: str, device=None) -> dict:
    """The numbers ``run.py`` compares, from a run of it with ``fault``."""
    from benchmark import run as run_mod

    out = io.StringIO()
    with served_fault(fault), contextlib.redirect_stdout(out):
        run_mod.main(["--workload", name, "--seed", str(seed), "--seconds", "1"], device=device)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    return {k: v["value"] for k, v in res["checks"].items()}


def training(ctx, kind: str) -> dict:
    pool = traffic.pool(ctx.seed, ctx.traffic, ctx.device)
    ref = train_steps.reference_steps(ctx, pool)
    if kind == "half_batch":   # the draws of the whole batch, the loss of its first half
        low = train_steps.reference_steps(ctx, pool, rows=slice(0, ctx.traffic["batch"] // 2))
    elif kind == "tf32":
        low = train_steps.reference_steps(ctx, pool, tf32=True)
    else:
        low = train_steps.reference_steps(ctx, pool, quant=ref_model.Quant(kind))
    return {k: v for k, (v, _) in compare.train_gaps(low, ref).items()}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=("half_batch",) + SERVED_FAULTS, default=None)
    args = ap.parse_args(argv)
    wl = cell.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    dev = device
    serve = wl["driver"] == "serve_batches"
    if args.fault and (args.fault in SERVED_FAULTS) != serve:
        print(f"--fault {args.fault} does not apply to {args.workload}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = cell.Ctx(args.workload, wl, wl["config_file"], seed, 0.0, False, dev, STARTED)
        t0 = time.perf_counter()
        kind = args.fault or wl["config_file"]["control"]
        if serve and args.fault:
            got = served_run(args.workload, seed, kind, None if dev.type == "cuda" else dev)
        elif serve:
            got = serving(ctx, kind)
        else:
            got = training(ctx, kind)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": kind,
                          "numbers": got, "limits": wl["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
