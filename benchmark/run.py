"""One run of one benchmark cell of the PyTorch/H100 port, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's driver (``benchmark/drivers/``)
makes its weights and traffic from the seed, builds the port's program,
warms it up (set-up, ``setup_s``), runs the measured window, then checks
what the window produced against the plain reference
(``benchmark/reference/``).  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` profiles the window and reports its per-layer
metrics (``benchmark/metrics/``), the device's busy seconds and the
breakdown.  The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error.  Exits 2 without a card (or with fewer than the cell asks
for) and 3 if JAX or the JAX package was loaded, printing no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import cell  # noqa: E402


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed places inside the checkout: only a checkout's
    # first run builds
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    bench = cell.load_json(ROOT / "BENCHMARK.json")
    wl = cell.workload(args.workload)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            print(f"needs {wl['chips']} CUDA card(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count() "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    ctx = cell.Ctx(args.workload, wl, wl["config_file"], args.seed, args.seconds,
                   bool(args.trace), device, STARTED)
    driver = importlib.import_module(f"benchmark.drivers.{wl['driver']}")
    out = driver.run(ctx)
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3

    metrics = {}
    for m in cell.metrics_of(bench, args.workload, ctx.trace):
        if ctx.trace:
            value = cell.load_module(cell.HERE / "metrics" / f"{m['name']}.py").read(out.reading)
        else:
            value = out.end_to_end[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": wl["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": all(v <= lim for v, lim, _ in out.checks.values()),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": dev}
    if ctx.trace and out.reading is not None and out.reading.trace is not None:
        tr = out.reading.trace
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = tr.breakdown()
        print(f"trace: {len(tr.kernels)} kernels, device records {tr.kinds}", file=sys.stderr)
    print("set-up phases, seconds from the process's start: "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.phases.items()), file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in out.checks.items()}
    for k, (v, lim, where) in out.checks.items():
        print(f"check {k} {v!r} limit {lim!r} ({where})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
