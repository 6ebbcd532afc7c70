"""The data-parallel cell (``joint_dp_perf-b512_dp4``) on the CPU at a small
size: two gloo processes of depth 0.25 at 139 px, 4 rows each, through
``run.py``; its per-layer metrics' readers; its controls and faults against
the cell's limits.  The card test (``-m cuda``, four cards) holds the
captured four-rank step bit for bit to the same step run op by op."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import tiny_cells  # noqa: E402

from benchmark import cell, control_dp  # noqa: E402
from benchmark.drivers import train_dp_steps  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402

CELL = "joint_dp_perf-b512_dp4"
_workload = cell.workload
METRICS = cell.HERE / "metrics"
# NCCL's kernels as the profiler recorded them in a traced window of the
# cell on four H100s (NCCL 2.28.9, torch 2.11), and the other kernels of
# the train steps' windows (the f32 cell's breakdown in PERF_LEDGER.jsonl).
NCCL_NAMES = ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",)
OTHER_NAMES = (
    "sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc",
    "void cudnn::cnn::wgrad_alg1_engine<float, float, 128, 5, 5, 3, 3, 3, false, true>",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::WelfordOps",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast",
    "Memcpy HtoD (Pinned -> Device)")


def tiny(name):
    wl = tiny_cells.shrink(_workload(name))
    if name == CELL:
        wl["traffic"].update(batch=4, processes=2)
        wl["config_file"]["train"].update(batch_size=4)
    return wl


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _run(trace=0, seed=2**31 + 7):
    from benchmark import run as run_mod

    out, err = io.StringIO(), io.StringIO()
    readings = []
    real = cell.Reading

    def reading(*args):
        readings.append(real(*args))
        return readings[-1]

    with mock.patch.object(cell, "workload", tiny), mock.patch.object(cell, "Reading", reading), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = run_mod.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                             "--trace", str(trace)], device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None), readings


def _norms():
    convs = ref_model.layer_table(139, 0.25)
    return sum(1 for c in convs if not c.head)


# The sound step's readings at this size stay under these (tests/test_torch_dp_reference.py
# measures them); the cell's own limits are set at its size (PERF.md).
TINY = {"grad_gap": 0.2, "change_gap": 0.2, "change_gap.median": 0.01, "head_gap.text": 0.08,
        "head_gap.aux": 0.4, "rank_gap": 0.0}


def test_the_cell_runs_its_processes_and_reports_its_metrics():
    code, res, _ = _run(trace=0)
    assert code == 0
    assert all(res["checks"][k]["value"] <= v for k, v in TINY.items()), res["checks"]
    assert set(res["metrics"]) == {"train_examples_s", "setup_s"}
    assert set(res["checks"]) == set(TINY)
    assert res["checks"]["rank_gap"]["value"] == 0.0
    code, res, readings = _run(trace=1)
    assert code == 0
    # no card: no NCCL kernel, no device record; the program's counter and
    # the rows still read
    assert res["metrics"]["allreduces.dp"]["value"] == 4 * _norms() + 2
    assert {"train_mfu.dp", "feed_wait_ms.dp"} <= set(res["metrics"])
    assert not {"allreduce_ms.dp", "allreduce_busbw.dp", "idle_share.dp",
                "bn_pass_ms.dp"} & set(res["metrics"])
    c = readings[0].counters
    trainable = [k for k, (s, kind) in ref_model.param_shapes(139, 0.25, 15, 1000, 200).items()
                 if kind not in ("mean", "var")]
    shapes = ref_model.param_shapes(139, 0.25, 15, 1000, 200)
    flat = sum(int(torch.Size(shapes[k][0]).numel()) for k in trainable)
    assert c["allreduce_bytes.gradient"] == 4 * flat and c["processes"] == 2
    busbw = cell.load_module(METRICS / "allreduce_busbw.dp.py")
    assert busbw.bus_bytes(c) == 2.0 * (2 - 1) / 2 * 4 * flat
    assert busbw.bus_bytes({}) is None


def test_the_nccl_pattern_matches_nccls_kernels_and_no_other():
    import re

    (pattern,) = cell.load_module(METRICS / "allreduce_ms.dp.py").NCCL
    rx = re.compile(pattern, re.IGNORECASE)
    assert all(rx.search(n) for n in NCCL_NAMES)
    assert not any(rx.search(n) for n in OTHER_NAMES)


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels


def test_the_busbw_reads_each_steps_gradient_all_reduce():
    """Synthetic steps of 6 all-reduces (2 batch norms), the gradient's the
    fifth: its kernels are the ones read, and 450 GB/s reads 100%."""
    busbw = cell.load_module(METRICS / "allreduce_busbw.dp.py")
    nbytes = 1e9
    t = nbytes * 1.5 / 450e9 * 1e9           # ns of the ring's bytes at NVLink's rate
    kernels, now = [], 0
    for _ in range(3):
        for i in range(6):
            d = t if i == 4 else 1e4
            kernels.append(("ncclDevKernel_AllReduce_Sum_f32_RING_LL", now, now + d))
            kernels.append(("void at::native::elementwise_kernel", now + d, now + d + 10))
            now += d + 100
    r = cell.Reading(_Trace(kernels), 3, 4, {"allreduces": 6, "processes": 4,
                                             "allreduce_bytes.gradient": nbytes}, {}, {})
    assert abs(busbw.read(r) - 100.0) < 1e-6
    r.counters["allreduces"] = 5                      # not whole steps: no reading
    assert busbw.read(r) is None


def test_the_bn_passes_leave_out_nccls_kernels():
    """NCCL's all-reduce kernels hold "Reduce" in their names, which
    ``bn_pass_ms.train``'s patterns match: ``bn_pass_ms.dp`` counts the
    elementwise and reduction kernels of a step and no NCCL kernel."""
    from benchmark import devtrace

    names = NCCL_NAMES + OTHER_NAMES
    kernels = [(n, i * 100, i * 100 + 10 * (i + 1)) for i, n in enumerate(names)]
    trace = devtrace.Trace(0, 10_000, kernels, kernels, [], [])
    r = cell.Reading(trace, 2, 128, {}, {}, {})
    got = cell.load_module(METRICS / "bn_pass_ms.dp.py").read(r)
    passes = sum(b - a for n, a, b in kernels if "elementwise" in n or "Welford" in n)
    assert abs(got - 1e3 * passes / 1e9 / 2) < 1e-12
    train = cell.load_module(METRICS / "bn_pass_ms.train.py").read(r)
    assert train > got                       # the train cell's reader counts NCCL's


def _control(kind, seeds):
    out = io.StringIO()
    with mock.patch.object(cell, "workload", tiny), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        control_dp.main(["--workload", CELL, "--seeds", ",".join(map(str, seeds)),
                         "--control", kind], device=torch.device("cpu"))
    return [json.loads(s)["numbers"] for s in out.getvalue().strip().splitlines()]


@pytest.mark.parametrize("kind", ["bf16_masters", "fp8", "local_statistics", "dropped_rank"])
def test_each_control_breaks_a_limit_of_the_cell(kind):
    limits = _workload(CELL)["limits"]
    for numbers in _control(kind, [11]):
        assert any(numbers[k] > v for k, v in limits.items() if k in numbers), numbers


_FOUR_RANKS = """
import json, os, sys
import torch
sys.path.insert(0, os.getcwd())
from benchmark import cell, traffic
from benchmark.drivers import train_dp_steps, train_steps

rank, address, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dev = torch.device("cuda", rank)
wl = cell.workload("joint_dp_perf-b512_dp4")
wl["traffic"].update(batch=32, pool_batches=3)
train_dp_steps.join(address, rank, 4, dev)
states = []
for graph in ("true", "false"):
    os.environ["TET_TORCH_TRAIN_COMPILER_OPTIONS"] = json.dumps({"cuda_graph": graph})
    ctx = cell.Ctx("cuda test", wl, wl["config_file"], 123, 0.0, False, dev, 0.0)
    pool = train_dp_steps.rows_of(train_dp_steps.global_pool(ctx, dev), rank, 32)
    tr, state, batches, gen, prog = train_steps.program_steps(ctx, pool)
    assert tr.step_mode == ("captured" if graph == "true" else "eager"), tr.step_mode
    batches.close()
    states.append({k: v.detach().cpu() for k, v in state.state.items()})
    del tr, state, batches, gen
torch.distributed.destroy_process_group()
same = all(torch.equal(states[0][k], states[1][k]) for k in states[0])
json.dump({"same": same, "leaves": len(states[0])}, open(out, "w"))
"""


@pytest.mark.cuda
def test_the_captured_four_rank_step_is_the_eager_one(tmp_path):
    """Four processes over NCCL, one card each, the cell's configuration at
    32 rows a card: three steps through ``Trainer.compile``'s captured graph
    and three op by op from the same weights and batches leave every
    process's state bit-equal."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    root = cell.HERE.parent
    address = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", _FOUR_RANKS, str(r), address,
                               str(tmp_path / f"r{r}.json")], env=env, cwd=root)
             for r in range(4)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0, 0, 0]
    for r in range(4):
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got["same"] and got["leaves"] > 0, (r, got)
