"""The port's ``data_parallel`` step over a two-process gloo group against
the plain float32 reference's one-process step over the global batch
(``benchmark/reference/train.py``), on seeded random weights: the
benchmark's data-parallel driver (``benchmark/drivers/train_dp_steps.py``)
on the CPU, its cell cut to depth 0.25, 139 px, a 1,000-word vocabulary and
4 rows a process, each process a gloo rank (rank 1 a child process).

The step is the preset's own: bf16 on float32 masters, batch norm over the
global 8 rows through autograd all-reduces, the distortions and dropout
drawn for the global batch.  It is held to the reference with the
benchmark's comparison (``benchmark/compare_dp.py``): bf16 steps never
agree bit for bit, and train-mode batch norm over 8 rows passes every
rounding on through the tower, so each tolerance sits about twice above the
largest reading of the sound step (seeds 5 and 6, on the CPU: worst leaf
0.109 and 0.119 on its scale, worst change 0.087 and 0.104, median change
0.0060 and 0.0059, the embedding's gradient 0.037 and 0.029 and the
auxiliary head's 0.217 and 0.220 element by element, ``rank_gap`` 0
exactly: every process holds the same state) and below what a broken step
reads: rank 0's gradient left out of the all-reduce (worst leaf 0.34, worst
change 0.36, median change 0.015, the embedding 0.55, the auxiliary head
0.66) and batch norm on each process's rows alone (``rank_gap`` 0.71).
"""

import contextlib
import sys
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import cell, control_dp  # noqa: E402
from benchmark.drivers import train_dp_steps  # noqa: E402

CELL = "joint_dp_perf-b512_dp4"
TOLERANCE = {"grad_gap": 0.2, "change_gap": 0.2, "change_gap.median": 0.01,
             "head_gap.text": 0.08, "head_gap.aux": 0.4, "rank_gap": 0.0}
_workload = cell.workload


def _tiny(name):
    wl = _workload(name)
    cfg, t = wl["config_file"], wl["traffic"]
    cfg["image"].update(image_size=139, depth_multiplier=0.25)
    cfg["text"].update(vocab_size=1000)
    cfg["train"].update(batch_size=4)
    t["captions"].update(vocab_size=1000)
    t.update(batch=4, processes=2, pool_batches=3, image_hw=[160, 170], trace_seconds=1)
    return wl


def _checks(seed, broken=contextlib.nullcontext()):
    """The numbers the driver holds against the cell's limits (run.py's
    own checks stand aside: this process has loaded JAX)."""
    wl = _tiny(CELL)
    ctx = cell.Ctx(CELL, wl, wl["config_file"], seed, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with broken:
            out = train_dp_steps.run(ctx)
    finally:
        torch.set_num_threads(saved)
    return {k: v for k, (v, _, _) in out.checks.items()}


@pytest.mark.parametrize("seed", [5, 6])
def test_two_processes_take_the_references_global_step(seed):
    got = _checks(seed)
    for name, tol in TOLERANCE.items():
        assert got[name] <= tol, (name, got[name], tol)


def test_a_rank_left_out_of_the_gradient_is_refused():
    got = _checks(5, control_dp.dropped_rank())
    assert all(got[k] > TOLERANCE[k] for k in ("grad_gap", "change_gap", "change_gap.median",
                                               "head_gap.text", "head_gap.aux")), got


def test_batch_norm_on_each_process_alone_is_refused():
    with mock.patch.object(control_dp.train_dp_steps, "CHILD", "benchmark.control_dp"), \
            mock.patch.dict("os.environ", {control_dp.FAULT_VAR: "local_statistics"}):
        got = _checks(6, control_dp.local_statistics())
    assert got["rank_gap"] > 0.1
