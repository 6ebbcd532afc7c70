"""Runs of the benchmark on the CPU at a small size (depth 0.25, 139 px):
the reference against the port's float32 path, a cell added as files only,
the controls, and runs with the timed path broken underneath, which have
to come out not correct.  Card-only tests are marked ``cuda``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny_cells  # noqa: E402

from benchmark import cell, compare, control, traffic  # noqa: E402
from benchmark import run as run_mod  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import preprocess as ref_pre  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402

SERVE, TRAIN = "joint_int8-b64", "joint_finetune_f32-b32"


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


def _port_parts(depth=0.25, size=139):
    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.models import build_model, joint_model

    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=depth, image_size=size))
    state = joint_model.init_state(build_model(cfg, device="meta"), 0)
    return cfg, state


def test_reference_serves_what_the_ports_float32_path_serves():
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.models import build_model

    cfg, state = _port_parts()
    shapes = ref_model.param_shapes(139, 0.25)
    assert {k: s for k, (s, _) in shapes.items()} == {k: tuple(v.shape) for k, v in state.items()}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    g = torch.Generator().manual_seed(0)
    u8 = torch.randint(0, 256, (4, 160, 170, 3), generator=g, dtype=torch.uint8)
    tokens = torch.randint(2, 50000, (4, 50), generator=g)
    lengths = torch.tensor([0, 50, 7, 12])
    x = ref_pre.eval_images(u8, 139)
    assert (preprocess_for_eval(u8, 139, 139) - x).abs().max() < 1e-6
    with torch.no_grad():
        want = model(x, tokens, lengths)[1]["Predictions"]
        got = ref_model.joint_forward(state, x, tokens, lengths, depth_multiplier=0.25)
    assert compare.logit_gaps(want.numpy(), got["Predictions"].numpy())["logit_gap"] < 1e-5


def test_reference_draws_and_trains_as_the_ports_float32_step():
    from tumblr_emotions_torch.data import preprocessing as pp
    from tumblr_emotions_torch.train.trainer import Trainer

    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    port, ref = pp.draw_train(g1, 64, (160, 170)), ref_pre.draw(g2, 64, (160, 170))
    for a, b in (("oy", "oy"), ("ox", "ox"), ("ch", "ch"), ("cw", "cw"), ("flip", "flip"),
                 ("delta", "delta"), ("factor", "factor"), ("order", "bright_first")):
        assert torch.equal(getattr(port, a), ref[b]), a
    cfg, state = _port_parts()
    cfg = cfg.replace(train=cfg.train.replace(batch_size=16))
    tr = Trainer(cfg, preprocess="train", device="cpu")
    ts = tr.init_state(state)
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (16, 160, 170, 3), generator=g, dtype=torch.uint8),
             "tokens": torch.randint(2, 50000, (16, 50), generator=g, dtype=torch.int32),
             "lengths": torch.randint(1, 51, (16,), generator=g, dtype=torch.int32),
             "label": torch.randint(0, 15, (16,), generator=g)}
    _, m = tr.train_step(ts, batch, torch.Generator().manual_seed(7))
    nu = ts.opt_state["nu"]
    prog = {"loss": [float(m["loss"])], "change": {k: ts.state[k].detach() - state[k]
                                                   for k in nu},
            "grad_abs": {k: (v / 0.1).sqrt() for k, v in nu.items()}}
    hp = dict(cfg.image.__dict__, **cfg.train.__dict__)
    ref = ref_train.run_steps(state, [batch], [7], hp)
    gaps = compare.train_gaps(prog, ref)
    assert gaps["loss_gap.step1"][0] < 1e-5
    assert gaps["grad_gap"][0] < 0.05 and gaps["grad_gap.median"][0] < 1e-3


def test_a_cell_added_as_files_only_is_found_and_run(tmp_path):
    """A new traffic mix (data only) and a new per-layer metric (a reader of
    its own), added with their ``BENCHMARK.json`` entries, run through the
    unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_cells.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tiny_cells.ROOT / "BENCHMARK.json").read_text())
    wl = json.loads((root / "benchmark/workloads/joint_int8-b64.json").read_text())
    wl["traffic"]["batch"] = 4
    (root / "benchmark/workloads/joint_int8-b4.json").write_text(json.dumps(wl))
    (root / "benchmark/metrics/rows_per_batch.serve.py").write_text(
        "def read(r):\n    return None if r is None else float(r.rows)\n")
    bench["workloads"].append({"name": "joint_int8-b4", "config": "joint_int8",
                               "traffic": "joint_int8-b4", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("joint_int8-b4")
    bench["per_layer"].append({"name": "rows_per_batch.serve", "unit": "posts",
                               "better": "higher", "source": "program_counter",
                               "layer": "served step", "moves": "serve_posts_s",
                               "workloads": ["joint_int8-b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with mock.patch.object(cell, "HERE", root / "benchmark"), \
            mock.patch.object(run_mod, "ROOT", root):
        code, res, _ = tiny_cells.run("joint_int8-b4", trace=1)
    assert code == 0 and res["correct"]
    assert set(res["metrics"]) == {"rows_per_batch.serve"}   # the metrics that name it
    assert res["metrics"]["rows_per_batch.serve"]["value"] == 4.0


def test_a_run_reports_its_cells_metrics_and_checks_last():
    code, res, err = tiny_cells.run(SERVE, trace=0)
    assert code == 0 and res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_posts_s", "setup_s"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == {"logit_gap", "logit_gap.rel"}
    assert [s.split()[1] for s in err.strip().splitlines()[-2:]] == list(res["checks"])
    code, res, _ = tiny_cells.run(TRAIN, trace=1)
    assert code == 0 and res["correct"]
    assert {"feed_wait_ms.train", "train_mfu"} <= set(res["metrics"])
    assert set(res["checks"]) == {"loss_gap.step1", "grad_gap", "grad_gap.median", "change_gap"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_mod.main(["--workload", SERVE, "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_jax_loaded_means_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "flax", mock.MagicMock())
    code, res, err = tiny_cells.run(SERVE)
    assert code == 3 and res is None and "flax" in err


def _shrunk(name):
    return tiny_cells.shrink(_real_workload(name))


_real_workload = cell.workload


def _control(workload, seeds, fault=()):
    lines = []
    with mock.patch.object(cell, "workload", _shrunk), \
            mock.patch("builtins.print", lambda s, **k: lines.append(s)):
        control.main(["--workload", workload, "--seeds", ",".join(map(str, seeds)),
                      *fault], device=torch.device("cpu"))
    return [json.loads(s)["numbers"] for s in lines]


def test_controls_read_far_above_sound_runs():
    """At this size: the int4 engine in the int8 program's place, and the
    float32 step with the loss over half of each batch; the program's own
    readings over the same seeds stay far below them.  (TF32, the float32
    cell's control, exists on the card only: ``test_controls_on_the_card``.)"""
    seeds = [11, 12, 13]
    sound = [tiny_cells.run(SERVE, seed=s)[1]["checks"]["logit_gap"]["value"] for s in seeds]
    int4 = [n["logit_gap"] for n in _control(SERVE, seeds)]
    assert min(int4) > 3 * max(sound)
    half = [n["grad_gap.median"] for n in _control(TRAIN, seeds, ["--fault", "half_batch"])]
    limit = _real_workload(TRAIN)["limits"]["grad_gap.median"]
    assert min(half) > 10 * limit


@pytest.mark.cuda
def test_controls_on_the_card(capsys):
    """The controls at the cells' own size, on the card: each breaks one of
    its cell's limits on every seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in (SERVE, TRAIN):
        limits = _real_workload(name)["limits"]
        assert control.main(["--workload", name, "--seeds", "31,32,33"]) == 0
        for line in capsys.readouterr().out.strip().splitlines():
            numbers = json.loads(line)["numbers"]
            assert any(numbers[k] > v for k, v in limits.items())


def _full_width(wl):
    """The serving cell at its own widths (299 px, depth 1.0) but 32 posts
    and 16 calibration images: at depth 0.25 and 139 px two posts' answers
    lie too close together for a misrouted answer to show."""
    wl = _small(wl)
    wl["config_file"]["image"].update(image_size=299, depth_multiplier=1.0)
    wl["traffic"].update(image_hw=[347, 347], batch=32, pool_batches=2, check_posts=32)
    return wl


_small = tiny_cells.shrink


@pytest.mark.parametrize("fault", control.SERVED_FAULTS)
def test_a_broken_served_path_is_not_correct(fault):
    """Each fault a served cell can have (``control.served_fault``): a step
    that returns its last answers, an answer altered (sent to the next
    post) and half of the batch left out; ``sound`` is the unbroken run."""
    with mock.patch.object(tiny_cells, "shrink", _full_width), control.served_fault(fault):
        code, res, _ = tiny_cells.run(SERVE, seconds=0.1)
    assert code == 0 and res["correct"] is (fault == "sound")


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault):
    from tumblr_emotions_torch.train import optim, trainer

    real_ce = trainer.cross_entropy
    patches = {
        "state_unchanged": mock.patch.object(optim.Optimizer, "apply",
                                             lambda self, *a, **k: None),
        "half_batch": mock.patch.object(
            trainer, "cross_entropy",
            lambda logits, labels, reduce=True: real_ce(logits[:len(labels) // 2],
                                                        labels[:len(labels) // 2], reduce)),
    }
    with patches[fault]:
        code, res, _ = tiny_cells.run(TRAIN)
    assert code == 0 and res["correct"] is False


def test_traffic_gives_every_seed_the_same_work():
    p = _real_workload(SERVE)["traffic"]["captions"]
    a, b = traffic.captions(1, 1024, p), traffic.captions(2**40 + 3, 1024, p)
    assert sorted(a["lengths"]) == sorted(b["lengths"]) and a["lengths"].max() == 50
    assert not np.array_equal(a["tokens"], b["tokens"])
    assert (a["tokens"][np.arange(50)[None] >= a["lengths"][:, None]] == 0).all()
    assert a["tokens"].max() < 50000 and a["tokens"][:, 0].min() >= 2
