"""The port's TensorBoard event writer and profiler hook
(``tumblr_emotions_torch/utils/summaries.py``) against the JAX package's
(``clu``'s writer over TF in this environment), both read back with
TensorBoard's own event loader (imported here only; the port imports
neither TensorBoard nor clu)."""

import ast
import contextlib
import glob
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tumblr_emotions_torch import get_preset as tpreset
from tumblr_emotions_torch.models import build_model, text_model
from tumblr_emotions_torch.train import trainer as ttrainer
from tumblr_emotions_torch.utils import summaries as tsum
from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu.parallel import mesh as mesh_lib
from tumblr_emotions_tpu.train import trainer as jtrainer
from tumblr_emotions_tpu.utils import summaries as jsum

torch.set_num_threads(2)
V, D, T, B = 32, 8, 6, 4


def _read(logdir):
    """{tag: [(step, value)]} as TensorBoard loads the run."""
    from tensorboard.backend.event_processing import plugin_event_accumulator as pea
    from tensorboard.util import tensor_util

    acc = pea.EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                  for e in acc.Tensors(tag)] for tag in acc.Tags()["tensors"]}


def _raw_events(logdir):
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    (path,) = glob.glob(str(logdir / "*tfevents*"))
    return list(EventFileLoader(path).Load())


CALLS = [(1, {"train/loss": 2.5, "train/accuracy": 0.25}),
         (2, {"train/loss": 2.25, "train/learning_rate": 1e-3}),
         (10, {"eval/accuracy": 0.5, "eval/loss": 1.0 / 3.0}),
         (123456789, {"x": -7.0e-9})]


def test_event_file_reads_back_equal_to_the_reference_writer(tmp_path):
    for module, d in ((jsum, tmp_path / "jax"), (tsum, tmp_path / "port")):
        w = module.SummaryWriter(str(d))
        for step, scalars in CALLS:
            w.write_scalars(step, scalars)
        w.flush()
        w.close()
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert got == want and len(got) == 6
    # event for event, the same protos but the wall time (and the writer's
    # name in the file header)
    jraw, traw = _raw_events(tmp_path / "jax"), _raw_events(tmp_path / "port")
    assert traw[0].file_version == jraw[0].file_version == "brain.Event:2"
    assert len(traw) == len(jraw) == 8
    for a, b in zip(jraw[1:], traw[1:]):
        assert a.step == b.step and a.summary == b.summary


def test_writer_without_a_logdir_writes_nothing(tmp_path):
    w = tsum.SummaryWriter("")
    w.write_scalars(1, {"a": 1.0})
    w.flush()
    w.close()
    assert w.path is None


def _text_cfgs(log_dir, **train):
    out = []
    for c in (jconfig, None):
        cfg = c.get_preset("text_only") if c else tpreset("text_only")
        cfg = cfg.replace(text=cfg.text.replace(vocab_size=V, embed_dim=D, max_len=T),
                          train=cfg.train.replace(batch_size=B, log_dir=str(log_dir / (
                              "jax" if c else "port")), log_every=1, **train))
        out.append(cfg)
    return out


def _text_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, V, (B, T)).astype(np.int32),
             "lengths": rng.randint(0, T + 1, B).astype(np.int32),
             "label": rng.randint(0, 15, B).astype(np.int32)} for _ in range(n)]


def test_fit_writes_the_reference_scalars(tmp_path):
    """``fit`` (text_only, 4 steps, a checkpoint and an evaluation at step 2
    and at the end) writes the reference's train/* and eval/* tags at its
    steps; losses, accuracies, the learning rate and the eval numbers agree
    with the JAX trainer's on the same weights and batches (examples/s is a
    host clock)."""
    jcfg, tcfg = _text_cfgs(tmp_path, checkpoint_every=2, num_steps=4)
    jcfg = jcfg.replace(train=jcfg.train.replace(checkpoint_dir=str(tmp_path / "jck")))
    tcfg = tcfg.replace(train=tcfg.train.replace(checkpoint_dir=str(tmp_path / "tck")))
    state = text_model.init_state(build_model(tcfg, device="meta"), 0)
    batches, ev = _text_batches(4), _text_batches(2, seed=1)
    tr = ttrainer.Trainer(tcfg, device="cpu")
    tr.checkpoint_manager()
    tr.fit(tr.init_state(state), batches, eval_batches=lambda: ev)
    from tumblr_emotions_torch import convert

    mesh = mesh_lib.create_mesh(jconfig.MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(jcfg, mesh=mesh)
    js = jtr.init_state(jax.random.PRNGKey(0), batches[0],
                        initial_variables=convert.to_variables(state))
    jtr.checkpoint_manager()
    jtr.fit(js, iter(batches), eval_batches=lambda: ev)
    want, got = _read(tmp_path / "jax"), _read(tmp_path / "port")
    assert sorted(got) == sorted(want) == sorted(
        ["train/loss", "train/accuracy", "train/examples_per_sec", "train/learning_rate",
         "eval/accuracy", "eval/loss"])
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
        if tag != "train/examples_per_sec":
            np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                                       rtol=1e-5, err_msg=tag)
    assert [s for s, _ in got["eval/loss"]] == [2, 4, 4]


def test_profiler_hook_traces_exactly_its_window(tmp_path):
    """profile_start_step 2, profile_num_steps 2 over 5 steps: the trace
    holds the ``train_step`` ranges of steps 2 and 3 and no other."""
    _, tcfg = _text_cfgs(tmp_path, profile_start_step=2, profile_num_steps=2)
    state = text_model.init_state(build_model(tcfg, device="meta"), 0)
    tr = ttrainer.Trainer(tcfg, device="cpu")
    tr.fit(tr.init_state(state), _text_batches(5), num_steps=5)
    assert tr.last_trace == str(tmp_path / "port" / "trace_steps_2-3.json")
    trace = json.load(open(tr.last_trace))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {n for n in names if str(n).startswith("train_step ")} == {"train_step 2",
                                                                      "train_step 3"}
    assert any("addmm" in str(n) or "aten::" in str(n) for n in names)


@pytest.mark.parametrize("start,num,want", [(0, 3, None), (1, 1, (1, 1)), (4, 3, (4, 6))])
def test_profiler_hook_window(tmp_path, start, num, want):
    hook = tsum.ProfilerHook(str(tmp_path), start, num)
    if want is None:
        assert hook.trace_path is None
    else:
        assert hook.trace_path.endswith(f"trace_steps_{want[0]}-{want[1]}.json")
    assert tsum.ProfilerHook("", 3, 2).trace_path is None


def test_read_scalars_reads_what_tensorboard_reads(tmp_path):
    """The port's own reader (``chip_smoke.py`` reads fit's event file with
    it, importing no TensorBoard) against TensorBoard's,
    on the reference writer's file and on the port's."""
    for module, d in ((jsum, tmp_path / "jax"), (tsum, tmp_path / "port")):
        w = module.SummaryWriter(str(d))
        for step, scalars in CALLS:
            w.write_scalars(step, scalars)
        w.close()
        (path,) = glob.glob(str(d / "*tfevents*"))
        got = tsum.read_scalars(path)
        assert got == {k: [(s, float(np.float32(v))) for s, v in vals]
                       for k, vals in _read(d).items()}


def _ranges(prof, name):
    return [e for e in prof.profiler.kineto_results.events() if e.name() == name]


@pytest.mark.parametrize("name", ["captured.stage", "prefetch.wait"])
def test_a_span_is_a_profiler_range_only_while_one_runs(name):
    """No profiler: every span is the one shared null context (nothing
    made, nothing recorded).  Under one: a range of that name around the
    work inside it, and an operator's record, not a user annotation (which
    the profiler would mirror onto the card as device work)."""
    off = tsum.span(name)
    assert isinstance(off, contextlib.nullcontext) and off is tsum.span("trainer.bind")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with off:
            torch.ones(2).mul_(2)
        with tsum.span(name):
            torch.ones(2).add_(1)
    (rng,) = _ranges(prof, name)
    (add,) = _ranges(prof, "aten::add_")
    assert rng.start_ns() <= add.start_ns() and add.end_ns() <= rng.end_ns()
    assert rng.start_ns() > _ranges(prof, "aten::mul_")[0].end_ns()
    assert not rng.is_user_annotation() and rng.activity_type() == "cpu_op"


def _program_span_names():
    """The name of every ``span(...)`` call in the port's source."""
    names = set()
    for path in sorted(Path(tsum.__file__).resolve().parents[1].rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return sorted(names)


PROGRAM_SPANS = ["captured.capture", "captured.copy_in", "captured.copy_out",
                 "captured.launch", "captured.stage", "captured.wait", "dp.allreduce",
                 "prefetch.wait", "trainer.bind"]


def test_the_program_spans_are_the_listed_ones():
    assert _program_span_names() == PROGRAM_SPANS


@pytest.mark.parametrize("name", PROGRAM_SPANS)
def test_no_program_span_is_named_as_one_of_the_benchmarks(name, monkeypatch):
    """The benchmark reads a range named as its own spans as its own
    (``benchmark/devtrace.SPANS``); the program's ranges are read as host
    operations inside them."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from benchmark import devtrace

    assert name not in devtrace.SPANS
