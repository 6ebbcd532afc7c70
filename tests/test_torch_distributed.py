"""Data parallelism in the port on the CPU: the cluster set-up, two gloo
processes against one, lockstep sharded evaluation and the two-process CLI.

The reference's own tests are the model: ``tests/test_distributed.py``
(two processes train, checkpoint, restart and train on, equal to one
process over the same global batches) and ``tests/test_eval_loop.py``
(ragged sharded eval equal to the full eval).  Children are this file run
as a script (``python tests/test_torch_distributed.py <mode> <rank>
<world> <address> <workdir>``), one thread each, meeting through a
file in the work directory.
Sizes are small: the joint model at depth 0.25 and 75 px without the aux
head, 4 rows per process, records of the fixture JPEGs resized to 100 px.
"""

import json
import os
import re
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "jpeg"
WORDS = ["happy", "sad", "love", "rain", "sun", "tired", "wow", "calm", "day", "cat"]
LOCAL_B, HOST = 4, 100
IMAGE = 75
LR = 1e-6
STEPS, FIRST = 5, 3            # the 2-process run stops after FIRST, restarts, goes on
CHILD_TIMEOUT_S = 300
# Two processes against one process on the same global batches, f32: the
# 2-process batch norm sums its statistics in another order, and training
# the whole tower is chaotic at f32 resolution (tests/test_torch_train.py),
# so the distance of the updates, ||(a - a0) - (b - b0)|| / ||b - b0||, is
# held within NOISE_FACTOR of the one-process run's own floor (its distance
# to runs from weights moved by NOISE_EPS of themselves, NOISE_SEEDS).  The
# learning rate LR keeps the five steps near the initial weights, so the
# steps' gradients are compared rather than trajectories that chaos has
# pulled apart (at joint_finetune's 1e-4 the floor is 0.44-0.65).
# Measured: parameters 0.0030 against a floor of 0.0058, batch-norm
# statistics 2.1e-5 against 2.9e-5; per-process statistics instead: 2.37
# and 0.20.
NOISE_FACTOR = 3.0
NOISE_EPS = 1e-7
NOISE_SEEDS = (1, 2, 3)
# The text model (no batch norm) is steady: two processes equal one to f32
# summation order.  Measured 4.7e-8 of max|w| (the embedding), per leaf.
TEXT_TOL = 1e-5


def _cfg(model="joint", seed=0):
    from tumblr_emotions_torch import get_preset

    cfg = get_preset("text_only" if model == "text" else "joint_finetune")
    return cfg.replace(
        image=cfg.image.replace(depth_multiplier=0.25, image_size=IMAGE, min_depth=8,
                                create_aux_logits=False),
        text=cfg.text.replace(max_len=8),
        train=cfg.train.replace(batch_size=LOCAL_B, eval_batch_size=LOCAL_B, seed=seed,
                                log_every=1, checkpoint_every=FIRST,
                                learning_rate=LR if model == "joint" else cfg.train.learning_rate))


def _pipeline(data, vocab, rank, world, train=True, batch=LOCAL_B):
    from tumblr_emotions_torch.data import pipeline

    pcfg = pipeline.PipelineConfig(
        batch_size=batch, host_size=HOST, max_len=8, shuffle=train, seed=0,
        num_epochs=None if train else 1, drop_remainder=train, decode_threads=1,
        shard_index=rank, shard_count=world)
    return pipeline.batches(str(Path(data) / ("train-*.tfrecord" if train else
                                              "validation-*.tfrecord")), vocab, pcfg)


def _vocab(data):
    from tumblr_emotions_torch.data.vocab import Vocabulary

    return Vocabulary.load(str(Path(data) / "vocab.txt"))


def _init(cfg):
    from tumblr_emotions_torch.models import build_model, joint_model, text_model

    init = text_model.init_state if cfg.model == "text" else joint_model.init_state
    return init(build_model(cfg, device="meta"), 0)


def _fitted_cfg(cfg, data):
    return cfg.replace(text=cfg.text.replace(vocab_size=_vocab(data).size))


# ---------------------------------------------------------------------------
# The children
# ---------------------------------------------------------------------------

def _child(mode, rank, world, address, workdir):
    torch.set_num_threads(1)
    from tumblr_emotions_torch.models.layers import set_data_parallel
    from tumblr_emotions_torch.parallel import distributed
    from tumblr_emotions_torch.train.trainer import Trainer

    assert distributed.maybe_initialize(address, world, rank, device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    work = Path(workdir)
    out = work / f"{mode}.{rank}"
    if mode == "allreduce":
        t = torch.tensor([float(rank + 1)], requires_grad=True)
        s = distributed.all_reduce(t * 2)
        (g,) = torch.autograd.grad(s.sum() * (rank + 1), t)
        json.dump({"sum": s.item(), "grad": g.item(), "shard": distributed.host_shard_options(),
                   "gathered": distributed.all_gather_int(10 * rank)}, open(out, "w"))
        return
    data = work / "data"
    vocab = _vocab(data)
    if mode == "shards":
        ids = []
        for b in _pipeline(data, vocab, *distributed.host_shard_options(), train=False, batch=1):
            ids += b["tokens"].tolist()
        json.dump(ids, open(out, "w"))
        return
    if mode == "eval":
        cfg = _fitted_cfg(_cfg(), data)
        tr = Trainer(cfg, preprocess="eval", device="cpu")
        local = list(_pipeline(data, vocab, rank, world, train=False, batch=3))
        if rank == 1:
            local = local[:-1]                  # ragged: one batch fewer
        summary = tr.evaluate(tr.init_state(_init(cfg)), local)
        json.dump({k: np.asarray(v).tolist() for k, v in summary.items()}, open(out, "w"))
        return
    # mode "train" / "per_replica": 3 steps, checkpoint, restart, 2 more
    cfg = _fitted_cfg(_cfg(), data)
    cfg = cfg.replace(train=cfg.train.replace(checkpoint_dir=str(work / f"ck_{mode}")))

    def trainer():
        tr = Trainer(cfg, preprocess="train", device="cpu")
        if mode == "per_replica":
            set_data_parallel(tr.model, None, rank, world)     # local statistics
        tr.checkpoint_manager()
        return tr

    tr = trainer()
    it = _pipeline(data, vocab, rank, world)
    tr.fit(tr.init_state(_init(cfg)), it, num_steps=FIRST, input_iterator=it)
    tr = trainer()
    it = _pipeline(data, vocab, rank, world)
    ts = tr.restore_latest(tr.init_state(_init(cfg)))
    assert ts.step == FIRST and tr.restore_input_iterator(it)
    ts = tr.fit(ts, it, num_steps=STEPS - FIRST, input_iterator=it)
    torch.save({k: v.detach() for k, v in ts.state.items()}, str(out))


# ---------------------------------------------------------------------------
# Helpers of the parent
# ---------------------------------------------------------------------------

def _rendezvous(workdir):
    """A fresh ``file://`` init method in ``workdir``: the processes meet
    through a file, so no port is chosen before the children bind it (a
    port probed free and closed again could be taken by another test
    process in between)."""
    return f"file://{Path(workdir).resolve() / ('rendezvous.' + uuid.uuid4().hex)}"


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    return env


def _wait(procs):
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a child process timed out")
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def _spawn(mode, workdir, world=2):
    address = _rendezvous(workdir)
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world), address,
                               str(workdir)], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(world)]
    return _wait(procs)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Records (train and validation) of 48 posts over the fixture JPEGs
    and their vocabulary, under ``workdir/data``."""
    import csv
    import shutil

    from tumblr_emotions_torch.data.convert import convert

    tmp = tmp_path_factory.mktemp("dp")
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    (tmp / "images").mkdir()
    for name in names:
        shutil.copy(FIXTURES / name, tmp / "images" / name)
    rng = np.random.RandomState(7)
    with open(tmp / "posts.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "label", "image"])
        for i in range(48):
            w.writerow([f"p{i}", " ".join(rng.choice(WORDS, rng.randint(1, 9))),
                        rng.randint(15), names[i % len(names)]])
    convert(str(tmp / "posts.csv"), str(tmp / "images"), str(tmp / "data"), num_shards=3,
            valid_fraction=0.3, min_freq=1)
    return tmp


def _distance(a, a0, b, b0, keys):
    num = sum(float(((a[k].double() - a0[k].double()) - (b[k].double() - b0[k].double()))
                    .square().sum()) for k in keys)
    den = sum(float((b[k].double() - b0[k].double()).square().sum()) for k in keys)
    return (num / den) ** 0.5


def _one_process(cfg, data, state, steps=STEPS):
    """One process over the 2-process run's global batches: step i takes
    batch i of shard 0, then of shard 1."""
    from tumblr_emotions_torch.train.trainer import Trainer

    vocab = _vocab(data)
    shards = [_pipeline(data, vocab, r, 2) for r in range(2)]
    batches = [{k: np.concatenate([b0[k], b1[k]]) for k in b0}
               for _, b0, b1 in zip(range(steps), *shards)]
    tr = Trainer(cfg.replace(train=cfg.train.replace(batch_size=2 * LOCAL_B)),
                 preprocess="train" if cfg.model != "text" else None, device="cpu")
    ts = tr.fit(tr.init_state(state), batches, num_steps=steps)
    return tr, {k: v.detach() for k, v in ts.state.items()}


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def test_maybe_initialize_is_a_noop_without_a_cluster(monkeypatch):
    from tumblr_emotions_torch.parallel import distributed

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.detect_cluster_env() is None
    assert distributed.maybe_initialize() is False
    assert distributed.maybe_initialize("127.0.0.1:1", 1, 0, device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.host_shard_options() == (0, 1)


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"MASTER_ADDR": "10.0.0.1"}, None),                         # one process
    ({"MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "1"}, None),
    ({"MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "4"}, "MASTER_ADDR"),
    ({"WORLD_SIZE": "4"}, None),                                 # no rendezvous address
])
def test_detect_cluster_env_reads_the_environment(monkeypatch, env, want):
    from tumblr_emotions_torch.parallel import distributed

    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.detect_cluster_env() == want


@pytest.mark.parametrize("device,local,count,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 8, "nccl")])
def test_backend_rule(monkeypatch, device, local, count, want):
    """NCCL iff every process of the machine has a card of its own."""
    from tumblr_emotions_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert distributed.backend_for(device, local) == want


def test_mesh_checks_the_process_count():
    """The data axis is every process; one process has no group (the plain
    step); a model axis other than 1 is refused."""
    from tumblr_emotions_torch.config import MeshConfig
    from tumblr_emotions_torch.parallel import mesh as mesh_lib

    m = mesh_lib.create_mesh(MeshConfig(), world_size=4, rank=2)
    assert (m.data, m.rank) == (4, 2)
    assert m.rows(8) == slice(16, 24)
    assert mesh_lib.create_mesh() == mesh_lib.Mesh(1, 0, None)
    with pytest.raises(ValueError, match="mesh 8x1 != 4 processes"):
        mesh_lib.create_mesh(MeshConfig(data=8), world_size=4, rank=0)
    with pytest.raises(ValueError, match="model must be 1"):
        mesh_lib.create_mesh(MeshConfig(data=1, model=2), world_size=2, rank=0)


def test_two_process_gloo_all_reduce(tmp_path):
    _spawn("allreduce", tmp_path)
    for r in range(2):
        got = json.loads((tmp_path / f"allreduce.{r}").read_text())
        # sum of 2*(r+1); its gradient sums the two processes' 2*(r+1)
        assert got["sum"] == 6.0 and got["grad"] == 2.0 * 3
        assert got["shard"] == [r, 2] and got["gathered"] == [0, 10]


def test_host_shard_options_shards_are_disjoint(workdir):
    _spawn("shards", workdir)
    shards = [json.loads((workdir / f"shards.{r}").read_text()) for r in range(2)]
    every = [b["tokens"].tolist() for b in _pipeline(workdir / "data", _vocab(workdir / "data"),
                                                      0, 1, train=False, batch=1)]
    assert shards[0] and shards[1]
    assert sorted(shards[0] + shards[1]) == sorted(sum(every, []))
    assert shards[0] == sum(every[0::2], []) and shards[1] == sum(every[1::2], [])


@pytest.fixture(scope="module")
def two_process_runs(workdir):
    """The 2-process runs (synchronised and per-process statistics) and the
    1-process runs (and its floor runs) over the same global batches."""
    _spawn("train", workdir)
    _spawn("per_replica", workdir)
    data = workdir / "data"
    cfg = _fitted_cfg(_cfg(), data)
    state = _init(cfg)
    tr, one = _one_process(cfg, data, state)
    noise = []
    for seed in NOISE_SEEDS:
        g = torch.Generator().manual_seed(seed)
        moved = {k: v * (1 + NOISE_EPS * torch.randn(v.shape, generator=g))
                 for k, v in state.items()}
        noise.append((moved, _one_process(cfg, data, moved)[1]))
    runs = {m: [torch.load(str(workdir / f"{m}.{r}")) for r in range(2)]
            for m in ("train", "per_replica")}
    return dict(tr=tr, state=state, one=one, noise=noise, runs=runs)


@pytest.mark.parametrize("collection", ["params", "stats"])
def test_two_processes_equal_one_process(two_process_runs, collection):
    """Two processes (3 steps, checkpoint, a new trainer restored at the
    exact record, 2 more) end where one process ends over the same global
    batches; both processes hold the same state."""
    r = two_process_runs
    a, b = r["runs"]["train"]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    keys = [k for k in r["one"] if (k in r["tr"].param_keys) == (collection == "params")
            and not torch.equal(r["one"][k], r["state"][k])]
    assert len(keys) > 20
    floor = np.mean([_distance(n, n0, r["one"], r["state"], keys) for n0, n in r["noise"]])
    got = _distance(a, r["state"], r["one"], r["state"], keys)
    assert got <= NOISE_FACTOR * floor, (got, floor)


@pytest.mark.parametrize("collection", ["params", "stats"])
def test_per_process_batch_statistics_would_not_match(two_process_runs, collection):
    """The same two processes with each batch norm on its own rows (as an
    unsynchronised data-parallel step would have it) fall outside the
    tolerance the synchronised run meets."""
    r = two_process_runs
    keys = [k for k in r["one"] if (k in r["tr"].param_keys) == (collection == "params")
            and not torch.equal(r["one"][k], r["state"][k])]
    floor = np.mean([_distance(n, n0, r["one"], r["state"], keys) for n0, n in r["noise"]])
    got = _distance(r["runs"]["per_replica"][0], r["state"], r["one"], r["state"], keys)
    assert got > NOISE_FACTOR * floor, (got, floor)


def test_two_process_checkpoint_layout(two_process_runs, workdir):
    """Process 0 wrote one bundle per kept step; each process its own input
    position files."""
    ck = workdir / "ck_train"
    assert sorted(p.name for p in ck.iterdir() if p.name.isdigit()) == [str(FIRST), str(STEPS)]
    for step in (FIRST, STEPS):
        for r in range(2):
            assert (ck / f"input_iterator_{step}.proc{r}.json").exists()
    assert not [p for p in ck.iterdir() if re.fullmatch(r"input_iterator_\d+\.json", p.name)]


def test_ragged_sharded_eval_equals_the_full_eval(workdir):
    """Process 1's shard has one batch fewer; the lockstep evaluation pads
    it with a weight-0 batch and both report the statistics of the
    validation batches evaluated in one process."""
    from tumblr_emotions_torch.train.trainer import Trainer

    _spawn("eval", workdir)
    data = workdir / "data"
    cfg = _fitted_cfg(_cfg(), data)
    vocab = _vocab(data)
    shards = [list(_pipeline(data, vocab, r, 2, train=False, batch=3)) for r in range(2)]
    assert len(shards[1]) >= 2
    every = shards[0] + shards[1][:-1]
    tr = Trainer(cfg, preprocess="eval", device="cpu")
    want = tr.evaluate(tr.init_state(_init(cfg)), every)
    for r in range(2):
        got = json.loads((workdir / f"eval.{r}").read_text())
        assert got["count"] == want["count"] > 0
        assert got["accuracy"] == want["accuracy"]
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


def test_lockstep_eval_refuses_an_empty_shard(monkeypatch):
    from tumblr_emotions_torch.parallel import distributed
    from tumblr_emotions_torch.parallel.mesh import Mesh
    from tumblr_emotions_torch.train.trainer import Trainer

    cfg = _cfg().replace(text=_cfg().text.replace(vocab_size=16))
    tr = Trainer(cfg, device="cpu", mesh=Mesh(2, 1))
    monkeypatch.setattr(distributed, "all_gather_int", lambda n, group, device: [3, n])
    with pytest.raises(ValueError, match="zero batches while another produced 3"):
        tr.lockstep_local_batches([])
    b = {"label": np.zeros(2, np.int32)}
    padded = tr.lockstep_local_batches([b])
    assert len(padded) == 3 and padded[0]["weight"].tolist() == [1, 1]
    assert padded[2]["weight"].tolist() == [0, 0]


def test_two_process_cli_train_and_eval_equal_one_process(workdir):
    """``cli train --num-processes 2`` (two processes, each on its record
    shard, the text model from records) ends equal to one process over the
    same global batches, and ``cli eval --num-processes 2`` (and with
    ``--follow``) reports what one process reports."""
    from tumblr_emotions_torch import convert
    from tumblr_emotions_torch.utils import checkpoint as ck

    data = workdir / "data"
    common = ["--preset", "text_only", "--model", "text", "--vocab", str(data / "vocab.txt"),
              "--batch-size", str(LOCAL_B), "--max-len", "8", "--device", "cpu",
              "--checkpoint-dir", str(workdir / "ck_cli")]
    address = _rendezvous(workdir)

    def two(command, extra):
        return _wait([subprocess.Popen(
            [sys.executable, "-m", "tumblr_emotions_torch.cli", command, *common, *extra,
             "--coordinator-address", address, "--num-processes", "2", "--process-id", str(r)],
            env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)])

    two("train", ["--records", str(data / "train-*.tfrecord"), "--steps", "3"])
    reader = ck.CheckpointManager(str(workdir / "ck_cli")).reader(3)
    cfg = _fitted_cfg(_cfg("text"), data)
    tr, one = _one_process(cfg, data, _init(cfg), steps=3)
    for k, v in one.items():
        got = reader.get_tensor("params/" + k.replace(".", "/"))
        want = convert.to_jax_leaf(k, v)
        np.testing.assert_allclose(got, want, rtol=TEXT_TOL, atol=TEXT_TOL * np.abs(want).max(),
                                   err_msg=k)
    assert (workdir / "ck_cli" / "input_iterator_3.proc1.json").exists()
    logs = two("eval", ["--records", str(data / "validation-*.tfrecord"),
                        "--out", str(workdir / "ev.jsonl")])
    lines = (workdir / "ev.jsonl").read_text().splitlines()
    assert len(lines) == 1                       # process 0 reports for the group
    got = json.loads(lines[0])
    tr.checkpoint_manager(str(workdir / "ck_cli"))
    want = tr.evaluate(tr.restore_latest(tr.init_state(_init(cfg))),
                       _pipeline(data, _vocab(data), 0, 1, train=False, batch=LOCAL_B))
    assert got["count"] == want["count"] and got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert "accuracy" in logs[0]
    # evaluate_continuously under data parallelism: process 0's poll
    # decides, both evaluate step 3 in lockstep, process 0 reports
    logs = two("eval", ["--records", str(data / "validation-*.tfrecord"), "--follow",
                        "--steps", "3", "--eval-timeout", "2", "--eval-interval", "0.1",
                        "--out", str(workdir / "follow.jsonl")])
    lines = (workdir / "follow.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["step"] == 3
    assert json.loads(lines[0])["accuracy"] == want["accuracy"]
    assert "== step 3 ==" in logs[0] and "== step 3 ==" not in logs[1]


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
