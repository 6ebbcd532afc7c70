"""The port's CLI (``python -m tumblr_emotions_torch.cli``) on the CPU,
against the JAX package's CLI on the same state: train and resume, eval,
infer (also ``--dp``), serve, predict, export, ArrayRecord shards, and the
flags once refused (the tooling commands: ``tests/test_torch_tooling.py``)."""

import contextlib
import csv
import io
import json
import shutil
import urllib.request
from pathlib import Path

import argparse

import flax
import jax
import numpy as np
import pytest
import torch

from tumblr_emotions_torch import cli as tcli
from tumblr_emotions_torch.data.pipeline import TFRecordIndex, record_source
from tumblr_emotions_torch.utils import checkpoint as ck
from tumblr_emotions_tpu import cli as jcli
from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu.data.vocab import Vocabulary as JVocabulary
from tumblr_emotions_tpu.parallel import mesh as mesh_lib
from tumblr_emotions_tpu.train import trainer as jtrainer

FIXTURES = Path(__file__).parent / "data" / "jpeg"
WORDS = ["happy", "sad", "love", "rain", "sun", "tired", "wow", "calm", "day", "cat"]


def _posts(tmp_path, n, images=False):
    rng = np.random.RandomState(7)
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    if images:
        (tmp_path / "images").mkdir()
        for name in names:
            shutil.copy(FIXTURES / name, tmp_path / "images" / name)
    path = tmp_path / "posts.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "label", "image"])
        for i in range(n):
            w.writerow([f"p{i}", " ".join(rng.choice(WORDS, rng.randint(1, 9))),
                        rng.randint(15), names[i % len(names)]])
    return str(path)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _to_orbax(jcfg, port_dir, step, jax_dir, sample):
    """The port checkpoint's state written as the JAX trainer's orbax
    checkpoint (through ``convert``)."""
    reader = ck.CheckpointManager(port_dir).reader(step)
    names = reader.keys()
    variables = {"params": {}, "batch_stats": {}}
    for col in variables:
        flat = {n[len(col) + 1:]: reader.get_tensor(n) for n in names if n.startswith(col + "/")}
        variables[col] = flat
    mesh = mesh_lib.create_mesh(jconfig.MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(jcfg, mesh=mesh)
    js = jtr.init_state(jax.random.PRNGKey(0), sample)
    # the port's names are slash-joined JAX paths; the JAX tree's keys hold
    # '/' themselves, so match each leaf by its joined path
    def fill(tree, flat):
        out = {}
        for path, leaf in flax.traverse_util.flatten_dict(tree).items():
            arr = flat["/".join(path)]
            assert arr.shape == np.shape(leaf), path
            out[path] = arr
        return flax.traverse_util.unflatten_dict(out)

    params = fill(jax.device_get(js.params), variables["params"])
    stats = fill(jax.device_get(js.batch_stats), variables["batch_stats"])
    opt = jax.tree_util.tree_map_with_path(
        lambda p, leaf: reader.get_tensor("opt_state/" + "/".join(
            str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None)))) for k in p)),
        jax.device_get(js.opt_state))
    jtr.checkpoint_manager(jax_dir)
    jtr.save_checkpoint(jtrainer.TrainState(step=np.int32(step), params=params,
                                            batch_stats=stats, opt_state=opt))


def test_text_only_train_resume_eval_against_the_reference(tmp_path):
    csv_path = _posts(tmp_path, 44)
    vocab = str(tmp_path / "vocab.txt")
    _run(tcli.main, ["build-vocab", "--csv", csv_path, "--out", vocab, "--min-freq", "1"])
    common = ["--preset", "text_only", "--csv", csv_path, "--vocab", vocab, "--batch-size", "8",
              "--max-len", "8", "--device", "cpu", "--checkpoint-every", "2", "--log-every", "1"]
    a, s = str(tmp_path / "a"), str(tmp_path / "s")
    _run(tcli.main, ["train", *common, "--steps", "3", "--checkpoint-dir", a])
    _run(tcli.main, ["train", *common, "--steps", "7", "--checkpoint-dir", a])  # resumes at 3
    _run(tcli.main, ["train", *common, "--steps", "7", "--checkpoint-dir", s])
    ra, rs = ck.CheckpointManager(a).reader(7), ck.CheckpointManager(s).reader(7)
    assert sorted(ra.keys()) == sorted(rs.keys())
    for n in ra.keys():
        np.testing.assert_array_equal(ra.get_tensor(n), rs.get_tensor(n), err_msg=n)
    assert json.loads((Path(a) / "input_iterator_7.json").read_text()) == \
        json.loads((Path(s) / "input_iterator_7.json").read_text()) == {"epoch": 1, "index": 16}
    # eval: the port's and the reference CLI's on the same state
    got = _run(tcli.main, ["eval", *common, "--checkpoint-dir", a,
                           "--out", str(tmp_path / "ev.jsonl")])
    jcfg = jcli._build_config(_namespace(common))
    jcfg = jcfg.replace(text=jcfg.text.replace(vocab_size=JVocabulary.load(vocab).size))
    sample = {"tokens": np.zeros((1, 8), np.int32), "lengths": np.ones((1,), np.int32),
              "label": np.zeros((1,), np.int32)}
    _to_orbax(jcfg, a, 7, str(tmp_path / "j"), sample)
    want = _run(jcli.main, ["eval", *[c for c in common if c not in ("--device", "cpu")],
                            "--checkpoint-dir", str(tmp_path / "j")])
    assert got == want and got.startswith("accuracy:")
    summary = json.loads((tmp_path / "ev.jsonl").read_text())
    assert summary["count"] == 44 and summary["step"] == 7 and len(summary["confusion"]) == 15
    follow = _run(tcli.main, ["eval", *common, "--checkpoint-dir", a, "--follow",
                              "--steps", "7", "--eval-timeout", "1", "--eval-interval", "0.1"])
    assert follow.startswith("== step 7 ==")


def test_an_unreadable_latest_checkpoint_stops_train_and_leaves_the_others(tmp_path):
    """`train` refuses to start over from fresh init when the latest
    checkpoint is unreadable (it would overwrite the kept ones), and
    `eval --follow` backs off on it until its timeout."""
    csv_path = _posts(tmp_path, 20)
    vocab = str(tmp_path / "vocab.txt")
    _run(tcli.main, ["build-vocab", "--csv", csv_path, "--out", vocab, "--min-freq", "1"])
    ck_dir = tmp_path / "ck"
    common = ["--preset", "text_only", "--csv", csv_path, "--vocab", vocab, "--batch-size", "4",
              "--max-len", "8", "--device", "cpu", "--checkpoint-every", "2",
              "--checkpoint-dir", str(ck_dir)]
    _run(tcli.main, ["train", *common, "--steps", "4"])
    assert ck.CheckpointManager(str(ck_dir)).all_steps() == [2, 4]
    index = ck_dir / "4" / "checkpoint.index"
    raw = bytearray(index.read_bytes())
    raw[10] ^= 1
    index.write_bytes(bytes(raw))
    before = {p: p.read_bytes() for p in ck_dir.rglob("*") if p.is_file()}
    with pytest.raises(IOError, match="crc mismatch"):
        tcli.main(["train", *common, "--steps", "6"])
    assert {p: p.read_bytes() for p in ck_dir.rglob("*") if p.is_file()} == before
    follow = _run(tcli.main, ["eval", *common, "--follow", "--steps", "4",
                              "--eval-timeout", "0.3", "--eval-interval", "0.1"])
    assert follow == ""


def _namespace(common):
    p = argparse.ArgumentParser()
    jcli._add_common(p)
    return p.parse_args([c for c in common if c not in ("--device", "cpu")])


@pytest.fixture(scope="module")
def joint_run(tmp_path_factory):
    """Records of fixture JPEGs, a vocabulary, and a joint_finetune
    checkpoint (depth 0.25, 139 px) after one CLI train step."""
    tmp = tmp_path_factory.mktemp("joint")
    csv_path = _posts(tmp, 24, images=True)
    _run(tcli.main, ["convert-dataset", "--csv", csv_path, "--images-dir", str(tmp / "images"),
                     "--out", str(tmp / "data"), "--num-shards", "2",
                     "--valid-fraction", "0.4"])
    vocab = str(tmp / "data" / "vocab.txt")
    common = ["--preset", "joint_finetune", "--vocab", vocab, "--depth-multiplier", "0.25",
              "--image-size", "139", "--batch-size", "4", "--checkpoint-dir",
              str(tmp / "ck"), "--device", "cpu"]
    _run(tcli.main, ["train", *common, "--records", str(tmp / "data" / "train-*.tfrecord"),
                     "--steps", "1", "--prefetch-depth", "2"])
    return tmp, common, str(tmp / "data" / "validation-*.tfrecord")


def test_joint_train_from_records_stopped_and_resumed_equals_a_straight_run(joint_run):
    tmp, common, _ = joint_run
    train = ["train", *common, "--records", str(tmp / "data" / "train-*.tfrecord"),
             "--checkpoint-every", "2"]
    at = train.index("--checkpoint-dir")
    del train[at:at + 2]
    a, s = str(tmp / "resumed"), str(tmp / "straight")
    _run(tcli.main, [*train, "--steps", "2", "--checkpoint-dir", a])
    _run(tcli.main, [*train, "--steps", "4", "--checkpoint-dir", a])
    _run(tcli.main, [*train, "--steps", "4", "--checkpoint-dir", s])
    ra, rs = ck.CheckpointManager(a).reader(4), ck.CheckpointManager(s).reader(4)
    assert sorted(ra.keys()) == sorted(rs.keys())
    for n in ra.keys():
        np.testing.assert_array_equal(ra.get_tensor(n), rs.get_tensor(n), err_msg=n)
    n_train = len(TFRecordIndex(str(tmp / "data" / "train-*.tfrecord")))
    epoch, index = divmod(4 * 4, n_train)
    assert json.loads((Path(a) / "input_iterator_4.json").read_text()) == \
        json.loads((Path(s) / "input_iterator_4.json").read_text()) == \
        {"epoch": epoch, "index": index}


@pytest.fixture(scope="module")
def jax_common(joint_run):
    """The JAX CLI's arguments for ``joint_run``'s checkpoint, written as the
    JAX trainer's orbax checkpoint."""
    tmp, common, _ = joint_run
    jcfg = jcli._build_config(_namespace(common))
    jcfg = jcfg.replace(text=jcfg.text.replace(
        vocab_size=JVocabulary.load(common[common.index("--vocab") + 1]).size))
    sample = {"image": np.zeros((1, 139, 139, 3), np.float32),
              "tokens": np.zeros((1, 50), np.int32), "lengths": np.ones((1,), np.int32),
              "label": np.zeros((1,), np.int32)}
    _to_orbax(jcfg, str(tmp / "ck"), 1, str(tmp / "jck"), sample)
    jcommon = [c for c in common if c not in ("--device", "cpu")]
    jcommon[jcommon.index("--checkpoint-dir") + 1] = str(tmp / "jck")
    return jcommon


def test_joint_infer_parity_within_1e4_of_the_reference_cli(joint_run, jax_common):
    tmp, common, val = joint_run
    out = tmp / "port.jsonl"
    summary = json.loads(_run(tcli.main, ["infer", *common, "--records", val,
                                          "--engine", "parity", "--out", str(out)]))
    jcommon = jax_common
    ref = tmp / "ref.jsonl"
    want = json.loads(_run(jcli.main, ["infer", *jcommon, "--records", val,
                                       "--engine", "parity", "--out", str(ref)]))
    assert summary["examples"] == want["examples"] > 0
    got_rows = [json.loads(line) for line in out.read_text().splitlines()]
    want_rows = [json.loads(line) for line in ref.read_text().splitlines()]
    assert len(got_rows) == len(want_rows) == summary["examples"]
    for g, w in zip(got_rows, want_rows):
        assert g["label"] == w["label"] and list(g["probs"]) == list(w["probs"])
        np.testing.assert_allclose(list(g["probs"].values()), list(w["probs"].values()),
                                   atol=1e-4)


def test_joint_infer_int8_serve_predict_and_export_on_the_cpu(joint_run):
    tmp, common, val = joint_run
    summary = json.loads(_run(tcli.main, ["infer", *common, "--records", val, "--engine",
                                          "int8", "--validate", "--probs-out",
                                          str(tmp / "p.npy")]))
    probs = np.load(tmp / "p.npy")
    assert probs.shape == (summary["examples"], 15) and np.isfinite(probs).all()
    assert summary["forwards"] == 2 and "quantization_delta" in summary
    # serve, built in process, answers a post
    httpd, info = tcli.build_server(tcli.parser().parse_args(
        ["serve", *common, "--records", val, "--host", "127.0.0.1", "--port", "0",
         "--serve-batch-size", "4", "--host-size", "64"]))
    try:
        httpd.serve_background()
        body = (FIXTURES / "baseline_444_64x48.jpg").read_bytes()
        req = urllib.request.Request(
            f"http://127.0.0.1:{info['port']}/predict?text=so+happy", data=body)
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
        assert len(answer["probs"]) == 15 and answer["top"] in answer["probs"]
    finally:
        httpd.close()
    # predict: the Predictor on the checkpoint
    got = json.loads(_run(tcli.main, ["predict", *common, "--image",
                                      str(FIXTURES / "rgb_444_16x12.jpg"), "--text", "so happy"]))
    assert len(got) == 15 and abs(sum(got.values()) - 1) < 1e-5
    # export: the slim bundle holds the checkpoint's tower, bit for bit
    slim = str(tmp / "slim" / "model.ckpt")
    _run(tcli.main, ["export-checkpoint", *common, "--out", slim])
    tower = ck.BundleReader(slim)
    step = ck.CheckpointManager(str(tmp / "ck")).reader(1)
    names = [n for n in step.keys() if n.startswith(("params/InceptionV3/",
                                                      "batch_stats/InceptionV3/"))]
    assert len(tower.keys()) == len(names) > 100
    for n in names:
        np.testing.assert_array_equal(tower.get_tensor(n.split("/", 1)[1]), step.get_tensor(n))


# The ``infer`` and ``serve`` flags the port once refused: they run, one
# process without a group (the process-group flags taken and not acted on,
# as the reference's infer and serve take them), and --dp over every card
# (the one CPU with --device cpu), each answering as the run without them.
@pytest.mark.parametrize("command,extra", [
    ("infer", ["--num-processes", "2", "--process-id", "1",
               "--coordinator-address", "127.0.0.1:1"]),
    ("infer", ["--dp"]),
    ("serve", ["--dp"]),
])
def test_refused_commands_and_flags_name_their_roadmap_item(joint_run, command, extra):
    import torch.distributed as dist

    tmp, common, val = joint_run
    if command == "infer":
        probs = {}
        for name, flags in (("plain", []), ("flags", extra)):
            summary = json.loads(_run(tcli.main, [
                "infer", *common, "--records", val, "--engine", "int8", *flags,
                "--probs-out", str(tmp / f"{name}.npy")]))
            assert summary["devices"] == 1 and not dist.is_initialized()
            probs[name] = np.load(tmp / f"{name}.npy")
        np.testing.assert_array_equal(probs["flags"], probs["plain"])
        return
    answers = {}
    for name, flags in (("plain", []), ("dp", extra)):
        httpd, info = tcli.build_server(tcli.parser().parse_args(
            ["serve", *common, "--records", val, "--host", "127.0.0.1", "--port", "0",
             "--serve-batch-size", "4", "--host-size", "64", *flags]))
        try:
            httpd.serve_background()
            assert info["devices"] == 1 and info["runner"].devices == [torch.device("cpu")]
            body = (FIXTURES / "baseline_444_64x48.jpg").read_bytes()
            req = urllib.request.Request(
                f"http://127.0.0.1:{info['port']}/predict?text=so+happy", data=body)
            with urllib.request.urlopen(req, timeout=60) as r:
                answers[name] = json.loads(r.read())
        finally:
            httpd.close()
    assert answers["dp"] == answers["plain"]


def test_joint_infer_dp_against_the_reference_cli(joint_run, jax_common):
    """``infer --dp`` (the int8 engine): the port on the one CPU against the
    reference's over its 8 virtual CPU devices (the batch of 64 split 8
    ways), each calibrated by its own package, within the int8 engines'
    tolerance."""
    tmp, common, val = joint_run
    got = json.loads(_run(tcli.main, ["infer", *common, "--records", val, "--dp",
                                      "--out", str(tmp / "dp_port.jsonl")]))
    want = json.loads(_run(jcli.main, ["infer", *jax_common, "--records", val, "--dp",
                                       "--out", str(tmp / "dp_ref.jsonl")]))
    assert got["examples"] == want["examples"] > 0 and jax.device_count() == 8
    for g, w in zip(*[[json.loads(line) for line in (tmp / f).read_text().splitlines()]
                      for f in ("dp_port.jsonl", "dp_ref.jsonl")]):
        assert g["label"] == w["label"] and list(g["probs"]) == list(w["probs"])
        np.testing.assert_allclose(list(g["probs"].values()), list(w["probs"].values()),
                                   atol=INT8_PROB_ATOL)


# each package's int8 engine calibrated by itself (tests/test_torch_serving.py)
INT8_PROB_ATOL = 2e-2


def test_refused_record_formats(tmp_path):
    """ArrayRecord shards, once refused: ``convert-dataset --format
    arrayrecord`` writes the same records as the TFRecord conversion, and
    ``train`` from them takes the step it takes from the TFRecords."""
    csv_path = _posts(tmp_path, 24, images=True)
    for fmt in ("tfrecord", "arrayrecord"):
        _run(tcli.main, ["convert-dataset", "--csv", csv_path, "--images-dir",
                         str(tmp_path / "images"), "--out", str(tmp_path / fmt),
                         "--num-shards", "2", "--format", fmt])
    tf_recs = list(TFRecordIndex(str(tmp_path / "tfrecord" / "train-*.tfrecord"))[i]
                   for i in range(len(TFRecordIndex(str(tmp_path / "tfrecord" /
                                                          "train-*.tfrecord")))))
    ar = record_source(str(tmp_path / "arrayrecord" / "train-*.arrayrecord"))
    assert [ar[i] for i in range(len(ar))] == tf_recs
    base = ["train", "--preset", "joint_finetune", "--vocab",
            str(tmp_path / "tfrecord" / "vocab.txt"), "--depth-multiplier", "0.25",
            "--image-size", "139", "--batch-size", "4", "--steps", "1", "--device", "cpu"]
    for fmt in ("tfrecord", "arrayrecord"):
        _run(tcli.main, [*base, "--records", str(tmp_path / fmt / f"train-*.{fmt}"),
                         "--checkpoint-dir", str(tmp_path / f"ck_{fmt}")])
    a, b = (ck.CheckpointManager(str(tmp_path / f"ck_{f}")).reader(1)
            for f in ("tfrecord", "arrayrecord"))
    assert sorted(a.keys()) == sorted(b.keys())
    for n in a.keys():
        np.testing.assert_array_equal(a.get_tensor(n), b.get_tensor(n), err_msg=n)


def _vocab(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("<pad>\n<unk>\nhappy\n")
    return str(p)


def test_the_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    csv_path = _posts(tmp_path, 10)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["train", "--preset", "text_only", "--csv", csv_path, "--batch-size", "4",
                   "--checkpoint-dir", str(tmp_path / "ck")])
