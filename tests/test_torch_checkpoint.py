"""The port's checkpoints against TF and the JAX package: the tensor-bundle
codec both ways, the slim warm start and export, the trainer's step
checkpoints (round trip, pruning, crash safety), resume equal to a straight
run, and a JAX state carried through orbax and ``convert`` into the port."""

import dataclasses

import flax
import jax
import numpy as np
import optax
import pytest
import tensorflow as tf
import torch

from tumblr_emotions_torch import config as tconfig
from tumblr_emotions_torch import convert
from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model
from tumblr_emotions_torch.train import trainer as ttrainer
from tumblr_emotions_torch.utils import checkpoint as ck
from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu.parallel import mesh as mesh_lib
from tumblr_emotions_tpu.train import trainer as jtrainer
from tumblr_emotions_tpu.utils import checkpoint as jck

B, HW, SRC = 4, 139, (160, 170)
V, D, T = 64, 16, 8


def _cfgs(preset, train=None, image=None):
    image = {"image_size": HW, "depth_multiplier": 0.25, "min_depth": 8, **(image or {})}
    text = {"vocab_size": V, "embed_dim": D, "max_len": T}
    train = {"batch_size": B, "log_every": 1, **(train or {})}
    out = []
    for c in (jconfig, tconfig):
        cfg = c.get_preset(preset)
        out.append(cfg.replace(image=cfg.image.replace(**image), text=cfg.text.replace(**text),
                               train=cfg.train.replace(**train)))
    return out


def _init(tcfg, seed=0):
    init = {"image": inception_v3.init_state, "joint": joint_model.init_state,
            "text": text_model.init_state}[tcfg.model]
    return init(build_model(tcfg, device="meta"), seed)


def _batches(tcfg, n, seed=1, weight=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.randint(0, V, (B, T)).astype(np.int32),
             "lengths": np.array([T, 3, 0, 5], np.int32),
             "label": rng.randint(0, 15, B).astype(np.int32)}
        if tcfg.model != "text":
            b["image"] = rng.randint(0, 256, (B, *SRC, 3)).astype(np.uint8)
        if weight:
            b["weight"] = np.array([1, 1, 1, 0], np.int32)
        out.append(b)
    return out


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree).items()}


# ---------------------------------------------------------------------------
# the tensor-bundle codec
# ---------------------------------------------------------------------------

def test_bundle_codec_against_tf_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    dtypes = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.int8, np.int16,
              np.bool_, np.float16, np.uint16]
    tensors = {"scalar": np.float32(2.5), "empty": np.zeros((0, 3), np.float32),
               "step": np.int64(7)}
    for i, dt in enumerate(dtypes):
        tensors[f"InceptionV3/t{i}/weights"] = (rng.normal(size=(2, 3, 4)) * 50).astype(dt)
    # enough long names that the table spans several 256 KiB blocks
    for i in range(4000):
        name = f"scope{i % 37:02d}/" + "".join(chr(97 + c) for c in rng.randint(0, 26, 150))
        tensors[name] = rng.normal(size=rng.randint(1, 4, size=rng.randint(0, 3))).astype(
            np.float32)
    names = sorted(tensors)
    tf.raw_ops.SaveV2(prefix=str(tmp_path / "tf" / "m"), tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(tensors[n]) for n in names])
    ck.write_bundle(str(tmp_path / "m"), tensors)
    for suffix in (".index", ck.DATA_SUFFIX):
        assert (tmp_path / ("m" + suffix)).read_bytes() == \
            (tmp_path / "tf" / ("m" + suffix)).read_bytes(), suffix
    assert (tmp_path / "m.index").stat().st_size > 2 * ck.BLOCK_SIZE
    port = ck.BundleReader(str(tmp_path / "tf" / "m"))
    theirs = tf.train.load_checkpoint(str(tmp_path / "m"))
    assert sorted(port.keys()) == names == sorted(theirs.get_variable_to_shape_map())
    for n in names:
        want = np.asarray(tensors[n])
        for got in (port.get_tensor(n), theirs.get_tensor(n)):
            assert got.dtype == want.dtype and got.shape == want.shape, n
            np.testing.assert_array_equal(got, want)


def test_bundle_reader_detects_corruption_and_refuses_compression(tmp_path):
    ck.write_bundle(str(tmp_path / "m"), {"a": np.arange(10, dtype=np.float32)})
    data = tmp_path / ("m" + ck.DATA_SUFFIX)
    raw = bytearray(data.read_bytes())
    raw[5] ^= 1
    data.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc mismatch for a"):
        ck.BundleReader(str(tmp_path / "m")).get_tensor("a")
    index = tmp_path / "m.index"
    raw = bytearray(index.read_bytes())
    raw[10] ^= 1
    index.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc mismatch"):
        ck.BundleReader(str(tmp_path / "m"))
    # a data block marked snappy-compressed, with a valid crc
    ck.write_bundle(str(tmp_path / "n"), {"a": np.arange(3, dtype=np.float32)})
    raw = bytearray((tmp_path / "n.index").read_bytes())
    meta_off, _ = ck._read_varint(raw[-ck.FOOTER_LEN:], 0)
    end = meta_off - ck._BLOCK_TRAILER      # the data block (the first) ends where its trailer starts
    raw[end] = 1
    crc = ck.crc32c.mask(ck.crc32c.extend(ck.crc32c.value(bytes(raw[:end])), b"\x01"))
    raw[end + 1:end + 5] = crc.to_bytes(4, "little")
    (tmp_path / "n.index").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="compressed"):
        ck.BundleReader(str(tmp_path / "n"))


# ---------------------------------------------------------------------------
# slim warm start and export
# ---------------------------------------------------------------------------

def _slim_file(tmp_path, state, extra=True):
    """A TF-written slim checkpoint of an InceptionV3 state (JAX layouts),
    with optimizer slots, a global step and a scope outside the root."""
    flat = {"InceptionV3/" + k: v for k, v in _flat(convert.to_variables(state)["params"]).items()}
    flat.update({"InceptionV3/" + k: v for k, v in
                 _flat(convert.to_variables(state)["batch_stats"]).items()})
    if extra:
        flat["InceptionV3/Conv2d_1a_3x3/weights/RMSProp"] = flat["InceptionV3/Conv2d_1a_3x3/weights"]
        flat["InceptionV3/Logits/Conv2d_1c_1x1/biases/Momentum"] = \
            flat["InceptionV3/Logits/Conv2d_1c_1x1/biases"]
        flat["global_step"] = np.int64(12)
        flat["Other/thing"] = np.ones(3, np.float32)
    names = sorted(flat)
    prefix = str(tmp_path / "slim" / "model.ckpt")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(flat[n]) for n in names])
    return prefix


@pytest.fixture(scope="module")
def image_states():
    _, tcfg = _cfgs("image_frozen")
    return tcfg, _init(tcfg, 0), _init(tcfg, 1)


def _port_view(ref):
    """The reference's load_slim_checkpoint result in the port's form."""
    return {col: {k: convert.to_port_leaf(tuple(k.split("/")), v)
                  for k, v in _flat(ref[col]).items()} for col in ("params", "batch_stats")}


@pytest.mark.parametrize("root,exclude", [
    ("InceptionV3", ()), ("InceptionV3", ("Logits",)), ("InceptionV3", ("Logits", "AuxLogits")),
    ("InceptionV3", ("Mixed_5b", "BatchNorm")), ("InceptionV3", ("Conv2d_1a_3x3/weights",)),
    ("Other", ())])
def test_load_slim_checkpoint_equals_the_reference(tmp_path, image_states, root, exclude):
    _, state, _ = image_states
    path = _slim_file(tmp_path, state)
    want = _port_view(jck.load_slim_checkpoint(path, root_scope=root, exclude_scopes=exclude))
    got = ck.load_slim_checkpoint(path, root_scope=root, exclude_scopes=exclude)
    for col in ("params", "batch_stats"):
        assert sorted(got[col]) == sorted(want[col]), col
        for k in got[col]:
            assert torch.equal(got[col][k], want[col][k]), k
    names = set(got["params"]) | set(got["batch_stats"])
    assert not any("RMSProp" in n or "Momentum" in n for n in names)
    if root == "InceptionV3" and exclude == ("Logits",):
        assert any(n.startswith("AuxLogits/") for n in names)
        assert not any(n.startswith("Logits/") for n in names)


def test_merge_pretrained_equals_the_reference_and_its_errors(tmp_path, image_states):
    tcfg, state, other = image_states
    path = _slim_file(tmp_path, other)
    jvars = convert.to_variables(state)
    want = convert.to_state(jck.merge_pretrained(
        jvars, jck.load_slim_checkpoint(path, exclude_scopes=("Logits",))))
    got = ck.merge_pretrained(state, ck.load_slim_checkpoint(path, exclude_scopes=("Logits",)))
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["Conv2d_1a_3x3.weights"], other["Conv2d_1a_3x3.weights"])
    assert torch.equal(got["Logits/Conv2d_1c_1x1.weights"], state["Logits/Conv2d_1c_1x1.weights"])
    pre = ck.load_slim_checkpoint(path)
    bad = {"params": dict(pre["params"]), "batch_stats": {}}
    bad["params"]["Conv2d_1a_3x3/weights"] = torch.zeros(1, 2, 3, 3)
    with pytest.raises(ValueError, match="Conv2d_1a_3x3/weights: checkpoint shape"):
        ck.merge_pretrained(state, bad)
    extra = {"params": {"NoSuchScope/weights": torch.zeros(1)}, "batch_stats": {}}
    with pytest.raises(ValueError, match="1 pretrained params leaves matched no model"):
        ck.merge_pretrained(state, extra)
    assert ck.merge_pretrained(state, extra, require_all_used=False).keys() == state.keys()
    with pytest.raises(ValueError, match="matched no model"):
        ck.merge_pretrained(state, pre, subtree="InceptionV3")


def test_warm_start_into_the_joint_models_tower(tmp_path, image_states):
    _, _, other = image_states
    _, jcfg = _cfgs("joint_finetune")
    joint = _init(jcfg, 0)
    path = _slim_file(tmp_path, other)
    excl = ("Logits", "AuxLogits")
    want = convert.to_state(jck.merge_pretrained(
        convert.to_variables(joint), jck.load_slim_checkpoint(path, exclude_scopes=excl),
        subtree="InceptionV3"))
    got = ck.merge_pretrained(joint, ck.load_slim_checkpoint(path, exclude_scopes=excl),
                              subtree="InceptionV3")
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in got)
    assert torch.equal(got["InceptionV3.Mixed_7c/Branch_0/Conv2d_0a_1x1.weights"],
                       other["Mixed_7c/Branch_0/Conv2d_0a_1x1.weights"])
    assert torch.equal(got["Text.WordEmbedding/embeddings"], joint["Text.WordEmbedding/embeddings"])


def test_save_as_slim_checkpoint_reads_back_everywhere(tmp_path, image_states):
    _, state, _ = image_states
    path = ck.save_as_slim_checkpoint(state, str(tmp_path / "port" / "model.ckpt"))
    ref_path = jck.save_as_slim_checkpoint(convert.to_variables(state),
                                           str(tmp_path / "ref" / "model.ckpt"))
    ours, theirs = tf.train.load_checkpoint(path), tf.train.load_checkpoint(ref_path)
    assert ours.get_variable_to_shape_map() == theirs.get_variable_to_shape_map()
    for n in theirs.get_variable_to_shape_map():
        np.testing.assert_array_equal(ours.get_tensor(n), theirs.get_tensor(n))
    tf.train.load_checkpoint(str(tmp_path / "port"))          # the directory's state file
    a = _port_view(jck.load_slim_checkpoint(path))
    b = ck.load_slim_checkpoint(ref_path)
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


# ---------------------------------------------------------------------------
# the trainer's step checkpoints
# ---------------------------------------------------------------------------

class _Position:
    """A resumable iterator's position protocol, counting batches."""

    def __init__(self):
        self.n = 0

    def get_state(self):
        return {"n": self.n}

    def set_state(self, state):
        self.n = state["n"]


def _counted(batches, pos):
    for b in batches:
        pos.n += 1
        yield b


def _assert_same(a, b):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    assert sorted(a.state) == sorted(b.state)
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k
        assert a.state[k].requires_grad == b.state[k].requires_grad, k
    for m in ("mu", "nu", "trace"):
        assert sorted(a.opt_state.get(m, {})) == sorted(b.opt_state.get(m, {})), m
        for k in a.opt_state.get(m, {}):
            assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), (m, k)


@pytest.mark.parametrize("preset,train", [
    ("text_only", {}),                                             # Adam: count in the tree
    ("image_frozen", {"lr_decay_steps": 2, "grad_clip_norm": 1.0}),  # scopes, schedule, clip
])
def test_checkpoint_round_trip_pruning_and_input_positions(tmp_path, preset, train):
    _, tcfg = _cfgs(preset, train=dict(checkpoint_every=1, keep_checkpoints=2,
                                       checkpoint_dir=str(tmp_path / "ck"), **train))
    pre = None if tcfg.model == "text" else "train"
    tr = ttrainer.Trainer(tcfg, preprocess=pre, device="cpu")
    tr.checkpoint_manager()
    pos = _Position()
    ts = tr.fit(tr.init_state(_init(tcfg)), _counted(_batches(tcfg, 3), pos), num_steps=3,
                input_iterator=pos)
    mgr = tr.checkpoint_manager()
    assert mgr.all_steps() == [2, 3] and tr.last_save["bytes"] > 0
    assert sorted(p.name for p in (tmp_path / "ck").glob("input_iterator_*.json")) == \
        ["input_iterator_2.json", "input_iterator_3.json"]
    tr2 = ttrainer.Trainer(tcfg, preprocess=pre, device="cpu")
    back = tr2.restore_latest(tr2.init_state(_init(tcfg, seed=5)))
    _assert_same(back, ts)
    pos2 = _Position()
    assert tr2.restore_input_iterator(pos2) and pos2.n == 3
    assert tr2.restore_input_iterator(pos2, step=2) and pos2.n == 2
    reader = mgr.reader(3)
    assert int(reader.get_tensor("step")) == 3
    # TF reads the step directory; names are the JAX tree's
    names = tf.train.load_checkpoint(mgr.step_dir(3)).get_variable_to_shape_map()
    assert "params/" + ("WordEmbedding/embeddings" if preset == "text_only"
                        else "Conv2d_1a_3x3/weights") in names
    assert ttrainer.Trainer(dataclasses.replace(tcfg, train=tcfg.train.replace(
        checkpoint_dir=str(tmp_path / "none"))), device="cpu").restore_latest(ts) is None


def test_a_crash_leaves_no_half_checkpoint(tmp_path, monkeypatch):
    _, tcfg = _cfgs("text_only", train=dict(checkpoint_dir=str(tmp_path / "ck")))
    tr = ttrainer.Trainer(tcfg, device="cpu")
    ts = tr.fit(tr.init_state(_init(tcfg)), _batches(tcfg, 1), num_steps=1)
    tr.save_checkpoint(ts)
    real = ck.write_bundle

    def dies(prefix, tensors):
        real(prefix, dict(list(tensors.items())[:3]))
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(ck, "write_bundle", dies)
    with pytest.raises(RuntimeError, match="mid-write"):
        tr.save_checkpoint(ttrainer.TrainState(2, ts.state, ts.opt_state))
    mgr = tr.checkpoint_manager()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    assert any(p.name.startswith(".2.tmp") for p in (tmp_path / "ck").iterdir())
    assert tr.restore_latest(ts).step == 1


@pytest.mark.parametrize("preset", ["text_only", "image_frozen"])
def test_resume_equals_a_straight_run(tmp_path, preset):
    """fit 4 steps == fit 2, checkpoint, restore in a new trainer, fit 2
    more: every tensor bit-equal (each step draws from (seed, step))."""
    _, tcfg = _cfgs(preset, train=dict(checkpoint_dir=str(tmp_path / "ck"),
                                       checkpoint_every=2))
    pre = None if tcfg.model == "text" else "train"
    batches = _batches(tcfg, 4)
    tr = ttrainer.Trainer(tcfg, preprocess=pre, device="cpu")
    straight = tr.fit(tr.init_state(_init(tcfg)), batches, num_steps=4)
    tr_a = ttrainer.Trainer(tcfg, preprocess=pre, device="cpu")
    tr_a.checkpoint_manager()
    half = tr_a.fit(tr_a.init_state(_init(tcfg)), batches[:2], num_steps=2)
    tr_b = ttrainer.Trainer(tcfg, preprocess=pre, device="cpu")
    resumed = tr_b.restore_latest(tr_b.init_state(_init(tcfg, seed=9)))
    _assert_same(resumed, half)
    resumed = tr_b.fit(resumed, batches[2:], num_steps=2)
    _assert_same(resumed, straight)
    in_process = tr.fit(tr.fit(tr.init_state(_init(tcfg)), batches[:2], num_steps=2),
                        batches[2:], num_steps=2)
    _assert_same(in_process, straight)


_OPTIMIZERS = [dict(), dict(lr_decay_steps=3), dict(optimizer="adam"),
               dict(optimizer="sgd", momentum=0.9), dict(optimizer="sgd", momentum=0.0),
               dict(optimizer="adam", grad_clip_norm=1.0),
               dict(trainable_scopes="TextLogits", lr_decay_steps=2)]


@pytest.mark.parametrize("train", _OPTIMIZERS)
def test_optimizer_state_names_are_the_optax_trees(train):
    jcfg, tcfg = _cfgs("text_only", train={"optimizer": "rmsprop", **train})
    state = _init(tcfg)
    params = convert.to_variables(state)["params"]
    jstate = jtrainer.make_optimizer(jcfg, params).init(params)
    want = sorted("/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None))))
                           for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(jstate)[0])
    tr = ttrainer.Trainer(tcfg, device="cpu")
    ts = tr.init_state(state)
    got = sorted(n[len("opt_state/"):] for n in tr.state_tensors(ts) if n.startswith("opt_state/"))
    assert got == want


def test_a_jax_state_through_orbax_is_evaluated_by_the_port(tmp_path):
    jcfg, tcfg = _cfgs("text_only", train=dict(checkpoint_dir=str(tmp_path / "jax")))
    state = _init(tcfg)
    batches = _batches(tcfg, 3, weight=True)
    mesh = mesh_lib.create_mesh(jconfig.MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(jcfg, mesh=mesh)
    js = jtr.init_state(jax.random.PRNGKey(0), batches[0],
                        initial_variables=convert.to_variables(state))
    step = jax.jit(jtr.train_step)
    for b in batches[:2]:
        js, _ = step(js, {k: v for k, v in b.items() if k != "weight"}, jax.random.PRNGKey(1))
    jtr.checkpoint_manager()
    jtr.save_checkpoint(js)
    jtr2 = jtrainer.Trainer(jcfg, mesh=mesh)
    jtr2.checkpoint_manager()
    js2 = jax.device_get(jtr2.restore_latest(jtr.init_state(jax.random.PRNGKey(0), batches[0])))
    want = jtr2.evaluate(js2, batches)
    # carried into a port checkpoint
    tcfg = tcfg.replace(train=tcfg.train.replace(checkpoint_dir=str(tmp_path / "port")))
    tr = ttrainer.Trainer(tcfg, device="cpu")
    ts = tr.init_state(convert.to_state({"params": js2.params, "batch_stats": js2.batch_stats}))
    opt = convert.opt_state_from_optax(js2.opt_state)
    ts = ttrainer.TrainState(int(js2.step), ts.state, dict(opt, count=opt["count"]))
    tr.save_checkpoint(ts)
    tr2 = ttrainer.Trainer(tcfg, device="cpu")
    back = tr2.restore_latest(tr2.init_state(state))
    _assert_same(back, ts)
    got = tr2.evaluate(back, batches)
    assert got["count"] == want["count"] == 9
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    # and the port's checkpoint names are the orbax tree's leaves
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None))))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(
                 {"params": js2.params, "batch_stats": js2.batch_stats,
                  "opt_state": js2.opt_state, "step": js2.step})[0]}
    assert set(tr2.checkpoint_manager().reader(2).keys()) == jflat
    np.testing.assert_array_equal(
        tr2.checkpoint_manager().reader(2).get_tensor("opt_state/0/mu/TextLogits/kernel"),
        js2.opt_state[0].mu["TextLogits"]["kernel"])
    assert isinstance(js2.opt_state[0], optax.ScaleByAdamState)
