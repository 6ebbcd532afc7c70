"""TF V1 checkpoints without TF (``utils/checkpoint.V1Reader``,
``load_checkpoint``): slim's released checkpoints are V1 single files, the
reference's documented warm start (``--warmstart inception_v3.ckpt``).

TensorFlow writes the V1 files here
(``tf.compat.v1.train.Saver(write_version=SaverDef.V1)``, through
``tests/data/v1/make_fixture.py``) and is the oracle: the port reads every
tensor bit for bit as ``tf.train.load_checkpoint`` does, and a partitioned
variable (which ``tf.train.load_checkpoint`` refuses) as TF's V1
``Restore`` op reassembles it.  The committed fixture (a few KB) is held to
the values TF read back from it, with no TF, so the card machine runs that
test too (``tests/test_torch_cuda.py``).
"""

import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest

from tumblr_emotions_torch import cli as tcli
from tumblr_emotions_torch import config as tconfig
from tumblr_emotions_torch import convert
from tumblr_emotions_torch.models import build_model, inception_v3
from tumblr_emotions_torch.utils import checkpoint as ck

FIXTURE = Path(__file__).parent / "data" / "v1"


def _maker():
    spec = importlib.util.spec_from_file_location("make_v1_fixture", FIXTURE / "make_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_committed_fixture_equals_its_stored_values():
    want = np.load(FIXTURE / "expected.npz")
    reader = ck.load_checkpoint(str(FIXTURE / "slim_v1.ckpt"))
    assert isinstance(reader, ck.V1Reader)
    assert sorted(reader.keys()) == sorted(want.files)
    part = "InceptionV3/Conv2d_2a_3x3/weights"
    assert reader.meta[part][2] == 3                     # saved as three slices
    for name in want.files:
        got = reader.get_tensor(name)
        assert got.dtype == want[name].dtype and got.shape == want[name].shape, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert reader.get_variable_to_shape_map()[part] == [3, 3, 8, 8]
    pre = ck.load_slim_checkpoint(str(FIXTURE / "slim_v1.ckpt"))
    assert set(pre["params"]) == {"Conv2d_1a_3x3/weights", "Conv2d_1a_3x3/BatchNorm/beta",
                                  "Conv2d_2a_3x3/weights", "Logits/Conv2d_1c_1x1/biases"}
    np.testing.assert_array_equal(
        pre["params"]["Conv2d_2a_3x3/weights"],
        convert.to_port_leaf(("Conv2d_2a_3x3", "weights"), want[part]))


@pytest.fixture(scope="module")
def tower():
    """A depth-0.25 slim tower (seeded), as the TF checkpoint names it, in
    the JAX layouts."""
    cfg = tconfig.get_preset("image_frozen")
    # the CLI's --depth-multiplier also sets min_depth 8
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.25, image_size=139,
                                              min_depth=8))
    state = inception_v3.init_state(build_model(cfg, device="meta"), 3)
    flat = {f"InceptionV3/{k.replace('.', '/')}": convert.to_jax_leaf(k, v)
            for k, v in state.items()}
    return cfg, flat


PART = "InceptionV3/Mixed_7c/Branch_3/Conv2d_0b_1x1/weights"


@pytest.fixture(scope="module")
def v1_files(tower, tmp_path_factory):
    """The tower written by TF as a V1 single file and as a sharded V1
    save, one leaf partitioned into three slices, with a global step and an
    optimizer slot; and the same values as a V2 bundle."""
    pytest.importorskip("tensorflow")
    make = _maker()
    _, flat = tower
    values = {k: v for k, v in flat.items() if k != PART}
    values["global_step"] = np.int64(7)
    values["InceptionV3/Logits/Conv2d_1c_1x1/biases/Adam"] = flat[
        "InceptionV3/Logits/Conv2d_1c_1x1/biases"]
    tmp = tmp_path_factory.mktemp("v1")
    for d in ("single", "sharded", "v2"):
        (tmp / d).mkdir()
    single = make.write(tmp / "single" / "model.ckpt", values, {PART: flat[PART]})
    sharded = make.write(tmp / "sharded" / "model.ckpt", values, {PART: flat[PART]},
                         sharded=True)
    v2 = str(tmp / "v2" / "model.ckpt")
    ck.write_bundle(v2, dict(values, **{PART: flat[PART]}))
    return single, sharded, v2, make


def test_v1_reader_equals_tf_load_checkpoint(tower, v1_files):
    import tensorflow as tf

    single, sharded, _, make = v1_files
    assert not single.endswith("?????") and sharded.endswith("-of-00001")
    for path in (single, sharded):
        want = make.read_back(path, partitioned=(PART,))
        reader = ck.load_checkpoint(path)
        assert isinstance(reader, ck.V1Reader)
        theirs = tf.train.load_checkpoint(path)
        assert reader.get_variable_to_shape_map() == theirs.get_variable_to_shape_map()
        for name, w in want.items():
            got = reader.get_tensor(name)
            assert got.dtype == w.dtype and got.shape == w.shape, name
            np.testing.assert_array_equal(got, w, err_msg=name)
        np.testing.assert_array_equal(reader.get_tensor(PART), tower[1][PART])
        assert reader.meta[PART][2] == 3


def test_a_warm_start_from_v1_equals_one_from_the_v2_bundle(v1_files):
    """``load_slim_checkpoint`` and ``cli train --warmstart``'s start
    (``_init_trainer_state``) from the V1 file and from a V2 bundle of the
    same values: the same state, bit for bit; through a directory's state
    file too."""
    single, _, v2, _ = v1_files
    a, b = ck.load_slim_checkpoint(single), ck.load_slim_checkpoint(v2)
    for col in ("params", "batch_stats"):
        assert sorted(a[col]) == sorted(b[col]) and len(a[col]) > 50
        for k in a[col]:
            np.testing.assert_array_equal(np.asarray(a[col][k]), np.asarray(b[col][k]))

    def start(path):
        args = tcli.parser().parse_args(
            ["train", "--preset", "image_frozen", "--depth-multiplier", "0.25",
             "--image-size", "139", "--warmstart", path, "--device", "cpu"])
        cfg = tcli._build_config(args)
        sample = {"image": np.zeros((1, 160, 160, 3), np.uint8),
                  "label": np.zeros(1, np.int32)}
        return tcli._init_trainer_state(args, cfg, None, sample)[1]

    sa, sb, sd = start(single), start(v2), start(str(Path(single).parent))
    for k in sa.state:
        np.testing.assert_array_equal(sa.state[k].detach().numpy(),
                                      sb.state[k].detach().numpy(), err_msg=k)
        np.testing.assert_array_equal(sa.state[k].detach().numpy(),
                                      sd.state[k].detach().numpy(), err_msg=k)


def test_load_checkpoint_tells_the_formats_apart(tmp_path, v1_files):
    single, sharded, v2, _ = v1_files
    assert isinstance(ck.load_checkpoint(v2), ck.BundleReader)
    assert isinstance(ck.load_checkpoint(v2 + ".index"), ck.BundleReader)
    assert isinstance(ck.load_checkpoint(sharded), ck.V1Reader)
    with pytest.raises(FileNotFoundError, match="neither a V2 bundle"):
        ck.load_checkpoint(str(tmp_path / "nothing.ckpt"))
    with pytest.raises(FileNotFoundError, match="load_checkpoint reads V1"):
        ck.BundleReader(single)


def _rewrite_first_block(path, out, mutate):
    """``path``'s table with its first data block changed by
    ``mutate(raw, offset, size)`` and its crc made valid again."""
    raw = bytearray(Path(path).read_bytes())
    _, pos = ck._read_varint(raw[-ck.FOOTER_LEN:], 0)
    _, pos = ck._read_varint(raw[-ck.FOOTER_LEN:], pos)
    off, pos = ck._read_varint(raw[-ck.FOOTER_LEN:], pos)
    size, _ = ck._read_varint(raw[-ck.FOOTER_LEN:], pos)
    handle = ck._read_block(bytes(raw), off, size)[0][1]
    boff, p = ck._read_varint(handle, 0)
    bsize, _ = ck._read_varint(handle, p)
    mutate(raw, boff, bsize)
    crc = ck.crc32c.mask(ck.crc32c.extend(ck.crc32c.value(bytes(raw[boff:boff + bsize])),
                                          bytes([raw[boff + bsize]])))
    raw[boff + bsize + 1:boff + bsize + 5] = struct.pack("<I", crc)
    Path(out).write_bytes(bytes(raw))


def test_v1_refusals_name_their_cause(tmp_path):
    src = FIXTURE / "slim_v1.ckpt"

    def compress(raw, boff, bsize):
        raw[boff + bsize] = 1                       # marked snappy-compressed
    _rewrite_first_block(src, tmp_path / "compressed.ckpt", compress)
    with pytest.raises(ValueError, match="compressed"):
        ck.load_checkpoint(str(tmp_path / "compressed.ckpt"))
    raw = bytearray(src.read_bytes())
    raw[20] ^= 1
    (tmp_path / "corrupt.ckpt").write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc mismatch"):
        ck.load_checkpoint(str(tmp_path / "corrupt.ckpt"))
    reader = ck.load_checkpoint(str(src))
    part = "InceptionV3/Conv2d_2a_3x3/weights"
    reader.slices[part] = reader.slices[part][:2]   # a shard of its slices missing
    with pytest.raises(IOError, match="2 of its 3 slices"):
        reader.get_tensor(part)
    with pytest.raises(KeyError):
        reader.get_tensor("nothing")
