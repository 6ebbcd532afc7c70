"""The PyTorch port's f32 slim tower and eval preprocessing against the JAX
package on the CPU, and the port's guards: it imports nothing of JAX, and
its entry points do not drop to the CPU unasked."""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu.data import preprocessing as jpp
from tumblr_emotions_tpu.models import InceptionV3 as JaxInceptionV3
from tumblr_emotions_torch import convert, get_preset
from tumblr_emotions_torch.data import preprocessing as tpp
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3
from tumblr_emotions_torch.ops.serving import build_forward, image_server

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL = dict(num_classes=15, depth_multiplier=0.25, create_aux_logits=True)
IMAGE = 139


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_size,in_size,method", [
    (299, 303, "tf1"), (139, 175, "tf1"), (299, 150, "tf1"),
    (299, 303, "half_pixel"), (64, 64, "tf1")])
def test_interp_matrix_equals_jax(out_size, in_size, method):
    np.testing.assert_array_equal(tpp._interp_matrix(out_size, in_size, method),
                                  jpp._interp_matrix(out_size, in_size, method))


@pytest.mark.parametrize("method,size", [("tf1", 299), ("tf1", 139),
                                         ("half_pixel", 299)])
def test_preprocess_for_eval_matches_jax(method, size):
    raw = np.random.RandomState(0).randint(0, 256, (2, 160, 200, 3), dtype=np.uint8)
    want = np.asarray(jpp.preprocess_for_eval(jnp.asarray(raw), size, size,
                                              resize_method=method))
    got = tpp.preprocess_for_eval(torch.from_numpy(raw), size, size,
                                  resize_method=method)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_central_crop_sizes_equal_jax():
    for hw in [(347, 347), (345, 517), (160, 200)]:
        assert tpp.central_crop_sizes(*hw, 0.875) == jpp.central_crop_sizes(*hw, 0.875)


# ---------------------------------------------------------------------------
# The f32 tower against Flax (precision="highest")
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def towers():
    port = InceptionV3(**MODEL, image_size=IMAGE, device="cpu")
    state = init_state(port, seed=4)
    port.load_state_dict(state)
    x = np.random.RandomState(5).uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)
    model = JaxInceptionV3(**MODEL, precision="highest")
    variables = convert.to_variables(state)
    _, want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        _, got = port(torch.from_numpy(x))
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))
    return state, variables, shapes, got, want


def test_port_variables_have_the_flax_structure(towers):
    _, variables, shapes, _, _ = towers
    want = jax.tree_util.tree_map(lambda s: s.shape, dict(shapes))
    got = jax.tree_util.tree_map(lambda a: a.shape, variables)
    assert got == want


@pytest.mark.parametrize("end_point", [
    "Conv2d_4a_3x3", "MaxPool_5a_3x3", "Mixed_5b", "Mixed_5c", "Mixed_5d",
    "Mixed_6a", "Mixed_6b", "Mixed_6e", "AuxLogits", "Mixed_7a", "Mixed_7b",
    "Mixed_7c", "PreLogits", "Logits", "Predictions"])
def test_f32_tower_matches_flax(towers, end_point):
    *_, got, want = towers
    g, w = got[end_point].numpy(), np.asarray(want[end_point])
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_tower_rejects_train_mode_and_wrong_rank(towers):
    port = InceptionV3(**MODEL, image_size=IMAGE, device="cpu")
    with pytest.raises(ValueError):
        port(torch.zeros(IMAGE, IMAGE, 3))
    # The bf16 (perf) model, once refused in train mode, trains
    # (tests/test_torch_perf_train.py): the wrong rank is refused there too.
    port = InceptionV3(**MODEL, image_size=IMAGE, dtype=torch.bfloat16, device="cpu")
    port.train()
    with pytest.raises(ValueError):
        port(torch.zeros(IMAGE, IMAGE, 3))
    logits, _ = port(torch.zeros(2, IMAGE, IMAGE, 3))
    assert logits.dtype == torch.float32 and logits.requires_grad


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tumblr_emotions_tpu", "PIL", "grain", "orbax",
             "google_crc32c", "tensorflow", "clu", "tensorboard", "array_record")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_source_imports_no_jax():
    files = sorted((ROOT / "tumblr_emotions_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        bad = [m for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
        assert not bad, (f, bad)


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "import tumblr_emotions_torch, tumblr_emotions_torch.ops.serving\n"
            "import tumblr_emotions_torch.convert, tumblr_emotions_torch.ops._build\n"
            "import tumblr_emotions_torch.ops.quant, tumblr_emotions_torch.ops.int8_conv\n"
            "import tumblr_emotions_torch.ops.int8_pool, tumblr_emotions_torch.profile_serving\n"
            "import tumblr_emotions_torch.server, tumblr_emotions_torch.train.predict\n"
            "import tumblr_emotions_torch.data.jpeg, tumblr_emotions_torch.data.pipeline\n"
            "import tumblr_emotions_torch.train.trainer, tumblr_emotions_torch.train.optim\n"
            "import tumblr_emotions_torch.utils.metrics, tumblr_emotions_torch.cli\n"
            "import tumblr_emotions_torch.data.records, tumblr_emotions_torch.data.csv_dataset\n"
            "import tumblr_emotions_torch.data.convert, tumblr_emotions_torch.data.index_shuffle\n"
            "import tumblr_emotions_torch.utils.checkpoint, tumblr_emotions_torch.utils.crc32c\n"
            "import tumblr_emotions_torch.utils.host_lib, tumblr_emotions_torch.parallel\n"
            "import tumblr_emotions_torch.parallel.mesh, tumblr_emotions_torch.parallel.distributed\n"
            "import tumblr_emotions_torch.utils.summaries, tumblr_emotions_torch.perf_noise\n"
            "import tumblr_emotions_torch.train.noise_floor\n"
            "import tumblr_emotions_torch.utils.compile_opts, tumblr_emotions_torch.analysis\n"
            "import tumblr_emotions_torch.data.word2vec, tumblr_emotions_torch.data.scraper\n"
            "import tumblr_emotions_torch.models.layers\n"
            "import tumblr_emotions_torch.utils.highwayhash, tumblr_emotions_torch.utils.zstd\n"
            "import tempfile, os\n"
            "from tumblr_emotions_torch.data import records\n"
            "p = os.path.join(tempfile.mkdtemp(), 'a.arrayrecord')\n"
            "with records.ArrayRecordWriter(p) as w:\n"
            "    w.write(b'x' * 70000)\n"
            "assert records.ArrayRecordReader(p).read() == [b'x' * 70000]\n"
            "from tumblr_emotions_torch.data import jpeg\n"
            "for m in ('islow', 'ifast', 'float'):\n"
            "    assert jpeg.decode(open(%r, 'rb').read(), dct_method=m).shape == (97, 161, 3)\n"
            "print('ok')\n" % (FORBIDDEN, str(ROOT / "tests/data/jpeg/arith/progressive_420_161x97.jpg")))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def _cpu_state():
    return init_state(InceptionV3(**MODEL, image_size=IMAGE, device="meta"), seed=0)


@pytest.mark.parametrize("entry", ["InceptionV3", "FusedInceptionV3", "image_server",
                                   "build_forward", "QuantizedInceptionV3"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    cfg = get_preset("fused_inference")
    calls = {
        "InceptionV3": lambda: InceptionV3(**MODEL),
        "FusedInceptionV3": lambda: FusedInceptionV3(_cpu_state()),
        "image_server": lambda: image_server(
            FusedInceptionV3(_cpu_state(), device="cpu")),
        "build_forward": lambda: build_forward(cfg, _cpu_state()),
        "QuantizedInceptionV3": lambda: QuantizedInceptionV3(
            _cpu_state(), np.zeros((1, IMAGE, IMAGE, 3), np.float32)),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
