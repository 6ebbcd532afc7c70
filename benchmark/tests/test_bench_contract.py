"""The benchmark's files against its contract, on the CPU: names, units and
keys of ``BENCHMARK.json``, every cell's files, the imports of the
harness and the reference, and the reference's work count against the
port's model."""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "tumblr_emotions_tpu"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == TOP
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contracts_keys_and_names(section, keys):
    entries = bench()[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_every_cell_metric_and_config_has_its_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert PATH.match(c["file"]) and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and all(NAME.match(k) for k in c["reduced"])
    used = set()
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] in configs and wl["chips"] == w["chips"]
        assert (BENCH / "drivers" / f"{wl['driver']}.py").is_file()
        used.add(w["config"])
    assert used == set(configs)
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:   # every cell: setup_s, one more end-to-end and one per-layer metric
        assert len([m for m in e2e.values() if cell in m.get("workloads", [cell])]) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


def test_file_names_under_paths_are_names():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
        assert all(NAME.match(part) for part in rel.split("/")), rel


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_nothing_the_benchmark_runs_imports_jax_and_the_reference_nothing_of_the_port():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]
    assert files
    for p in files:
        tops = {name.split(".")[0] for name in _imports(p)}
        assert not tops & FORBIDDEN, p
        assert "bench" != p.stem   # root bench.py is not read
        if "reference" in p.relative_to(BENCH).parts:
            assert "tumblr_emotions_torch" not in tops, p
    assert "tumblr_emotions_torch" not in FORBIDDEN   # top-level names compare whole


def test_reference_counts_the_tower_work_the_ports_model_does():
    """``chip_smoke.tower_macs``'s method (MACs from each conv's output shape
    on the meta device, through the convs' forward hooks, which the two
    heads' ``unrounded`` calls do not fire) on the port's model, against
    the reference's layer table."""
    import torch

    from benchmark.reference.model import layer_table
    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.models import build_model
    from tumblr_emotions_torch.models.layers import ConvBN

    cfg = get_preset("joint_finetune")
    model = build_model(cfg.replace(model="image"), device="meta")
    macs = []
    for mod in model.modules():
        if isinstance(mod, ConvBN):
            mod.register_forward_hook(
                lambda m, a, out: macs.append(out[0].numel() * m.weights[0].numel()))
    model(torch.empty(1, 299, 299, 3, device="meta"))
    table = layer_table(299)
    body = [c for c in table if not c.head]
    assert len(table) == 98 and len(body) == len(macs) == 96
    assert [c.macs() for c in body] == macs
    assert sum(c.macs() for c in table) == sum(macs) + 768 * 15 + 2048 * 15 == 5_716_125_536


class _Launches:
    """An op set for the port's int8 tower (``ops/quant._tower``) that
    records each conv launch's scopes; tensors are stand-ins that carry
    only their channel count."""

    stem_s2d = "pre"

    class T:
        def __init__(self, c):
            self.shape = (1, 1, 1, c)

    def __init__(self, table):
        import numpy as np

        self.folded = {c.name[len("InceptionV3."):]: (np.zeros((1, 1, 1, c.cout)),)
                       for c in table}
        self.launches = []

    def _cout(self, scope):
        return self.folded[scope][0].shape[-1]

    def stem_in(self, x):
        return self.T(3)

    def conv(self, t, scope, out_key=None, strides=(1, 1), padding="VALID", dst=None):
        self.launches.append([scope])
        return self.T(self._cout(scope))

    def conv_s2d(self, t, scope, out_key=None, dst=None):
        return self.conv(t, scope)

    def packed(self, t, scopes, out_keys=None, dsts=None):
        self.launches.append(list(scopes))
        return [self.T(self._cout(s)) for s in scopes]

    def act(self, p, out_key):
        return p

    def pool_act(self, p, out_key, dst=None):
        return p

    def maxpool(self, t, out_key=None, dst=None):
        return t

    def block_out(self, t, out_key, widths, reduce=False):
        return [self.T(w) for w in widths]

    def concat(self, parts, out_key=None):
        return self.T(sum(p.shape[-1] for p in parts))

    def finish(self, t):
        return t


def test_roofline_groups_the_convs_as_the_ports_int8_tower_launches_them():
    """The yardstick's 66 groups are the port's 66 int8 conv launches: the
    branch openers of a block that read its input, one wide conv each."""
    from benchmark import roofline
    from tumblr_emotions_torch.ops.quant import _tower

    ops = _Launches(roofline.served_convs())
    _tower(ops, None)
    port = sorted(sorted(g) for g in ops.launches)
    ours = sorted(sorted(c.name[len("InceptionV3."):] for c in g)
                  for g in roofline.served_launches())
    assert len(port) == 66 and port == ours
    rates = roofline.launch_bound_s(roofline.served_launches(), 64, roofline.PEAK_OPS_S["int8"])
    alone = roofline.launch_bound_s([[c] for c in roofline.served_convs()], 64,
                                    roofline.PEAK_OPS_S["int8"])
    assert 0.4e-3 < rates < alone   # the openers' input is read once, not once a conv


# Kernels of PyTorch and cuDNN as the card's profiler names them (traced
# runs of the two cells on an H100).
LIBRARY_KERNELS = {
    "pass": [
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::CUDAFunctor_add<float> >(at::",
        "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}:",
        "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
        "at::native::WelfordOps<float, float, int, thrust::THR",
    ],
    "other": [
        "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_nn_align1>("
        "cutlass_75_tensorop_bf16_s1688gemm_bf16",
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8_stage3_"
        "warpsize2x2x1_g1_ffma_aligna4_alig",
        "void cudnn::cnn::wgrad_alg1_engine_NHWC<float, float, 128, 5, 5, 3, 3, 3, false, true>("
        "int, int, int, float const*, int,",
        "Memcpy HtoD (Pinned -> Device)",
    ],
}


def _port_kernels():
    """{kernel: source file's stem} of every ``__global__`` function in the
    port's CUDA sources, named as the trace names them."""
    out = {}
    for cu in sorted((ROOT / "tumblr_emotions_torch" / "csrc").glob("*.cu")):
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                             cu.read_text()):
            out[f"void (anonymous namespace)::{m.group(1)}<16, 128, 64>(signed char const*"] = \
                cu.stem
    return out


def _matched(patterns, names, match=True):
    from benchmark.devtrace import Trace

    kernels = [(n, 0, 1) for n in names]
    return {n for n in names
            if Trace(0, 1, [(n, 0, 1)], kernels, [], []).kernel_s(patterns, match) > 0}


def test_metric_patterns_match_the_kernels_the_trace_names():
    """Each per-layer metric's kernel patterns, through the trace's own
    matching, against the port's kernel names and the library's."""
    from benchmark.cell import HERE, load_module

    port = _port_kernels()
    assert sorted(set(port.values())) == ["inception_blocks", "int8_conv", "int8_pool"]
    by_file = {f: {n for n, s in port.items() if s == f} for f in set(port.values())}
    assert len(by_file["int8_pool"]) == 2 and len(by_file["int8_conv"]) == 2
    passes = LIBRARY_KERNELS["pass"]
    names = set(port) | set(passes) | set(LIBRARY_KERNELS["other"])

    conv = load_module(HERE / "metrics" / "conv_int8_roofline.py").KERNELS
    assert _matched(conv, names) == by_file["int8_conv"]
    ours = load_module(HERE / "metrics" / "torch_pass_ms.serve.py").OURS
    assert _matched(ours, names, match=False) == \
        names - by_file["int8_conv"] - by_file["int8_pool"]
    bn = load_module(HERE / "metrics" / "bn_pass_ms.train.py").PASSES
    assert _matched(bn, names) == set(passes)
