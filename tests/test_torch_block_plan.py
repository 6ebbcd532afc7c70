"""The Inception-A/B blocks' launch plan and the block conv's tile rule, on
the CPU.

Each block runs as a fixed plan of launches of one conv kernel
(``ops/fused_inception.BlockPlan``): the 1x1 convs over the block input
packed into one launch, each later conv of a branch, and the pool branch as
the pooled form.  On the CPU the same plan runs with the plain per-launch
function, so these tests check the plan itself: its structure, that a
packed launch equals its separate convs, that the pooled form equals pool
then conv, and that the weights are packed once.  The tile rule is plain
Python and is checked against the kernel's instantiations.
"""

import re

import numpy as np
import pytest
import torch

from tumblr_emotions_torch import profile_serving
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops import _build
from tumblr_emotions_torch.ops import fused_inception as fi
from tumblr_emotions_torch.ops.inference import FusedInceptionV3

torch.set_num_threads(2)

# wgmma.mma_async m64nNk16 with bf16 operands: N a multiple of 8 up to 256.
WGMMA_BF16_N = set(range(8, 257, 8))
SMEM_PER_BLOCK = 232_448


@pytest.fixture(scope="module")
def taps():
    """Tap stacks of a depth-0.5 tower (every block width a multiple of 8),
    f32, from a seeded state."""
    state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=3)
    return FusedInceptionV3(state, dtype=torch.float32, device="cpu").taps


def _act(shape, seed, dtype=torch.float32):
    x = np.maximum(np.random.RandomState(seed).normal(size=shape), 0).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


SCOPES = [("Mixed_5b", fi.inception_a_branches(False), 5),
          ("Mixed_5c", fi.inception_a_branches(True), 5),
          ("Mixed_5d", fi.inception_a_branches(False), 5),
          ("Mixed_6b", fi.INCEPTION_B_BRANCHES, 8),
          ("Mixed_6c", fi.INCEPTION_B_BRANCHES, 8),
          ("Mixed_6e", fi.INCEPTION_B_BRANCHES, 8)]


@pytest.mark.parametrize("scope,branches,n", SCOPES, ids=[s[0] for s in SCOPES])
def test_plan_structure(taps, scope, branches, n):
    """5 launches per Inception-A block, 8 per Inception-B: the packed 1x1
    first (Branch_0 into its output slice, the branch openings into
    intermediates), the pooled 1x1 last into the last slice; every output
    channel written once, every intermediate written once and read once."""
    plan = fi.block_plan(taps, scope, branches)
    assert len(plan.launches) == n
    first, pooled = plan.launches[0], plan.launches[-1]
    cout = [taps[f"{scope}/{chain[-1][0]}"][0].shape[-1] for _, chain in branches]
    heads = [taps[f"{scope}/{chain[0][0]}"][0].shape[-1] for p, chain in branches if not p]
    assert first.src is None and first.op.kernel == (1, 1) and not first.op.pooled
    assert first.op.widths == tuple(heads) and first.dsts == (("out", 0), ("tmp", 0), ("tmp", 1))
    assert pooled.op.pooled and pooled.src is None and pooled.op.widths == (cout[3],)
    assert pooled.dsts == (("out", sum(cout[:3])),)
    assert sum(L.op.pooled for L in plan.launches) == 1
    written = sorted((i, i + L.op.widths[k]) for L in plan.launches
                     for k, (kind, i) in enumerate(L.dsts) if kind == "out")
    assert written == [(a, b) for a, b in zip(np.cumsum([0] + cout[:-1]), np.cumsum(cout))]
    assert plan.cout == sum(cout)
    tmp_written = [i for L in plan.launches for kind, i in L.dsts if kind == "tmp"]
    tmp_read = [L.src for L in plan.launches if L.src is not None]
    assert sorted(tmp_written) == sorted(tmp_read) == list(range(len(plan.tmp_widths)))


def test_plan_kernels_follow_the_branches(taps):
    plan = fi.block_plan(taps, "Mixed_6b", fi.INCEPTION_B_BRANCHES)
    assert [L.op.kernel for L in plan.launches] == [
        (1, 1), (1, 7), (7, 1), (7, 1), (1, 7), (7, 1), (1, 7), (1, 1)]
    plan = fi.block_plan(taps, "Mixed_5b", fi.inception_a_branches(False))
    assert [L.op.kernel for L in plan.launches] == [(1, 1), (5, 5), (3, 3), (3, 3), (1, 1)]


def test_packed_weights_are_built_once(taps, monkeypatch):
    """The plan is cached per tap stacks: a second call finds the same
    packed tensors and concatenates nothing."""
    x = _act((1, 5, 5, taps["Mixed_6b/Branch_0/Conv2d_0a_1x1"][0].shape[1]), 1)
    fi.fused_inception_b(x, taps, "Mixed_6b")
    plan = fi.block_plan(taps, "Mixed_6b", fi.INCEPTION_B_BRANCHES)
    packed = [(L.op.w, L.op.bias) for L in plan.launches]
    cats = []
    real_cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1) or real_cat(*a, **k))
    fi.fused_inception_b(x, taps, "Mixed_6b")
    assert not cats
    assert fi.block_plan(taps, "Mixed_6b", fi.INCEPTION_B_BRANCHES) is plan
    assert all(L.op.w is w and L.op.bias is b for L, (w, b) in zip(plan.launches, packed))


def test_new_taps_get_a_new_plan(taps):
    other = dict(taps)
    w, b = other["Mixed_5b/Branch_0/Conv2d_0a_1x1"]
    other["Mixed_5b/Branch_0/Conv2d_0a_1x1"] = (w.clone(), b)
    branches = fi.inception_a_branches(False)
    assert fi.block_plan(other, "Mixed_5b", branches) is not fi.block_plan(taps, "Mixed_5b",
                                                                          branches)


def test_a_plan_goes_with_its_tap_stacks(taps):
    """The cache does not keep a dropped engine's plans: an entry goes when
    a tap stack it packed is freed."""
    import gc

    other = {k: (w.clone(), b) for k, (w, b) in taps.items() if k.startswith("Mixed_6b/")}
    fi.block_plan(other, "Mixed_6b", fi.INCEPTION_B_BRANCHES)
    before = len(fi._PLANS)
    del other
    gc.collect()
    assert len(fi._PLANS) == before - 1


def test_engine_holds_its_plans():
    state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=4)
    eng = FusedInceptionV3(state, dtype=torch.bfloat16, device="cpu")
    assert sorted(eng.block_plans) == sorted(["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6b",
                                              "Mixed_6c", "Mixed_6d", "Mixed_6e"])
    assert eng.block_plans["Mixed_5c"] is fi.block_plan(eng.taps, "Mixed_5c",
                                                        fi.inception_a_branches(True))
    assert eng.block_plans["Mixed_6d"].launches[0].op.w.dtype == torch.bfloat16
    assert FusedInceptionV3(state, use_kernels=False, device="cpu").block_plans == {}


def _ulps(got, want):
    """Distance in bf16 ulps (of the larger magnitude) of each element."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    return (g - w).abs() / ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scope", ["Mixed_5b", "Mixed_6c"])
def test_packed_launch_equals_its_separate_convs(taps, scope, dtype):
    names = ["Branch_0/Conv2d_0a_1x1", "Branch_1/Conv2d_0a_1x1", "Branch_2/Conv2d_0a_1x1"]
    parts = [(taps[f"{scope}/{n}"][0].to(dtype), taps[f"{scope}/{n}"][1]) for n in names]
    op = fi.ConvOp(parts, (1, 1))
    x = _act((2, 7, 6, parts[0][0].shape[1]), 2, dtype)
    got = op(x)
    assert [tuple(g.shape) for g in got] == [(2, 7, 6, w.shape[-1]) for w, _ in parts]
    for g, (w, b) in zip(got, parts):
        want = fi.conv_same_bias_relu_plain(x, w, b, (1, 1))
        if dtype == torch.float32:
            torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())
        else:
            assert _ulps(g, want).max().item() <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pooled_form_is_pool_then_conv(taps, dtype):
    w, b = taps["Mixed_6b/Branch_3/Conv2d_0b_1x1"]
    w = w.to(dtype)
    x = _act((2, 9, 8, w.shape[1]), 3, dtype)
    (got,) = fi.ConvOp([(w, b)], (1, 1), pooled=True)(x)
    want = fi.conv_same_bias_relu_plain(fi.avg_pool3_same_plain(x), w, b, (1, 1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("scope,branches,n", SCOPES, ids=[s[0] for s in SCOPES])
def test_plan_equals_the_conv_by_conv_block(taps, scope, branches, n):
    """The plan on the CPU against the block computed conv by conv (the
    plain version chip_smoke.py holds the kernel block to)."""
    x = _act((2, 9, 9, taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1]), 4)
    got = fi.block_plan(taps, scope, branches)(x)
    want = fi._run_block_plain(x, taps, scope, branches)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_conv_op_refuses_what_does_not_fit(taps):
    w, b = taps["Mixed_5b/Branch_2/Conv2d_0b_3x3"]
    with pytest.raises(ValueError):
        fi.ConvOp([(w, b)], (1, 3))                   # 9 taps, not 3
    with pytest.raises(ValueError):
        fi.ConvOp([(w, b)], (3, 3), pooled=True)      # the pooled form is 1x1
    with pytest.raises(ValueError):
        fi.ConvOp([(w, b)] * 5, (3, 3))               # five segments
    op = fi.ConvOp([(w, b)], (3, 3))
    with pytest.raises(ValueError):
        op(_act((1, 5, 5, w.shape[1] + 8), 5))        # Cin
    with pytest.raises(ValueError):
        op(_act((1, 5, 5, w.shape[1]), 5), [torch.empty(1, 5, 4, w.shape[2])])


# ---------------------------------------------------------------------------
# The tile rule
# ---------------------------------------------------------------------------

# The launches of the full-width blocks at B=64: (site, M, Cout, K, pooled).
FULL_WIDTH = [
    ("Mixed_5b packed", 64 * 35 * 35, 176, 192, False),
    ("Mixed_5b 5x5", 64 * 35 * 35, 64, 25 * 48, False),
    ("Mixed_5b 3x3 a", 64 * 35 * 35, 96, 9 * 64, False),
    ("Mixed_5b 3x3 b", 64 * 35 * 35, 96, 9 * 96, False),
    ("Mixed_5b pooled", 64 * 35 * 35, 32, 192, True),
    ("Mixed_5d pooled", 64 * 35 * 35, 64, 288, True),
    ("Mixed_6b packed", 64 * 17 * 17, 448, 768, False),
    ("Mixed_6c packed", 64 * 17 * 17, 512, 768, False),
    ("Mixed_6e packed", 64 * 17 * 17, 576, 768, False),
    ("Mixed_6b 1x7", 64 * 17 * 17, 128, 7 * 128, False),
    ("Mixed_6b 7x1", 64 * 17 * 17, 192, 7 * 128, False),
    ("Mixed_6c 1x7", 64 * 17 * 17, 160, 7 * 160, False),
    ("Mixed_6e 7x1", 64 * 17 * 17, 192, 7 * 192, False),
    ("Mixed_6b pooled", 64 * 17 * 17, 192, 768, True),
]


@pytest.mark.parametrize("site,m,cout,k,pooled", FULL_WIDTH, ids=[s[0] for s in FULL_WIDTH])
def test_tile_rule_at_the_full_width_launches(site, m, cout, k, pooled):
    width = (35 if m == 64 * 35 * 35 else 17) if pooled else 0
    tile = fi.pick_tile(m, cout, k, pooled, width)
    assert tile.pooled == pooled and (tile.bm, tile.bn) in fi.CONFIGS[pooled]
    assert tile.bn in WGMMA_BF16_N and tile.bm in (64, 128)
    assert fi._smem_bytes(tile.bm, tile.bn, pooled, width) <= SMEM_PER_BLOCK
    assert tile.tiles(m, cout) >= fi.SMS, site
    full = [fi.TileConfig(bm, bn, pooled) for bm, bn in fi.CONFIGS[pooled]
            if fi.TileConfig(bm, bn, pooled).tiles(m, cout) >= fi.SMS]
    assert fi._tile_cost(m, cout, k, tile.bm, tile.bn, pooled, width) == min(
        fi._tile_cost(m, cout, k, t.bm, t.bn, pooled, width) for t in full)


def test_every_pooled_tile_fits_the_blocks_images():
    """The pooled form's halo grows with the image width: every pooled
    tile fits shared memory at 35 pixels, and a far wider image is
    refused rather than launched."""
    assert all(fi._smem_bytes(bm, bn, True, 35) <= SMEM_PER_BLOCK for bm, bn in fi.CONFIGS[True])
    with pytest.raises(ValueError):
        fi.pick_tile(64 * 900 * 900, 64, 288, True, 900)


def test_tile_rule_on_a_tiny_launch():
    """With no tile giving one tile per SM, the pick gives the most tiles."""
    tile = fi.pick_tile(2 * 5 * 5, 40, 360)
    assert tile.tiles(50, 40) == max(fi.TileConfig(bm, bn).tiles(50, 40)
                                     for bm, bn in fi.CONFIGS[False])


def test_tiles_are_the_kernels_instantiations():
    """CONFIGS names exactly the (BM, BN, pooled) the CUDA source
    instantiates, and the shared-memory model matches the source's."""
    src = (_build.CSRC / "inception_blocks.cu").read_text()
    block = src[src.index("#define BF16_CONFIGS(X)"):]
    block = block[:block.index("\n\n")]
    got = {(int(bm), int(bn), bool(int(p)))
           for bm, bn, p in re.findall(r"X\((\d+), (\d+), (\d)\)", block)}
    want = {(bm, bn, p) for p, tiles in fi.CONFIGS.items() for bm, bn in tiles}
    assert got == want
    assert "return (POOL ? 1 : STAGES) * BM * ROWB + STAGES * BN * ROWB + BM * BN * 2 + 4 * BN " \
        "+ BN + 256 +\n         8 * STAGES + 1024 + 128;" in src
    assert "return STAGES * (BM + 2 * W + 2) * ROWB;" in src
    assert "constexpr int BK = 64;" in src and "constexpr int STAGES = 3;" in src
    assert "constexpr int MAX_SEGS = 4;" in src and fi.MAX_SEGMENTS == 4


def test_block_widths_are_instantiated():
    """Every Cout of the full-width blocks' launches is a multiple of some
    instantiated BN of its form, so no channel tile is partial there."""
    for _, _, cout, _, pooled in FULL_WIDTH:
        assert any(cout % bn == 0 for _, bn in fi.CONFIGS[pooled]), cout


# ---------------------------------------------------------------------------
# The build and the profile's groups
# ---------------------------------------------------------------------------

def test_a_header_edit_rebuilds(tmp_path, monkeypatch):
    """The library's name hashes the shared headers under csrc/ too."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in _build.SIGNATURES}
    (tmp_path / "hopper_ptx.cuh").write_text((tmp_path / "hopper_ptx.cuh").read_text() + "\n")
    after = {n: _build._target(n) for n in _build.SIGNATURES}
    assert all(before[n] != after[n] for n in ("int8_conv", "inception_blocks"))


def test_profile_groups_follow_the_kernel_names():
    assert profile_serving._group("void (anonymous namespace)::conv_bf16_wgmma<128, 176, false>"
                                  "(...)") == "block conv kernel (ours)"
    assert profile_serving._group("conv_bf16_wgmma<64, 32, true>") == "block conv kernel (ours)"
    assert profile_serving._group("conv_int8_wgmma<16, 128, 64>") == "int8 conv kernel (ours)"
    assert not any("pool3" in key for key, _ in profile_serving.GROUPS)
