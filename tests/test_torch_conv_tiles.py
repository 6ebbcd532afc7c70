"""The int8 conv kernel's tile rule (``ops/int8_conv.pick_tile``), on the CPU.

The rule is plain Python, so it is checked here at the full-width shapes
the served int8 program gives ``conv_int8`` (B=64) and at every conv of a
depth-0.25 engine, recorded through the wrapper: each pick is a tile the
kernel has, with a width ``wgmma`` takes for ``.s8``, covers Cout, fits in
shared memory, and cuts the output into at least one tile per SM or,
where no tile does, into as many tiles as any tile does.
"""

import re

import numpy as np
import pytest
import torch

from tumblr_emotions_torch.data.preprocessing import (
    preprocess_for_eval, preprocess_for_eval_s2d)
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops import _build
from tumblr_emotions_torch.ops import int8_conv as ic
from tumblr_emotions_torch.ops import quant as tq

# wgmma.mma_async m64nNk32 with .s8 operands: N = 8, 16, 24, then multiples
# of 16 up to 256 (PTX ISA).
WGMMA_S8_N = {8, 16, 24} | set(range(32, 257, 16))
SMEM_PER_BLOCK = 232_448

# The served convs at full width, B=64: (site, [B,H,W,Cin], Cout, kernel,
# stride, padding) -- the shapes of the per-shape table in PERF.md.
FULL_WIDTH = [
    ("Conv2d_1a s2d", (64, 150, 150, 12), 32, (2, 2), 1, "VALID"),
    ("Conv2d_2a", (64, 149, 149, 32), 32, (3, 3), 1, "VALID"),
    ("Conv2d_2b", (64, 147, 147, 32), 64, (3, 3), 1, "SAME"),
    ("Conv2d_3b", (64, 73, 73, 64), 80, (1, 1), 1, "VALID"),
    ("Mixed_5b packed", (64, 35, 35, 192), 208, (1, 1), 1, "VALID"),
    ("Mixed_5b 5x5", (64, 35, 35, 48), 64, (5, 5), 1, "SAME"),
    ("Mixed_6a 3x3/2", (64, 35, 35, 288), 384, (3, 3), 2, "VALID"),
    ("Mixed_6b 1x7", (64, 17, 17, 128), 128, (1, 7), 1, "SAME"),
    ("Mixed_6b 7x1", (64, 17, 17, 128), 192, (7, 1), 1, "SAME"),
    ("Mixed_7a packed", (64, 17, 17, 768), 384, (1, 1), 1, "VALID"),
    ("Mixed_7b 1x3", (64, 8, 8, 384), 384, (1, 3), 1, "SAME"),
    ("Mixed_7b 3x1", (64, 8, 8, 384), 384, (3, 1), 1, "SAME"),
    ("Mixed_7c packed", (64, 8, 8, 2048), 1344, (1, 1), 1, "VALID"),
    ("Mixed_7c 1x3", (64, 8, 8, 384), 384, (1, 3), 1, "SAME"),
    ("Mixed_7c 3x1", (64, 8, 8, 384), 384, (3, 1), 1, "SAME"),
    ("K1 at Conv2d_2a", (64, 149, 149, 32), 32, (3, 3), 1, "VALID"),
    ("K1 at Conv2d_4a", (64, 73, 73, 80), 192, (3, 3), 1, "VALID"),
]


def _check_pick(m, cout, k, load_bytes):
    tile = ic.pick_tile(m, cout, k, load_bytes)
    if load_bytes == 1:
        assert tile == ic.TileConfig(1, 64, 64)
        return tile
    assert tile.load_bytes == load_bytes
    assert (tile.bm, tile.bn) in ic.CONFIGS[load_bytes]
    assert tile.bn in WGMMA_S8_N and tile.bm in (64, 128)
    assert -(-cout // tile.bn) * tile.bn >= cout
    assert ic._smem_bytes(tile.bm, tile.bn) <= SMEM_PER_BLOCK
    most = max(ic.TileConfig(load_bytes, bm, bn).tiles(m, cout)
               for bm, bn in ic.CONFIGS[load_bytes])
    assert tile.tiles(m, cout) >= ic.SMS or tile.tiles(m, cout) == most
    return tile


@pytest.mark.parametrize("site,shape,cout,kernel,stride,padding", FULL_WIDTH,
                         ids=[s[0] for s in FULL_WIDTH])
def test_tile_rule_at_the_full_width_shapes(site, shape, cout, kernel, stride, padding):
    B, H, W, cin = shape
    ph, pw = ic.conv_padding(kernel, (stride, stride), padding)
    ho = (H + 2 * ph - kernel[0]) // stride + 1
    wo = (W + 2 * pw - kernel[1]) // stride + 1
    load_bytes = 16 if cin % 16 == 0 else 4
    tile = _check_pick(B * ho * wo, cout, kernel[0] * kernel[1] * cin, load_bytes)
    # Every one of these convs has enough pixels for a full wave.
    assert tile.tiles(B * ho * wo, cout) >= ic.SMS, site


@pytest.fixture(scope="module")
def engine_convs():
    """Every conv_int8 call of one forward of a depth-0.25 engine (both
    fronts), with its operands, recorded through the engine's wrapper."""
    state = init_state(InceptionV3(num_classes=15, depth_multiplier=0.25,
                                   create_aux_logits=True, image_size=139, device="meta"),
                       seed=7)
    raw = torch.from_numpy(
        np.random.RandomState(8).randint(0, 256, (2, 160, 200, 3), dtype=np.uint8))
    calib = preprocess_for_eval(raw, 139, 139)
    calls = {}
    for front, stem_s2d, x in (("s2d", "pre", preprocess_for_eval_s2d(raw, 139, 139)),
                               ("float", False, calib)):
        eng = tq.QuantizedInceptionV3(state, calib, stem_s2d=stem_s2d, device="cpu")
        ops = eng.int8_ops()
        log = []
        conv = ops._conv

        def recorded(x, w, epi, strides=(1, 1), pad=(0, 0), outs=None, _conv=conv, _log=log):
            _log.append((x, w, tuple(strides), tuple(pad)))
            return _conv(x, w, epi, strides, pad, outs)

        ops._conv = recorded
        with torch.inference_mode():
            eng(x)
        calls[front] = log
    return calls


@pytest.mark.parametrize("front", ["s2d", "float"])
def test_tile_rule_on_the_engines_convs(engine_convs, front):
    calls = engine_convs[front]
    assert len(calls) == 66
    for x, w, strides, pad in calls:
        tile = ic.conv_config(x, w, strides, pad)
        cout, kh, kw, cin = w.shape
        ho, wo = ic._out_hw(x, w, strides, pad)
        _check_pick(x.shape[0] * ho * wo, cout, kh * kw * cin, tile.load_bytes)
        assert tile == ic.pick_tile(x.shape[0] * ho * wo, cout, kh * kw * cin,
                                    ic.load_bytes(x, w))
    # Only the float front's Cin 3 stem takes the byte-load kernel.
    byte_convs = [w.shape for x, w, s, p in calls if ic.conv_config(x, w, s, p).load_bytes == 1]
    assert byte_convs == ([] if front == "s2d" else [calls[0][1].shape])
    assert calls[0][1].shape[-1] == (12 if front == "s2d" else 3)


def test_load_bytes_follow_channels_stride_and_pointers():
    w16 = torch.zeros(8, 1, 1, 32, dtype=torch.int8)
    assert ic.load_bytes(torch.zeros(1, 4, 4, 32, dtype=torch.int8), w16) == 16
    assert ic.load_bytes(torch.zeros(1, 4, 4, 12, dtype=torch.int8),
                         torch.zeros(8, 2, 2, 12, dtype=torch.int8)) == 4
    assert ic.load_bytes(torch.zeros(1, 4, 4, 3, dtype=torch.int8),
                         torch.zeros(8, 3, 3, 3, dtype=torch.int8)) == 1
    # A channel slice 4 bytes into its buffer: 4-byte copies only.
    big = torch.zeros(1, 4, 4, 48, dtype=torch.int8)
    assert ic.load_bytes(big[..., 4:36], w16) == 4


def test_tiles_are_the_kernels_instantiations():
    """CONFIGS names exactly the (copy width, BM, BN) the CUDA source
    instantiates, and the smem model matches the source's formula."""
    src = (_build.CSRC / "int8_conv.cu").read_text()
    block = src[src.index("#define WGMMA_CONFIGS(X)"):]
    block = block[:block.index("\n\n")]
    got = {(int(g), int(bm), int(bn))
           for g, bm, bn in re.findall(r"X\((\d+), (\d+), (\d+)\)", block)}
    want = {(g, bm, bn) for g, tiles in ic.CONFIGS.items() for bm, bn in tiles}
    assert got == want
    assert "STAGES * (BM + BN) * BK + BM * BN * 4 + 64 + 16 * BN + 16 * BN + 128 + 256 + 64 +" \
        in src
    assert ic._smem_bytes(64, 32) == 3 * 96 * 128 + 64 * 32 * 4 + 64 + 32 * 32 + 1472


def test_pick_is_the_cheapest_tile_of_a_full_wave():
    """Among tiles that give at least one tile per SM the pick has the least
    modelled cost; with none (a tiny conv), the pick gives the most tiles."""
    m, cout, k = 64 * 35 * 35, 96, 576
    tile = ic.pick_tile(m, cout, k, 16)
    full = [ic.TileConfig(16, bm, bn) for bm, bn in ic.CONFIGS[16]
            if ic.TileConfig(16, bm, bn).tiles(m, cout) >= ic.SMS]
    assert tile in full
    assert ic._tile_cost(m, cout, k, tile.bm, tile.bn) == min(
        ic._tile_cost(m, cout, k, t.bm, t.bn) for t in full)
    small = ic.pick_tile(2 * 3 * 3, 40, 360, 16)
    assert small.tiles(18, 40) == max(ic.TileConfig(16, bm, bn).tiles(18, 40)
                                        for bm, bn in ic.CONFIGS[16])


def _shift_epilogue(cout, rng):
    return ic.Epilogue.build([("shift", cout, rng.randint(0, 3000, cout),
                               rng.randint(4, 10, cout))], "cpu")


def test_conv_int8_plans_once_per_geometry():
    """The wrapper decides the tile once per operand geometry and keeps it
    on the epilogue (an engine builds one per conv site): a second call of
    the same geometry adds no plan, a channel slice at another alignment
    gets its own with its own copy width, and the CPU result is the plain
    version's."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randint(-50, 50, (40, 3, 3, 32)).astype(np.int8))
    epi = _shift_epilogue(40, rng)
    big = torch.from_numpy(rng.randint(-50, 50, (2, 9, 9, 48)).astype(np.int8))
    x = big[..., :32]
    (got,) = ic.conv_int8(x, w, epi, (1, 1), (1, 1))
    ic.conv_int8(x, w, epi, (1, 1), (1, 1))
    assert len(epi.plans) == 1
    (plan,) = epi.plans.values()
    assert plan.cfg == ic.conv_config(x, w, (1, 1), (1, 1)) and plan.cfg.load_bytes == 16
    assert plan.out_shapes == ((2, 9, 9, 40),) and plan.x_stride == 48 and not plan.copy
    ic.conv_int8(big[..., 4:36], w, epi, (1, 1), (1, 1))
    assert [p.cfg.load_bytes for p in epi.plans.values()] == [16, 4]
    assert torch.equal(got, ic.conv_int8_plain(x, w, epi, (1, 1), (1, 1))[0])


def test_forced_tiles_are_checked():
    """``_launch`` (the card tests' and tile_sweep's way to run a given
    tile) refuses a tile the kernel does not have for the operands."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randint(0, 10, (1, 9, 9, 20)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-5, 5, (40, 1, 1, 20)).astype(np.int8))
    epi = _shift_epilogue(40, rng)
    with pytest.raises(ValueError):     # 16-byte copies of Cin 20
        ic._launch(ic.TileConfig(16, 128, 64), x, w, epi)
    with pytest.raises(ValueError):     # not an instantiated width
        ic._launch(ic.TileConfig(4, 128, 48), x, w, epi)
    (got,) = ic._launch(ic.TileConfig(4, 64, 32), x, w, epi)
    assert torch.equal(got, ic.conv_int8_plain(x, w, epi)[0])
