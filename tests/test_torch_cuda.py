"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests skip without an NVIDIA card.
On one:  python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops import fused_inception as fi
from tumblr_emotions_torch.ops import int8_conv as ic
from tumblr_emotions_torch.ops import int8_pool as ip
from tumblr_emotions_torch.ops.inference import FusedInceptionV3

pytestmark = pytest.mark.cuda

TOL = 2.0 ** -6  # max|kernel - plain| / max|plain| in bf16, as chip_smoke.py


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def taps(dev):
    # depth 0.5 keeps every block width a multiple of 8, as the kernel needs.
    state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=0)
    return FusedInceptionV3(state, device=dev).taps


def _act(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.relu(torch.randn(*shape, generator=g, device=dev)).to(torch.bfloat16)


def _close(got, want):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() <= TOL, err.item()


@pytest.mark.parametrize("name,kernel,hw", [
    ("Mixed_5b/Branch_0/Conv2d_0a_1x1", (1, 1), 35),
    ("Mixed_5b/Branch_1/Conv2d_0b_5x5", (5, 5), 35),
    ("Mixed_5b/Branch_2/Conv2d_0c_3x3", (3, 3), 35),
    ("Mixed_6c/Branch_2/Conv2d_0b_7x1", (7, 1), 17),
    ("Mixed_6c/Branch_2/Conv2d_0c_1x7", (1, 7), 17),
])
def test_conv_kernel_matches_plain(dev, taps, name, kernel, hw):
    w, b = taps[name]
    x = _act(dev, 3, hw, hw, w.shape[1])
    before = fi.conv_same_bias_relu.launches
    _close(fi.conv_same_bias_relu(x, w, b, kernel), fi.conv_same_bias_relu_plain(x, w, b, kernel))
    assert fi.conv_same_bias_relu.launches == before + 1


def test_conv_kernel_writes_a_channel_slice(dev, taps):
    w, b = taps["Mixed_5b/Branch_2/Conv2d_0b_3x3"]
    x = _act(dev, 2, 35, 35, 8 + w.shape[1] + 8)[..., 8:8 + w.shape[1]]
    out = torch.zeros(2, 35, 35, 16 + w.shape[2], dtype=torch.bfloat16, device=dev)
    fi.conv_same_bias_relu(x, w, b, (3, 3), out=out[..., 8:8 + w.shape[2]])
    _close(out[..., 8:8 + w.shape[2]], fi.conv_same_bias_relu_plain(x, w, b, (3, 3)))
    assert out[..., :8].abs().max().item() == 0 and out[..., -8:].abs().max().item() == 0


def test_conv_kernel_rejects_what_it_does_not_take(dev, taps):
    w, b = taps["Mixed_5b/Branch_0/Conv2d_0a_1x1"]
    x = _act(dev, 1, 35, 35, w.shape[1])
    with pytest.raises(ValueError):
        fi.conv_same_bias_relu(x.float(), w, b, (1, 1))     # f32 input
    with pytest.raises(ValueError):
        fi.conv_same_bias_relu(x[..., :-4], w[:, :-4].contiguous(), b, (1, 1))  # Cin % 8


# The bf16 engine's cuDNN-side convs round once on the card too: f32 (TF32
# allowed) on the bf16 values, bias, ReLU, one rounding.  Held against an f64
# conv of the same values plus the bias, rounded to bf16 once: no element
# more than one bf16 ulp off beyond what any f32 summation order may add
# (K * 2^-24 * sum|x*w| for K products; it matters only where the sum nearly
# cancels), and at most this share of the elements not bit-equal, the bound
# tests/test_torch_serving.py holds the CPU path to (double rounding gave
# 11-14% there).
ROUNDING_SHARE_MAX = 0.01


def _bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("which", ["stem", "packed"])
def test_bf16_convs_round_once_on_the_card(dev, which):
    state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=0)
    eng = FusedInceptionV3(state, use_kernels=False, device=dev)
    if which == "stem":
        scopes = ["Conv2d_2b_3x3"]
    else:
        scopes = [f"Mixed_5b/{b}" for b in ("Branch_0/Conv2d_0a_1x1", "Branch_1/Conv2d_0a_1x1",
                                            "Branch_2/Conv2d_0a_1x1", "Branch_3/Conv2d_0b_1x1")]
    cin = eng.w[scopes[0]][0].shape[1]
    x = _act(dev, 4, 35, 35, cin, seed=2)
    if which == "stem":
        got = [eng._conv(x, scopes[0], padding="SAME")]
    else:
        got = [torch.relu(p).to(torch.bfloat16) for p in eng._packed_conv1x1(x, scopes)]
    x64 = x.permute(0, 3, 1, 2).double()
    want, slack = [], []
    for s in scopes:
        w, b = eng.w[s]
        pad = (w.shape[2] // 2, w.shape[3] // 2)
        conv = torch.nn.functional.conv2d
        y = conv(x64, w.double(), padding=pad).permute(0, 2, 3, 1) + b.double()
        mag = conv(x64.abs(), w.double().abs(), padding=pad).permute(0, 2, 3, 1) + b.double().abs()
        want.append(torch.relu(y).to(torch.bfloat16))
        slack.append(w[0].numel() * 2.0 ** -24 * mag)
    got = torch.cat([g.double().flatten() for g in got])
    want = torch.cat([v.double().flatten() for v in want])
    slack = torch.cat([v.flatten() for v in slack])
    assert torch.isfinite(got).all() and got.shape == want.shape
    off = ((got - want).abs() - slack).clamp_min(0)
    assert (off <= _bf16_ulp(torch.maximum(got.abs(), want.abs()))).all()
    assert (got != want).double().mean().item() <= ROUNDING_SHARE_MAX


@pytest.mark.parametrize("scope", ["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6b", "Mixed_6c",
                                   "Mixed_6e"])
def test_block_kernels_match_plain(dev, taps, scope):
    cin = taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1]
    hw = 35 if scope.startswith("Mixed_5") else 17
    x = _act(dev, 2, hw, hw, cin, seed=1)
    before = (fi.conv_same_bias_relu.launches, fi.conv_same_bias_relu.pooled_launches)
    if scope.startswith("Mixed_5"):
        q = scope == "Mixed_5c"
        got, want = fi.fused_inception_a(x, taps, scope, q), fi.fused_inception_a_plain(x, taps, scope, q)
    else:
        got, want = fi.fused_inception_b(x, taps, scope), fi.fused_inception_b_plain(x, taps, scope)
    _close(got, want)
    n = 5 if scope.startswith("Mixed_5") else 8
    assert (fi.conv_same_bias_relu.launches - before[0],
            fi.conv_same_bias_relu.pooled_launches - before[1]) == (n, 1)


# ---------------------------------------------------------------------------
# The block conv's forms and tiles (csrc/inception_blocks.cu)
# ---------------------------------------------------------------------------


def _op(dev, cin, widths, kernel, pooled=False, seed=0):
    """A ConvOp over random weights: one tap stack per segment width."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kh, kw = kernel
    parts = [((torch.randn(kh * kw, cin, n, generator=g, device=dev) / (kh * kw * cin) ** 0.5)
              .to(torch.bfloat16), torch.randn(n, generator=g, device=dev) * 0.1)
             for n in widths]
    return fi.ConvOp(parts, kernel, pooled)


def _same_outs(got, op, x):
    want = fi.conv_segments_plain(x, op, [torch.empty_like(g) for g in got])
    for g, w in zip(got, want):
        _close(g, w)


_BF16_TILES = [fi.TileConfig(bm, bn, p) for p, tiles in sorted(fi.CONFIGS.items())
               for bm, bn in tiles]


@pytest.mark.parametrize("tile", _BF16_TILES, ids=lambda t: t.name.replace(" ", "-"))
def test_block_conv_every_tile_ragged(dev, tile):
    """Every tile the rule can pick, forced, on ragged edges: M = 3*13*11
    not a multiple of BM, Cout = BN + 40 (a partial channel tile), K not a
    multiple of 64, a channel-slice input, four segments, two of them into
    channel slices of two different tensors."""
    cin = 40 if tile.pooled else 48                # K = 40 or 432
    kernel = (1, 1) if tile.pooled else (3, 3)
    cout = tile.bn + 40
    widths = (16, cout - 48, 24, 8)
    op = _op(dev, cin, widths, kernel, tile.pooled, seed=tile.bm + tile.bn)
    x = _act(dev, 3, 13, 11, 16 + cin + 8, seed=3)[..., 16:16 + cin]
    buf0 = torch.zeros(3, 13, 11, widths[0] + 32, dtype=torch.bfloat16, device=dev)
    buf1 = torch.zeros(3, 13, 11, widths[1] + 24, dtype=torch.bfloat16, device=dev)
    outs = fi._run(op, x, [buf0[..., 16:16 + widths[0]], buf1[..., 8:8 + widths[1]], None, None],
                   tile)
    _same_outs(outs, op, x)
    assert buf0[..., :16].abs().max().item() == 0 and buf0[..., -16:].abs().max().item() == 0
    assert buf1[..., :8].abs().max().item() == 0 and buf1[..., -16:].abs().max().item() == 0


@pytest.mark.parametrize("cin,kernel", [(48, (5, 5)), (96, (3, 3)), (160, (1, 7)),
                                        (288, (1, 1))])
def test_block_conv_partial_k_steps(dev, cin, kernel):
    """Cin not a multiple of 64: K steps that span two taps."""
    op = _op(dev, cin, (96,), kernel, seed=cin)
    x = _act(dev, 2, 17, 17, cin, seed=4)
    _same_outs(op(x), op, x)


@pytest.mark.parametrize("kernel", [(1, 7), (7, 1), (3, 3), (5, 5)])
def test_block_conv_at_image_corners(dev, kernel):
    """Images smaller than the kernel's reach: every pixel near a corner."""
    op = _op(dev, 64, (64,), kernel, seed=sum(kernel))
    x = _act(dev, 5, 4, 6, 64, seed=5)
    _same_outs(op(x), op, x)


def test_block_conv_packed_segments_into_two_tensors(dev):
    """The packed 1x1: three segments, the first into a channel slice of
    one tensor, the others into slices of another, as a block writes its
    Branch_0 output and its intermediates."""
    op = _op(dev, 192, (64, 48, 64), (1, 1), seed=6)
    x = _act(dev, 2, 35, 35, 192, seed=6)
    out = torch.zeros(2, 35, 35, 256, dtype=torch.bfloat16, device=dev)
    tmp = torch.zeros(2, 35, 35, 48 + 64, dtype=torch.bfloat16, device=dev)
    before = fi.conv_same_bias_relu.launches
    got = op(x, [out[..., :64], tmp[..., :48], tmp[..., 48:]])
    assert fi.conv_same_bias_relu.launches == before + 1
    _same_outs(got, op, x)
    assert out[..., 64:].abs().max().item() == 0


@pytest.mark.parametrize("hw,cin,cout", [(35, 288, 64), (17, 768, 192)])
def test_pooled_form_matches_plain(dev, hw, cin, cout):
    op = _op(dev, cin, (cout,), (1, 1), pooled=True, seed=hw)
    x = _act(dev, 4, hw, hw, cin, seed=7)
    before = fi.conv_same_bias_relu.pooled_launches
    got = op(x)
    assert fi.conv_same_bias_relu.pooled_launches == before + 1
    _close(got[0], fi.conv_same_bias_relu_plain(fi.avg_pool3_same_plain(x),
                                                op.w.reshape(cout, 1, cin).permute(1, 2, 0),
                                                op.bias, (1, 1)))


def test_pooled_form_rounds_as_the_reference(dev):
    """Through an identity 1x1 the pooled form returns its A operand: the
    f32 sum of the in-image taps in the TPU kernel's order (dy, then dx),
    divided by their count, rounded to bf16, bit for bit."""
    c = 64
    x = _act(dev, 2, 7, 9, c, seed=8) + 0.01
    eye = torch.eye(c, device=dev).to(torch.bfloat16).reshape(1, c, c)
    (got,) = fi.ConvOp([(eye, torch.zeros(c, device=dev))], (1, 1), pooled=True)(x)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    ones = torch.nn.functional.pad(torch.ones(2, 7, 9, 1, device=dev), (0, 0, 1, 1, 1, 1))
    s, n = torch.zeros(2, 7, 9, c, device=dev), torch.zeros(2, 7, 9, 1, device=dev)
    for dy in range(3):
        for dx in range(3):
            s = s + xp[:, dy:dy + 7, dx:dx + 9]
            n = n + ones[:, dy:dy + 7, dx:dx + 9]
    torch.cuda.synchronize()
    assert torch.equal(got, (s / n).to(torch.bfloat16))


def test_block_conv_refuses_what_it_does_not_take(dev):
    op = _op(dev, 32, (32,), (3, 3))
    x = _act(dev, 1, 9, 9, 48)
    with pytest.raises(ValueError):                   # f32 input
        op(x[..., :32].float())
    with pytest.raises(ValueError):                   # 8-byte aligned slice
        op(x[..., 4:36])
    with pytest.raises(ValueError):                   # a pixel stride not a multiple of 8
        op(_act(dev, 1, 9, 9, 36)[..., :32])
    with pytest.raises(ValueError):                   # output of the wrong dtype
        op(x[..., :32], [torch.empty(1, 9, 9, 32, device=dev)])
    with pytest.raises(ValueError):                   # a pooled 3x3
        _op(dev, 32, (32,), (3, 3), pooled=True)
    with pytest.raises(ValueError):                   # a tile of the other form
        fi._run(op, x[..., :32], None, fi.TileConfig(64, 32, pooled=True))


# ---------------------------------------------------------------------------
# The int8 engine's kernels: conv_int8 (K1, widened) and the int8 max pool
# (K4a/K4b).  Both must equal their plain versions bit for bit.
# ---------------------------------------------------------------------------


def _i8(dev, shape, lo, hi, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int8)


def _segment(kind, n, rng):
    if kind == "shift":
        return (kind, n, rng.randint(-3000, 6000, n), rng.randint(4, 13, n))
    if kind in ("f32", "dequant"):
        return (kind, n, rng.uniform(1e-4, 2e-2, n), rng.uniform(-4, 4, n))
    return (kind, n, None, None)


def _graph_int8(program):
    """(conv_int8 nodes, maxpool3x3s2_int8 nodes, replays) of each CUDA
    graph of a captured program, the nodes read from the graph by kernel
    name."""
    return [(sum(n for k, n in g["kernels"].items() if "conv_int8_" in k),
             sum(n for k, n in g["kernels"].items() if "maxpool_" in k), g["replays"])
            for g in program.kernel_nodes()]


def _same(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:     # one bf16 ulp at most
        g, w = got.float(), want.float()
        assert ((g - w).abs() <= w.abs() * 2.0 ** -8).all()
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kernel,strides,padding,cin,cout,hw", [
    ((1, 1), (1, 1), "SAME", 64, 48, 35),
    ((3, 3), (1, 1), "SAME", 32, 64, 37),
    ((3, 3), (1, 1), "VALID", 80, 192, 25),
    ((5, 5), (1, 1), "SAME", 48, 64, 35),
    ((1, 3), (1, 1), "SAME", 384, 384, 8),
    ((3, 1), (1, 1), "SAME", 448, 384, 8),
    ((1, 7), (1, 1), "SAME", 128, 128, 17),
    ((7, 1), (1, 1), "SAME", 160, 192, 17),
    ((3, 3), (2, 2), "VALID", 288, 384, 35),
    ((2, 2), (1, 1), "VALID", 12, 32, 150),     # the space-to-depth stem
    ((3, 3), (2, 2), "VALID", 3, 32, 299),      # the stem on the float front
    ((3, 3), (1, 1), "SAME", 40, 20, 19),       # Cin % 16 != 0, Cout % 8 != 0
])
def test_conv_int8_matches_plain(dev, kernel, strides, padding, cin, cout, hw):
    rng = np.random.RandomState(cin + cout)
    x = _i8(dev, (2, hw, hw, cin), 0, 40, seed=1)
    w = _i8(dev, (cout, *kernel, cin), -60, 61, seed=2)
    epi = ic.Epilogue.build([_segment("shift", cout, rng)], dev)
    pad = ic.conv_padding(kernel, strides, padding)
    before, bytes_before = ic.conv_int8.launches, ic.conv_int8.byte_launches
    (got,) = ic.conv_int8(x, w, epi, strides, pad)
    (want,) = ic.conv_int8_plain(x, w, epi, strides, pad)
    _same(got, want)
    assert ic.conv_int8.launches == before + 1
    # Only an input that is not 4-byte aligned (the Cin 3 stem) takes the
    # byte-load kernel.
    assert ic.conv_int8.byte_launches - bytes_before == (cin % 4 != 0)


_TILES = [ic.TileConfig(g, bm, bn) for g, tiles in sorted(ic.CONFIGS.items())
          for bm, bn in tiles] + [ic.TileConfig(1, 64, 64)]


@pytest.mark.parametrize("tile", _TILES, ids=lambda t: t.name.replace(" ", "-"))
def test_conv_int8_every_tile_ragged(dev, tile):
    """Every kernel and tile the rule can pick, forced, on ragged edges: M
    not a multiple of BM, Cout not a multiple of BN, K not a multiple of
    128 (nor of 32), a channel-slice input, outputs whose pixel stride is
    not their width (one not a multiple of 16 bytes), four segments of
    mixed kinds."""
    rng = np.random.RandomState(tile.bm + tile.bn + tile.load_bytes)
    cin = 20 if tile.load_bytes == 4 else 48      # K = 180 or 432
    big = _i8(dev, (3, 13, 11, 16 + cin + 16), -30, 90, seed=11)
    x = big[..., 16:16 + cin]                     # M = 3 * 13 * 11 = 429
    cout = tile.bn + 40
    widths = [16, cout - 48, 24, 8]
    w = _i8(dev, (cout, 3, 3, cin), -90, 91, seed=12)
    epi = ic.Epilogue.build([_segment(k, n, rng) for k, n in
                             zip(("shift", "f32", "dequant", "pre"), widths)], dev)
    buf0 = torch.zeros(3, 13, 11, widths[0] + 32, dtype=torch.int8, device=dev)
    buf1 = torch.zeros(3, 13, 11, widths[1] + 5, dtype=torch.int8, device=dev)
    outs = ic._launch(tile, x, w, epi, (1, 1), (1, 1),
                      outs=[buf0[..., 16:16 + widths[0]], buf1[..., 3:3 + widths[1]], None, None])
    want = ic.conv_int8_plain(x, w, epi, (1, 1), (1, 1))
    for g, wt in zip(outs, want):
        _same(g, wt)
    assert buf0[..., :16].abs().max().item() == 0 and buf0[..., -16:].abs().max().item() == 0
    assert buf1[..., :3].abs().max().item() == 0 and buf1[..., -2:].abs().max().item() == 0


@pytest.mark.parametrize("widths", [(13, 20, 7, 24), (30, 34)], ids=["odd", "even"])
def test_conv_int8_mixed_tiles(dev, widths):
    """Segments that share a tile: bounds odd (converted element by element)
    and even (pair by pair), on every tile width of 16-byte copies."""
    rng = np.random.RandomState(sum(widths))
    x = _i8(dev, (2, 9, 11, 64), -40, 80, seed=15)
    w = _i8(dev, (sum(widths), 3, 3, 64), -90, 91, seed=16)
    kinds = ("shift", "f32", "dequant", "pre")[:len(widths)]
    epi = ic.Epilogue.build([_segment(k, n, rng) for k, n in zip(kinds, widths)], dev)
    want = ic.conv_int8_plain(x, w, epi, (1, 1), (1, 1))
    for bm, bn in ic.CONFIGS[16]:
        got = ic._launch(ic.TileConfig(16, bm, bn), x, w, epi, (1, 1), (1, 1))
        for g, wt in zip(got, want):
            _same(g, wt)


def test_conv_int8_takes_a_permuted_stem_input(dev):
    """The float front's stem input is a permuted view (channels not
    contiguous in NHWC pixels): the wrapper copies it and takes the
    byte-load kernel for its 3 channels."""
    rng = np.random.RandomState(4)
    x = _i8(dev, (2, 3, 41, 37), -50, 50, seed=13).permute(0, 2, 3, 1)
    w = _i8(dev, (32, 3, 3, 3), -60, 61, seed=14)
    epi = ic.Epilogue.build([_segment("shift", 32, rng)], dev)
    before = ic.conv_int8.byte_launches
    (got,) = ic.conv_int8(x, w, epi, (2, 2), (0, 0))
    _same(got, ic.conv_int8_plain(x, w, epi, (2, 2), (0, 0))[0])
    assert ic.conv_int8.byte_launches == before + 1


def test_conv_int8_rejects_a_tile_it_does_not_have(dev):
    rng = np.random.RandomState(2)
    x = _i8(dev, (1, 9, 9, 20), 0, 10)
    w = _i8(dev, (40, 1, 1, 20), -5, 5)
    epi = ic.Epilogue.build([_segment("shift", 40, rng)], dev)
    with pytest.raises(ValueError):     # 16-byte copies of Cin 20
        ic._launch(ic.TileConfig(16, 128, 64), x, w, epi)
    with pytest.raises(ValueError):     # not an instantiated width
        ic._launch(ic.TileConfig(4, 128, 48), x, w, epi)


@pytest.mark.parametrize("kind", ["shift", "f32", "dequant", "pre"])
def test_conv_int8_epilogue_kinds(dev, kind):
    rng = np.random.RandomState(3)
    x = _i8(dev, (2, 17, 17, 96), -20, 60, seed=3)
    w = _i8(dev, (72, 3, 3, 96), -127, 128, seed=4)
    epi = ic.Epilogue.build([_segment(kind, 72, rng)], dev)
    (got,) = ic.conv_int8(x, w, epi, (1, 1), (1, 1))
    (want,) = ic.conv_int8_plain(x, w, epi, (1, 1), (1, 1))
    _same(got, want)


def test_conv_int8_packed_segments_into_slices(dev):
    """A packed 1x1 with four kinds; segment 0 writes into a channel slice
    of a larger buffer and reads a channel slice of its input."""
    rng = np.random.RandomState(5)
    big = _i8(dev, (2, 35, 35, 16 + 288 + 16), 0, 50, seed=5)
    x = big[..., 16:16 + 288]
    widths = [64, 48, 64, 32]
    w = _i8(dev, (sum(widths), 1, 1, 288), -80, 81, seed=6)
    epi = ic.Epilogue.build([_segment(k, n, rng) for k, n in
                             zip(("shift", "f32", "dequant", "pre"), widths)], dev)
    buf = torch.zeros(2, 35, 35, 256, dtype=torch.int8, device=dev)
    outs = ic.conv_int8(x, w, epi, outs=[buf[..., 32:96], None, None, None])
    want = ic.conv_int8_plain(x, w, epi)
    for g, wt in zip(outs, want):
        _same(g, wt)
    assert buf[..., :32].abs().max().item() == 0 and buf[..., 96:].abs().max().item() == 0


def test_valid_conv3x3_int8_shift_matches_plain(dev):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(-127, 128, (2, 19, 17, 16)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (3, 3, 16, 32)).astype(np.int8))
    b = rng.randint(0, 5000, 32).astype(np.int32)
    k = rng.randint(6, 12, 32).astype(np.int32)
    got = ic.valid_conv3x3_int8_shift(x.to(dev), w, b, k)
    want = ic.valid_conv3x3_int8_shift(x, w, b, k)      # CPU: the plain version
    assert torch.equal(got.cpu(), want)


def test_conv_int8_rejects_what_it_does_not_take(dev):
    rng = np.random.RandomState(1)
    x = _i8(dev, (1, 9, 9, 32), 0, 10)
    w = _i8(dev, (40, 1, 1, 32), -5, 5)
    with pytest.raises(ValueError):     # five segments
        ic.conv_int8(x, w, ic.Epilogue.build([_segment("shift", 8, rng)] * 5, dev))
    epi = ic.Epilogue.build([_segment("shift", 40, rng)], dev)
    with pytest.raises(ValueError):     # float input
        ic.conv_int8(x.float(), w, epi)
    with pytest.raises(ValueError):     # output of the wrong dtype
        ic.conv_int8(x, w, epi, outs=[torch.empty(1, 9, 9, 40, device=dev)])
    with pytest.raises(ValueError):     # non-contiguous weights
        ic.conv_int8(x, w.permute(3, 1, 2, 0).contiguous().permute(3, 1, 2, 0), epi)


@pytest.mark.parametrize("shape,rescale", [
    ((2, 147, 147, 32), None), ((2, 147, 147, 64), None), ((2, 35, 35, 288), 0.7731),
    ((2, 17, 17, 768), 1.37), ((2, 15, 13, 20), 0.9)])
def test_maxpool_int8_matches_plain(dev, shape, rescale):
    x = _i8(dev, shape, -128, 128, seed=7)
    before = ip.maxpool3x3s2_int8.launches
    _same(ip.maxpool3x3s2_int8(x, rescale), ip.maxpool3x3s2_int8_plain(x, rescale))
    assert ip.maxpool3x3s2_int8.launches == before + 1


def test_maxpool_int8_writes_a_channel_slice(dev):
    x = _i8(dev, (2, 35, 35, 288), 0, 128, seed=8)
    buf = torch.zeros(2, 17, 17, 32 + 288, dtype=torch.int8, device=dev)
    ip.maxpool3x3s2_int8(x, 0.5, out=buf[..., 32:])
    _same(buf[..., 32:], ip.maxpool3x3s2_int8_plain(x, 0.5))
    assert buf[..., :32].abs().max().item() == 0
    with pytest.raises(ValueError):
        ip.maxpool3x3s2_int8(x.float())


@pytest.fixture(scope="module")
def int8_engines(dev):
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3

    state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=0)
    raw = _i8(dev, (4, 347, 347, 3), 0, 127, seed=9).to(torch.uint8) * 2
    calib = preprocess_for_eval(raw)
    kern = QuantizedInceptionV3(state, calib, stem_s2d="pre", device=dev)
    plain = QuantizedInceptionV3(state, calib, stem_s2d="pre", use_kernels=False,
                                 device=dev)
    plain.scales = kern.scales
    return kern, plain, raw


def test_int8_engine_kernels_match_plain(dev, int8_engines):
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval_s2d
    from tumblr_emotions_torch.ops import quant

    kern, plain, raw = int8_engines
    x = preprocess_for_eval_s2d(raw)
    for stop in ("stem", "Mixed_5d", "Mixed_6a", "Mixed_6e", "Mixed_7a"):
        with torch.inference_mode():
            got = quant._tower(kern.int8_ops(), x, stop_at=stop)
            want = quant._tower(plain.int8_ops(), x, stop_at=stop)
        _same(got[0], want[0])
        assert got[1] == want[1]
    c0, p0 = ic.conv_int8.launches, ip.maxpool3x3s2_int8.launches
    got, _ = kern(x)
    assert (ic.conv_int8.launches - c0, ip.maxpool3x3s2_int8.launches - p0) == (66, 4)
    want, _ = plain(x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The uint8 front (torch._int_mm resize), pool_mode="int8", the joint and
# text programs, on the card against their plain versions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [((4, 347, 347, 3), 299), ((3, 161, 197, 3), 139)],
                         ids=["crop303-to-299", "odd-crop141x173-to-139"])
def test_uint8_front_matches_plain(dev, shape, size):
    """The int8 resize GEMMs by torch._int_mm (K padded to a multiple of 8
    with zero taps) against the float64 products on the CPU: the row-resized
    intermediate and the final int8 equal."""
    from tumblr_emotions_torch.data.preprocessing import central_crop_sizes
    from tumblr_emotions_torch.ops import quant as tq

    g = torch.Generator(device=dev).manual_seed(sum(shape))
    raw = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    oh, ow, ch, cw = central_crop_sizes(shape[1], shape[2], 0.875)
    crop = raw[:, oh:oh + ch, ow:ow + cw]
    rows = tq._resize_rows_int8(crop, size)
    torch.cuda.synchronize()
    assert torch.equal(rows.cpu(), tq._resize_rows_int8(crop.cpu(), size))
    got = tq.preprocess_for_eval_int8(raw, 0.0079, size, size)
    want = tq.preprocess_for_eval_int8(raw.cpu(), 0.0079, size, size)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], size, size, 3) and torch.equal(got.cpu(), want)


def test_int8_pool_mode_matches_plain(dev, int8_engines):
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval, preprocess_for_eval_s2d
    from tumblr_emotions_torch.ops import quant
    from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3

    _, _, raw = int8_engines
    state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=0)
    calib = preprocess_for_eval(raw)
    kern = QuantizedInceptionV3(state, calib, stem_s2d="pre", pool_mode="int8", device=dev)
    plain = QuantizedInceptionV3(state, calib, stem_s2d="pre", pool_mode="int8",
                                 use_kernels=False, device=dev)
    plain.scales = kern.scales
    x = preprocess_for_eval_s2d(raw)
    for stop in ("Mixed_5d", "Mixed_6e", "Mixed_7a"):
        with torch.inference_mode():
            got = quant._tower(kern.int8_ops(), x, stop_at=stop)
            want = quant._tower(plain.int8_ops(), x, stop_at=stop)
        _same(got[0], want[0])
    assert torch.equal(kern(x)[1], plain(x)[1])


def test_joint_runner_matches_plain_engine(dev, int8_engines):
    """build_forward's joint program (int8 tower, s2d front, mean text
    branch, fusion head) on the card: 66 + 4 kernel launches per forward
    (the first call's from Python, a replay's in its graph) and the
    probabilities of the same runner on the plain int8 engine."""
    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3
    from tumblr_emotions_torch.ops.serving import build_forward, joint_server

    _, _, raw = int8_engines
    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.5),
                      text=cfg.text.replace(vocab_size=1000, embed_dim=32))
    state = joint_model.init_state(build_model(cfg, device="meta"), 0)
    calib = preprocess_for_eval(raw)
    runner = build_forward(cfg, state, calib_images=calib, device=dev)
    tok = torch.from_numpy(synthetic_ids(np.random.RandomState(0), raw.shape[0], 50, 1000))
    c0, p0 = ic.conv_int8.launches, ip.maxpool3x3s2_int8.launches
    runner(raw, tok)                           # eager warm-up, then the capture
    assert (ic.conv_int8.launches - c0, ip.maxpool3x3s2_int8.launches - p0) == (66, 4)
    got = runner(raw, tok)                     # a replay: nothing from Python
    assert (ic.conv_int8.launches - c0, ip.maxpool3x3s2_int8.launches - p0) == (66, 4)
    assert _graph_int8(runner.program) == [(66, 4, 1)]
    model = build_model(cfg, device=dev)
    model.load_state_dict(state)
    plain = QuantizedInceptionV3(joint_model.tower_state(state), calib, stem_s2d="pre",
                                 use_kernels=False, device=dev)
    plain.scales = runner.engine.scales
    want = joint_server(plain, model, device=dev)(raw, tok)
    assert got.shape == (raw.shape[0], 15) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-6


def test_sliced_staging_answers_as_one_piece(dev, int8_engines, monkeypatch):
    """The joint int8 runner on a served batch of host numpy (64 images of
    347 px, 23.1 MB: staged in row slices, each sent to the card as soon as
    it is staged) answers bit for bit as the same runner staging each input
    in one piece."""
    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.ops.serving import build_forward
    from tumblr_emotions_torch.utils import compile_opts

    _, _, raw = int8_engines
    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.5),
                      text=cfg.text.replace(vocab_size=1000, embed_dim=32))
    state = joint_model.init_state(build_model(cfg, device="meta"), 0)
    runner = build_forward(cfg, state, calib_images=preprocess_for_eval(raw), device=dev)
    batches = []
    for seed in (1, 2):
        rng = np.random.RandomState(seed)
        batches.append((rng.randint(0, 256, (64, 347, 347, 3)).astype(np.uint8),
                        synthetic_ids(rng, 64, 50, 1000),
                        rng.randint(1, 51, 64).astype(np.int32)))
    assert len(compile_opts._row_slices(batches[0][0])) > 1
    assert len(compile_opts._row_slices(batches[0][1])) == 1
    sliced = [runner(*b).cpu() for b in batches]    # the capture, then a replay
    assert runner.program.split_stages == 2
    monkeypatch.setattr(compile_opts, "_SLICE_BYTES", 1 << 62)
    whole = [runner(*b).cpu() for b in batches]
    assert runner.program.split_stages == 2 and runner.program.replays == 3
    assert not torch.equal(sliced[0], sliced[1])
    for s, w in zip(sliced, whole):
        assert torch.equal(s, w)


def test_rnn_text_model_matches_the_cpu(dev):
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import text_model

    tok = torch.from_numpy(synthetic_ids(np.random.RandomState(1), 16, 50, 5000))
    feats = []
    for where in (dev, "cpu"):
        m = text_model.TextEmotionModel(5000, 64, aggregator="rnn", rnn_hidden=128, device=where)
        m.load_state_dict(text_model.init_state(m, 3))
        with torch.inference_mode():
            feats.append(m.represent(tok.to(where)).cpu())
    assert torch.isfinite(feats[0]).all()
    assert (feats[0] - feats[1]).abs().max() <= 1e-5 * feats[1].abs().max()


# ---------------------------------------------------------------------------
# The HTTP path and the batch-1 Predictor on the card.
# ---------------------------------------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def test_http_path_on_the_card(dev, int8_engines):
    """EmotionHTTPServer over build_forward's joint int8 program on the
    card: every answer is the in-process runner's on the same decoded,
    resized image and caption (to the responses' 5 decimals), each device
    batch replays a graph of 66 conv_int8 and 4 maxpool3x3s2_int8 (nothing
    launched from Python), /healthz says cuda,
    and a corrupt body gets a 400 while its batch is answered."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from tumblr_emotions_torch import EMOTIONS, get_preset
    from tumblr_emotions_torch.data import jpeg
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.data.vocab import build_vocabulary
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.ops.serving import build_forward
    from tumblr_emotions_torch.server import BatchedPredictor, EmotionHTTPServer

    _, _, raw = int8_engines
    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.5),
                      text=cfg.text.replace(vocab_size=300, embed_dim=32))
    state = joint_model.init_state(build_model(cfg, device="meta"), 0)
    runner = build_forward(cfg, state, calib_images=preprocess_for_eval(raw), device=dev)
    captions = ["happy dog day", "sad rain", "so calm", "love love love", "", "excited cat"]
    vocab = build_vocabulary(captions * 2, max_size=300)
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))[:6]
    bodies = [(FIXTURES / n).read_bytes() for n in names]
    pred = BatchedPredictor(runner, batch_size=4, host_size=347, vocab=vocab, max_len=50,
                            max_delay_ms=100.0)
    srv = EmotionHTTPServer(pred, host="127.0.0.1", port=0)
    srv.serve_background()
    base = "http://%s:%d" % srv.server_address[:2]
    results = {}

    def post(i, body, text):
        req = urllib.request.Request(f"{base}/predict", data=body, method="POST",
                                     headers={"X-Text": text})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            results[i] = (e.code, json.loads(e.read()))

    try:
        # the batcher's signature (host images, tokens and lengths): captured here
        runner(np.zeros((4, 347, 347, 3), np.uint8), np.zeros((4, 50), np.int32),
               np.ones(4, np.int32))
        c0, p0 = ic.conv_int8.launches, ip.maxpool3x3s2_int8.launches
        posts = list(zip(bodies, captions)) + [(b"\xff\xd8 corrupt", "happy")]
        threads = [threading.Thread(target=post, args=(i, b, t)) for i, (b, t) in enumerate(posts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.close()
    convs, pools = ic.conv_int8.launches - c0, ip.maxpool3x3s2_int8.launches - p0
    assert health["platform"] == "cuda" and health["devices"] >= 1
    assert stats["batches"] >= 2 and (convs, pools) == (0, 0)
    assert _graph_int8(runner.program) == [(66, 4, stats["batches"])]
    assert results[len(bodies)][0] == 400
    imgs = np.stack([jpeg.resize_bilinear(jpeg.decode(b), 347, 347) for b in bodies])
    tok, lens = vocab.encode_batch(captions, 50)
    want = runner(imgs, tok, lens).cpu().numpy()
    for i in range(len(bodies)):
        status, got = results[i]
        assert status == 200 and got["top"] == EMOTIONS[int(want[i].argmax())]
        assert max(abs(got["probs"][e] - want[i][k]) for k, e in enumerate(EMOTIONS)) <= 1e-5


def test_predictor_on_the_card_matches_the_cpu(dev):
    """The batch-1 Predictor on the card against itself on the CPU: the f32
    joint model (TF32 off) within 1e-5, the bf16 perf image model within
    the bf16 floor of test_torch_serving."""
    from tumblr_emotions_torch import EMOTIONS, get_preset
    from tumblr_emotions_torch.data.vocab import build_vocabulary
    from tumblr_emotions_torch.models import build_model, inception_v3, joint_model
    from tumblr_emotions_torch.train.predict import Predictor

    body = (FIXTURES / "baseline_420_403x301.jpg").read_bytes()
    for preset, tol in (("joint_finetune", 1e-5), ("fused_inference", 2e-3)):
        cfg = get_preset(preset)
        cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.5),
                          text=cfg.text.replace(vocab_size=300, embed_dim=32))
        init = joint_model if cfg.model == "joint" else inception_v3
        state = init.init_state(build_model(cfg, device="meta"), 2)
        vocab = build_vocabulary(["happy dog", "sad cat"] * 2)
        text = "happy dog" if cfg.model == "joint" else None
        got = Predictor(cfg, state, vocab, device=dev).predict(body, text)
        want = Predictor(cfg, state, vocab, device="cpu").predict(body, text)
        assert max(abs(got[e] - want[e]) for e in EMOTIONS) <= tol, preset


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------

# One train step on the card against the same step on the CPU (depth 0.25,
# 139 px with the aux head, vocabulary 300; dropout off; the same distortion
# draws).  The loss is a forward pass with TF32 off on both: within 1e-4
# (TF32 moves it ~1e-3).  The text models update per leaf within 1e-3 of
# the update's own max.  The image models are not steady in f32 (train-mode
# batch norm over 4 images, and over the aux head's 4 values per channel,
# amplifies rounding; see tests/test_torch_train.py), so there the card's
# update's distance to the CPU's, ||(card - init) - (cpu - init)|| / ||cpu -
# init||, is held within 3x the CPU's own floor: the mean distance of its
# update to its updates from weights moved by 1e-6 of themselves and each
# image's brightness by 1e-6 (three seeds), about the rounding by which
# cuDNN's f32 convs and the CPU's differ (1.0e-6 to 1.7e-6 of the output's
# scale, `python -m tumblr_emotions_torch.op_grads`).  The per-image move
# matters: the card's rounding differs image by image, which batch
# centring does not cancel as it cancels much of a move of the weights
# (measured at image_frozen: 2.5e-4 for the weights alone, 1.0e-3 to
# 1.8e-3 with the images).  The BN statistics are held within f32 rounding
# of their values.
TRAIN_CASES = {
    "image": ("image_frozen", dict(model="image"), dict(trainable_scopes="")),
    "joint": ("joint_finetune", {}, dict(grad_clip_norm=1.0)),
    "text_mean": ("text_only", {}, {}),
    "text_rnn": ("text_only", dict(aggregator="rnn"), dict(optimizer="sgd", momentum=0.9)),
    "image_frozen": ("image_frozen", {}, {}),
}


def _train_cfg(name):
    from tumblr_emotions_torch import get_preset

    preset, extra, train = TRAIN_CASES[name]
    cfg = get_preset(preset)
    cfg = cfg.replace(
        image=cfg.image.replace(image_size=139, depth_multiplier=0.25, dropout_keep_prob=1.0),
        text=cfg.text.replace(vocab_size=300, embed_dim=32, max_len=12,
                              aggregator=extra.get("aggregator", "mean")),
        train=cfg.train.replace(batch_size=4, **train))
    return cfg.replace(model=extra.get("model", cfg.model))


def _train_init(cfg, seed=0):
    from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model

    init = {"image": inception_v3, "joint": joint_model, "text": text_model}[cfg.model]
    return init.init_state(build_model(cfg, device="meta"), seed)


def _train_batch(cfg, seed=1):
    from tumblr_emotions_torch.data.vocab import synthetic_ids

    rng = np.random.RandomState(seed)
    b = {"tokens": synthetic_ids(rng, 4, 12, 300),
         "label": rng.randint(0, 15, 4).astype(np.int32)}
    b["lengths"] = (b["tokens"] != 0).sum(-1).astype(np.int32)
    if cfg.model != "text":
        b["image"] = rng.randint(0, 256, (4, 160, 170, 3)).astype(np.uint8)
    return b


def _one_step(cfg, state, batch, where, draws):
    from tumblr_emotions_torch.train.trainer import Trainer

    tr = Trainer(cfg, preprocess=None if cfg.model == "text" else "train", device=where)
    ts = tr.init_state(state)
    ts, m = tr.train_step(ts, batch, draws=None if draws is None else draws.to(where))
    return float(m["loss"]), {k: v.detach().cpu() for k, v in ts.state.items()}, tr


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step_on_the_card_matches_the_cpu(dev, name):
    from tumblr_emotions_torch.data import preprocessing as pp

    cfg = _train_cfg(name)
    state, batch = _train_init(cfg), _train_batch(cfg)
    draws = None if cfg.model == "text" else pp.draw_train(
        torch.Generator().manual_seed(0), 4, (160, 170))
    loss_card, card, tr = _one_step(cfg, state, batch, dev, draws)
    loss_cpu, cpu, _ = _one_step(cfg, state, batch, "cpu", draws)
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    keys = [k for k in tr.param_keys if not torch.equal(cpu[k], state[k])]
    stats = [k for k in state if k.endswith(("moving_mean", "moving_variance"))]
    assert keys
    if cfg.model != "text":
        def dist(a, a0, ks):
            """How far update a is from the CPU's, over ``ks``."""
            num = sum(float((((a[k] - a0[k]) - (cpu[k] - state[k])).double() ** 2).sum())
                      for k in ks)
            den = sum(float(((cpu[k] - state[k]).double() ** 2).sum()) for k in ks)
            return (num / den) ** 0.5

        floors = []
        for seed in (1, 2, 3):
            g = torch.Generator().manual_seed(seed)
            moved = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
                     for k, v in state.items()}
            nudged = dataclasses.replace(draws, delta=draws.delta + 1e-6 * torch.randn(
                4, generator=g))
            _, noise, _ = _one_step(cfg, moved, batch, "cpu", nudged)
            floors.append(dist(noise, moved, keys))
        assert dist(card, state, keys) <= 3 * np.mean(floors) + 1e-6
        # The statistics are the forward's: equal to f32 rounding of their
        # values (their one-step change, 3e-4 of them, is below f32's
        # resolution to compare with).
        for k in stats:
            torch.testing.assert_close(card[k], cpu[k], rtol=1e-5, atol=1e-6)
    else:
        for k in keys + stats:
            scale = (cpu[k] - state[k]).abs().max().item()
            assert (card[k] - cpu[k]).abs().max().item() <= 1e-3 * scale + 1e-7, k


@pytest.mark.parametrize("window,strides,padding", [
    ((3, 3), (1, 1), "SAME"), ((5, 5), (3, 3), "VALID"), ((8, 8), (1, 1), "VALID")])
def test_avg_pool_backward_on_the_card_matches_the_cpu(dev, window, strides, padding):
    """The tower's average pools, forward and backward, on a channels-last
    view: PyTorch's own CUDA backward of the padded pool divides by the
    wrong count, so the SAME pool carries its own backward."""
    from tumblr_emotions_torch.models.layers import avg_pool

    x = torch.rand(4, 17, 17, 64)
    g = torch.randn(avg_pool(x, window, strides, padding).shape)
    out = {}
    for where in ("cpu", dev):
        xi = x.to(where).requires_grad_(True)
        y = avg_pool(xi, window, strides, padding)
        (gx,) = torch.autograd.grad(y, xi, g.to(where))
        out[where] = (y.detach().cpu(), gx.cpu())
    torch.testing.assert_close(out[dev][0], out["cpu"][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[dev][1], out["cpu"][1], rtol=1e-6, atol=1e-6)


def test_train_step_runs_the_backward_without_tf32_on_the_card(dev):
    """A hook on the logits' gradient reads the TF32 flags while autograd
    runs the backward on the card: both off, though cuDNN's is on outside."""
    from tumblr_emotions_torch.train.trainer import Trainer

    cfg = _train_cfg("joint")
    tr = Trainer(cfg, preprocess="train", device=dev)
    ts = tr.init_state(_train_init(cfg))
    seen = []

    def hook(module, args, out):
        out[0].register_hook(lambda g: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))

    handle = tr.model.register_forward_hook(hook)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        tr.train_step(ts, _train_batch(cfg), torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    finally:
        handle.remove()
        torch.backends.cudnn.allow_tf32 = saved
    assert seen == [(False, False)]


def test_image_frozen_leaves_frozen_parameters_bit_unchanged_on_the_card(dev):
    from tumblr_emotions_torch.train.trainer import Trainer, path_in_scopes

    cfg = _train_cfg("image_frozen")
    state = _train_init(cfg)
    tr = Trainer(cfg, preprocess="train", device=dev)
    ts = tr.init_state(state)
    gen = torch.Generator(device=dev).manual_seed(0)
    for seed in (1, 2):
        ts, _ = tr.train_step(ts, _train_batch(cfg, seed), gen)
    for k in tr.param_keys:
        same = torch.equal(ts.state[k].detach().cpu(), state[k])
        assert same != path_in_scopes(k, ("Logits", "AuxLogits")), k
    for k in state:
        if k.endswith(("moving_mean", "moving_variance")):
            assert not torch.equal(ts.state[k].cpu(), state[k]), k


def test_device_prefetch_copies_from_pinned_memory_on_a_side_stream(dev):
    from tumblr_emotions_torch.data.pipeline import DevicePrefetchIterator

    class Source:
        def __init__(self):
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.n == 6:
                raise StopIteration
            self.n += 1
            return {"image": np.full((4, 33, 33, 3), self.n, np.uint8),
                    "label": np.arange(4, dtype=np.int32) + self.n}

        def get_state(self):
            return {"n": self.n}

        def set_state(self, state):
            self.n = state["n"]

    src = Source()
    pinned = []
    real_empty = torch.empty

    def spy(*a, **k):
        t = real_empty(*a, **k)
        if k.get("pin_memory"):
            pinned.append(t.is_pinned())
        return t

    torch.empty = spy
    try:
        pf = DevicePrefetchIterator(src, device=dev, depth=2)
        got = []
        for i, b in enumerate(pf, start=1):
            assert b["image"].device == dev and b["label"].device == dev
            assert int(b["image"][0, 0, 0, 0]) == i and int(b["label"][0]) == i
            assert pf.get_state() == {"n": i}
            got.append(i)
    finally:
        torch.empty = real_empty
    assert got == [1, 2, 3, 4, 5, 6] and pinned and all(pinned)


def test_one_cli_train_step_on_the_card(tmp_path):
    import csv
    import shutil

    from tumblr_emotions_torch import cli
    from tumblr_emotions_torch.utils.checkpoint import CheckpointManager

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    fixtures = sorted((Path(__file__).parent / "data" / "jpeg").glob("*.jpg"))
    (tmp_path / "images").mkdir()
    for f in fixtures:
        shutil.copy(f, tmp_path / "images" / f.name)
    with open(tmp_path / "posts.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "label", "image"])
        for i in range(24):
            w.writerow([f"p{i}", f"post {i} so happy", i % 15, fixtures[i % len(fixtures)].name])
    data = tmp_path / "data"
    assert cli.main(["convert-dataset", "--csv", str(tmp_path / "posts.csv"), "--images-dir",
                     str(tmp_path / "images"), "--out", str(data), "--num-shards", "2"]) == 0
    common = ["--preset", "joint_finetune", "--vocab", str(data / "vocab.txt"),
              "--depth-multiplier", "0.5", "--batch-size", "8", "--checkpoint-dir",
              str(tmp_path / "ck")]
    assert cli.main(["train", *common, "--records", str(data / "train-*.tfrecord"),
                     "--steps", "1", "--prefetch-depth", "2"]) == 0
    reader = CheckpointManager(str(tmp_path / "ck")).reader(1)
    assert int(reader.get_tensor("step")) == 1
    assert np.isfinite(reader.get_tensor("params/JointLogits/kernel")).all()


PERF_NOISE_EPS = 1e-6


def _perf_grads(cfg, state, batch, where, draws, images=None):
    """A perf step's loss and gradients on ``where`` (CPU tensors), its
    trainer and state before the update, and its distorted images (on the
    CPU); ``images``: distorted images to run the model on instead."""
    from tumblr_emotions_torch.train.trainer import Trainer

    tr = Trainer(cfg, preprocess="train", device=where)
    ts = tr.init_state(state)
    inputs = tr.train_inputs(batch, None, draws.to(where))
    if images is not None:
        inputs = dict(inputs, image=images.to(where))
    loss, _, grads = tr.loss_and_grads(ts, inputs)
    return (float(loss), {k: g.detach().cpu() for k, g in grads.items()}, tr, ts,
            inputs["image"].detach().cpu())


def _perf_step_floors(cfg, state, batch, draws):
    """The CPU's own floor for a perf step's loss and gradients: its step
    with the bf16 layers' products accumulated in float64 (another
    summation order, as the card's is), and its steps from weights moved
    by PERF_NOISE_EPS of themselves and brightness nudged as much.
    Returns [(loss, gradients)] of the floor runs."""
    from tumblr_emotions_torch.train import noise_floor

    with noise_floor.float64_accumulation():
        runs = [_perf_grads(cfg, state, batch, "cpu", draws)[:2]]
    for seed in (1, 2, 3):
        g = torch.Generator().manual_seed(seed)
        moved = {k: v * (1 + PERF_NOISE_EPS * torch.randn(v.shape, generator=g))
                 for k, v in state.items()}
        nudged = dataclasses.replace(draws, delta=draws.delta + PERF_NOISE_EPS * torch.randn(
            4, generator=g))
        runs.append(_perf_grads(cfg, moved, batch, "cpu", nudged)[:2])
    return runs


@pytest.mark.parametrize("name", ["joint", "text_mean"])
def test_perf_train_step_on_the_card_matches_the_cpu(dev, name):
    """One perf (bf16) step on the card against the same step on the CPU.
    bf16 roundings flip where the card's and the CPU's f32 sums differ, and
    train-mode batch norm over 4 images amplifies them.  The joint step is
    held in three parts.  The train distortions: the card's images within
    1e-4 of the CPU's (f32 in [-1, 1], two f32 programs of the same
    distortions, as ``test_torch_train_preprocessing.JIT_TOL`` holds the
    jitted reference to its own op-by-op run; the card was 6.6e-5 from the
    CPU on an H100; they still put 0.08-0.5% of the
    values on the other side of a bf16 rounding, which moves the loss by
    0.003-0.029 over 8 batches, mean 0.013, against the CPU's float64
    floor's mean 0.005: ``python -m tumblr_emotions_torch.perf_noise``).
    The model on the CPU's images: its loss and gradients within 3x the
    CPU's own floor (``_perf_step_floors``; over the 8 batches the card
    was 0.004 in mean), the gradients as a whole and leaf by leaf where the
    floor is under ``noise_floor.SIGNAL_FLOOR``, a check that refuses no
    gradient and a reversed one.  The optimizer: the update the card makes
    from the CPU's gradients within 8 f32 roundings of each parameter
    (the larger of before and after) of the CPU's (global-norm clipping scales every leaf by the noisy tower's
    norm, so updates from each side's own gradients have no leaf to hold).
    The text model: its update within one bf16 rounding (2^-8).  The
    readings are printed (``-s``)."""
    from tumblr_emotions_torch.data import preprocessing as pp
    from tumblr_emotions_torch.train import noise_floor

    cfg = _train_cfg(name)
    cfg = cfg.replace(train=cfg.train.replace(precision_mode="perf"))
    state, batch = _train_init(cfg), _train_batch(cfg)
    if cfg.model == "text":
        loss_card, card, tr = _one_step(cfg, state, batch, dev, None)
        loss_cpu, cpu, _ = _one_step(cfg, state, batch, "cpu", None)
        assert tr.model.dtype == torch.bfloat16
        keys = [k for k in tr.param_keys if not torch.equal(cpu[k], state[k])]
        assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
        assert noise_floor.distance(card, state, cpu, state, keys) <= 2.0 ** -8
        return
    draws = pp.draw_train(torch.Generator().manual_seed(0), 4, (160, 170))
    loss_cpu, cpu, tr_cpu, ts_cpu, images = _perf_grads(cfg, state, batch, "cpu", draws)
    loss_own, _, _, _, own_images = _perf_grads(cfg, state, batch, dev, draws)
    loss_card, card, tr, ts_card, _ = _perf_grads(cfg, state, batch, dev, draws, images)
    assert tr.model.dtype == torch.bfloat16
    keys = [k for k in cpu if bool(cpu[k].any())]
    floors = _perf_step_floors(cfg, state, batch, draws)
    loss_floors = [abs(f[0] - loss_cpu) / abs(loss_cpu) for f in floors]
    h = noise_floor.hold(card, cpu, cpu, [f[1] for f in floors], None, keys, 3.0, 2.0 ** -7,
                         2.0 ** -6)
    tr.apply_gradients(ts_card, {k: g.to(dev) for k, g in cpu.items()})
    tr_cpu.apply_gradients(ts_cpu, cpu)
    after_card = {k: ts_card.state[k].detach().cpu() for k in keys}
    after_cpu = {k: ts_cpu.state[k].detach() for k in keys}
    image_diff = float((own_images - images).abs().max())
    print(json.dumps({
        "test": f"perf_train_step[{name}]", "image_max_abs_diff": image_diff,
        "loss_rel_diff_own_images": abs(loss_own - loss_cpu) / abs(loss_cpu),
        "loss_rel_diff": abs(loss_card - loss_cpu) / abs(loss_cpu), "loss_floors": loss_floors,
        "grads_to_cpu": h["to_ref"], "grads_floor": h["floor"],
        "signal_leaves": h["signal_leaves"],
        "update_from_cpu_grads": noise_floor.distance(after_card, state, after_cpu, state, keys),
        "update_max_rel_diff": max(float(((after_card[k] - after_cpu[k]).abs() / _scale(
            state[k], after_cpu[k])).max()) for k in keys)}))
    assert image_diff <= 1e-4
    assert abs(loss_card - loss_cpu) / abs(loss_cpu) <= 3 * np.mean(loss_floors) + 1e-5
    assert h["ok"], (h["to_ref"], h["limit"], h["failed_leaves"])
    assert h["refuses_noop"] and h["refuses_flip"], h["signal_leaves"]
    for k in keys:
        diff = (after_card[k] - after_cpu[k]).abs()
        assert bool((diff <= 2.0 ** -20 * _scale(state[k], after_cpu[k])).all()), k


def _scale(before, after):
    """The larger magnitude of a parameter before and after its update,
    elementwise: an update that nearly cancels the parameter is held to the
    parameter's own rounding, not to the tiny result's."""
    return torch.maximum(before.abs(), after.abs()).clamp_min(1e-30)


def test_perf_eval_mode_gradients_on_the_card_match_the_cpu(dev):
    """The bf16 tower's backward on the card (cuDNN's convs on bf16 values,
    ``_Bf16AvgPool``) against the CPU's, with batch norm on its moving
    statistics (no amplification by batch statistics): every gradient of
    the image model within 3x the CPU's float64 floor, a limit under 0.5
    (no gradient is 1)."""
    from tumblr_emotions_torch.train import noise_floor
    from tumblr_emotions_torch.train.trainer import Trainer, cross_entropy, l2_regularization

    cfg = _train_cfg("image")
    cfg = cfg.replace(train=cfg.train.replace(precision_mode="perf", trainable_scopes=""))
    state, batch = _train_init(cfg), _train_batch(cfg)
    batch = dict(batch, image=np.random.RandomState(3).uniform(
        -1, 1, (4, 139, 139, 3)).astype(np.float32))

    def grads(where):
        tr = Trainer(cfg, device=where)
        ts = tr.init_state(state)
        keys = tr.trainable_keys(ts)
        tr.model.eval()
        inputs = tr._to_device(batch)
        logits, _ = torch.func.functional_call(tr.model, ts.state, tr._model_args(inputs))
        loss = cross_entropy(logits, inputs["label"]) + l2_regularization(
            ts.state, cfg.train.weight_decay)
        gs = torch.autograd.grad(loss, [ts.state[k] for k in keys], allow_unused=True)
        return {k: g.detach().cpu() for k, g in zip(keys, gs) if g is not None}

    with torch.enable_grad():
        card, cpu = grads(dev), grads("cpu")
        with noise_floor.float64_accumulation():
            f64 = grads("cpu")
    h = noise_floor.hold(card, cpu, cpu, [f64], None, list(cpu), 3.0, 2.0 ** -7, 2.0 ** -6)
    print(json.dumps({"test": "perf_eval_mode_gradients", "to_cpu": h["to_ref"],
                      "floor": h["floor"], "limit": h["limit"]}))
    assert h["ok"] and h["limit"] < 0.5, (h["to_ref"], h["limit"], h["failed_leaves"])
    assert h["refuses_noop"] and h["refuses_flip"]


_TWO_RANKS = """
import json, sys
import numpy as np, torch
from tumblr_emotions_torch import get_preset
from tumblr_emotions_torch.models import build_model, text_model
from tumblr_emotions_torch.parallel import distributed
from tumblr_emotions_torch.train.trainer import Trainer

rank, address, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dev = distributed.init_group(address, 2, rank, device="cuda")
assert torch.distributed.get_backend() == "gloo" and dev.type == "cuda"
x = torch.tensor([rank + 1.0], device=dev)
distributed.all_reduce_(x)
cfg = get_preset("text_only")
cfg = cfg.replace(text=cfg.text.replace(vocab_size=300, embed_dim=32, max_len=12),
                  train=cfg.train.replace(batch_size=4))
tr = Trainer(cfg, device=dev)
ts = tr.init_state(text_model.init_state(build_model(cfg, device="meta"), 0))
rng = np.random.RandomState(5)
for _ in range(2):
    b = {"tokens": rng.randint(0, 300, (8, 12)).astype(np.int32),
         "label": rng.randint(0, 15, 8).astype(np.int32)}
    ts, m = tr.train_step(ts, {k: v[4 * rank:4 * rank + 4] for k, v in b.items()})
torch.save({"sum": x.item(), "loss": m["loss"].item(),
            "state": {k: v.detach().cpu() for k, v in ts.state.items()}}, out)
torch.distributed.destroy_process_group()
"""


def test_two_ranks_share_one_card(dev, tmp_path):
    """Two processes on the one card run on gloo (NCCL refuses two ranks on
    one device): an all-reduce of card tensors, and two data-parallel steps
    of the text model equal to one process on the same 8 rows."""
    import os
    import socket
    import subprocess
    import sys

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.models import build_model, text_model
    from tumblr_emotions_torch.train.trainer import Trainer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), address,
                               str(tmp_path / f"r{r}.pt")], env=env, cwd=root)
             for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    got = [torch.load(str(tmp_path / f"r{r}.pt")) for r in range(2)]
    assert got[0]["sum"] == got[1]["sum"] == 3.0
    cfg = get_preset("text_only")
    cfg = cfg.replace(text=cfg.text.replace(vocab_size=300, embed_dim=32, max_len=12),
                      train=cfg.train.replace(batch_size=8))
    tr = Trainer(cfg, device=dev)
    ts = tr.init_state(text_model.init_state(build_model(cfg, device="meta"), 0))
    rng = np.random.RandomState(5)
    for _ in range(2):
        ts, m = tr.train_step(ts, {"tokens": rng.randint(0, 300, (8, 12)).astype(np.int32),
                                   "label": rng.randint(0, 15, 8).astype(np.int32)})
    assert abs(got[0]["loss"] - m["loss"].item()) <= 1e-5 * abs(m["loss"].item())
    for k, v in ts.state.items():
        torch.testing.assert_close(got[0]["state"][k], v.detach().cpu(), rtol=1e-5, atol=1e-6)
        assert torch.equal(got[0]["state"][k], got[1]["state"][k])


# ---------------------------------------------------------------------------
# Captured programs (utils/compile_opts.capture): every served runner as one
# CUDA graph per input signature, bit-equal to the same program launched op
# by op.
# ---------------------------------------------------------------------------

EAGER = {"cuda_graph": "false"}


def _captured_runners(dev, raw):
    """name -> (captured runner, the same program eager, needs tokens)."""
    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.models import build_model, joint_model, text_model
    from tumblr_emotions_torch.ops.serving import build_forward, image_server
    from tumblr_emotions_torch.utils.compile_opts import capture

    img = get_preset("fused_inference")
    img = img.replace(image=img.image.replace(depth_multiplier=0.5))
    state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=0)
    calib = preprocess_for_eval(raw)
    joint = get_preset("joint_finetune")
    joint = joint.replace(image=joint.image.replace(depth_multiplier=0.5),
                          text=joint.text.replace(vocab_size=1000, embed_dim=32))
    jstate = joint_model.init_state(build_model(joint, device="meta"), 0)
    text = get_preset("text_only")
    text = text.replace(text=text.text.replace(vocab_size=1000, embed_dim=32,
                                               aggregator="rnn", rnn_hidden=64, max_len=50))
    tstate = text_model.init_state(build_model(text, device="meta"), 0)
    runners = {}
    for name, cfg, st, kw in [
            ("int8_s2d", img, state, dict(engine="int8", front="s2d")),
            ("int8_uint8", img, state, dict(engine="int8", front="uint8")),
            ("int8_float", img, state, dict(engine="int8", front="float")),
            ("bf16_cudnn", img, state, dict(engine="bf16")),
            ("parity", img, state, dict(engine="parity")),
            ("joint_int8", joint, jstate, dict(engine="int8")),
            ("text_rnn", text, tstate, dict(engine="parity"))]:
        r = build_forward(cfg, st, calib_images=calib, device=dev, **kw)
        runners[name] = (r, capture(r.program.fn, options=EAGER, device=dev),
                         cfg.model != "image")
    srv = image_server(FusedInceptionV3(state, use_kernels=True, device=dev), device=dev)
    runners["bf16_kernels"] = (lambda image, tokens=None, lengths=None: srv(image)[0],
                               capture(srv.program.fn, options=EAGER, device=dev), False)
    runners["bf16_kernels"][0].program = srv.program
    return runners


def _batch(dev, n, seed):
    from tumblr_emotions_torch.data.vocab import synthetic_ids

    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, 256, (n, 347, 347, 3), generator=g, device=dev, dtype=torch.uint8)
    return raw, synthetic_ids(np.random.RandomState(seed), n, 50, 1000)


def test_every_captured_runner_is_bit_equal_to_eager(dev, int8_engines):
    """Each build_forward runner (int8 s2d / uint8 / float, bf16 cuDNN,
    parity, joint, text) and the bf16 kernel engine, served as CUDA graphs,
    against the same program launched op by op: equal bit for bit over
    three batches (two replays), a second batch size (a second graph in the
    runner's pool) and the first size again; numpy inputs take the pinned
    path."""
    runners = _captured_runners(dev, int8_engines[2])
    # (batch, seed, images from host memory): the signatures (4, card),
    # (4, host) and (2, card) for the image runners; the text runner sees
    # its host token batches only, (4, host) and (2, host).
    plan = [(4, 1, False), (4, 2, False), (4, 3, True), (4, 4, True), (2, 5, False),
            (4, 6, False)]
    for name, (runner, eager, text) in runners.items():
        for i, (n, seed, host) in enumerate(plan):
            raw, tok = _batch(dev, n, seed)
            image = raw.cpu().numpy() if host else raw
            got = runner(image, tok) if text else runner(image)
            if text:
                want = eager(raw, torch.from_numpy(tok).to(dev), None)
            else:   # the parity body takes (image, tokens, lengths)
                want = eager(raw, None, None) if name == "parity" else eager(raw)[0]
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, i, (got - want).abs().max().item())
        graphs, replays = (2, 4) if name == "text_rnn" else (3, 3)
        assert (runner.program._cache_size(), runner.program.replays) == (graphs, replays), name
        if name.startswith("int8") or name == "joint_int8":   # one forward per graph
            assert [g[:2] for g in _graph_int8(runner.program)] == [(66, 4)] * graphs, name


@pytest.mark.parametrize("name", ["int8_s2d", "int8_uint8", "bf16_cudnn", "joint_int8"])
def test_a_batch_split_over_two_runners_on_the_card_is_one_runners(dev, int8_engines, name):
    """``build_forward(..., devices=[card, card])``: each runner a captured
    program of its own (66 int8 conv and 4 pool nodes per graph), the rows
    split 2 and 2, the answers bit for bit the one runner's, from card
    and from host (numpy, the pinned staging) inputs alike."""
    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.ops.serving import build_forward

    cfg = get_preset("joint_finetune" if name == "joint_int8" else "fused_inference")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.5),
                      text=cfg.text.replace(vocab_size=1000, embed_dim=32))
    state = (joint_model.init_state(build_model(cfg, device="meta"), 0) if cfg.model == "joint"
             else init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=0))
    engine, _, front = name.partition("_")
    kw = dict(engine="int8" if engine == "joint" else engine,
              front=front if front in ("s2d", "uint8") else "s2d",
              calib_images=preprocess_for_eval(int8_engines[2]))
    one = build_forward(cfg, state, device=dev, **kw)
    two = build_forward(cfg, state, devices=[dev, dev], **kw)
    if kw["engine"] == "int8":          # two calibrations on the card: one set of scales
        two.engine.scales = one.engine.scales
    for seed, host in ((1, False), (2, False), (3, True)):
        raw, tok = _batch(dev, 4, seed)
        args = (raw.cpu().numpy() if host else raw,) + ((tok,) if cfg.model == "joint" else ())
        got, want = two(*args), one(*args)
        torch.cuda.synchronize()
        assert got.device == dev and torch.equal(got, want), (seed, (got - want).abs().max())
    for program in two.programs:          # card inputs: a capture and a replay; host: one
        assert program.replays == 1 and program._cache_size() == 2
        if kw["engine"] == "int8":
            assert [g[:2] for g in _graph_int8(program)] == [(66, 4)] * 2


def test_captured_answers_survive_the_next_replay(dev, int8_engines):
    """The batcher hands out rows of one answer while the next batch runs:
    the runner returns copies, so a later replay leaves an earlier answer
    as it was."""
    runner, eager, _ = _captured_runners(dev, int8_engines[2])["int8_s2d"]
    (x0, _), (x1, _), (x2, _) = (_batch(dev, 4, s) for s in (6, 7, 8))
    runner(x0)                                  # capture
    a = runner(x1)
    a_copy = a.clone()
    b = runner(x2)
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, a_copy)
    assert torch.equal(a, eager(x1)[0]) and not torch.equal(a, b)


def test_a_rebuilt_runner_does_not_replay_an_old_graph(dev, int8_engines):
    """Graphs bake in their weights' addresses and tensor maps: a runner
    rebuilt on other weights captures its own graphs and answers from them."""
    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.ops.serving import build_forward

    cfg = get_preset("fused_inference")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.5))
    raw = int8_engines[2]
    calib = preprocess_for_eval(raw)
    x, _ = _batch(dev, 4, 9)
    outs = []
    for seed in (0, 1):
        state = init_state(InceptionV3(depth_multiplier=0.5, device="meta"), seed=seed)
        for engine in ("int8", "bf16"):
            r = build_forward(cfg, state, engine=engine, calib_images=calib, device=dev)
            r(x)
            got = r(x)                            # a replay
            torch.cuda.synchronize()
            assert torch.equal(got, r.program.fn(x)[0]) and r.program.replays == 1
            outs.append(got)
    assert not torch.equal(outs[0], outs[2]) and not torch.equal(outs[1], outs[3])


def test_full_mode_distortions_on_the_card_match_the_cpu(dev):
    """Full-mode train distortions (four resizes, hue and contrast chains)
    on the card against the CPU on the same draws, within the 1e-4 the
    repo holds two f32 programs of the distortions to."""
    from tumblr_emotions_torch.data import preprocessing as pp

    g = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 256, (16, 173, 190, 3), generator=g, dtype=torch.uint8)
    d = pp.draw_train(torch.Generator().manual_seed(1), 16, (173, 190), fast_mode=False)
    assert set(d.resize.tolist()) == {0, 1, 2, 3} == set(d.chain.tolist())
    want = pp.apply_train(raw, d, 139, 139, fast_mode=False)
    got = pp.apply_train(raw.to(dev), d.to(dev), 139, 139, fast_mode=False)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# The card's divisions, the captured train and eval steps, V1 checkpoints
# ---------------------------------------------------------------------------

def test_preprocess_for_eval_divides_as_the_cpu_on_the_card(dev):
    """f32 eval preprocessing on the card bit-equal to the CPU's: every byte
    value (a 16x16 image resized to itself, so the division alone) and a
    seeded [8,347,347,3] batch at 299 px.  The uint8 -> [0, 1] step divides
    by 255 as IEEE division, as the reference does; PyTorch's ``x / 255.0``
    is a product with the reciprocal on the card (126 of 256 values one ulp
    off)."""
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval

    v = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1).expand(1, 16, 16, 3)
    want = preprocess_for_eval(v, 16, 16, central_fraction=1.0)
    assert torch.equal(preprocess_for_eval(v.to(dev), 16, 16, central_fraction=1.0).cpu(),
                       want)
    g = torch.Generator().manual_seed(0)
    raw = torch.randint(0, 256, (8, 347, 347, 3), generator=g, dtype=torch.uint8)
    assert torch.equal(preprocess_for_eval(raw.to(dev)).cpu(), preprocess_for_eval(raw))


def test_int8_calibration_on_the_card_gives_the_cpus_input_scale(dev):
    """The int8 engine calibrated on the card and on the CPU from one batch
    (depth 0.25, 299 px): the input scale (the preprocessed images' range)
    bit-equal; the conv sites' scales within 2^-6 of each other: the f32
    conv sums run in another order, and where one lands by a rounding
    boundary the next layer's bf16 operand rounds the other way (2^-8 of
    that value), which the layers after it carry (7.4e-5 at Mixed_6c/out
    on an H100)."""
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3

    state = init_state(InceptionV3(depth_multiplier=0.25, device="meta"), seed=0)
    g = torch.Generator().manual_seed(1)
    raw = torch.randint(0, 256, (4, 347, 347, 3), generator=g, dtype=torch.uint8)
    card = QuantizedInceptionV3(state, preprocess_for_eval(raw.to(dev)), stem_s2d="pre",
                                device=dev).scales
    cpu = QuantizedInceptionV3(state, preprocess_for_eval(raw), stem_s2d="pre",
                               device="cpu").scales
    assert sorted(card) == sorted(cpu) and card["input"] == cpu["input"]
    rel = {k: abs(card[k] - cpu[k]) / cpu[k] for k in cpu}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 2.0 ** -6, (worst, rel[worst])


def test_adam_update_on_the_card_equals_the_cpu(dev):
    """Three Adam updates (bias corrections read from a tensor, divided as
    IEEE division) on the card bit-equal to the CPU's."""
    from tumblr_emotions_torch.config import TrainConfig
    from tumblr_emotions_torch.train import optim

    opt = optim.Optimizer(TrainConfig(optimizer="adam", learning_rate=1e-3, lr_decay_steps=1))
    rng = np.random.RandomState(0)
    p0 = {k: rng.normal(size=(64, 65)).astype(np.float32) for k in "ab"}
    grads = [{k: rng.normal(size=(64, 65)).astype(np.float32) for k in p0} for _ in range(3)]
    out = []
    for where in ("cpu", dev):
        p = {k: torch.tensor(v, device=where) for k, v in p0.items()}   # copies
        st = opt.init(p)
        for g in grads:
            opt.update(p, {k: torch.tensor(v, device=where) for k, v in g.items()}, st)
        out.append({k: v.cpu() for k, v in p.items()})
    assert all(torch.equal(out[0][k], out[1][k]) for k in p0)


def _fit_compiled(cfg, state, batches, dev, eager, ckpt=None):
    import os

    from tumblr_emotions_torch.train.trainer import Trainer
    from tumblr_emotions_torch.utils import compile_opts

    env = os.environ.pop(compile_opts.TRAIN_ENV_VAR, None)
    try:
        if eager:
            os.environ[compile_opts.TRAIN_ENV_VAR] = '{"cuda_graph": "false"}'
        tr = Trainer(cfg, preprocess=None if cfg.model == "text" else "train",
                     device=dev).compile()
    finally:
        os.environ.pop(compile_opts.TRAIN_ENV_VAR, None)
        if env is not None:
            os.environ[compile_opts.TRAIN_ENV_VAR] = env
    assert tr.step_mode == ("eager" if eager else "captured")
    if ckpt:
        tr.checkpoint_manager(ckpt)
    ts = tr.fit(tr.init_state(state), iter(batches), num_steps=len(batches))
    return tr, ts


def _same_train_state(a, b):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k
    for m in a.opt_state:
        if m != "count":
            for k in a.opt_state[m]:
                assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), (m, k)


@pytest.mark.parametrize("name", ["joint", "image", "text_mean"])
def test_captured_train_and_eval_steps_equal_eager_on_the_card(dev, name):
    """Four steps of fit with the steps captured (one graph, replayed from
    the second step) bit-equal to four eager steps: parameters, optimizer
    moments, BN statistics; evaluate's statistics too.  The options' false
    runs the steps eagerly."""
    cfg = _train_cfg(name)
    cfg = cfg.replace(image=cfg.image.replace(dropout_keep_prob=0.8))
    batches = [_train_batch(cfg, seed) for seed in range(4)]
    state = _train_init(cfg)
    tr_e, ts_e = _fit_compiled(cfg, state, batches, dev, eager=True)
    tr_c, ts_c = _fit_compiled(cfg, state, batches, dev, eager=False)
    _same_train_state(ts_c, ts_e)
    program = tr_c._programs["train"]
    assert program._cache_size() == 1 and program.replays == 3
    if cfg.model != "text":
        tr_c.preprocess = tr_e.preprocess = "eval"
    ev_c, ev_e = tr_c.evaluate(ts_c, batches[:2]), tr_e.evaluate(ts_e, batches[:2])
    assert (ev_c["count"], ev_c["accuracy"], ev_c["loss"]) == \
        (ev_e["count"], ev_e["accuracy"], ev_e["loss"])
    assert tr_c._programs["eval"].replays == 1


def test_restore_under_capture_equals_the_straight_run_on_the_card(dev, tmp_path):
    """A captured run checkpointed at step 2, restored into new tensors (the
    graph captured on the old ones dropped) and trained to step 4, bit-equal
    to four captured steps straight."""
    cfg = _train_cfg("joint")
    cfg = cfg.replace(train=cfg.train.replace(checkpoint_every=2))
    batches = [_train_batch(cfg, seed) for seed in range(4)]
    state = _train_init(cfg)
    _, straight = _fit_compiled(cfg, state, batches, dev, eager=False)
    tr, ts = _fit_compiled(cfg, state, batches[:2], dev, eager=False, ckpt=str(tmp_path))
    restored = tr.restore_latest(tr.init_state(state))
    assert restored.step == 2
    ts = tr.fit(restored, iter(batches[2:]), num_steps=2)
    _same_train_state(ts, straight)
    assert tr._programs["train"]._cache_size() == 1


def test_v1_fixture_warm_starts_a_model_on_the_card(dev):
    """The committed V1 checkpoint (a partitioned leaf among slim names)
    read on the card machine, which has no TensorFlow: every tensor equal
    to the values TF read back when it was written, and a warm start puts
    them on the card bit for bit."""
    from tumblr_emotions_torch import convert
    from tumblr_emotions_torch.utils import checkpoint as ck

    fixture = Path(__file__).parent / "data" / "v1"
    want = np.load(fixture / "expected.npz")
    reader = ck.load_checkpoint(str(fixture / "slim_v1.ckpt"))
    for name in want.files:
        np.testing.assert_array_equal(reader.get_tensor(name), want[name])
    model = InceptionV3(depth_multiplier=0.25, min_depth=8, device="meta")
    state = {k: v.to(dev) for k, v in init_state(model, seed=0).items()}
    warm = ck.merge_pretrained(state, ck.load_slim_checkpoint(str(fixture / "slim_v1.ckpt")))
    keys = {k.replace(".", "/"): k for k in warm}
    used = [n for n in want.files if n[len("InceptionV3/"):] in keys]
    assert len(used) == 6      # not the optimizer slot, the global step
    for name in used:
        key = keys[name[len("InceptionV3/"):]]
        assert warm[key].device.type == "cuda"
        np.testing.assert_array_equal(
            warm[key].cpu().numpy(),
            convert.to_port_leaf(tuple(name.split("/")[1:]), want[name]).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_on_the_card_is_the_cpu_bit_for_bit(dev, dtype, monkeypatch):
    """The port's Dropout (f32, and bf16 as perf mode runs it) on one draw:
    the card's output bit-equal to the CPU's."""
    from tumblr_emotions_torch.models.layers import Dropout

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(64, 1, 1, 2048, generator=gen) * 4).to(getattr(torch, dtype))
    u = torch.rand(x.shape, generator=gen)
    monkeypatch.setattr(torch, "rand", lambda *a, device=None, **k: u.to(device))
    drop = Dropout(0.8).train()
    cpu, card = drop(x), drop(x.to(dev)).cpu()
    assert card.dtype == cpu.dtype and torch.equal(card, cpu)


# The bf16 train-mode batch norm's Triton kernels (ops/batch_norm) at the
# tower's shapes at 128 rows, against their plain versions.
BN_SHAPES = [(149, 32), (147, 64), (35, 288), (17, 768), (8, 2048)]


def _bn_inputs(dev, hw, c, seed=0, slice_g=False):
    from tumblr_emotions_torch.ops import batch_norm as bn_ops

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(128 * hw * hw, c, generator=gen, device=dev) * 2.0 + 0.5
    beta = torch.randn(c, generator=gen, device=dev) * 0.1
    wide = torch.randn(128, hw, hw, c + (16 if slice_g else 0), generator=gen, device=dev)
    g = bn_ops.as_rows((wide * 1e-3).to(torch.bfloat16)[..., :c])
    var, mean = torch.var_mean(x, dim=0, correction=0)
    inv = torch.rsqrt(var + 0.001)
    return x, g, mean, inv, beta - mean * inv


def _within_summation(got, want, scale):
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-5 * scale).all(), ((got - want).abs() / scale).max().item()


@pytest.mark.parametrize("hw,c", BN_SHAPES)
def test_batch_norm_kernels_match_plain(dev, hw, c):
    """Statistics within f32 summation-order error of the plain sums; the
    normalisation and the input gradient bit-equal given the same
    per-channel vectors; two launches bit-equal."""
    from tumblr_emotions_torch.ops import batch_norm as bn_ops

    x, g, mean, inv, shift = _bn_inputs(dev, hw, c, slice_g=hw == 35)
    assert (g.stride(0) == c + 16) == (hw == 35)
    s = bn_ops.sums(x)
    _within_summation(s, bn_ops.sums_plain(x), x.abs().sum(0))
    q = bn_ops.sums(x, mean)
    _within_summation(q, bn_ops.sums_plain(x, mean), bn_ops.sums_plain(x, mean))
    out = bn_ops.normalize(x, inv, shift)
    assert out.dtype == torch.bfloat16 and torch.equal(out, bn_ops.normalize_plain(x, inv, shift))
    gs = bn_ops.grad_sums(g, x, inv, shift, mean)
    gm = bn_ops._masked(g, x, inv, shift)
    scale = torch.cat([gm.abs().sum(0), (gm * (x - mean)).abs().sum(0)])
    _within_summation(gs, bn_ops.grad_sums_plain(g, x, inv, shift, mean), scale)
    n = x.shape[0]
    c1, c2 = -(inv * gs[:c]) / n, -(inv * inv * inv * gs[c:]) / n
    gy = bn_ops.grad(g, x, inv, shift, mean, c1, c2)
    assert gy.dtype == torch.float32
    assert torch.equal(gy, bn_ops.grad_plain(g, x, inv, shift, mean, c1, c2))
    again = (bn_ops.sums(x), bn_ops.sums(x, mean), bn_ops.normalize(x, inv, shift),
             bn_ops.grad_sums(g, x, inv, shift, mean), bn_ops.grad(g, x, inv, shift, mean, c1, c2))
    assert all(torch.equal(a, b) for a, b in zip(again, (s, q, out, gs, gy)))


def test_batch_norm_kernels_keep_subnormal_products(dev):
    """2^-64 x 2^-64 is an f32 subnormal, kept as PyTorch's kernels keep it
    (libdevice's mul_rn would flush it to 0 under Triton's FTZ setting)."""
    from tumblr_emotions_torch.ops import batch_norm as bn_ops

    x = torch.full((4096, 16), 2.0 ** -64, device=dev)
    inv, shift = torch.full((16,), 2.0 ** -64, device=dev), torch.zeros(16, device=dev)
    out = bn_ops.normalize(x, inv, shift)
    assert torch.equal(out, bn_ops.normalize_plain(x, inv, shift))
    assert out[0, 0].item() == 2.0 ** -128


def test_batch_norm_kernels_refuse_what_they_do_not_take(dev):
    from tumblr_emotions_torch.ops import batch_norm as bn_ops

    x, g, mean, inv, shift = _bn_inputs(dev, 8, 64)
    with pytest.raises(ValueError):
        bn_ops.normalize(x.to(torch.bfloat16), inv, shift)    # x must be f32
    with pytest.raises(ValueError):
        bn_ops.normalize(x, inv[:32], shift)                  # [C] vectors
    with pytest.raises(ValueError):
        bn_ops.grad_sums(g.float(), x, inv, shift, mean)      # g must be bf16


def test_captured_perf_train_steps_equal_eager_on_the_card(dev):
    """Four bf16 (perf) steps of fit captured bit-equal to four eager ones,
    every batch-normed conv through the fused step: its eight kernels a
    layer in the graph, and 96 normalisations launched a forward eagerly."""
    from tumblr_emotions_torch.ops import batch_norm as bn_ops

    cfg = _train_cfg("joint")
    cfg = cfg.replace(image=cfg.image.replace(dropout_keep_prob=0.8),
                      train=cfg.train.replace(precision_mode="perf"))
    batches = [_train_batch(cfg, seed) for seed in range(4)]
    state = _train_init(cfg)
    before = bn_ops.normalize.launches
    tr_e, ts_e = _fit_compiled(cfg, state, batches, dev, eager=True)
    assert bn_ops.normalize.launches - before == 4 * 96
    tr_c, ts_c = _fit_compiled(cfg, state, batches, dev, eager=False)
    _same_train_state(ts_c, ts_e)
    (graph,) = tr_c._programs["train"].kernel_nodes()
    fused = {k: n for k, n in graph["kernels"].items() if "bn_bf16_" in k}
    assert sum(fused.values()) == 8 * 96, fused
