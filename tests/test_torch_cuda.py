"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests skip without an NVIDIA card.
On one:  python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops import fused_inception as fi
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


@pytest.mark.parametrize("hw,c", [(35, 144), (17, 384)])
def test_avg_pool_kernel_matches_plain(dev, hw, c):
    x = _act(dev, 2, hw, hw, c)
    _close(fi.avg_pool3_same(x), fi.avg_pool3_same_plain(x))


def test_avg_pool_kernel_rejects_what_it_does_not_take(dev):
    x = _act(dev, 1, 17, 17, 24)
    with pytest.raises(ValueError):
        fi.avg_pool3_same(x[..., :20].contiguous())          # C % 8
    with pytest.raises(ValueError):
        fi.avg_pool3_same(x[..., :16])                       # not contiguous
    with pytest.raises(ValueError):
        fi.avg_pool3_same(x.float())                         # f32


@pytest.mark.parametrize("scope", ["Mixed_5b", "Mixed_5c", "Mixed_6b", "Mixed_6e"])
def test_block_kernels_match_plain(dev, taps, scope):
    cin = taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1]
    hw = 35 if scope.startswith("Mixed_5") else 17
    x = _act(dev, 2, hw, hw, cin, seed=1)
    if scope.startswith("Mixed_5"):
        q = scope == "Mixed_5c"
        got, want = fi.fused_inception_a(x, taps, scope, q), fi.fused_inception_a_plain(x, taps, scope, q)
    else:
        got, want = fi.fused_inception_b(x, taps, scope), fi.fused_inception_b_plain(x, taps, scope)
    _close(got, want)
