"""The all-reduces of one data-parallel train step, counted by the program
(``parallel/distributed.counting``, ``Trainer.collectives``) and shown as
``dp.allreduce`` spans: on the CPU over a gloo group of one process, which
takes the collective path (``parallel/mesh.Mesh`` with a group).

The expected counts are derived from the model, not written down: each
train-mode batch norm all-reduces its sums and its squared deviations
forward, and the gradients of both backward (four); the step then sums the
flat gradient once and its loss and accuracy once."""

import uuid

import pytest
import torch

from tumblr_emotions_torch import get_preset
from tumblr_emotions_torch.models import build_model, joint_model
from tumblr_emotions_torch.models.layers import SlimBatchNorm
from tumblr_emotions_torch.parallel import distributed
from tumblr_emotions_torch.parallel.mesh import Mesh
from tumblr_emotions_torch.train.trainer import Trainer

B, IMAGE = 2, 75


@pytest.fixture
def group(tmp_path):
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / ('rendezvous.' + uuid.uuid4().hex)}",
        world_size=1, rank=0)
    try:
        yield torch.distributed.group.WORLD
    finally:
        torch.distributed.destroy_process_group()


def _trainer(group, precision):
    cfg = get_preset("data_parallel")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.25, image_size=IMAGE,
                                              min_depth=8, create_aux_logits=False),
                      text=cfg.text.replace(vocab_size=50, max_len=6),
                      train=cfg.train.replace(batch_size=B, precision_mode=precision))
    tr = Trainer(cfg, device="cpu", mesh=Mesh(1, 0, group))
    return tr, tr.init_state(joint_model.init_state(build_model(cfg, device="meta"), 0))


def _batch():
    g = torch.Generator().manual_seed(0)
    return {"image": torch.rand(B, IMAGE, IMAGE, 3, generator=g) * 2 - 1,
            "tokens": torch.randint(2, 50, (B, 6), generator=g, dtype=torch.int32),
            "lengths": torch.tensor([6, 3], dtype=torch.int32),
            "label": torch.tensor([1, 4])}


@pytest.mark.parametrize("precision", ["perf", "parity"])
def test_one_step_counts_four_all_reduces_a_batch_norm_and_two_more(group, precision):
    tr, ts = _trainer(group, precision)
    norms = [m for m in tr.model.modules() if isinstance(m, SlimBatchNorm)]
    trainable = [ts.state[k] for k in tr.trainable_keys(ts)]
    assert tr.collectives is None
    ts, _ = tr.train_step(ts, _batch(), torch.Generator().manual_seed(1))
    c = tr.collectives
    assert c.calls == {"batch_norm": 4 * len(norms), "gradient": 1, "statistics": 1,
                       "other": 0}
    assert c.total() == 4 * len(norms) + 2
    assert c.bytes["gradient"] == 4 * sum(t.numel() for t in trainable)
    assert c.bytes["batch_norm"] == 4 * 4 * sum(m.beta.numel() for m in norms)
    assert c.bytes["statistics"] == 2 * 4
    # counted anew by each step run op by op: the same numbers
    ts, _ = tr.train_step(ts, _batch(), torch.Generator().manual_seed(2))
    assert tr.collectives is not c and tr.collectives.calls == c.calls


def test_each_all_reduce_of_an_op_by_op_step_is_a_span(group):
    tr, ts = _trainer(group, "perf")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train_step(ts, _batch(), torch.Generator().manual_seed(1))
    spans = [e for e in prof.events() if e.name == "dp.allreduce"]
    assert len(spans) == tr.collectives.total()


def test_counting_nests(group):
    t = torch.ones(3)
    with distributed.counting() as outer:
        distributed.all_reduce_(t, group, "gradient")
        with distributed.counting() as inner:
            distributed.all_reduce_(t, group, "statistics")
        distributed.all_reduce_(t, group)
    assert outer.calls == {"batch_norm": 0, "gradient": 1, "statistics": 0, "other": 1}
    assert inner.calls["statistics"] == 1 and inner.bytes["statistics"] == 12
