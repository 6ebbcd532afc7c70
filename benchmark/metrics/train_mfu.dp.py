"""Rank 0's share of the card's bf16 peak (989 TFLOP/s): ``train_mfu``'s
reader over the data-parallel cell's trace, whose rows are rank 0's."""

from pathlib import Path

from benchmark import cell

_TRAIN = cell.load_module(Path(__file__).resolve().parent / "train_mfu.py")


def read(r):
    return _TRAIN.read(r)
