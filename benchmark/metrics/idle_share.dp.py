"""Share of the traced window in which no operation ran on rank 0's card:
``idle_share.train``'s reader over the data-parallel cell's trace."""

from pathlib import Path

from benchmark import cell

_TRAIN = cell.load_module(Path(__file__).resolve().parent / "idle_share.train.py")


def read(r):
    return _TRAIN.read(r)
