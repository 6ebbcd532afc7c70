"""Host milliseconds per step that rank 0 waits in the program's
``prefetch.wait``: ``prefetch_wait_ms.train``'s reader over the
data-parallel cell's trace."""

from pathlib import Path

from benchmark import cell

_TRAIN = cell.load_module(Path(__file__).resolve().parent / "prefetch_wait_ms.train.py")


def read(r):
    return _TRAIN.read(r)
