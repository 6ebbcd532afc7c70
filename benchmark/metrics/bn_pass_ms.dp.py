"""Device milliseconds per train step on rank 0's card in PyTorch's
elementwise and reduction kernels: ``bn_pass_ms.train``'s patterns, less
NCCL's kernels (``allreduce_ms.dp``'s pattern: NCCL's all-reduce kernels
hold "Reduce" in their names)."""

from pathlib import Path

from benchmark import cell

_HERE = Path(__file__).resolve().parent
_PASSES = cell.load_module(_HERE / "bn_pass_ms.train.py").PASSES
_NCCL = cell.load_module(_HERE / "allreduce_ms.dp.py").NCCL


def read(r):
    if r is None or r.trace is None or not r.units or not r.trace.kernels:
        return None
    # the passes that are not NCCL's: (passes or NCCL) less NCCL
    return 1e3 * (r.trace.kernel_s(_PASSES + _NCCL) - r.trace.kernel_s(_NCCL)) / r.units
