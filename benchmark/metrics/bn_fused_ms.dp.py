"""Device milliseconds per train step on rank 0's card in the bf16 train
step's batch-norm kernels (``tumblr_emotions_torch/ops/batch_norm.py``,
every name ``bn_bf16_*``): the statistics, the normalisation with its ReLU,
and their backward, for the tower's batch-normed convs.  The layer's time
("model in train mode") is this plus ``bn_pass_ms.dp``, whose patterns
match none of these names.  Nothing when no such kernel ran in the window
(a program without them)."""

KERNELS = (r"bn_bf16_",)


def read(r):
    if r is None or r.trace is None or not r.units or not r.trace.kernels:
        return None
    s = r.trace.kernel_s(KERNELS)
    return 1e3 * s / r.units if s else None
