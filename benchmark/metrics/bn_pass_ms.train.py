"""Device milliseconds per train step in PyTorch's elementwise and
reduction kernels (``profile_serving``'s groups): batch norm's statistics
and normalisation, the bf16 casts and roundings, ReLU and dropout, forward
and backward."""

PASSES = (r"elementwise", r"reduce")


def read(r):
    if r is None or r.trace is None or not r.units or not r.trace.kernels:
        return None
    return 1e3 * r.trace.kernel_s(PASSES) / r.units
