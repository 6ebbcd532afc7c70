"""Device milliseconds per train step in NCCL's kernels on rank 0's card:
every all-reduce of the step (batch norm's statistics and their gradients,
the flat gradient, the loss and accuracy), each kernel's time including its
wait for the other ranks."""

NCCL = (r"nccl",)


def read(r):
    if r is None or r.trace is None or not r.units or not r.trace.kernels:
        return None
    return 1e3 * r.trace.kernel_s(NCCL) / r.units
