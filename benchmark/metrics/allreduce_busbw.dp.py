"""The gradient all-reduce's share of its roofline on rank 0's card: its bus
bandwidth, 2(n - 1)/n x its bytes over its device time (the bytes each rank
sends and receives in a ring all-reduce of n ranks), over NVLink's 450 GB/s
a direction of an H100 SXM.  The bytes are the program's count of the flat
gradient (``Trainer.collectives``, ``allreduce_bytes.gradient``); the
kernel is each step's all-reduce issued second to last (the flat gradient,
before the loss and accuracy), found by its place among the step's NCCL
kernels, the program's count of a step's all-reduces apart.  None where the
program keeps no count, or the window's NCCL kernels are not whole steps."""

NVLINK_BYTES_S = 450e9


def bus_bytes(counters):
    """Bytes each rank moves each way in the ring all-reduce of the flat
    gradient: 2(n - 1)/n x its size; None without the program's count."""
    if "allreduce_bytes.gradient" not in counters:
        return None
    n = counters["processes"]
    return 2.0 * (n - 1) / n * counters["allreduce_bytes.gradient"]


def gradient_kernels(r):
    """(start, end) of each step's gradient all-reduce on the card."""
    import re

    per_step = int(r.counters.get("allreduces", 0))
    rx = re.compile("nccl", re.IGNORECASE)
    nccl = sorted((a, b) for n, a, b in r.trace.kernels if rx.search(n))
    if not per_step or len(nccl) != per_step * r.units:
        return None
    return [nccl[i] for i in range(per_step - 2, len(nccl), per_step)]


def read(r):
    if r is None or r.trace is None or not r.units:
        return None
    nbytes = bus_bytes(r.counters)
    spans = gradient_kernels(r) if nbytes else None
    if not spans:
        return None
    seconds = sum(b - a for a, b in spans) / 1e9 / len(spans)
    return 100.0 * nbytes / seconds / NVLINK_BYTES_S
