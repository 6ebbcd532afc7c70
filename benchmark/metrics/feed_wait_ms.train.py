"""Host milliseconds per step spent waiting in ``next()`` on the device
feed (``DevicePrefetchIterator``), from the benchmark's ``feed`` spans."""


def read(r):
    if r is None or r.trace is None:
        return None
    waits = r.trace.span_s("feed")
    return 1e3 * sum(waits) / len(waits) if waits else None
