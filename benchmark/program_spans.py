"""The program's own spans in a traced window: the port's profiler ranges
(``tumblr_emotions_torch/utils/summaries.span``), which ``devtrace.to_trace``
keeps among the window thread's host operations (``Trace.host_ops``).  A
checkout whose program has no such span reads None."""


def ms_per_unit(r, name: str):
    """Milliseconds per unit of work (``r.units``: batches or steps) in the
    spans called ``name`` on the window's thread, each clipped to the
    window; None where the window holds none."""
    if r is None or r.trace is None or not r.units:
        return None
    tr = r.trace
    spans = [(a, b) for n, a, b in tr.host_ops if n == name]
    if not spans:
        return None
    return sum(max(0, min(b, tr.hi) - max(a, tr.lo)) for a, b in spans) / 1e6 / r.units
