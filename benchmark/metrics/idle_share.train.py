"""Share of the traced training window in which no operation ran on the card
(kernels, copies and fills), from the device trace: 1 - busy / window."""


def read(r):
    if r is None or r.trace is None or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
