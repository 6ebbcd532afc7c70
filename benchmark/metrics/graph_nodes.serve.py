"""Kernel nodes the card launches per served batch: the program's own
count of its captured graph's kernel nodes (``Captured.kernel_nodes``)."""


def read(r):
    if r is None:
        return None
    return r.counters.get("graph_nodes")
