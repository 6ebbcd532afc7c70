"""Host milliseconds per served batch in the launch of its captured graph
(``CUDAGraph.replay``): the program's ``captured.launch`` spans
(``utils/compile_opts.Captured``)."""

from benchmark import program_spans

SPAN = "captured.launch"


def read(r):
    return program_spans.ms_per_unit(r, SPAN)
