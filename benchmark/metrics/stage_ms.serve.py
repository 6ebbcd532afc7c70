"""Host milliseconds per served batch spent copying the batch's host
arrays into the captured program's pinned staging buffers: the program's
``captured.stage`` spans (``utils/compile_opts.Captured``)."""

from benchmark import program_spans

SPAN = "captured.stage"


def read(r):
    return program_spans.ms_per_unit(r, SPAN)
