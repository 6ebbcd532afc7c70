"""Host milliseconds per train step that the consumer waits in the device
feed's ``next()`` for the producer's batch and its copy: the program's
``prefetch.wait`` spans (``data/pipeline.DevicePrefetchIterator``), inside
the benchmark's ``feed`` span."""

from benchmark import program_spans

SPAN = "prefetch.wait"


def read(r):
    return program_spans.ms_per_unit(r, SPAN)
