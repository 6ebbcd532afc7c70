"""All-reduces one train step issues, from the program's count of the step it
recorded into its graph (``Trainer.collectives``, read by the driver into
``counters``); None where the program keeps no such count."""


def read(r):
    if r is None or "allreduces" not in r.counters:
        return None
    return float(r.counters["allreduces"])
