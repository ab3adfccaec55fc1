"""Device idle milliseconds an iteration while the innermost of the
program's layer spans open on the host is of layer
``glue`` (``ops/mpmm.py``, ``ops/exact.py``, ``mp/core.py``):
``portbench/layers.py``."""

from portbench import layers


def read(run):
    return layers.idle_ms(run, "glue")
