"""Device idle milliseconds an iteration while the innermost of the
program's layer spans open on the host is of layer ``phases``
(``solver/bucket_iteration.py``: the residues and the step's phases):
``portbench/layers.py``."""

from portbench import layers


def read(run):
    return layers.idle_ms(run, "phases")
