"""Device idle milliseconds an iteration while the innermost of the
program's layer spans open on the host is of layer ``panels`` (a panel
step of a blocked factorization or substitution in ``mp/linalg.py``,
opened only above 64 rows): ``portbench/layers.py``.  None where no
such span covered an idle gap, as in a program without the layer."""

from portbench import layers


def read(run):
    got = layers.readings(run)
    if got is None or got["idle_ms"] is None:
        return None
    return got["idle_ms"].get("panels")
