"""Device idle milliseconds an iteration while the innermost of the
program's layer spans open on the host is of layer
``limb_kernels`` (the launchers of ``ops/limb_kernels.py``):
``portbench/layers.py``."""

from portbench import layers


def read(run):
    return layers.idle_ms(run, "limb_kernels")
