"""The program's count of syncs (the host waiting on a device value,
``syncs`` of ``sdpb_tpu_torch/utils/timers.py``) an iteration over the
traced iterations: ``portbench/layers.py``."""

from portbench import layers


def read(run):
    return layers.syncs(run)
