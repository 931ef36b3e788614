"""The least time of the profiled volumes' 3x3x3 conv work (``work.py``,
from the shapes) as a share of the device time of the kernels launched
inside ``Predictor.network``."""


def read(rec):
    busy = sum(e[3] - e[2] for e in rec["device"] if e[1] == "kernel" and e[4] == "network")
    if busy <= 0:
        return None
    return 100.0 * rec["profiled"]["least_s"] / busy
