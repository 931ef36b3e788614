"""The least time of the profiled steps' 3x3x3 conv work (forward, dx but
the first conv's, dw; ``work.py``) as a share of the device time of the
kernels launched outside ``generate_batch``."""


def read(rec):
    busy = sum(e[3] - e[2] for e in rec["device"]
               if e[1] == "kernel" and e[4] != "generate_batch")
    if busy <= 0:
        return None
    return 100.0 * rec["profiled"]["least_s"] / busy
