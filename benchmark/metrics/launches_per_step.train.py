"""Device kernels per step, counted in the profiled stretch."""


def read(rec):
    n = sum(1 for e in rec["device"] if e[1] == "kernel")
    if not n or not rec["profiled"]["units"]:
        return None
    return n / rec["profiled"]["units"]
