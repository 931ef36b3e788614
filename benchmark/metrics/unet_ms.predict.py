"""Device milliseconds per volume of every kernel launched inside
``Predictor.network`` (the flip-TTA pair of the U-Net), from the profiled
stretch."""


def read(rec):
    ms = [e[3] - e[2] for e in rec["device"] if e[1] == "kernel" and e[4] == "network"]
    if not ms or not rec["profiled"]["units"]:
        return None
    return 1e3 * sum(ms) / rec["profiled"]["units"]
