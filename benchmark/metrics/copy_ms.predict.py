"""Device milliseconds per volume of host<->device copies (Memcpy HtoD and
DtoH: the resample's round trip, the input, the output), from the profiled
stretch."""


def read(rec):
    ms = [e[3] - e[2] for e in rec["device"]
          if e[1] == "gpu_memcpy" and ("HtoD" in e[0] or "DtoH" in e[0])]
    if not ms or not rec["profiled"]["units"]:
        return None
    return 1e3 * sum(ms) / rec["profiled"]["units"]
