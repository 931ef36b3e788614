"""Host milliseconds per volume in ``Predictor.prepare`` (resample,
alignment, normalisation, pad and the copies inside them), by the host
clock of the benchmark's span around each call, over the traced window."""


def read(rec):
    s = rec["spans"].get("prepare")
    if not s or not s["count"]:
        return None
    return 1e3 * s["seconds"] / s["count"]
