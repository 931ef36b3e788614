"""Host milliseconds per step in ``train.training.generate_batch`` (the
synthetic pair's generation, launch-bound), by the host clock of the
benchmark's span around each call, over the traced window."""


def read(rec):
    s = rec["spans"].get("generate_batch")
    if not s or not s["count"]:
        return None
    return 1e3 * s["seconds"] / s["count"]
