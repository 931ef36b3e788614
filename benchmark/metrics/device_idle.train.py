"""The share of the profiled stretch in which no kernel, copy or set ran
on the device (one minus the union of their intervals over the wall)."""

from harness import busy_seconds


def read(rec):
    if rec["profiled"]["seconds"] <= 0 or not rec["device"]:
        return None
    return 100.0 * (1.0 - busy_seconds(rec["device"]) / rec["profiled"]["seconds"])
