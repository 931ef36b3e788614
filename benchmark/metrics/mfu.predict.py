"""The conv operations of the volumes completed in the traced window over
its wall time, as a share of the H100's bf16 peak (989 TFLOP/s)."""

from work import MFU_PEAK


def read(rec):
    w = rec["window"]
    if not w["units"] or w["seconds"] <= 0:
        return None
    return 100.0 * w["flops"] / (w["seconds"] * MFU_PEAK)
