"""The 90th percentile of the turnaround of every volume of the traced
window (host clock around each ``predict_volume``), the highest percentile
with at least ten volumes beyond it at 51 s.  Not an end-to-end metric: on
these machines its spread from run to run is too wide for any bound the
benchmark may set (PERF.md)."""

import numpy as np


def read(rec):
    lat = rec["window"].get("latencies") or []
    if len(lat) < 10:
        return None
    return float(np.percentile(lat, 90))
