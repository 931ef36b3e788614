"""``Predictor.predict_volume`` of the port from several checkouts, in turns on
one card.  Each checkout (a directory holding ``synthsr_tpu_torch/``) runs in
a process of its own, in the order given and then reversed (A B B A for two),
on the same seeded random weights and synthetic volumes as ``chip_smoke.py``:
the 256x256x128 T1 at 1x1x2 mm (256^3 after resampling), the clinical scan
that pads to 192x224x192 and the 1 mm CT that pads to 192x256x512.  Each
process builds its checkout's kernels, warms each volume up once, then times
``REPS`` predict_volume calls (host clock around a synchronised call) and the
flip-TTA network (CUDA events).

    python3 tools/ab_predict_volume.py PARENT_CHECKOUT .

Needs one CUDA GPU and nvcc.  Prints the card's name and power limit, one
JSON line per process, then per (volume, checkout) the median and range.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
from ab_common import open_checkout, run_in_turns, turns_main

REPS = 5
NET_REPS = 3


def worker(checkout):
    smoke = open_checkout(checkout)
    import torch
    from synthsr_tpu_torch.cli import predict
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
    from synthsr_tpu_torch.ops import conv_cf

    conv_cf.build_kernels()
    rng = np.random.default_rng(0)
    vols = [*smoke.VOLUMES[:2], (*smoke.LARGE_FOV, True)]  # the 256^3 T1, clinical, large FOV
    result = {"checkout": str(checkout), "volumes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(variables_to_state_dict(random_variables(seed=0)), weights)
        predictors = {ct: predict.Predictor(model_path=weights, ct=ct) for ct in (False, True)}
        for name, shape, zooms, ct in vols:
            vol = smoke.phantom(shape, zooms, ct, rng)
            aff = np.diag(list(zooms) + [1.0])
            pred = predictors[ct]
            pred.predict_volume(vol, aff)  # warm-up
            x = pred.prepare(vol, aff)[0]
            net_ms = smoke.cuda_ms(lambda: pred.network(x), NET_REPS)
            del x
            secs = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.predict_volume(vol, aff)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            result["volumes"][name] = {"predict_volume_ms": [1e3 * s for s in secs],
                                       "network_tta_ms": net_ms}
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


def main(checkouts):
    runs = run_in_turns(__file__, checkouts)
    for name in runs[0]["volumes"]:
        for checkout in dict.fromkeys(r["checkout"] for r in runs):
            mine = [r["volumes"][name] for r in runs if r["checkout"] == checkout]
            ms = [t for r in mine for t in r["predict_volume_ms"]]
            net = [r["network_tta_ms"] for r in mine]
            print(f"  {name:24s} {checkout}: predict_volume median {np.median(ms):.1f} ms "
                  f"(range {min(ms):.1f}-{max(ms):.1f}, {len(ms)} calls); network "
                  f"{', '.join(f'{t:.1f}' for t in net)} ms", flush=True)


if __name__ == "__main__":
    turns_main(__doc__, worker, main)
