"""Helpers of the benchmark's CPU tests: the benchmark's modules on the
path, and each cell cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import harness  # noqa: E402

# the train cell's network at two levels of 4 features; the predict entry
# always builds the shipped network (Predictor), which runs at 32^3 here
TINY_NET = {"nb_features": 4, "nb_levels": 2, "conv_size": 3, "nb_labels": 1,
            "feat_mult": 2, "nb_conv_per_level": 2, "activation": "elu",
            "final_pred_activation": "linear"}


def tiny(cell: str):
    """(workload, config) of ``cell`` at a CPU size: scans an eighth of their
    size per axis (one of each acquisition), label maps of 40^3 cut to 32^3."""
    wl = copy.deepcopy(harness.workload(cell))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    tr = wl["traffic"]
    if "acquisitions" in tr:
        for a in tr["acquisitions"]:
            a["shape"] = [max(4, s // 8) for s in a["shape"]]
            a["count"] = 1
        tr.pop("padded", None)
    else:
        cfg["network"] = dict(TINY_NET)
        tr["label_maps"]["size"] = 40
        cfg["training"]["output_shape"] = 32
        cfg["training"]["loss_cropping"] = 24
    return wl, cfg


def cells():
    return [w["name"] for w in harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
            ["workloads"]]
