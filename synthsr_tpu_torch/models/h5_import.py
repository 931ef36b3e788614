"""Import Keras .h5 checkpoints (the shipped SynthSR weights) into flax-layout
trees of numpy arrays: the port's own copy of ``synthsr_tpu/models/h5_import.py``
(``models/weights.py`` bridges the trees to a ``UNet3D`` state dict).

The reference distributes ``models/SynthSR_v10_210712.h5`` and
``..._hyperfine.h5`` (models/models.txt:1-2) and loads them with
``load_weights(by_name=True)`` (scripts/predict_command_line.py:79).  Keras
Conv3D kernels are stored as (k, k, k, in, out) with bias (out,) — exactly the
flax ``nn.Conv`` layout in NDHWC, so import is a rename, not a transpose.
BatchNormalization layers map gamma/beta -> params.scale/bias and
moving_mean/moving_variance -> batch_stats.mean/var.

Also implements the reference's warm-start rename trick: loading
segmentation-pretrained weights while skipping the incompatible
``unet_likelihood`` head (training.py:356-369) maps to simply dropping that
layer from the imported tree.
"""

from __future__ import annotations

import numpy as np

# Keras weight name -> (flax collection, flax param name)
_KERAS_TO_FLAX = {
    "kernel": ("params", "kernel"),
    "bias": ("params", "bias"),
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}
_FLAX_TO_KERAS_CONV = {"kernel": "kernel", "bias": "bias"}
_FLAX_TO_KERAS_BN = {("params", "scale"): "gamma", ("params", "bias"): "beta",
                     ("batch_stats", "mean"): "moving_mean",
                     ("batch_stats", "var"): "moving_variance"}


def _collect_weight_groups(h5file):
    """Find {layer_name: {weight_name: array}} in either a full-model save
    (group 'model_weights') or a save_weights file (layers at root)."""
    import h5py

    root = h5file["model_weights"] if "model_weights" in h5file else h5file
    layers = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            parts = name.split("/")
            w_name = parts[-1].split(":")[0]
            layer = parts[-2]
            layers.setdefault(layer, {})[w_name] = np.asarray(obj)

    root.visititems(visit)
    return layers


def _is_bn(layer_tree: dict) -> bool:
    return "scale" in layer_tree or "mean" in layer_tree


def load_keras_unet_weights(path: str, variables: dict, prefix: str = "unet_",
                            skip_layers=()) -> dict:
    """Fill a flax UNet3D variables dict from a Keras .h5 file.

    :param variables: template ``{"params": ..., "batch_stats": ...}`` from
        ``model.init``; layer names must be the reference names minus ``prefix``.
    :param skip_layers: flax layer names left at template values — e.g.
        ('likelihood',) replicates the reference seg-pretrained warm start
        (training.py:356-369).
    :return: new variables dict; raises if a non-skipped weight is missing.
    """
    import h5py

    with h5py.File(path, "r") as f:
        h5_layers = _collect_weight_groups(f)

    stripped = {}
    for name, weights in h5_layers.items():
        key = name[len(prefix):] if name.startswith(prefix) else name
        stripped[key] = weights

    out = {coll: {} for coll in variables}
    layer_names = set()
    for coll in variables:
        layer_names |= set(variables[coll].keys())

    for lname in layer_names:
        if lname in skip_layers:
            for coll in variables:
                if lname in variables[coll]:
                    out[coll][lname] = variables[coll][lname]
            continue
        if lname not in stripped:
            raise KeyError(f"layer '{lname}' not found in {path} "
                           f"(available: {sorted(stripped)[:8]}...)")
        src = stripped[lname]
        for kname, arr in src.items():
            if kname not in _KERAS_TO_FLAX:
                raise KeyError(f"unknown Keras weight '{kname}' in layer '{lname}'")
            coll, pname = _KERAS_TO_FLAX[kname]
            if coll not in variables or lname not in variables[coll]:
                raise KeyError(f"model has no {coll}/{lname} for Keras weight {kname}")
            tmpl = variables[coll][lname][pname]
            arr = np.asarray(arr, np.float32)
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {lname}/{pname}: "
                                 f"h5 {arr.shape} vs model {tuple(tmpl.shape)}")
            out[coll].setdefault(lname, {})[pname] = arr
        # sanity: all template weights for this layer were covered
        for coll in variables:
            if lname in variables[coll]:
                missing = set(variables[coll][lname]) - set(out[coll].get(lname, {}))
                if missing:
                    raise KeyError(f"weights {missing} of {coll}/{lname} missing in {path}")
    return out


def export_keras_unet_weights(path: str, variables: dict, prefix: str = "unet_") -> None:
    """Write flax UNet3D variables as a Keras-style weights .h5 (round-trips via
    load_keras_unet_weights; also lets users move back to the reference)."""
    import h5py

    params = variables.get("params", {})
    batch_stats = variables.get("batch_stats", {})
    layer_names = list(params.keys())

    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        names = []
        for lname in layer_names:
            kname = prefix + lname
            lg = g.create_group(kname).create_group(kname)
            wnames = []
            tree = params[lname]
            if _is_bn(tree) or lname in batch_stats:
                items = [(("params", p), v) for p, v in tree.items()]
                items += [(("batch_stats", p), v) for p, v in batch_stats.get(lname, {}).items()]
                for key, arr in items:
                    kw = _FLAX_TO_KERAS_BN[key]
                    lg.create_dataset(f"{kw}:0", data=np.asarray(arr, np.float32))
                    wnames.append(f"{kname}/{kw}:0".encode())
            else:
                for pname, arr in tree.items():
                    kw = _FLAX_TO_KERAS_CONV[pname]
                    lg.create_dataset(f"{kw}:0", data=np.asarray(arr, np.float32))
                    wnames.append(f"{kname}/{kw}:0".encode())
            g[kname].attrs["weight_names"] = wnames
            names.append(kname.encode())
        g.attrs["layer_names"] = names
