"""Weight bridge between the JAX package's flax tree and the port's state dict.

It stands in for flax ``init`` and for the glue around
``synthsr_tpu/models/h5_import.py``:

- :func:`variables_to_state_dict` / :func:`state_dict_to_variables` convert
  ``{"params", "batch_stats"}`` (numpy, flax layout) to and from a
  ``UNet3D.state_dict()``: conv kernels DHWIO <-> OIDHW (permute (4,3,0,1,2),
  as tests/test_unet.py:134-137), BatchNorm scale/bias/mean/var <->
  weight/bias/running_mean/running_var;
- :func:`random_variables` builds seeded random weights in the flax layout
  with numpy alone, so both packages load the same numbers;
- :func:`load_unet_weights` fills a ``UNet3D`` from a Keras ``.h5`` (through
  ``load_keras_unet_weights`` and the bridge) or a ``torch.save``d state dict.
"""

from __future__ import annotations

import numpy as np
import torch

from synthsr_tpu.models.h5_import import load_keras_unet_weights

from .unet import SYNTHSR_CONFIG, unet_layers

_BN_KEYS = (("params", "scale", "weight"), ("params", "bias", "bias"),
            ("batch_stats", "mean", "running_mean"),
            ("batch_stats", "var", "running_var"))


def variables_to_state_dict(variables: dict) -> dict:
    """flax ``{"params", "batch_stats"}`` (array-likes) -> ``UNet3D`` state dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        if "scale" in p:  # BatchNorm
            src = {"params": p, "batch_stats": stats[name]}
            for coll, key, tkey in _BN_KEYS:
                sd[f"{name}.{tkey}"] = torch.from_numpy(
                    np.array(src[coll][key], np.float32))
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
        else:
            k = np.array(p["kernel"], np.float32)
            sd[f"{name}.weight"] = torch.from_numpy(k).permute(4, 3, 0, 1, 2).contiguous()
            sd[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return sd


def state_dict_to_variables(sd: dict) -> dict:
    """``UNet3D`` state dict -> flax ``{"params", "batch_stats"}`` of numpy arrays."""
    params, stats = {}, {}
    names = sorted({k.rsplit(".", 1)[0] for k in sd})
    for name in names:
        if f"{name}.running_mean" in sd:
            params[name], stats[name] = {}, {}
            for coll, key, tkey in _BN_KEYS:
                dst = params[name] if coll == "params" else stats[name]
                dst[key] = sd[f"{name}.{tkey}"].detach().cpu().numpy()
        else:
            w = sd[f"{name}.weight"].detach().cpu()
            params[name] = {"kernel": w.permute(2, 3, 4, 1, 0).contiguous().numpy(),
                            "bias": sd[f"{name}.bias"].detach().cpu().numpy()}
    return {"params": params, "batch_stats": stats}


def random_variables(cfg: dict | None = None, in_channels: int = 1, seed: int = 0) -> dict:
    """Seeded random U-Net weights in the flax layout, numpy only.

    He-style conv kernels (std sqrt(2 / fan_in)), BatchNorm var in [0.5, 1.5],
    so the full-width 18-conv net keeps O(1) activations and tolerances
    stay meaningful.  The likelihood is scaled so that a 1-label linear head
    predicts about 0.25 +- 0.1, inside the predict CLI's [0, 128] / 255
    output window.  Keys missing from ``cfg`` take the shipped configuration's
    values."""
    cfg = dict(SYNTHSR_CONFIG, **(cfg or {}))
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    k = cfg.get("conv_size", 3)
    for name, kind, cin, cout in unet_layers(cfg, in_channels):
        if kind == "conv":
            std = np.sqrt(2.0 / (k ** 3 * cin))
            params[name] = {
                "kernel": (rng.standard_normal((k, k, k, cin, cout)) * std).astype(np.float32),
                "bias": (rng.standard_normal(cout) * 0.05).astype(np.float32)}
        elif kind == "bn":
            params[name] = {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}
            stats[name] = {"mean": (rng.standard_normal(cout) * 0.1).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
        else:
            params[name] = {
                "kernel": (rng.standard_normal((1, 1, 1, cin, cout))
                           * 0.1 / np.sqrt(cin)).astype(np.float32),
                "bias": np.full(cout, 0.25, np.float32)}
    return {"params": params, "batch_stats": stats}


def load_unet_weights(model, model_path: str):
    """Fill ``model`` (a ``UNet3D``) from ``.h5`` (Keras; a ``random_variables``
    tree is the shape template) or a ``torch.save``d state dict (``.pt`` /
    ``.pth``)."""
    if model_path.endswith(".h5"):
        template = random_variables(model.config, model.in_channels)
        sd = variables_to_state_dict(load_keras_unet_weights(model_path, template))
    elif model_path.endswith((".pt", ".pth")):
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"unsupported weights format: {model_path}")
    model.load_state_dict(sd)
    return model
