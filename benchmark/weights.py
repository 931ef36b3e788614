"""Seeded random weights of the SynthSR U-Net, made on the device.

The shipped weights are not in the repository, so every configuration runs
weights drawn from the run's seed at the shipped shapes: He-style 3x3x3
kernels (std sqrt(2 / fan_in)), biases of std 0.05, BatchNorm scale in
[0.8, 1.2], shift and mean of std 0.1, variance in [0.5, 1.5], and a linear
1x1x1 head that predicts about 0.25 +- 0.1, inside the predict output's
[0, 128] / 255 window.  Each kind is one draw from one generator on the
device.  The names and layouts (OIDHW) are those of a ``UNet3D`` state dict.
"""

from __future__ import annotations

import torch

from work import unet_convs


def unet_layout(cfg: dict, in_channels: int):
    """(convs [(name, C_in, C_out)], batch norms [(name, C)], head (C_in, C_out))."""
    convs = [(name, sum(cins), cout)
             for name, cins, cout, _ in unet_convs(cfg, in_channels, (1, 1, 1))]
    nl, nf, fm = cfg["nb_levels"], cfg["nb_features"], cfg["feat_mult"]
    feats = [int(round(nf * fm ** level)) for level in range(nl)]
    bns = [(f"bn_down_{level}", feats[level]) for level in range(nl)]
    bns += [(f"bn_up_{level}", feats[nl - 2 - level]) for level in range(nl - 1)]
    return convs, bns, (convs[-1][2], cfg["nb_labels"])


def make_unet_weights(cfg: dict, in_channels: int, gen: torch.Generator, device) -> dict:
    convs, bns, (hin, hout) = unet_layout(cfg, in_channels)
    k = cfg["conv_size"]
    f32 = dict(dtype=torch.float32, device=device)
    sizes = [cout * cin * k ** 3 for _, cin, cout in convs]
    kernels = torch.randn(sum(sizes), generator=gen, **f32).split(sizes)
    biases = (torch.randn(sum(c for _, _, c in convs), generator=gen, **f32) * 0.05) \
        .split([c for _, _, c in convs])
    sd = {}
    for (name, cin, cout), w, b in zip(convs, kernels, biases):
        sd[f"{name}.weight"] = (w * (2.0 / (k ** 3 * cin)) ** 0.5).reshape(cout, cin, k, k, k)
        sd[f"{name}.bias"] = b
    widths = [c for _, c in bns]
    n = sum(widths)
    u = torch.rand(2, n, generator=gen, **f32)
    z = torch.randn(2, n, generator=gen, **f32) * 0.1
    parts = [t.split(widths) for t in (0.8 + 0.4 * u[0], z[0], z[1], 0.5 + u[1])]
    for i, (name, c) in enumerate(bns):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = parts[0][i], parts[1][i]
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = parts[2][i], parts[3][i]
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    sd["likelihood.weight"] = (torch.randn(hout, hin, generator=gen, **f32)
                               * 0.1 / hin ** 0.5).reshape(hout, hin, 1, 1, 1)
    sd["likelihood.bias"] = torch.full((hout,), 0.25, **f32)
    return {key: v.contiguous() for key, v in sd.items()}
