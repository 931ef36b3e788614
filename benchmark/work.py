"""The yardstick's arithmetic: the work of the U-Net's 3x3x3 convolutions,
counted from their shapes, and the published peaks of one NVIDIA H100.

The least time of a conv is the larger of its operations over the peak rate
of its type and its bytes over the memory rate, each input read once and each
output written once whatever a kernel reads again (the same rule as
``chip_smoke.bound`` at the parent of this benchmark).  It depends only on
the shapes, so a roofline share reads the same work whatever kernel runs it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FLOPS = {"bfloat16": 989e12,
              # float32-accurate work as split TF32: three TF32 products a product
              "float32": 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
MFU_PEAK = PEAK_FLOPS["bfloat16"]  # every mfu is a share of the bf16 tensor peak
ITEMSIZE = {"bfloat16": 2, "float32": 4}
TAPS = 27


def unet_convs(cfg: dict, in_channels: int, spatial) -> list:
    """[(name, source channels, C_out, spatial)] of every 3x3x3 conv of the
    SynthSR U-Net in forward order: ``nb_conv_per_level`` convs a level, the
    encoder at ``nb_features * feat_mult ** level`` features, each decoder
    level's first conv reading [skip, upsampled] as two sources, every
    spatial size halved per level."""
    nl, nf, fm = cfg["nb_levels"], cfg["nb_features"], cfg["feat_mult"]
    ncpl = cfg["nb_conv_per_level"]
    convs, cin, skips = [], in_channels, []
    for level in range(nl):
        shape = tuple(int(s) // 2 ** level for s in spatial)
        feats = int(round(nf * fm ** level))
        for c in range(ncpl):
            convs.append((f"conv_downarm_{level}_{c}", (cin,), feats, shape))
            cin = feats
        skips.append(feats)
    for level in range(nl - 1):
        src = nl - 2 - level
        shape = tuple(int(s) // 2 ** src for s in spatial)
        feats = int(round(nf * fm ** src))
        for c in range(ncpl):
            srcs = (skips[src], cin) if c == 0 else (cin,)
            convs.append((f"conv_uparm_{nl + level}_{c}", srcs, feats, shape))
            cin = feats
    return convs


def voxels(spatial) -> int:
    n = 1
    for s in spatial:
        n *= int(s)
    return n


def conv_flops(cins, cout, spatial) -> float:
    """Multiply-adds of one 3x3x3 conv (or its dx or dw) counted as 2 operations."""
    return 2.0 * TAPS * sum(cins) * cout * voxels(spatial)


def conv_bytes(cins, cout, spatial, kind: str, dtype: str = "bfloat16") -> float:
    """Bytes a conv must move: its activations in ``dtype``, its weights in
    ``dtype``, and for ``dw`` the float32 gradient it writes."""
    it = ITEMSIZE[dtype]
    acts = (sum(cins) + cout) * voxels(spatial) * it
    weights = TAPS * sum(cins) * cout
    if kind == "dw":
        return acts + weights * 4
    if kind in ("fwd", "dx"):
        return acts + weights * it
    raise ValueError(f"kind must be fwd, dx or dw, got {kind!r}")


def least_seconds(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def conv_work(convs, kinds=("fwd",), dtype: str = "bfloat16"):
    """(operations, least seconds) of ``convs`` (from :func:`unet_convs`) run
    as each of ``kinds`` ("fwd", "dx", "dw").  The first conv's dx is left
    out: nothing needs the gradient of the network's input."""
    flops = least = 0.0
    for i, (_, cins, cout, spatial) in enumerate(convs):
        for kind in kinds:
            if kind == "dx" and i == 0:
                continue
            f = conv_flops(cins, cout, spatial)
            flops += f
            least += least_seconds(f, conv_bytes(cins, cout, spatial, kind, dtype), dtype)
    return flops, least


def predict_work(cfg: dict, in_channels: int, padded, tta: bool = True, dtype="bfloat16"):
    """(operations, least seconds) of one volume's network: two forwards
    with flip TTA, one without."""
    flops, least = conv_work(unet_convs(cfg, in_channels, padded), ("fwd",), dtype)
    n = 2 if tta else 1
    return n * flops, n * least


def train_work(cfg: dict, in_channels: int, crop, batch: int = 1, dtype="bfloat16"):
    """(operations, least seconds) of one train step's convs: forward, dx
    (not the first conv's) and dw, per example."""
    flops, least = conv_work(unet_convs(cfg, in_channels, crop), ("fwd", "dx", "dw"), dtype)
    return batch * flops, batch * least
