"""The plain SynthSR generative model, label map -> (input channels,
regression target), one example, from given random draws: the reference of
the train cells' generated pairs (BBillot/SynthSR
``labels_to_image_model.py:32-266`` with the ``ext/lab2im`` layers it
calls).  It imports nothing of the program.

The draws are those of one example, under the names the program's
``Generator.sample`` gives them: ``crop_idx``, ``affine``, ``svf``,
``flip``, ``gmm_noise``, and per channel ``bias_<i>`` (small field, coin),
``intensity_<i>`` ({"gamma"}), ``blur_<i>`` (sigma factors) and, for the
channel that simulates a registration error, ``t_fwd_<i>`` / ``t_err_<i>``.
Volumes are channels-last (X, Y, Z, C), float32; interpolation clips its
locations to the volume (edge replication), resizing maps output index g to
input coordinate g / zoom, and blurs pad with zeros, as the lab2im layers do.
``q``: a rounding applied to every intermediate volume (the
lower-precision control), or None.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def settings(t: dict, labels_shape, nb_levels: int, neutral, left, right) -> dict:
    """The static quantities of the configuration's ``training`` settings ``t``
    for label maps of ``labels_shape`` at 1 mm with the identity affine (so
    the flip axis is 0): shapes, per-channel blur sigmas and acquisition
    grids, the generation labels in FreeSurfer order (neutral, left, right)
    and the left/right swap."""
    if t["randomise_res"]:
        raise NotImplementedError("the reference draws no acquisition resolution")
    margin = int((t["output_shape"] - t["loss_cropping"]) / 2)
    padded = [s + 2 * margin for s in labels_shape]
    div = 2 ** nb_levels
    out = [min(p, t["output_shape"]) // div * div for p in padded]
    n_ch = len(t["input_channels"])
    res, thick = list(map(list, t["data_res"])), list(map(list, t["thickness"]))
    for i in t["output_channel"]:  # a target-only channel is acquired at 1 mm
        if not t["input_channels"][i]:
            res.insert(i, [1.0] * 3)
            thick.insert(i, [1.0] * 3)
    sigma = [[0.0 if min(r, h) == 0 else 0.42 * min(r, h) for r, h in zip(res[i], thick[i])]
             for i in range(n_ch)]
    down = [[int(o * 1.0 / r) for o, r in zip(out, res[i])] for i in range(n_ch)]
    labels = sorted(neutral) + sorted(left) + sorted(right)
    swap = dict(zip(sorted(left), sorted(right)))
    swap.update({b: a for a, b in swap.items()})
    first = t["input_channels"].index(True)
    return {"margin": margin, "padded": padded, "out": out, "n_ch": n_ch, "sigma": sigma,
            "down": down, "labels": labels, "swap": swap, "t": t,
            "reg_err": [bool(t["input_channels"][i] and t["simulate_registration_error"]
                             and i != first) for i in range(n_ch)]}


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def linear(vol: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of ``vol`` (X, Y, Z, C) at ``loc`` (..., 3)."""
    shape = vol.shape[:3]
    p = [loc[..., d].clamp(0, shape[d] - 1) for d in range(3)]
    i0 = [p[d].floor().long() for d in range(3)]
    i1 = [(i0[d] + 1).clamp(max=shape[d] - 1) for d in range(3)]
    f = [p[d] - i0[d] for d in range(3)]
    out = 0.0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                w = ((f[0] if cx else 1 - f[0]) * (f[1] if cy else 1 - f[1])
                     * (f[2] if cz else 1 - f[2]))
                v = vol[(i1[0] if cx else i0[0]), (i1[1] if cy else i0[1]),
                        (i1[2] if cz else i0[2])]
                out = out + w[..., None] * v
    return out


def nearest(vol: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Nearest samples of ``vol`` (X, Y, Z[, C]) at ``loc`` (..., 3)."""
    idx = [torch.round(loc[..., d]).long().clamp(0, vol.shape[d] - 1) for d in range(3)]
    return vol[idx[0], idx[1], idx[2]]


def grid(shape, device) -> list:
    return list(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=device)
                                 for s in shape], indexing="ij"))


def resize_axis(vol: torch.Tensor, axis: int, size: int, method: str) -> torch.Tensor:
    """Resize one axis: output index g samples input coordinate g / (size / n)."""
    n = vol.shape[axis]
    if n == size:
        return vol
    c = (torch.arange(size, dtype=torch.float32, device=vol.device) / (size / n)).clamp(0, n - 1)
    if method == "nearest":
        return vol.index_select(axis, torch.round(c).long())
    lo = c.floor().long()
    hi = (lo + 1).clamp(max=n - 1)
    f = (c - lo).reshape([-1 if d == axis else 1 for d in range(vol.dim())])
    return vol.index_select(axis, lo) * (1 - f) + vol.index_select(axis, hi) * f


def resize(vol: torch.Tensor, shape, method: str = "linear") -> torch.Tensor:
    for d in range(3):
        vol = resize_axis(vol, d, shape[d], method)
    return vol


def warp_affine(vol: torch.Tensor, aff: torch.Tensor) -> torch.Tensor:
    """``vol`` sampled (trilinear) at aff · (x - centre) + centre."""
    shape = vol.shape[:3]
    mesh = grid(shape, vol.device)
    moved = [mesh[d] - (shape[d] - 1) / 2.0 for d in range(3)]
    loc = torch.stack([sum(aff[r, k] * moved[k] for k in range(3)) + aff[r, 3]
                       + (shape[r] - 1) / 2.0 for r in range(3)], -1)
    return linear(vol, loc)


# ---------------------------------------------------------------------------
# blur
# ---------------------------------------------------------------------------

def window(max_sigma: float) -> int:
    return int(math.ceil(2.5 * float(max_sigma)) / 2) * 2 + 1


def blur(vol: torch.Tensor, sigmas, max_sigmas) -> torch.Tensor:
    """Separable gaussian blur with zero padding, each axis's taps sized by
    its ``max_sigmas`` and shaped by its (drawn) ``sigmas``."""
    for d in range(3):
        w = window(max_sigmas[d])
        if w <= 1:
            continue
        s = torch.as_tensor(sigmas[d], dtype=torch.float32, device=vol.device)
        x = torch.arange(w, dtype=torch.float32, device=vol.device) - (w - 1) / 2.0
        if float(s) > 0:
            k = torch.exp(-x * x / (2.0 * s * s))
            k = k / k.sum()
        else:
            k = (x == 0).to(torch.float32)
        moved = vol.movedim(d, -1)
        flat = moved.reshape(-1, 1, moved.shape[-1])
        out = F.conv1d(flat, k.view(1, 1, -1), padding=(w - 1) // 2)
        vol = out.reshape(moved.shape).movedim(-1, d)
    return vol


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def deformation_locations(s: dict, d: dict, device) -> torch.Tensor:
    """Where each voxel of the crop window samples the padded label map: the
    affine about the padded volume's centre applied to the voxel moved by
    the integrated velocity field (7 squarings at half the padded size)."""
    padded, out = s["padded"], s["out"]
    idx = d["crop_idx"].tolist() if "crop_idx" in d else [0, 0, 0]
    coords = [idx[k] + torch.arange(out[k], dtype=torch.float32, device=device)
              for k in range(3)]
    mesh = list(torch.meshgrid(*coords, indexing="ij"))
    svf = d["svf"].float()
    half = [max(int(padded[k] / 2), svf.shape[k]) for k in range(3)]
    v = resize(svf, half, "linear") / 2 ** 7
    hmesh = grid(half, device)
    for _ in range(7):
        v = v + linear(v, torch.stack([hmesh[k] + v[..., k] for k in range(3)], -1))
    field = linear(v, torch.stack([mesh[k] / (padded[k] / half[k]) for k in range(3)], -1))
    centre = [(padded[k] - 1) / 2.0 for k in range(3)]
    moved = [mesh[k] - centre[k] + field[..., k] for k in range(3)]
    aff = d["affine"].float()
    return torch.stack([sum(aff[r, k] * moved[k] for k in range(3)) + aff[r, 3] + centre[r]
                        for r in range(3)], -1)


def reliability(out: int, down: int) -> np.ndarray:
    """1 on the acquired slices, falling linearly to the interpolated ones
    (SynthSR ``edit_tensors.resample_tensor``'s reliability map), one axis."""
    if out == down:
        return np.ones(out, np.float32)
    loc = np.arange(0, out, out / down)
    lo = np.floor(loc).astype(np.int64)
    hi = np.clip(lo + 1, 0, out - 1)
    rel = np.zeros(out, np.float32)
    rel[lo] = 1 - (loc - lo)
    rel[hi] += loc - lo
    return rel


def generate(s: dict, labels: torch.Tensor, means: torch.Tensor, stds: torch.Tensor,
             d: dict, q=None):
    """(image (X, Y, Z, 2·inputs): each input channel then its reliability
    map, target (X, Y, Z, outputs)) of one example from its label map (X, Y,
    Z[, 1]), GMM means and stds (labels, channels) and draws ``d``."""
    q = q or (lambda v: v)
    t, dev = s["t"], labels.device
    lab = labels.reshape(labels.shape[:3]).long()
    m = s["margin"]
    lab = F.pad(lab, (m, m, m, m, m, m))
    lab = nearest(lab, deformation_locations(s, d, dev))
    if t["flipping"] and bool(d["flip"][0]):
        lut = torch.arange(int(lab.max()) + 1, device=dev)
        for a, b in s["swap"].items():
            if a < len(lut):
                lut[a] = b
        lab = lut[lab].flip(0)
    row = torch.zeros(max(max(s["labels"]), int(lab.max())) + 1, dtype=torch.long, device=dev)
    for r, v in enumerate(s["labels"]):
        row[v] = r
    rows = row[lab]
    image = q(stds.float()[rows] * d["gmm_noise"].float() + means.float()[rows])
    inputs, targets = [], []
    for i in range(s["n_ch"]):
        x = image[..., i:i + 1]
        is_input = t["input_channels"][i]
        if is_input:
            field, coin = d[f"bias_{i}"]
            if bool(coin):
                x = q(torch.exp(resize(q(field.float()), s["out"], "linear")) * x)
        x = x.clamp(0, 300)
        lo, hi = x.amin(), x.amax()
        x = (x.clamp(lo, hi) - lo) / (hi - lo + 1e-7)
        x = q(x.clamp(min=0) ** torch.exp(d[f"intensity_{i}"]["gamma"].float().reshape(())))
        x = q(blur(x, [0.5] * 3, [0.5] * 3))
        if i in t["output_channel"]:
            targets.append(x)
        if not is_input:
            continue
        if s["reg_err"][i]:
            x = q(warp_affine(x, d[f"t_fwd_{i}"].float()))
        sig = s["sigma"][i]
        f = d[f"blur_{i}"].float() if t["blur_range"] != 1 else torch.ones(3, device=dev)
        x = q(blur(x, [sig[k] * f[k] for k in range(3)],
                   [sig[k] * t["blur_range"] for k in range(3)]))
        down = s["down"][i] if t["downsample"] else s["out"]
        x = q(resize(resize(x, down, "nearest"), s["out"], "linear"))
        r = [reliability(s["out"][k], down[k]) for k in range(3)]
        rel = torch.as_tensor(r[0][:, None, None] * r[1][None, :, None] * r[2][None, None, :],
                              device=dev)[..., None]
        if s["reg_err"][i]:
            inv = d[f"t_err_{i}"].float() @ torch.linalg.inv(d[f"t_fwd_{i}"].float())
            x, rel = q(warp_affine(x, inv)), q(warp_affine(rel, inv))
        inputs += [x, rel]
    return torch.cat(inputs, -1), torch.cat(targets, -1)


def gaps(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """Per channel of (X, Y, Z, C): the RMS, the 99th and 99.9th percentiles
    and the largest of |prog - ref|."""
    g = (prog.float() - ref.float()).abs().reshape(-1, ref.shape[-1])
    n = g.shape[0]
    pct = {f"q{p}": g.kthvalue(max(1, math.ceil(float("0." + p) * n)), dim=0).values
           for p in ("99", "999")}
    return {"rms": g.pow(2).mean(0).sqrt(), **pct, "max": g.amax(0)}
