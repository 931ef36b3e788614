"""The benchmark's one traffic generator: it reads a cell's ``traffic``
parameters and makes the cell's inputs from the seed.

- ``acquisitions`` (predict): [{"shape", "zooms", "flip", "count"}], the
  raw scans of a directory, ``count`` distinct volumes of each; the order in
  which the closed loop cycles through them is a permutation drawn from the
  seed, so every seed sends the same set of sizes.  Each volume is a T1-like
  head phantom drawn on the device: a head, brain, white matter and
  ventricles as ellipsoids with jittered radii, a few lesions, a smooth
  multiplicative bias and gaussian noise.
- ``label_maps`` (train): {"count", "size"}: seeded label maps of nested
  ellipsoids split into left and right hemispheres (FreeSurfer label ids),
  the generation label list and 3-channel normal GMM priors, made as
  ``chip_smoke.make_train_data`` at the parent of this benchmark makes them.
"""

from __future__ import annotations

import numpy as np
import torch

NEUTRAL, LEFT, RIGHT = [0, 14, 24], [2, 3, 4, 17], [41, 42, 43, 53]
GENERATION_LABELS = np.array(NEUTRAL + LEFT + RIGHT, np.int32)


def _ellipsoid(grid, centre, radii):
    return sum(((g - c) / r) ** 2 for g, c, r in zip(grid, centre, radii)) < 1


def phantom(shape, zooms, gen: torch.Generator, device) -> np.ndarray:
    """One T1-like head phantom, float32 on the host, axes in the scan's order."""
    f32 = dict(dtype=torch.float32, device=device)
    grid = [((torch.arange(n, **f32) - n / 2 + 0.5) * z).reshape(
        [-1 if d == i else 1 for d in range(3)]) for i, (n, z) in enumerate(zip(shape, zooms))]
    u = torch.rand(40, generator=gen, **f32).tolist()
    head = [72 * (0.92 + 0.1 * u[0]), 90 * (0.92 + 0.1 * u[1]), 78 * (0.92 + 0.1 * u[2])]
    centre = [4 * (u[3] - 0.5), 4 * (u[4] - 0.5), 4 * (u[5] - 0.5)]
    vol = torch.zeros(tuple(shape), **f32)
    vol[_ellipsoid(grid, centre, head)] = 250.0
    vol[_ellipsoid(grid, centre, [0.88 * r for r in head])] = 550.0
    vol[_ellipsoid(grid, centre, [0.62 * r for r in head])] = 800.0
    for side in (-1, 1):
        c = [centre[0] + side * (7 + 3 * u[6]), centre[1] + 5 * (u[7] - 0.5), centre[2] + 8]
        vol[_ellipsoid(grid, c, [5 + 2 * u[8], 18 + 6 * u[9], 9 + 3 * u[10]])] = 120.0
    for k in range(4):
        a = u[11 + 5 * k: 16 + 5 * k]
        c = [centre[0] + 0.4 * head[0] * (2 * a[0] - 1), centre[1] + 0.4 * head[1] * (2 * a[1] - 1),
             centre[2] + 0.4 * head[2] * (2 * a[2] - 1)]
        vol[_ellipsoid(grid, c, [4 + 6 * a[3]] * 3)] = 400.0 + 300.0 * a[4]
    c0, c1, c2 = (torch.cos(g / s + 6.3 * v) for g, s, v in zip(grid, (40, 50, 45), u[31:34]))
    bias = 1.0 + 0.1 * c0 * c1 * c2
    vol = vol * bias + 15.0 * torch.randn(tuple(shape), generator=gen, **f32)
    return vol.cpu().numpy()


def affine(shape, zooms, flip) -> np.ndarray:
    """A scan's voxel-to-RAS affine: its axes along R, A, S, reversed where
    ``flip`` says, centred on the origin."""
    aff = np.eye(4)
    for i, (n, z, f) in enumerate(zip(shape, zooms, flip)):
        aff[i, i] = -z if f else z
        aff[i, 3] = -aff[i, i] * (n - 1) / 2
    return aff


def scans(traffic: dict, seed: int, device):
    """(volumes [(float32 array, affine, acquisition index)], the order the
    loop cycles through them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vols = []
    for a, acq in enumerate(traffic["acquisitions"]):
        for _ in range(acq["count"]):
            vols.append((phantom(acq["shape"], acq["zooms"], gen, device),
                         affine(acq["shape"], acq["zooms"], acq["flip"]), a))
    order = np.random.default_rng(seed).permutation(len(vols))
    return vols, [int(i) for i in order]


def label_maps(traffic: dict, seed: int):
    """(label maps [int32 (n, n, n)], prior means, prior stds) from the seed."""
    rng = np.random.default_rng(seed)
    spec = traffic["label_maps"]
    n = spec["size"]
    grid = np.meshgrid(*[np.arange(n) - n / 2] * 3, indexing="ij", sparse=True)
    maps = []
    for _ in range(spec["count"]):
        lab = np.zeros((n, n, n), np.int32)
        for k, r in enumerate((70, 55, 40, 25)):
            radii = r * n / 160 * rng.uniform(0.85, 1.1, 3)
            inside = sum((g / ri) ** 2 for g, ri in zip(grid, radii)) < 1
            side = np.broadcast_to(np.where(grid[0] < 0, LEFT[k], RIGHT[k]), lab.shape)
            lab[inside] = side[inside]
        lab[(np.abs(grid[0]) < 2) & (lab > 0)] = 24
        lab[(np.abs(grid[1]) < 3) & (np.abs(grid[2]) < 3) & (lab > 0)] = 14
        maps.append(lab)
    n_lab = len(GENERATION_LABELS)
    means = np.concatenate([np.stack([rng.uniform(10, 240, n_lab), rng.uniform(5, 25, n_lab)])
                            for _ in range(3)])
    stds = np.concatenate([np.stack([rng.uniform(2, 12, n_lab), rng.uniform(1, 3, n_lab)])
                           for _ in range(3)])
    return maps, means.astype(np.float32), stds.astype(np.float32)
