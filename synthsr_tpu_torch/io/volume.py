"""Host-side volume loading and numpy geometry: the port's own copy of the
functions it uses from ``synthsr_tpu/io/volume.py`` (reference
``ext/lab2im/utils.py:76-207`` load / save / get_volume_info and
``ext/lab2im/edit_volumes.py`` get_ras_axes :591, align_volume_to_ref :609,
resample_volume_like :555).  The orientation algebra and resampling
conventions are the contract, so each function follows its namesake
statement for statement; ``tests/test_torch_host.py`` holds them equal.

``load_volume`` reads through ``io/nifti.py`` only: the JAX package's
optional C++ NIfTI loader (``synthsr_tpu/native/``) gives bit-identical
volumes and is not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import RegularGridInterpolator

from ..utils.misc import get_dims, reformat_to_list
from .nifti import VolumeHeader, read_volume_file, write_volume_file

FS_AFFINE = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], float)


def load_volume(path_volume, im_only=True, squeeze=True, dtype=None, aff_ref=None,
                fast=True):
    """Load a volume; optionally reorient to ``aff_ref`` (ref utils.py:76-119).
    ``fast`` selects the original's native loader, which is not ported; it is
    accepted and ignored (the results are bit-identical either way)."""
    del fast
    volume, aff, header = read_volume_file(path_volume)
    if squeeze:
        volume = np.squeeze(volume)
    if not path_volume.endswith((".npz", ".npy")):
        volume = np.asarray(volume, dtype=np.float64)  # nibabel get_fdata semantics
    if dtype is not None:
        if "int" in str(dtype):
            volume = np.round(volume)
        volume = volume.astype(dtype)
    if aff_ref is not None:
        n_dims, _ = get_dims(list(volume.shape), max_channels=10)
        volume, aff = align_volume_to_ref(volume, aff, aff_ref=aff_ref,
                                          return_aff=True, n_dims=n_dims)
    if im_only:
        return volume
    return volume, aff, header


def save_volume(volume, aff, header, path, res=None, dtype=None, n_dims=3):
    """Save a volume (ref utils.py:122-160). ``aff`` may be None, 'FS', or 4x4;
    the header's zooms derive from the affine, so ``header``, ``res`` and
    ``n_dims`` are ignored, as in the original."""
    del header, res, n_dims
    if isinstance(aff, str):
        if aff != "FS":
            raise ValueError(f"unknown affine string: {aff}")
        aff = FS_AFFINE
    write_volume_file(path, np.asarray(volume), aff, dtype=dtype)


def get_volume_info(path_volume, return_volume=False, aff_ref=None, max_channels=10):
    """Shape / affine / dims / channels / resolution (ref utils.py:163-207)."""
    im, aff, header = load_volume(path_volume, im_only=False)
    im_shape = list(im.shape)
    n_dims, n_channels = get_dims(im_shape, max_channels=max_channels)
    im_shape = im_shape[:n_dims]
    data_res = np.array(reformat_to_list(header.zooms[:n_dims], length=n_dims)).astype(float) \
        if isinstance(header, VolumeHeader) else np.ones(n_dims)
    if aff_ref is not None:
        ras_axes = get_ras_axes(aff, n_dims=n_dims)
        ras_axes_ref = get_ras_axes(aff_ref, n_dims=n_dims)
        im = align_volume_to_ref(im, aff, aff_ref=aff_ref, n_dims=n_dims)
        im_shape = np.array(im_shape)[ras_axes][ras_axes_ref].tolist()
        data_res = data_res[ras_axes][ras_axes_ref]
    if return_volume:
        return im, im_shape, aff, n_dims, n_channels, header, data_res
    return im_shape, aff, n_dims, n_channels, header, data_res


def get_ras_axes(aff, n_dims=3):
    """Which volume axis carries each RAS direction (ref edit_volumes.py:591-606)."""
    aff_inv = np.linalg.inv(aff)
    axes = np.argmax(np.abs(aff_inv[:n_dims, :n_dims]), axis=0)
    # repair duplicates so the result is a permutation
    for i in range(n_dims):
        if i not in axes:
            unique, counts = np.unique(axes, return_counts=True)
            dup = unique[np.argmax(counts)]
            axes[np.where(axes == dup)[0][-1]] = i
    return axes


def align_volume_to_ref(volume, aff, aff_ref=None, return_aff=False, n_dims=None,
                        return_copy=True):
    """Axis-permute + flip a volume so its orientation matches ``aff_ref``
    (ref edit_volumes.py:609-654)."""
    new_volume = volume.copy() if return_copy else volume
    aff_flo = np.array(aff, dtype=float, copy=True)
    if aff_ref is None:
        aff_ref = np.eye(4)
    if n_dims is None:
        n_dims, _ = get_dims(new_volume.shape)
    ras_ref = get_ras_axes(aff_ref, n_dims=n_dims)
    ras_flo = get_ras_axes(aff_flo, n_dims=n_dims)

    aff_flo[:, ras_ref] = aff_flo[:, ras_flo]
    for i in range(n_dims):
        if ras_flo[i] != ras_ref[i]:
            new_volume = np.swapaxes(new_volume, ras_flo[i], ras_ref[i])
            j = int(np.where(ras_flo == ras_ref[i])[0][0])
            ras_flo[j], ras_flo[i] = ras_flo[i], ras_flo[j]

    dots = np.sum(aff_flo[:3, :3] * aff_ref[:3, :3], axis=0)
    for i in range(n_dims):
        if dots[i] < 0:
            new_volume = np.flip(new_volume, axis=i)
            aff_flo[:, i] = -aff_flo[:, i]
            aff_flo[:3, 3] = aff_flo[:3, 3] - aff_flo[:3, i] * (new_volume.shape[i] - 1)

    if return_aff:
        return new_volume, aff_flo
    return new_volume


def resample_volume_like(vol_ref, aff_ref, vol_flo, aff_flo, interpolation="linear"):
    """Reslice floating volume into the reference grid (ref edit_volumes.py:555-588)."""
    t = np.linalg.inv(aff_flo) @ aff_ref
    grids = tuple(np.arange(s) for s in vol_flo.shape[:3])
    interp = RegularGridInterpolator(grids, vol_flo, bounds_error=False, fill_value=0.0,
                                     method=interpolation)
    mesh = np.meshgrid(*[np.arange(s) for s in vol_ref.shape[:3]], indexing="ij")
    coords = np.stack([m.ravel() for m in mesh] + [np.ones(mesh[0].size)])
    new = (t @ coords)[:3]
    out = interp((new[0], new[1], new[2]))
    return out.reshape(vol_ref.shape[:3])
