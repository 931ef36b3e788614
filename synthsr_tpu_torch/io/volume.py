"""Host-side volume loading and numpy geometry: the port's own copy of
``synthsr_tpu/io/volume.py`` (reference ``ext/lab2im/utils.py:76-207``
load / save / get_volume_info and the ``ext/lab2im/edit_volumes.py``
geometry ops: resample_volume :504, resample_volume_like :555,
get_ras_axes :591, align_volume_to_ref :609, blur_volume :657,
mask_volume :95, rescale_volume :148, crop_volume :179, crop_volume_with_idx
:392, pad_volume :424, flip_volume :472).  The orientation algebra and
resampling conventions are the contract, so each function follows its
namesake statement for statement; ``tests/test_torch_host.py`` holds them
equal, signatures included.

``load_volume(fast=True)`` with an explicit ``dtype`` reads NIfTI through the
port's copy of the C++ loader (``native/``, built with g++ on first use) and
falls back to ``io/nifti.py`` for files it does not take; the volumes are
bit-identical either way.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import RegularGridInterpolator
from scipy.ndimage import gaussian_filter

from ..utils.misc import get_dims, reformat_to_list
from .nifti import VolumeHeader, read_volume_file, write_volume_file

FS_AFFINE = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], float)


def load_volume(path_volume, im_only=True, squeeze=True, dtype=None, aff_ref=None,
                fast=True):
    """Load a volume; optionally reorient to ``aff_ref`` (ref utils.py:76-119).

    ``fast`` enables the native-loader / reduced-copy path when an explicit
    ``dtype`` is requested (bit-identical results, skips the float64
    get_fdata intermediate that exists only for nibabel parity)."""
    volume = None
    if fast and dtype is not None and path_volume.endswith((".nii", ".nii.gz")):
        from ..native import read_nifti_fast

        want = "int32" if "int" in str(dtype) else "float32"
        res = read_nifti_fast(path_volume, want)
        if res is not None:
            volume, aff, header = res
            if squeeze:
                volume = np.squeeze(volume)
            volume = volume.astype(dtype, copy=False)
    if volume is None:
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


def resample_volume(volume, aff, new_vox_size, interpolation="linear", blur=True):
    """Resample to a new voxel size, updating the affine (ref edit_volumes.py:504-552).

    Anti-alias blur sigma = 0.25/factor on downsampled axes; sampling grid is
    centre-aligned: start = -(factor-1)/(2 factor), step = 1/factor, clipped to
    the volume bounds.
    """
    pixdim = np.sqrt(np.sum(aff * aff, axis=0))[:-1]
    new_vox_size = np.array(reformat_to_list(new_vox_size, length=3), dtype=float)
    factor = pixdim / new_vox_size
    sigmas = 0.25 / factor
    sigmas[factor > 1] = 0
    vol = gaussian_filter(volume, sigmas) if blur else volume

    grids = tuple(np.arange(s) for s in vol.shape[:3])
    interp = RegularGridInterpolator(grids, vol, method=interpolation)
    start = -(factor - 1) / (2 * factor)
    step = 1.0 / factor
    stop = start + step * np.ceil(np.array(vol.shape[:3]) * factor)
    coords = []
    for d in range(3):
        c = np.arange(start=start[d], stop=stop[d], step=step[d])
        coords.append(np.clip(c, 0, vol.shape[d] - 1))
    mesh = np.meshgrid(*coords, indexing="ij", sparse=True)
    out = interp(tuple(mesh))

    aff2 = aff.copy()
    for c in range(3):
        aff2[:-1, c] = aff2[:-1, c] / factor[c]
    aff2[:-1, -1] = aff2[:-1, -1] - aff2[:-1, :-1] @ (0.5 * (factor - 1))
    return out, aff2


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


# ---------------------------------------------------------------------------
# intensity / shape edits  (reference edit_volumes.py:95-501)
# ---------------------------------------------------------------------------

def blur_volume(volume, sigma, mask=None):
    """Gaussian blur, optionally mask-renormalized (ref edit_volumes.py:657-685)."""
    sigma = reformat_to_list(sigma, length=volume.ndim)
    if mask is None:
        return gaussian_filter(volume, sigma)
    assert volume.shape == mask.shape, "volume and mask must share a shape"
    mask = (mask > 0).astype(volume.dtype)
    blurred = gaussian_filter(volume * mask, sigma)
    weights = gaussian_filter(mask, sigma)
    out = blurred / (weights + 1e-9)
    out[mask == 0] = 0
    return out


def mask_volume(volume, mask=None, threshold=0.1, dilate=0, erode=0, fill_holes=False,
                masking_value=0, return_mask=False, return_copy=True):
    """Mask a volume (ref edit_volumes.py:95-145)."""
    from scipy.ndimage import binary_dilation, binary_erosion, binary_fill_holes

    from ..utils.misc import build_binary_structure

    vol = volume.copy() if return_copy else volume
    n_dims, n_channels = get_dims(vol.shape)
    if mask is None:
        mask = vol >= threshold
    else:
        assert mask.shape[:n_dims] == vol.shape[:n_dims], "mask and volume shapes differ"
        mask = mask > 0
    if dilate > 0:
        mask = binary_dilation(mask, structure=build_binary_structure(dilate, n_dims))
    if erode > 0:
        mask = binary_erosion(mask, structure=build_binary_structure(erode, n_dims))
    if fill_holes:
        mask = binary_fill_holes(mask)
    if n_channels > 1:
        full_mask = np.stack([mask] * n_channels, axis=-1)
    else:
        full_mask = mask
    vol[~full_mask] = masking_value
    if return_mask:
        return vol, mask
    return vol


def rescale_volume(volume, new_min=0, new_max=255, min_percentile=2.0,
                   max_percentile=98.0, use_positive_only=False):
    """Robust percentile rescale (ref edit_volumes.py:148-176)."""
    new_volume = volume.copy().astype(float)
    intensities = new_volume[new_volume > 0] if use_positive_only else new_volume.flatten()
    robust_min = np.min(intensities) if min_percentile == 0 else \
        np.percentile(intensities, min_percentile)
    robust_max = np.max(intensities) if max_percentile == 100 else \
        np.percentile(intensities, max_percentile)
    new_volume = np.clip(new_volume, robust_min, robust_max)
    if robust_min != robust_max:
        return new_min + (new_volume - robust_min) / (robust_max - robust_min) * \
            (new_max - new_min)
    return np.zeros_like(new_volume)


def crop_volume(volume, cropping_margin=None, cropping_shape=None, aff=None,
                return_crop_idx=False, mode="center"):
    """Crop by margin or to shape (ref edit_volumes.py:179-238)."""
    assert (cropping_margin is None) != (cropping_shape is None), \
        "provide exactly one of cropping_margin, cropping_shape"
    new_volume = volume.copy()
    n_dims, _ = get_dims(new_volume.shape)
    vol_shape = np.array(new_volume.shape[:n_dims])

    if cropping_margin is not None:
        margin = np.array(reformat_to_list(cropping_margin, length=n_dims))
        min_idx = margin
        max_idx = vol_shape - margin
        assert np.all(max_idx > min_idx), "cropping_margin too large"
    else:
        shape = np.array(reformat_to_list(cropping_shape, length=n_dims))
        if mode == "center":
            min_idx = np.clip((vol_shape - shape) // 2, 0, None)
        elif mode == "random":
            min_idx = np.array([np.random.randint(0, max(1, v - s + 1))
                                for v, s in zip(vol_shape, shape)])
        else:
            raise ValueError(f"mode should be center or random, got {mode}")
        max_idx = np.minimum(min_idx + shape, vol_shape)

    crop_idx = np.concatenate([min_idx, max_idx])
    slicer = tuple(slice(int(a), int(b)) for a, b in zip(min_idx, max_idx))
    new_volume = new_volume[slicer]
    if aff is not None:
        aff = aff.copy()
        aff[:3, -1] = aff[:3, -1] + aff[:3, :3] @ min_idx
        out = [new_volume, aff]
    else:
        out = [new_volume]
    if return_crop_idx:
        out.append(crop_idx)
    return out[0] if len(out) == 1 else tuple(out)


def crop_volume_with_idx(volume, crop_idx, aff=None, n_dims=None, return_copy=True):
    """Crop with precomputed indices (ref edit_volumes.py:392-421)."""
    new_volume = volume.copy() if return_copy else volume
    if n_dims is None:
        n_dims = int(len(crop_idx) // 2)
    slicer = tuple(slice(int(crop_idx[i]), int(crop_idx[i + n_dims])) for i in range(n_dims))
    new_volume = new_volume[slicer]
    if aff is not None:
        aff = aff.copy()
        aff[:3, -1] = aff[:3, -1] + aff[:3, :3] @ np.asarray(crop_idx[:3])
        return new_volume, aff
    return new_volume


def pad_volume(volume, padding_shape, padding_value=0, aff=None, return_pad_idx=False):
    """Centre-pad to shape (ref edit_volumes.py:424-469)."""
    new_volume = volume.copy()
    vol_shape = np.array(new_volume.shape)
    n_dims, n_channels = get_dims(new_volume.shape)
    padding_shape = np.array(reformat_to_list(padding_shape, length=n_dims, dtype="int"))
    if n_channels > 1:
        padding_shape = np.concatenate([padding_shape, [n_channels]])
    pad = np.maximum(padding_shape - vol_shape[: len(padding_shape)], 0)
    min_margin = pad // 2
    max_margin = pad - min_margin
    pad_width = [(int(a), int(b)) for a, b in zip(min_margin, max_margin)]
    while len(pad_width) < new_volume.ndim:
        pad_width.append((0, 0))
    if np.any(pad > 0):
        new_volume = np.pad(new_volume, pad_width, mode="constant",
                            constant_values=padding_value)
        if aff is not None:
            aff = aff.copy()
            aff[:3, -1] = aff[:3, -1] - aff[:3, :3] @ min_margin[:3]
    pad_idx = np.concatenate([min_margin[:n_dims],
                              min_margin[:n_dims] + vol_shape[:n_dims]])
    out = [new_volume]
    if aff is not None:
        out.append(aff)
    if return_pad_idx:
        out.append(pad_idx)
    return out[0] if len(out) == 1 else tuple(out)


def flip_volume(volume, axis=None, direction=None, aff=None, return_copy=True):
    """Flip along an axis, or along an anatomical direction given the affine
    (ref edit_volumes.py:472-501)."""
    new_volume = volume.copy() if return_copy else volume
    assert (axis is not None) or ((aff is not None) and (direction is not None)), \
        "provide either axis, or aff and direction"
    if axis is None:
        ras = get_ras_axes(aff, n_dims=3)
        axis = {"rl": ras[0], "ap": ras[1], "si": ras[2]}[direction]
    return np.flip(new_volume, axis=axis)
