"""The port's own copy of ``synthsr_tpu/io/dataset_tools.py``,
held equal to it by ``tests/test_torch_host.py``.

Directory-level dataset tools (batch variants of the volume/label ops).

Re-implementation of the ``*_in_dir`` utilities of
``ext/lab2im/edit_volumes.py:1042-2795``: per-file batch wrappers around the
volume and label-map ops, evaluation-set builders
(simulate_upsampled_anisotropic_images :1805, upsample_anisotropic_images
:1739 — implemented with this package's resampling instead of FreeSurfer
mri_convert shell-outs), atlas building :2343, dataset cropping :2457-2693,
and patch subdivision :2694.  External-binary wrappers (mri_convert, samseg,
niftyreg) are kept as thin subprocess shims that error clearly when the tool
is absent.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from ..ops.blur import blurring_sigma_np
from ..utils.misc import (LoopInfo, get_dims, list_images_in_folder,
                          reformat_to_list, reformat_to_n_channels_array)
from . import volume as ev
from .label_edit import (compute_hard_volumes, correct_label_map,
                         crop_volume_around_region, erode_label_map,
                         mask_label_map, smooth_label_map)
from .volume import load_volume, save_volume


def _iterate(image_dir, result_dir, fn, recompute=True, text="processing",
             dtype=None):
    """Generic per-file driver: load -> fn(vol, aff, header, path, idx) ->
    (vol, aff) -> save.  idx is the position in the sorted listing (stable
    across recompute=False skips, so mask/ref pairing never drifts)."""
    os.makedirs(result_dir, exist_ok=True)
    paths = list_images_in_folder(image_dir)
    loop_info = LoopInfo(len(paths), 10, text, True)
    outputs = []
    for idx, path in enumerate(paths):
        loop_info.update(idx)
        out_path = os.path.join(result_dir, os.path.basename(path))
        if os.path.isfile(out_path) and not recompute:
            # skipped files still occupy their slot: fn is index-paired to the
            # sorted listing (reference pairs by sorted index via zip)
            outputs.append(out_path)
            continue
        vol, aff, h = load_volume(path, im_only=False, dtype=dtype)
        res = fn(vol, aff, h, path, idx)
        if res is not None:
            new_vol, new_aff = res
            save_volume(new_vol, new_aff, h, out_path)
        outputs.append(out_path)
    return outputs


# --------------------------- image batch tools -----------------------------

def mask_images_in_dir(image_dir, result_dir, mask_dir=None, threshold=0.1,
                       dilate=0, erode=0, fill_holes=False, masking_value=0,
                       write_mask=False, mask_result_dir=None, recompute=True):
    """(reference :1042-1096)"""
    if write_mask:
        assert mask_result_dir is not None, "mask_result_dir required with write_mask"
        os.makedirs(mask_result_dir, exist_ok=True)
    masks = list_images_in_folder(mask_dir) if mask_dir is not None else None

    def fn(vol, aff, h, path, idx):
        mask = None
        if masks is not None:
            mask = load_volume(masks[idx])
        out, m = ev.mask_volume(vol, mask=mask, threshold=threshold, dilate=dilate,
                                erode=erode, fill_holes=fill_holes,
                                masking_value=masking_value, return_mask=True)
        if write_mask:
            save_volume(m.astype(np.int32), aff, h,
                        os.path.join(mask_result_dir, os.path.basename(path)))
        return out, aff

    return _iterate(image_dir, result_dir, fn, recompute, "masking")


def rescale_images_in_dir(image_dir, result_dir, new_min=0, new_max=255,
                          min_percentile=2.0, max_percentile=98.0,
                          use_positive_only=False, recompute=True):
    """(reference :1099-1129)"""
    return _iterate(image_dir, result_dir,
                    lambda v, a, h, p, i: (ev.rescale_volume(
                        v, new_min, new_max, min_percentile, max_percentile,
                        use_positive_only), a),
                    recompute, "rescaling")


def crop_images_in_dir(image_dir, result_dir, cropping_margin=None,
                       cropping_shape=None, recompute=True):
    """(reference :1132-1157)"""
    def fn(v, a, h, p, idx):
        out, aff = ev.crop_volume(v, cropping_margin=cropping_margin,
                                  cropping_shape=cropping_shape, aff=a)
        return out, aff

    return _iterate(image_dir, result_dir, fn, recompute, "cropping")


def crop_images_around_region_in_dir(image_dir, result_dir, mask_dir=None,
                                     threshold=0.1, masking_labels=None,
                                     crop_margin=5, recompute=True):
    """(reference :1160-1205)"""
    masks = list_images_in_folder(mask_dir) if mask_dir is not None else None

    def fn(v, a, h, p, idx):
        mask = load_volume(masks[idx]) if masks is not None else None
        out, _, aff = crop_volume_around_region(v, mask=mask, threshold=threshold,
                                                masking_labels=masking_labels,
                                                margin=crop_margin, aff=a)
        return out, aff

    return _iterate(image_dir, result_dir, fn, recompute, "cropping")


def pad_images_in_dir(image_dir, result_dir, max_shape=None, padding_value=0,
                      recompute=True):
    """Pad all images to the same shape (max over dir if not given)
    (reference :1208-1245)."""
    paths = list_images_in_folder(image_dir)
    if max_shape is None:
        max_shape = np.zeros(3, int)
        for p in paths:
            shape, _, n_dims, _, _, _ = ev.get_volume_info(p)
            max_shape = np.maximum(max_shape, np.array(shape[:3]))
        max_shape = max_shape.tolist()

    def fn(v, a, h, p, idx):
        out, aff = ev.pad_volume(v, max_shape, padding_value=padding_value, aff=a)
        return out, aff

    _iterate(image_dir, result_dir, fn, recompute, "padding")
    return max_shape


def flip_images_in_dir(image_dir, result_dir, axis=None, direction=None,
                       recompute=True):
    """(reference :1248-1272)"""
    return _iterate(image_dir, result_dir,
                    lambda v, a, h, p, i: (ev.flip_volume(v, axis=axis,
                                                       direction=direction, aff=a), a),
                    recompute, "flipping")


def align_images_in_dir(image_dir, result_dir, aff_ref=None, path_ref=None,
                        recompute=True):
    """(reference :1275-1320)"""
    if path_ref is not None:
        _, aff_ref, _ = load_volume(path_ref, im_only=False)
    if aff_ref is None:
        aff_ref = np.eye(4)

    def fn(v, a, h, p, idx):
        n_dims, _ = get_dims(v.shape)
        out, aff = ev.align_volume_to_ref(v, a, aff_ref=aff_ref, return_aff=True,
                                          n_dims=n_dims)
        return out, aff

    return _iterate(image_dir, result_dir, fn, recompute, "aligning")


def correct_nans_images_in_dir(image_dir, result_dir, recompute=True):
    """(reference :1323-1343)"""
    return _iterate(image_dir, result_dir,
                    lambda v, a, h, p, i: (np.nan_to_num(v), a),
                    recompute, "correcting")


def blur_images_in_dir(image_dir, result_dir, sigma, mask_dir=None, gpu=False,
                       recompute=True):
    """(reference :1346-1403); gpu flag accepted for surface parity."""
    del gpu
    masks = list_images_in_folder(mask_dir) if mask_dir is not None else None

    def fn(v, a, h, p, idx):
        mask = load_volume(masks[idx]) if masks is not None else None
        return ev.blur_volume(v, sigma, mask=mask), a

    return _iterate(image_dir, result_dir, fn, recompute, "blurring")


def create_mutlimodal_images(list_channel_dir, result_dir, recompute=True):
    """Stack per-channel directories into multi-channel images
    (reference :1406-1442; name kept verbatim, typo included)."""
    os.makedirs(result_dir, exist_ok=True)
    list_channel_dir = reformat_to_list(list_channel_dir)
    channel_paths = [list_images_in_folder(d) for d in list_channel_dir]
    n = len(channel_paths[0])
    assert all(len(p) == n for p in channel_paths), \
        "all channel folders must contain the same number of images"
    loop_info = LoopInfo(n, 10, "stacking", True)
    for idx in range(n):
        loop_info.update(idx)
        out_path = os.path.join(result_dir, os.path.basename(channel_paths[0][idx]))
        if os.path.isfile(out_path) and not recompute:
            continue
        channels = []
        aff = h = None
        for cp in channel_paths:
            v, aff, h = load_volume(cp[idx], im_only=False)
            channels.append(v)
        save_volume(np.stack(channels, axis=-1), aff, h, out_path)


def convert_images_in_dir_to_nifty(image_dir, result_dir, aff=None,
                                   ref_aff_dir=None, recompute=True):
    """(reference :1445-1482)"""
    os.makedirs(result_dir, exist_ok=True)
    paths = list_images_in_folder(image_dir)
    refs = list_images_in_folder(ref_aff_dir) if ref_aff_dir is not None else None
    for idx, path in enumerate(paths):
        base = os.path.basename(path)
        for ext in (".nii.gz", ".nii", ".mgz", ".npz"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        out_path = os.path.join(result_dir, base + ".nii.gz")
        if os.path.isfile(out_path) and not recompute:
            continue
        v, file_aff, h = load_volume(path, im_only=False)
        use_aff = aff if aff is not None else file_aff
        if refs is not None:
            _, use_aff, _ = load_volume(refs[idx], im_only=False)
        save_volume(v, use_aff, h, out_path)


# ----------------------- external-binary wrappers --------------------------

def _run_external(binary, args_list, what):
    if shutil.which(binary) is None:
        raise FileNotFoundError(
            f"{what} requires the external binary '{binary}', which is not on "
            "PATH. This wrapper only shells out; the native equivalents are "
            "resample/align/simulate functions in synthsr_tpu_torch.io.")
    for args in args_list:
        subprocess.run([binary] + args, check=True)


def mri_convert_images_in_dir(image_dir, result_dir, interpolation=None,
                              reference_dir=None, same_reference=False,
                              voxsize=None, path_freesurfer="/usr/local/freesurfer/",
                              mri_convert_path=None, recompute=True):
    """FreeSurfer mri_convert shell-out (reference :1485-1546)."""
    os.makedirs(result_dir, exist_ok=True)
    binary = mri_convert_path or os.path.join(path_freesurfer, "bin/mri_convert")
    if shutil.which(binary) is None and not os.path.isfile(binary):
        binary = "mri_convert"
    paths = list_images_in_folder(image_dir)
    refs = list_images_in_folder(reference_dir) if reference_dir is not None else None
    cmds = []
    for idx, p in enumerate(paths):
        out = os.path.join(result_dir, os.path.basename(p))
        if os.path.isfile(out) and not recompute:
            continue
        args = [p, out]
        if interpolation:
            args += ["-rt", interpolation]
        if refs is not None:
            args += ["-rl", refs[0] if same_reference else refs[idx]]
        if voxsize is not None:
            vs = reformat_to_list(voxsize, dtype="float")
            args += ["--voxsize"] + [str(v) for v in vs]
        args += ["-odt", "float"]
        cmds.append(args)
    _run_external(binary, cmds, "mri_convert_images_in_dir")


def samseg_images_in_dir(image_dir, result_dir, atlas_dir=None, threads=4,
                         path_freesurfer="/usr/local/freesurfer/", recompute=True):
    """FreeSurfer samseg shell-out (reference :1549-1603)."""
    os.makedirs(result_dir, exist_ok=True)
    binary = os.path.join(path_freesurfer, "bin/run_samseg")
    cmds = []
    for p in list_images_in_folder(image_dir):
        out_dir = os.path.join(result_dir, os.path.basename(p).split(".")[0])
        if os.path.isdir(out_dir) and not recompute:
            continue
        args = ["-i", p, "-o", out_dir, "--threads", str(threads)]
        if atlas_dir is not None:
            args += ["-a", atlas_dir]
        cmds.append(args)
    _run_external(binary if os.path.isfile(binary) else "run_samseg", cmds,
                  "samseg_images_in_dir")


def niftyreg_images_in_dir(image_dir, reference_dir, result_dir,
                           operation="reg_aladin", transformation_dir=None,
                           recompute=True):
    """NiftyReg shell-out (reference :1606-1736, common path)."""
    os.makedirs(result_dir, exist_ok=True)
    paths = list_images_in_folder(image_dir)
    refs = list_images_in_folder(reference_dir)
    cmds = []
    for idx, p in enumerate(paths):
        out = os.path.join(result_dir, os.path.basename(p))
        if os.path.isfile(out) and not recompute:
            continue
        args = ["-flo", p, "-ref", refs[idx], "-res", out]
        if transformation_dir is not None:
            os.makedirs(transformation_dir, exist_ok=True)
            args += ["-aff", os.path.join(transformation_dir,
                                          os.path.basename(p) + ".txt")]
        cmds.append(args)
    _run_external(operation, cmds, "niftyreg_images_in_dir")


# ----------------------- evaluation-set builders ---------------------------

def upsample_anisotropic_images(image_dir, resample_image_result_dir,
                                resample_like_dir, path_freesurfer=None,
                                recompute=True, build_dist_map=True):
    """Resample LR images into the grid of HR references + distance maps
    (reference :1739-1802).  Native reslicing replaces mri_convert."""
    del path_freesurfer  # native implementation
    os.makedirs(resample_image_result_dir, exist_ok=True)
    paths = list_images_in_folder(image_dir)
    refs = list_images_in_folder(resample_like_dir)
    assert len(paths) == len(refs), "image and reference folders differ in size"
    loop_info = LoopInfo(len(paths), 10, "upsampling", True)
    for idx, (p, pref) in enumerate(zip(paths, refs)):
        loop_info.update(idx)
        out = os.path.join(resample_image_result_dir, os.path.basename(p))
        im, aff, h = load_volume(p, im_only=False)
        ref, ref_aff, ref_h = load_volume(pref, im_only=False)
        if recompute or not os.path.isfile(out):
            up = ev.resample_volume_like(ref, ref_aff, im, aff)
            save_volume(up, ref_aff, ref_h, out)
        if build_dist_map:
            out_d = os.path.join(resample_image_result_dir,
                                 "dist_map_" + os.path.basename(p))
            if recompute or not os.path.isfile(out_d):
                # header zooms (always length 3) rather than get_volume_info,
                # whose channel heuristic miscounts dims on small volumes
                image_res = np.asarray(h.zooms[:3], np.float64)
                # LR voxel coordinates of every HR voxel
                t = np.linalg.inv(aff) @ ref_aff
                mesh = np.meshgrid(*[np.arange(s) for s in ref.shape[:3]],
                                   indexing="ij")
                coords = np.stack([m.ravel() for m in mesh]
                                  + [np.ones(mesh[0].size)])
                lr = (t @ coords)[:3].reshape(3, *ref.shape[:3])
                d = np.minimum(lr - np.floor(lr), np.ceil(lr) - lr)
                d = d * np.asarray(image_res[:3]).reshape(3, 1, 1, 1)
                dist = np.sqrt(np.sum(d ** 2, axis=0))
                save_volume(dist, ref_aff, ref_h, out_d)


def simulate_upsampled_anisotropic_images(image_dir, downsample_image_result_dir,
                                          resample_image_result_dir, data_res,
                                          labels_dir=None,
                                          downsample_labels_result_dir=None,
                                          slice_thickness=None,
                                          build_dist_map=False,
                                          path_freesurfer=None, gpu=False,
                                          recompute=True):
    """HR -> blurred+NN-downsampled LR -> linearly re-upsampled eval pairs
    (reference :1805-1929).  Native resampling replaces mri_convert."""
    del path_freesurfer, gpu
    os.makedirs(downsample_image_result_dir, exist_ok=True)
    os.makedirs(resample_image_result_dir, exist_ok=True)
    if labels_dir is not None:
        assert downsample_labels_result_dir is not None, \
            "downsample_labels_result_dir required with labels_dir"
        os.makedirs(downsample_labels_result_dir, exist_ok=True)
    paths = list_images_in_folder(image_dir)
    lab_paths = [None] * len(paths) if labels_dir is None \
        else list_images_in_folder(labels_dir)
    _, _, n_dims, _, _, image_res = ev.get_volume_info(paths[0], aff_ref=np.eye(4))
    data_res = np.squeeze(reformat_to_n_channels_array(data_res, n_dims, 1))
    slice_thickness = reformat_to_list(slice_thickness, length=n_dims) \
        if slice_thickness is not None else None

    loop_info = LoopInfo(len(paths), 10, "processing", True)
    for idx, (p, pl) in enumerate(zip(paths, lab_paths)):
        loop_info.update(idx)
        down_path = os.path.join(downsample_image_result_dir, os.path.basename(p))
        up_path = os.path.join(resample_image_result_dir, os.path.basename(p))
        im, aff, h = load_volume(p, im_only=False)
        n_d, _ = get_dims(im.shape)
        im, aff_al = ev.align_volume_to_ref(im, aff, aff_ref=np.eye(4),
                                            return_aff=True, n_dims=n_d)
        res = np.sqrt(np.sum(aff_al[:3, :3] ** 2, axis=0))
        sigma = blurring_sigma_np(res, data_res, thickness=slice_thickness)
        sigma = np.where(np.asarray(data_res) == res, 0.0, sigma)
        if recompute or not os.path.isfile(down_path):
            blurred = ev.blur_volume(im, sigma)
            down, down_aff = ev.resample_volume(blurred, aff_al, data_res,
                                                interpolation="nearest", blur=False)
            save_volume(down, down_aff, h, down_path)
        if recompute or not os.path.isfile(up_path):
            down, down_aff, _ = load_volume(down_path, im_only=False)
            up = ev.resample_volume_like(im, aff_al, down, down_aff)
            if build_dist_map:
                t = np.linalg.inv(down_aff) @ aff_al
                mesh = np.meshgrid(*[np.arange(s) for s in im.shape[:3]],
                                   indexing="ij")
                coords = np.stack([m.ravel() for m in mesh]
                                  + [np.ones(mesh[0].size)])
                lr = (t @ coords)[:3].reshape(3, *im.shape[:3])
                d = np.minimum(lr - np.floor(lr), np.ceil(lr) - lr)
                d = d * np.asarray(data_res).reshape(3, 1, 1, 1)
                dist = np.sqrt(np.sum(d ** 2, axis=0))
                up = np.stack([up, dist], axis=-1)
            save_volume(up, aff_al, h, up_path)
        if pl is not None:
            lab_out = os.path.join(downsample_labels_result_dir, os.path.basename(pl))
            if recompute or not os.path.isfile(lab_out):
                lab, laff, lh = load_volume(pl, im_only=False, dtype="int32")
                lab, laff_al = ev.align_volume_to_ref(lab, laff, aff_ref=np.eye(4),
                                                      return_aff=True, n_dims=n_d)
                lab_d, lab_aff = ev.resample_volume(lab.astype(np.float32), laff_al,
                                                    data_res,
                                                    interpolation="nearest",
                                                    blur=False)
                save_volume(np.round(lab_d).astype(np.int32), lab_aff, lh, lab_out)


# --------------------------- label batch tools -----------------------------

def correct_labels_in_dir(labels_dir, results_dir, incorrect_labels,
                          correct_labels=None, use_nearest_label=False,
                          remove_zero=False, smooth=False, recompute=True):
    """(reference :1980-2014)"""
    return _iterate(labels_dir, results_dir,
                    lambda v, a, h, p, i: (correct_label_map(
                        v.astype(np.int32), incorrect_labels, correct_labels,
                        use_nearest_label, remove_zero, smooth), a),
                    recompute, "correcting", dtype="int32")


def mask_labels_in_dir(labels_dir, result_dir, values_to_keep, masking_value=0,
                       mask_result_dir=None, recompute=True):
    """(reference :2017-2057)"""
    if mask_result_dir is not None:
        os.makedirs(mask_result_dir, exist_ok=True)

    def fn(v, a, h, p, idx):
        out, mask = mask_label_map(v.astype(np.int32), values_to_keep,
                                   masking_value, return_mask=True)
        if mask_result_dir is not None:
            save_volume(mask, a, h,
                        os.path.join(mask_result_dir, os.path.basename(p)))
        return out, a

    return _iterate(labels_dir, result_dir, fn, recompute, "masking", dtype="int32")


def smooth_labels_in_dir(labels_dir, result_dir, gpu=False, labels_list=None,
                         connectivity=1, recompute=True):
    """(reference :2060-2124)"""
    del gpu
    from ..utils.misc import build_binary_structure

    def fn(v, a, h, p, idx):
        n_dims, _ = get_dims(v.shape)
        kernel = build_binary_structure(connectivity, n_dims)
        return smooth_label_map(v.astype(np.int32), kernel,
                                labels_list=labels_list), a

    return _iterate(labels_dir, result_dir, fn, recompute, "smoothing",
                    dtype="int32")


def erode_labels_in_dir(labels_dir, result_dir, labels_to_erode,
                        erosion_factors=1.0, gpu=False, recompute=True):
    """(reference :2158-2185)"""
    del gpu
    return _iterate(labels_dir, result_dir,
                    lambda v, a, h, p, i: (erode_label_map(
                        v.astype(np.int32), labels_to_erode, erosion_factors), a),
                    recompute, "eroding", dtype="int32")


def upsample_labels_in_dir(labels_dir, target_res, result_dir,
                           path_label_list=None, recompute=True):
    """One-hot, blur-free NN upsampling of label maps (reference :2188-2264
    common path: resample each map to target_res with nearest interpolation)."""
    def fn(v, a, h, p, idx):
        out, aff = ev.resample_volume(v.astype(np.float32), a,
                                      reformat_to_list(target_res, length=3),
                                      interpolation="nearest", blur=False)
        return np.round(out).astype(np.int32), aff

    return _iterate(labels_dir, result_dir, fn, recompute, "upsampling",
                    dtype="int32")


def compute_hard_volumes_in_dir(labels_dir, voxel_volume=None, path_label_list=None,
                                skip_background=True, path_numpy_result=None):
    """(reference :2267-2340). Returns (n_labels, n_subjects) array."""
    from ..utils.misc import load_array_if_path

    paths = list_images_in_folder(labels_dir)
    label_list = load_array_if_path(path_label_list)
    results = []
    for p in paths:
        lab, aff, _ = load_volume(p, im_only=False, dtype="int32")
        vv = voxel_volume
        if vv is None:
            vv = float(np.abs(np.linalg.det(aff[:3, :3])))
        results.append(compute_hard_volumes(lab, vv, label_list, skip_background))
    out = np.stack(results, axis=-1)
    if path_numpy_result is not None:
        os.makedirs(os.path.dirname(path_numpy_result) or ".", exist_ok=True)
        np.save(path_numpy_result, out)
    return out


def build_atlas(labels_dir, label_list, align_centre_of_mass=False, margin=15,
                shape=None, path_atlas=None):
    """Probabilistic atlas: average one-hot label maps, optionally centred on
    the foreground centre of mass (reference :2343-2414)."""
    from ..utils.misc import load_array_if_path

    paths = list_images_in_folder(labels_dir)
    label_list = np.asarray(load_array_if_path(label_list))
    atlas = None
    aff0 = None
    for idx, p in enumerate(paths):
        lab, aff, _ = load_volume(p, im_only=False, dtype="int32")
        if aff0 is None:
            aff0 = aff
        if shape is not None:
            lab, _ = ev.crop_volume(lab, cropping_shape=reformat_to_list(shape, 3),
                                    aff=aff)
            lab = ev.pad_volume(lab, reformat_to_list(shape, 3))
        if align_centre_of_mass:
            com = np.round(np.array(np.where(lab > 0)).mean(1)).astype(int)
            centre = np.array(lab.shape[:3]) // 2
            lab = np.roll(lab, tuple(centre - com), axis=(0, 1, 2))
        onehot = np.stack([(lab == la) for la in label_list], -1).astype(np.float32)
        atlas = onehot if atlas is None else atlas + onehot
    atlas = atlas / len(paths)
    if path_atlas is not None:
        save_volume(atlas, aff0, None, path_atlas)
    return atlas


# ------------------------------ dataset checks -----------------------------

def check_images_in_dir(image_dir, check_values=False, keep_unique=True,
                        max_channels=10, verbose=True):
    """Collect shapes/res (and value ranges) across a dir (reference :1932-1977)."""
    shapes, res, values = [], [], []
    for p in list_images_in_folder(image_dir):
        if check_values:
            im, shape, aff, n_dims, _, h, data_res = ev.get_volume_info(
                p, return_volume=True, max_channels=max_channels)
            values.append(np.unique(im))
        else:
            shape, aff, n_dims, _, h, data_res = ev.get_volume_info(
                p, max_channels=max_channels)
        shapes.append(shape)
        res.append(data_res)
        if verbose:
            print(os.path.basename(p), shape, np.around(data_res, 3))
    if keep_unique:
        shapes = np.unique(np.array(shapes), axis=0)
        res = np.unique(np.around(np.array(res), 3), axis=0)
    out = [shapes, res]
    if check_values:
        out.append(values)
    return out


def check_images_and_labels(image_dir, labels_dir, verbose=True):
    """Check image/label pairing: same shapes and affines (reference :2417-2454)."""
    p_im = list_images_in_folder(image_dir)
    p_lab = list_images_in_folder(labels_dir)
    assert len(p_im) == len(p_lab), "different numbers of images and labels"
    problems = []
    for pi, pl in zip(p_im, p_lab):
        im, aff_i, _ = load_volume(pi, im_only=False)
        lab, aff_l, _ = load_volume(pl, im_only=False)
        ok = (im.shape[:3] == lab.shape[:3]) and np.allclose(aff_i, aff_l, atol=1e-3)
        if not ok:
            problems.append((pi, pl))
            if verbose:
                print(f"mismatch: {pi} vs {pl}")
    return problems


# ---------------------------- dataset croppers -----------------------------

def crop_dataset_to_minimum_size(labels_dir, result_dir, image_dir=None,
                                 image_result_dir=None, margin=5):
    """Crop all label maps (and images) to the common minimal foreground box
    (reference :2457-2519)."""
    p_lab = list_images_in_folder(labels_dir)
    p_im = list_images_in_folder(image_dir) if image_dir is not None else None
    if p_im is not None:
        assert image_result_dir is not None
        os.makedirs(image_result_dir, exist_ok=True)
    os.makedirs(result_dir, exist_ok=True)

    # first pass: maximum box size across the dataset
    max_size = np.zeros(3, int)
    for p in p_lab:
        lab = load_volume(p, dtype="int32")
        _, crop = crop_volume_around_region(lab, margin=margin)
        if crop is None:
            continue
        n = len(crop) // 2
        max_size = np.maximum(max_size, np.array(crop[n:]) - np.array(crop[:n]))

    for idx, p in enumerate(p_lab):
        lab, aff, h = load_volume(p, im_only=False, dtype="int32")
        cropped, crop, aff_c = crop_volume_around_region(
            lab, cropping_shape=list(max_size), aff=aff, overflow="shift-padding")
        save_volume(cropped, aff_c, h, os.path.join(result_dir, os.path.basename(p)))
        if p_im is not None:
            im, aff_i, h_i = load_volume(p_im[idx], im_only=False)
            n = len(crop) // 2
            slicer = tuple(slice(int(crop[i]), int(crop[i + n])) for i in range(n))
            save_volume(im[slicer], aff_c, h_i,
                        os.path.join(image_result_dir, os.path.basename(p_im[idx])))
    return list(max_size)


def crop_dataset_around_region(image_dir, labels_dir, image_result_dir,
                               labels_result_dir, margin=0, masking_labels=None,
                               recompute=True):
    """Crop each image/label pair around the label region (reference :2624-2691)."""
    os.makedirs(image_result_dir, exist_ok=True)
    os.makedirs(labels_result_dir, exist_ok=True)
    p_im = list_images_in_folder(image_dir)
    p_lab = list_images_in_folder(labels_dir)
    for pi, pl in zip(p_im, p_lab):
        out_i = os.path.join(image_result_dir, os.path.basename(pi))
        out_l = os.path.join(labels_result_dir, os.path.basename(pl))
        if os.path.isfile(out_i) and os.path.isfile(out_l) and not recompute:
            continue
        lab, aff_l, h_l = load_volume(pl, im_only=False, dtype="int32")
        im, aff_i, h_i = load_volume(pi, im_only=False)
        cropped_lab, crop, aff_c = crop_volume_around_region(
            lab, masking_labels=masking_labels, margin=margin, aff=aff_l)
        if crop is None:
            continue
        n = len(crop) // 2
        slicer = tuple(slice(int(crop[i]), int(crop[i + n])) for i in range(n))
        save_volume(cropped_lab, aff_c, h_l, out_l)
        save_volume(im[slicer], aff_c, h_i, out_i)


def subdivide_dataset_to_patches(patch_shape, image_dir=None, image_result_dir=None,
                                 labels_dir=None, labels_result_dir=None,
                                 full_background=True, remove_after_dividing=False):
    """Split volumes into non-overlapping patches (reference :2694-2795).
    Patches are written as <name>_<i>.nii.gz; label patches that are entirely
    background are skipped (with their image twin) unless full_background."""
    assert (image_dir is None) == (image_result_dir is None)
    assert (labels_dir is None) == (labels_result_dir is None)
    patch_shape = reformat_to_list(patch_shape, length=3, dtype="int")
    p_im = list_images_in_folder(image_dir) if image_dir is not None else None
    p_lab = list_images_in_folder(labels_dir) if labels_dir is not None else None
    if image_result_dir is not None:
        os.makedirs(image_result_dir, exist_ok=True)
    if labels_result_dir is not None:
        os.makedirs(labels_result_dir, exist_ok=True)
    n = len(p_im) if p_im is not None else len(p_lab)

    for idx in range(n):
        im = aff_i = h_i = lab = aff_l = h_l = None
        if p_im is not None:
            im, aff_i, h_i = load_volume(p_im[idx], im_only=False)
        if p_lab is not None:
            lab, aff_l, h_l = load_volume(p_lab[idx], im_only=False, dtype="int32")
        shape = (im if im is not None else lab).shape[:3]
        counter = 0
        for x0 in range(0, shape[0] - patch_shape[0] + 1, patch_shape[0]):
            for y0 in range(0, shape[1] - patch_shape[1] + 1, patch_shape[1]):
                for z0 in range(0, shape[2] - patch_shape[2] + 1, patch_shape[2]):
                    slicer = (slice(x0, x0 + patch_shape[0]),
                              slice(y0, y0 + patch_shape[1]),
                              slice(z0, z0 + patch_shape[2]))
                    lab_patch = lab[slicer] if lab is not None else None
                    if (lab_patch is not None and not full_background
                            and not np.any(lab_patch)):
                        continue
                    suffix = f"_{counter}.nii.gz"
                    if im is not None:
                        name = os.path.basename(p_im[idx]).split(".")[0] + suffix
                        save_volume(im[slicer], aff_i, h_i,
                                    os.path.join(image_result_dir, name))
                    if lab_patch is not None:
                        name = os.path.basename(p_lab[idx]).split(".")[0] + suffix
                        save_volume(lab_patch, aff_l, h_l,
                                    os.path.join(labels_result_dir, name))
                    counter += 1
        if remove_after_dividing:
            if p_im is not None:
                os.remove(p_im[idx])
            if p_lab is not None:
                os.remove(p_lab[idx])
