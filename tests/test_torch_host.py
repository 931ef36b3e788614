"""The port's own copies of the JAX package's host modules (NIfTI I/O, volume
geometry and edits, host resample matrices, label lists, label-map editing,
the directory dataset tools, the prior estimation, the label-map sampler,
Keras .h5 import, misc helpers, the CLIs' path handling, the PSNR parity
harness) against their originals: the same calls on the same seeded inputs
give equal results, and every public function has its original's
signature."""

import inspect
import itertools
import os
import types

import numpy as np
import pytest

import synthsr_tpu.cli.parity as jax_parity
import synthsr_tpu.cli.predict as jax_predict
import synthsr_tpu.cli.predict_hyperfine as jax_hyperfine
import synthsr_tpu.io.dataset_tools as jax_dataset_tools
import synthsr_tpu.io.label_edit as jax_label_edit
import synthsr_tpu.io.labels as jax_labels
import synthsr_tpu.io.volume as jax_volume
import synthsr_tpu.models.h5_import as jax_h5
import synthsr_tpu.ops.host_matrices as jax_matrices
import synthsr_tpu.synth.estimate_priors as jax_priors
import synthsr_tpu.synth.model_inputs as jax_inputs
import synthsr_tpu.utils.misc as jax_misc
import synthsr_tpu_torch.cli.parity as port_parity
import synthsr_tpu_torch.cli.predict as port_predict
import synthsr_tpu_torch.cli.predict_hyperfine as port_hyperfine
import synthsr_tpu_torch.io.dataset_tools as port_dataset_tools
import synthsr_tpu_torch.io.label_edit as port_label_edit
import synthsr_tpu_torch.io.labels as port_labels
import synthsr_tpu_torch.io.volume as port_volume
import synthsr_tpu_torch.models.h5_import as port_h5
import synthsr_tpu_torch.ops.host_matrices as port_matrices
import synthsr_tpu_torch.synth.estimate_priors as port_priors
import synthsr_tpu_torch.synth.model_inputs as port_inputs
import synthsr_tpu_torch.utils.misc as port_misc
from synthsr_tpu_torch.models.weights import random_variables

JAX = types.SimpleNamespace(volume=jax_volume, labels=jax_labels, matrices=jax_matrices,
                            inputs=jax_inputs, h5=jax_h5, misc=jax_misc, predict=jax_predict,
                            hyperfine=jax_hyperfine, label_edit=jax_label_edit,
                            dataset_tools=jax_dataset_tools, priors=jax_priors,
                            parity=jax_parity)
PORT = types.SimpleNamespace(volume=port_volume, labels=port_labels, matrices=port_matrices,
                             inputs=port_inputs, h5=port_h5, misc=port_misc,
                             predict=port_predict, hyperfine=port_hyperfine,
                             label_edit=port_label_edit, dataset_tools=port_dataset_tools,
                             priors=port_priors, parity=port_parity)


def _assert_equal(a, b, where="result"):
    """Exact equality, recursing through sequences and dicts; numpy arrays
    also keep their dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _oblique(deg, zooms=(1.5, 1.5, 5.0)):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    aff = np.eye(4)
    aff[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag(zooms)
    aff[:3, 3] = [-40.0, -30.0, -20.0]
    return aff


def _label_dir(tmp_path):
    rng = np.random.default_rng(3)
    d = tmp_path / "labels"
    d.mkdir()
    ids = np.array([0, 2, 3, 14, 41, 42])
    for i in range(3):
        lab = ids[rng.integers(0, len(ids), size=(12, 14, 11))]
        aff = np.diag([1.0, -1.0, 1.0, 1.0]) if i == 1 else np.eye(4)
        jax_volume.save_volume(lab.astype(np.int32), aff, None, str(d / f"lab{i}.nii.gz"))
    return d


def _h5_file(tmp_path):
    path = str(tmp_path / "w.h5")
    jax_h5.export_keras_unet_weights(path, random_variables(dict(nb_features=4, nb_levels=2),
                                                            seed=4))
    return path


def case_volume_info(m, tmp_path):
    d = _label_dir(tmp_path)
    return [m.volume.get_volume_info(str(d / "lab1.nii.gz"), return_volume=True,
                                     aff_ref=np.eye(4))[k] for k in (0, 1, 3, 4, 6)]


def case_align_volume_to_ref(m, tmp_path):
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(7, 9, 11)).astype(np.float32)
    out = []
    # the 48 orientations of RAS: 3! axis orders by 2^3 flips
    for perm, flips in itertools.product(itertools.permutations(range(3)),
                                         itertools.product((1, -1), repeat=3)):
        aff = np.eye(4)
        aff[:3, :3] = np.eye(3)[:, list(perm)] * np.array(flips) * np.array([1.2, 0.9, 2.0])
        aff[:3, 3] = rng.normal(size=3) * 10
        out.append(m.volume.align_volume_to_ref(vol, aff, aff_ref=np.eye(4), return_aff=True,
                                                n_dims=3))
        out.append(m.volume.get_ras_axes(aff))
    return out


def case_resample_volume_like(m, tmp_path):
    rng = np.random.default_rng(2)
    ref = np.zeros((20, 18, 16), np.float32)
    flo = rng.uniform(0, 100, (14, 12, 5)).astype(np.float32)
    return m.volume.resample_volume_like(ref, np.eye(4), flo, _oblique(12.0))


def case_resample_volume_matrices(m, tmp_path):
    aff = np.diag([1.5, 1.5, 5.0, 1.0])
    aff[:3, 3] = [3.0, -2.0, 7.0]
    return [m.matrices.resample_volume_matrices((40, 36, 12), aff, [1.0, 1.0, 1.0]),
            m.matrices.resample_volume_matrices((10, 11, 12), np.diag([0.7, 1.0, 2.5, 1.0]),
                                                [1.0, 1.0, 1.0], interpolation="nearest")]


def case_reslice_like_matrices(m, tmp_path):
    ref_aff = np.diag([1.0, 1.0, 1.0, 1.0])
    flo_aff = np.diag([1.5, 1.5, 5.0, 1.0])
    flo_aff[:3, 3] = [-4.0, 2.0, -9.0]
    return [m.matrices.reslice_like_matrices((30, 28, 40), ref_aff, (20, 19, 8), flo_aff),
            m.matrices.reslice_like_matrices((30, 28, 40), ref_aff, (20, 19, 8), _oblique(20.0))]


def case_get_list_labels(m, tmp_path):
    d = str(_label_dir(tmp_path))
    return [m.labels.get_list_labels(labels_dir=d, FS_sort=True),
            m.labels.get_list_labels(labels_dir=d),
            m.labels.get_list_labels(label_list=[41, 0, 2, 14, 3], FS_sort=True)]


def case_build_model_inputs(m, tmp_path):
    d = _label_dir(tmp_path)
    paths = sorted(str(p) for p in d.iterdir())
    means = np.random.default_rng(5).uniform(20, 200, (4, 6)).astype(np.float32)
    stds = np.random.default_rng(6).uniform(1, 10, (4, 6)).astype(np.float32)
    gen = m.inputs.build_model_inputs(paths, 6, means, stds, batchsize=2, n_channels=2,
                                      rng=np.random.default_rng(7))
    labels_only = m.inputs.build_model_inputs(paths, 6, None, None, batchsize=1,
                                              rng=np.random.default_rng(8),
                                              include_gmm_params=False)
    # a data-parallel rank's slice: rank 1 of 2 at a global batch of 4
    sliced = m.inputs.build_model_inputs(paths, 6, means, stds, batchsize=4, n_channels=2,
                                         rng=np.random.default_rng(9), local_slice=(1, 2))
    sliced_labels = m.inputs.build_model_inputs(paths, 6, None, None, batchsize=2,
                                                rng=np.random.default_rng(10),
                                                include_gmm_params=False, local_slice=(0, 2))
    return [next(gen), next(gen), next(labels_only), next(sliced), next(sliced),
            next(sliced_labels)]


def case_h5_import(m, tmp_path):
    path = _h5_file(tmp_path)
    template = random_variables(dict(nb_features=4, nb_levels=2), seed=9)
    return [m.h5.load_keras_unet_weights(path, template),
            m.h5.load_keras_unet_weights(path, template, skip_layers=("likelihood",))]


def case_misc(m, tmp_path):
    f = m.misc
    return [f.reformat_to_list(3, length=3), f.reformat_to_list(np.array([1.0, 2.0, 3.0])),
            f.reformat_to_list((1, 2), dtype="float"), f.reformat_to_n_channels_array(
                [1.0, 2.0, 3.0], n_channels=2), f.get_dims((20, 20, 20, 3)),
            f.get_padding_margin(128, 96), f.get_padding_margin([160, 128, 96], 96),
            [f.infer(s) for s in ("1e-4", "True", "false", "abc")],
            f.get_mapping_lut([0, 2, 41, 3]), f.find_closest_number_divisible_by_m(37, 8, "closer"),
            f.draw_value_from_distribution(None, 4, "uniform", 125.0, 100.0,
                                           rng=np.random.default_rng(1)),
            f.draw_value_from_distribution(np.array([[1.0, 2.0], [3.0, 4.0]] * 2), 2, "normal",
                                           positive_only=True, rng=np.random.default_rng(2))]


def case_cli_paths(m, tmp_path):
    d1, d2 = tmp_path / "t1", tmp_path / "t2"
    d1.mkdir()
    d2.mkdir()
    for d in (d1, d2):
        for name in ("b.nii", "a.nii.gz", "c.mgz"):
            jax_volume.save_volume(np.zeros((11, 11, 11), np.float32), np.eye(4), None,
                                   str(d / name))
    lists = [*m.predict._prepare_paths(str(d1), str(tmp_path / "out")),
             *m.predict._prepare_paths(str(d1 / "a.nii.gz"), str(tmp_path / "o.nii.gz")),
             *m.hyperfine._prepare_paths(str(d1), str(d2), str(tmp_path / "out2"))]
    return [[os.path.relpath(p, tmp_path) for p in paths] for paths in lists]


def case_volume_edits(m, tmp_path):
    """resample / blur / mask / rescale / crop / pad / flip (io/volume.py:153-355)."""
    v = m.volume
    rng = np.random.default_rng(11)
    vol = rng.uniform(0, 100, (14, 12, 11)).astype(np.float32)
    vol4 = rng.uniform(0, 100, (14, 12, 11, 2)).astype(np.float32)
    aff = np.diag([1.5, 1.0, 2.0, 1.0])
    aff[:3, 3] = [3.0, -2.0, 7.0]
    mask = (rng.uniform(size=vol.shape) > 0.3).astype(np.float32)
    return [v.resample_volume(vol, aff, [1.0, 1.0, 1.0]),
            v.resample_volume(vol, aff, 2.0, interpolation="nearest", blur=False),
            v.blur_volume(vol, 1.2), v.blur_volume(vol, [0.8, 1.0, 1.5], mask=mask),
            v.mask_volume(vol, threshold=40.0, dilate=1, erode=1, fill_holes=True,
                          return_mask=True),
            v.mask_volume(vol4, mask=mask, masking_value=-1),
            v.rescale_volume(vol), v.rescale_volume(vol, 0, 1, 0, 100, use_positive_only=True),
            v.crop_volume(vol, cropping_margin=2, aff=aff, return_crop_idx=True),
            v.crop_volume(vol4, cropping_shape=[8, 6, 4]),
            v.crop_volume_with_idx(vol, [1, 2, 3, 9, 10, 8], aff=aff),
            v.pad_volume(vol, 16, aff=aff, return_pad_idx=True),
            v.pad_volume(vol4, [16, 14, 12], padding_value=3),
            v.flip_volume(vol, axis=1), v.flip_volume(vol, direction="si", aff=aff)]


def case_misc_more(m, tmp_path):
    f = m.misc
    pk = str(tmp_path / "obj.pkl")
    f.write_pickle(pk, {"a": np.arange(3), "b": [1, 2]})
    gen = f.build_training_generator(iter([np.ones(2), np.zeros(2)]), 3)
    summary = str(tmp_path / "summary.txt")
    variables = random_variables(dict(nb_features=2, nb_levels=2), seed=3)
    total = f.write_model_summary(variables, summary, line_length=80)
    return [f.add_axis(np.ones((2, 3)), [0, -1]), f.build_binary_structure(2, 3),
            f.build_binary_structure(1, 3, shape=[3, 5, 3]), f.read_pickle(pk),
            f.create_affine_transformation_matrix(3, [1.1, 0.9, 1.0], [10.0, -5.0, 3.0],
                                                  np.arange(6) * 0.01, [1.0, 2.0, 3.0]),
            f.create_affine_transformation_matrix(2, rotation=[30.0]), next(gen), next(gen),
            total, open(summary).read()]


def _toy_labels():
    lab = np.zeros((20, 20, 20), np.int32)
    lab[4:16, 4:16, 4:16] = 2
    lab[8:12, 8:12, 8:12] = 3
    lab[10, 10, 10] = 5
    return lab


def case_label_edit(m, tmp_path):
    """Every function of io/label_edit.py on tests/test_label_edit.py's toys."""
    e = m.label_edit
    lab = _toy_labels()
    mask = np.zeros((10, 10, 10), bool)
    mask[1:3, 1:3, 1:3] = True
    mask[5:9, 5:9, 5:9] = True
    corner = np.zeros((12, 12, 12), np.int32)
    corner[0:2, 0:2, 0:2] = 1
    two = np.zeros((24, 24, 24), np.int32)
    two[2:12, 2:22, 2:22] = 2
    two[12:22, 2:22, 2:22] = 4
    return [e.crop_volume_around_region(lab, masking_labels=3, margin=2),
            e.crop_volume_around_region(corner, masking_labels=1, cropping_shape=8,
                                        overflow="padding"),
            e.mask_label_map(lab, [3], return_mask=True), e.correct_label_map(lab, [3], [7]),
            e.correct_label_map(lab, [3, 5], use_nearest_label=True),
            e.smooth_label_map(lab, np.ones((3, 3, 3))), e.erode_label_map(two, [2, 4], 1),
            e.get_largest_connected_component(mask),
            e.compute_hard_volumes(lab, voxel_volume=2.0, label_list=[0, 2, 3]),
            e.compute_distance_map(lab), e.compute_distance_map(lab, masking_labels=[3],
                                                                crop_margin=2)]


def _dataset(m, tmp_path):
    """tests/test_dataset_tools.py's three images and label maps."""
    img_dir, lab_dir = tmp_path / "img", tmp_path / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        lab = np.zeros((24, 24, 24), np.int32)
        lab[6:18, 6:18, 6:18] = rng.integers(1, 4, (12, 12, 12))
        img = lab * 40.0 + rng.normal(0, 3, lab.shape)
        m.volume.save_volume(lab, np.eye(4), None, str(lab_dir / f"s{i}.nii.gz"))
        m.volume.save_volume(img.astype(np.float32), np.eye(4), None,
                             str(img_dir / f"s{i}.nii.gz"))
    return str(img_dir), str(lab_dir)


def _read_dir(tmp_path, sub):
    """Every volume written under ``sub``, as (relative name, data, affine)."""
    out = []
    for root, _, names in sorted(os.walk(tmp_path / sub)):
        for n in sorted(names):
            p = os.path.join(root, n)
            if n.endswith(".npy"):
                out.append((os.path.relpath(p, tmp_path), np.load(p)))
            else:
                vol, aff, _ = jax_volume.load_volume(p, im_only=False, fast=False)
                out.append((os.path.relpath(p, tmp_path), vol, aff))
    return out


def case_dataset_tools_images(m, tmp_path):
    dt = m.dataset_tools
    img_dir, lab_dir = _dataset(m, tmp_path)
    o = str(tmp_path / "out")
    dt.rescale_images_in_dir(img_dir, o + "/rescaled", min_percentile=0, max_percentile=100)
    dt.crop_images_in_dir(img_dir, o + "/c", cropping_shape=16)
    shape = dt.pad_images_in_dir(o + "/c", o + "/p", max_shape=[20, 20, 20])
    dt.flip_images_in_dir(img_dir, o + "/f", axis=0)
    dt.mask_images_in_dir(img_dir, o + "/m", threshold=20.0)
    dt.mask_images_in_dir(img_dir, o + "/mm", mask_dir=lab_dir, dilate=1)
    dt.create_mutlimodal_images([img_dir, img_dir], o + "/multi")
    dt.align_images_in_dir(img_dir, o + "/aligned", aff_ref=np.diag([-1.0, 1.0, 1.0, 1.0]))
    dt.correct_nans_images_in_dir(img_dir, o + "/nans")
    dt.blur_images_in_dir(img_dir, o + "/blur", 1.0, mask_dir=lab_dir)
    dt.crop_images_around_region_in_dir(img_dir, o + "/region", mask_dir=lab_dir)
    dt.simulate_upsampled_anisotropic_images(
        img_dir, o + "/down", o + "/up", data_res=[1, 1, 3], labels_dir=lab_dir,
        downsample_labels_result_dir=o + "/labdown", build_dist_map=True)
    dt.upsample_anisotropic_images(o + "/down", o + "/up2", img_dir)
    checks = dt.check_images_in_dir(img_dir, check_values=True, verbose=False)
    return [shape, checks, dt.check_images_and_labels(img_dir, lab_dir, verbose=False),
            _read_dir(tmp_path, "out")]


def case_dataset_tools_labels(m, tmp_path):
    dt = m.dataset_tools
    img_dir, lab_dir = _dataset(m, tmp_path)
    o = str(tmp_path / "out")
    dt.correct_labels_in_dir(lab_dir, o + "/corr", [3], [1], smooth=True)
    dt.mask_labels_in_dir(lab_dir, o + "/ml", values_to_keep=[1], mask_result_dir=o + "/mk")
    dt.smooth_labels_in_dir(lab_dir, o + "/sl")
    dt.erode_labels_in_dir(lab_dir, o + "/el", labels_to_erode=[1])
    dt.upsample_labels_in_dir(lab_dir, 0.5, o + "/ul")
    vols = dt.compute_hard_volumes_in_dir(lab_dir, path_label_list=np.array([0, 1, 2, 3]),
                                          path_numpy_result=o + "/vols.npy")
    atlas = dt.build_atlas(lab_dir, np.array([0, 1, 2, 3]), align_centre_of_mass=True,
                           margin=4, path_atlas=o + "/atlas.nii.gz")
    dt.crop_dataset_to_minimum_size(lab_dir, o + "/minl", image_dir=img_dir,
                                    image_result_dir=o + "/mini", margin=2)
    dt.crop_dataset_around_region(img_dir, lab_dir, o + "/ri", o + "/rl", margin=1)
    dt.subdivide_dataset_to_patches(12, image_dir=img_dir, image_result_dir=o + "/ip",
                                    labels_dir=lab_dir, labels_result_dir=o + "/lp",
                                    full_background=False)
    return [vols, atlas, _read_dir(tmp_path, "out")]


def case_estimate_priors(m, tmp_path):
    """tests/test_label_ops.py:76's priors round trip, and the per-image stats."""
    rng = np.random.default_rng(6)
    img_dir, lab_dir = tmp_path / "img", tmp_path / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    for i in range(3):
        lab = rng.integers(0, 2, (24, 24, 24)).astype(np.int32) * 2
        img = np.where(lab == 2, 200.0, 50.0) + rng.normal(0, 5, lab.shape)
        m.volume.save_volume(lab, np.eye(4), None, str(lab_dir / f"s{i}.nii.gz"))
        m.volume.save_volume(img.astype(np.float32), np.eye(4), None,
                             str(img_dir / f"s{i}.nii.gz"))
    stats = m.priors.build_intensity_stats([str(img_dir)], [str(lab_dir)],
                                           str(tmp_path / "out"), np.array([0, 2]),
                                           rescale=False)
    rescaled = m.priors.build_intensity_stats(str(img_dir), str(lab_dir),
                                              str(tmp_path / "out2"), np.array([0, 2]),
                                              estimation_classes=np.array([0, 1]))
    img = m.volume.load_volume(str(img_dir / "s0.nii.gz"))
    lab = m.volume.load_volume(str(lab_dir / "s0.nii.gz"), dtype="int32")
    return [stats, rescaled, m.priors.sample_intensity_stats_from_image(img, lab, [0, 2]),
            m.priors.estimate_t2_cropping(str(img_dir)), _read_dir(tmp_path, "out")]


def case_parity(m, tmp_path):
    """psnr and compare_dirs on two synthetic prediction directories
    (tests/test_predict.py:260)."""
    a = np.zeros((8, 8, 8), np.float32)
    d1, d2 = tmp_path / "p", tmp_path / "r"
    d1.mkdir()
    d2.mkdir()
    rng = np.random.default_rng(3)
    for name in ("s1.nii.gz", "s2.nii.gz"):
        v = rng.uniform(0, 128, (12, 12, 12)).astype(np.float32)
        m.volume.save_volume(v, np.eye(4), None, str(d1 / name))
        m.volume.save_volume(v + rng.normal(0, 1.28, v.shape).astype(np.float32), np.eye(4),
                             None, str(d2 / name))
    return [m.parity.psnr(a, a), m.parity.psnr(a, a + 1.28), m.parity.psnr(a, a + 0.5, 10.0),
            m.parity.compare_dirs(str(d1), str(d2)),
            m.parity.build_arg_parser().parse_args(["--tf_h5", "w", "--input_dir", "i"]).threshold]


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", list(CASES))
def test_port_copy_equals_original(name, tmp_path):
    """The same calls through the port's copy and the JAX package's original
    give equal results (values, dtypes, shapes)."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    _assert_equal(CASES[name](PORT, tmp_path / "port"), CASES[name](JAX, tmp_path / "jax"))


def _public_functions(mod):
    return [n for n, f in vars(mod).items()
            if inspect.isfunction(f) and f.__module__ == mod.__name__ and not n.startswith("_")]


VOLUME_FUNCTIONS = _public_functions(port_volume)
HOST_COPIES = ("misc", "label_edit", "dataset_tools", "priors", "parity", "inputs")
HOST_FUNCTIONS = [(mod, n) for mod in HOST_COPIES for n in _public_functions(getattr(PORT, mod))]


@pytest.mark.parametrize("name", VOLUME_FUNCTIONS)
def test_volume_signature_equals_original(name):
    """Each public function of the port's io/volume.py takes its original's
    parameters, in the original's order and with its defaults, so a
    positional call means the same in both packages."""
    assert inspect.signature(getattr(port_volume, name)) == \
        inspect.signature(getattr(jax_volume, name))


@pytest.mark.parametrize("mod,name", HOST_FUNCTIONS)
def test_host_copy_signature_equals_original(mod, name):
    """The same for every public function of the other host copies, and each
    original's public functions all exist in the port (the JAX package's
    compile-cache switch excepted: it configures JAX)."""
    assert inspect.signature(getattr(getattr(PORT, mod), name)) == \
        inspect.signature(getattr(getattr(JAX, mod), name))
    missing = set(_public_functions(getattr(JAX, mod))) - set(_public_functions(getattr(PORT, mod)))
    assert missing <= {"enable_persistent_compile_cache"}, missing


def test_parity_cli_our_half_on_the_cpu(tmp_path):
    """The port's parity CLI writes its predictions with ``.pt`` weights on the
    CPU, and a self-comparison passes (PSNR inf)."""
    import torch

    from synthsr_tpu_torch.models.weights import variables_to_state_dict

    weights = str(tmp_path / "w.pt")
    torch.save(variables_to_state_dict(random_variables(seed=0)), weights)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    rng = np.random.default_rng(8)
    port_volume.save_volume(rng.uniform(0, 100, (20, 24, 18)).astype(np.float32), np.eye(4),
                            None, str(in_dir / "input.nii.gz"))
    out = str(tmp_path / "ours")
    args = ["--tf_h5", weights, "--input_dir", str(in_dir), "--cpu"]
    assert port_parity.main(args + ["--output_dir", out]) == 0
    assert port_volume.load_volume(os.path.join(out, "input_SynthSR.nii.gz")).shape == (20, 24, 18)
    assert port_parity.main(args + ["--output_dir", str(tmp_path / "ours2"),
                                    "--reference_dir", out]) == 0


@pytest.mark.parametrize("ext", [".nii.gz", ".nii", ".mgz", ".npz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_volume_files_cross_read(ext, writer, tmp_path):
    """A volume saved by one package loads in both with equal data, affine and
    header zooms (float32 and int32 volumes, an oblique affine)."""
    rng = np.random.default_rng(4)
    save = (port_volume if writer == "port" else jax_volume).save_volume
    vols = {"f": rng.normal(size=(9, 8, 7)).astype(np.float32),
            "i": rng.integers(0, 60, size=(9, 8, 7)).astype(np.int32)}
    for key, vol in vols.items():
        path = str(tmp_path / f"{key}{ext}")
        save(vol, _oblique(7.0, (1.2, 0.8, 2.0)), None, path)
        got = port_volume.load_volume(path, im_only=False, dtype="float32")
        want = jax_volume.load_volume(path, im_only=False, dtype="float32")
        _assert_equal(got[:2], want[:2])
        _assert_equal(got[2].zooms, want[2].zooms)
        np.testing.assert_array_equal(port_volume.load_volume(path), vol)
