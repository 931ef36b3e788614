"""The port's own copies of the JAX package's host modules (NIfTI I/O, volume
geometry, host resample matrices, label lists, the label-map sampler, Keras
.h5 import, misc helpers, the CLIs' path handling) against their originals:
the same calls on the same seeded inputs give equal results."""

import inspect
import os
import types

import numpy as np
import pytest

import synthsr_tpu.cli.predict as jax_predict
import synthsr_tpu.cli.predict_hyperfine as jax_hyperfine
import synthsr_tpu.io.labels as jax_labels
import synthsr_tpu.io.volume as jax_volume
import synthsr_tpu.models.h5_import as jax_h5
import synthsr_tpu.ops.host_matrices as jax_matrices
import synthsr_tpu.synth.model_inputs as jax_inputs
import synthsr_tpu.utils.misc as jax_misc
import synthsr_tpu_torch.cli.predict as port_predict
import synthsr_tpu_torch.cli.predict_hyperfine as port_hyperfine
import synthsr_tpu_torch.io.labels as port_labels
import synthsr_tpu_torch.io.volume as port_volume
import synthsr_tpu_torch.models.h5_import as port_h5
import synthsr_tpu_torch.ops.host_matrices as port_matrices
import synthsr_tpu_torch.synth.model_inputs as port_inputs
import synthsr_tpu_torch.utils.misc as port_misc
from synthsr_tpu_torch.models.weights import random_variables

JAX = types.SimpleNamespace(volume=jax_volume, labels=jax_labels, matrices=jax_matrices,
                            inputs=jax_inputs, h5=jax_h5, misc=jax_misc, predict=jax_predict,
                            hyperfine=jax_hyperfine)
PORT = types.SimpleNamespace(volume=port_volume, labels=port_labels, matrices=port_matrices,
                             inputs=port_inputs, h5=port_h5, misc=port_misc,
                             predict=port_predict, hyperfine=port_hyperfine)


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
    for perm, flips in (((1, 0, 2), (1, -1, 1)), ((2, 0, 1), (-1, -1, 1)), ((0, 1, 2), (1, 1, -1))):
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


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", list(CASES))
def test_port_copy_equals_original(name, tmp_path):
    """The same calls through the port's copy and the JAX package's original
    give equal results (values, dtypes, shapes)."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    _assert_equal(CASES[name](PORT, tmp_path / "port"), CASES[name](JAX, tmp_path / "jax"))


VOLUME_FUNCTIONS = [n for n, f in vars(port_volume).items()
                    if inspect.isfunction(f) and f.__module__ == port_volume.__name__
                    and not n.startswith("_")]


@pytest.mark.parametrize("name", VOLUME_FUNCTIONS)
def test_volume_signature_equals_original(name):
    """Each public function of the port's io/volume.py takes its original's
    parameters, in the original's order and with its defaults, so a
    positional call means the same in both packages."""
    assert inspect.signature(getattr(port_volume, name)) == \
        inspect.signature(getattr(jax_volume, name))


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
