"""The port's C++ NIfTI loader (synthsr_tpu_torch/native/, behind
``io/volume.load_volume(fast=True)``), mirroring tests/test_native.py:21,38,
47,53 on NIfTI files the tests write: bit-equal to the numpy path, and to
the JAX package's loader.  Without g++ or zlib the loader is unavailable
and these tests skip, as the JAX package's do.
"""

import struct

import numpy as np
import pytest

from synthsr_tpu.native import read_nifti_fast as jax_read_nifti_fast
from synthsr_tpu_torch.io.volume import load_volume, save_volume
from synthsr_tpu_torch.native import library_path, native_available, read_nifti_fast

pytestmark = pytest.mark.skipif(not native_available(), reason="native loader unavailable")


def _scaled(tmp_path, name, data, slope, inter):
    p = str(tmp_path / name)
    save_volume(data, np.eye(4), None, p, dtype="int16")
    raw = bytearray(open(p, "rb").read())
    struct.pack_into("<f", raw, 112, slope)  # scl_slope
    struct.pack_into("<f", raw, 116, inter)  # scl_inter
    open(p, "wb").write(raw)
    return p


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_native_bit_equal_to_numpy_path(tmp_path, ext, dtype):
    """Label maps and images written here: the fast path equals the numpy
    path bit for bit, affine and zooms included (the counterpart of the
    JAX test on the absent reference label map)."""
    rng = np.random.default_rng(0)
    aff = np.diag([1.2, 0.9, 2.0, 1.0])
    aff[:3, 3] = [-30.0, 12.5, 4.0]
    vols = {"labels": rng.integers(0, 60, (23, 19, 17)).astype(np.int32),
            "image": rng.normal(50, 20, (23, 19, 17)).astype(np.float32)}
    for name, vol in vols.items():
        p = str(tmp_path / f"{name}{ext}")
        save_volume(vol, aff, None, p)
        slow = load_volume(p, im_only=False, dtype=dtype, fast=False)
        fast = load_volume(p, im_only=False, dtype=dtype, fast=True)
        assert fast[0].dtype == slow[0].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(fast[0], slow[0])
        np.testing.assert_array_equal(fast[1], slow[1])
        np.testing.assert_array_equal(fast[2].zooms, slow[2].zooms)
        np.testing.assert_array_equal(read_nifti_fast(p, dtype)[0],
                                      jax_read_nifti_fast(p, dtype)[0])


@pytest.mark.parametrize("shape", [(130, 70, 150), (66, 5, 129, 2), (200,), (1, 1, 65)])
def test_native_read_is_c_ordered(tmp_path, shape):
    """The loader hands numpy's order over, copied from the file's in blocks
    of the first and last axes: equal to the numpy path, C-contiguous, at
    shapes that do not divide into blocks."""
    vol = np.random.default_rng(1).integers(0, 60, shape).astype(np.int32)
    p = str(tmp_path / "v.nii.gz")
    save_volume(vol, np.eye(4), None, p)
    got = read_nifti_fast(p, "int32")[0]
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, load_volume(p, squeeze=False, dtype="int32", fast=False))


def test_native_float_with_scaling(tmp_path):
    data = np.random.default_rng(0).integers(0, 50, (12, 13, 14)).astype(np.int16)
    out = read_nifti_fast(_scaled(tmp_path, "scl.nii", data, 2.0, 3.0), "float32")
    assert out is not None
    np.testing.assert_allclose(out[0], data * 2.0 + 3.0, atol=1e-5)


def test_native_rounds_float_labels(tmp_path):
    vol = np.array([[[1.4, 1.6, 2.5001, -0.4]]], np.float32)
    p = str(tmp_path / "r.nii.gz")
    save_volume(vol, np.eye(4), None, p)
    out = read_nifti_fast(p, "int32")
    assert out is not None
    np.testing.assert_array_equal(out[0].ravel(), [1, 2, 3, 0])


def test_native_rejects_missing_and_foreign_files(tmp_path):
    """A missing file and a big-endian header give None, and load_volume
    reads the big-endian file through numpy."""
    assert read_nifti_fast(str(tmp_path / "missing.nii.gz"), "int32") is None
    data = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    p = str(tmp_path / "le.nii")
    save_volume(data, np.eye(4), None, p, dtype="int16")
    raw = bytearray(open(p, "rb").read())
    big = str(tmp_path / "be.nii")
    hdr = bytearray(raw[:348])
    struct.pack_into(">i", hdr, 0, 348)
    for off, n in ((40, 8), (70, 2), (72, 2)):  # dim[8], datatype, bitpix
        vals = struct.unpack_from(f"<{n}h", raw, off)
        struct.pack_into(f">{n}h", hdr, off, *vals)
    for off, n in ((76, 8), (108, 1), (112, 1), (116, 1)):  # pixdim, vox_offset, slope, inter
        vals = struct.unpack_from(f"<{n}f", raw, off)
        struct.pack_into(f">{n}f", hdr, off, *vals)
    for off, n in ((252, 2),):  # qform_code, sform_code
        vals = struct.unpack_from(f"<{n}h", raw, off)
        struct.pack_into(f">{n}h", hdr, off, *vals)
    for off, n in ((256, 6), (280, 12)):  # quatern/qoffset, srow_x/y/z
        vals = struct.unpack_from(f"<{n}f", raw, off)
        struct.pack_into(f">{n}f", hdr, off, *vals)
    body = np.frombuffer(bytes(raw[352:]), "<i2").astype(">i2").tobytes()
    open(big, "wb").write(bytes(hdr) + bytes(raw[348:352]) + body)
    assert read_nifti_fast(big, "int32") is None
    np.testing.assert_array_equal(load_volume(big, dtype="int32"),
                                  load_volume(p, dtype="int32", fast=False))


@pytest.mark.parametrize("slope,inter", [(float("nan"), 3.0), (0.0, 3.0),
                                         (float("nan"), float("nan"))])
def test_native_slope_edge_cases_match_python(tmp_path, slope, inter):
    """A non-finite or zero slope acts as 1.0 and a non-finite intercept as
    0.0, in the C++ path and the numpy reader alike."""
    data = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    p = _scaled(tmp_path, "edge.nii", data, slope, inter)
    py = load_volume(p, dtype="float32", fast=False)
    nat = read_nifti_fast(p, "float32")[0]
    assert np.isfinite(nat).all()
    np.testing.assert_allclose(nat, py, atol=1e-5)


def test_native_builds_into_the_ignored_build_dir():
    assert "/_build/native/" in library_path().replace("\\", "/")
    assert library_path().endswith("libnifti_loader.so")
