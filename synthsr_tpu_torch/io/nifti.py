"""Self-contained NIfTI-1 / FreeSurfer-MGH volume I/O (no nibabel dependency):
the port's own copy of ``synthsr_tpu/io/nifti.py``.

The volume-file layer of the reference (``ext/lab2im/utils.py:76-161`` --
load_volume/save_volume, which delegate to nibabel).  This module implements
the two on-disk formats the reference supports (.nii/.nii.gz and .mgz/.mgh)
plus .npz, from the published format specs, so the port has zero dependency
on nibabel.

Only features the reference uses are implemented: reading voxel data + affine
+ header zooms, and writing voxel data with a given affine.  Data is returned
as numpy arrays (host side); device transfer happens downstream.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# NIfTI-1 constants
# ---------------------------------------------------------------------------

_NIFTI_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}

_HDR_SIZE = 348
_MGH_HDR_SIZE = 284

_MGH_DTYPES = {0: np.uint8, 1: np.int32, 3: np.float32, 4: np.int16}
_MGH_CODES = {np.dtype(v): k for k, v in _MGH_DTYPES.items()}


@dataclass
class VolumeHeader:
    """Minimal header info carried alongside a volume."""

    zooms: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    dtype: np.dtype = np.dtype(np.float32)
    shape: tuple = ()


def _open_maybe_gz(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# ---------------------------------------------------------------------------
# Affine construction helpers
# ---------------------------------------------------------------------------

def _quaternion_to_affine(hdr: dict) -> np.ndarray:
    """NIfTI-1 'method 2' qform affine from quaternion fields."""
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    pixdim = hdr["pixdim"]
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = r * zooms[None, :]
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_nifti1_header(raw: bytes) -> dict:
    if len(raw) < _HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr_be = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr_be == _HDR_SIZE:
            endian = ">"
        else:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")

    def u(fmt, off):
        return struct.unpack(endian + fmt, raw[off : off + struct.calcsize(fmt)])

    hdr = {}
    hdr["endian"] = endian
    hdr["dim"] = np.array(u("8h", 40))
    hdr["datatype"] = u("h", 70)[0]
    hdr["bitpix"] = u("h", 72)[0]
    hdr["pixdim"] = np.array(u("8f", 76))
    hdr["vox_offset"] = u("f", 108)[0]
    hdr["scl_slope"] = u("f", 112)[0]
    hdr["scl_inter"] = u("f", 116)[0]
    hdr["qform_code"] = u("h", 252)[0]
    hdr["sform_code"] = u("h", 254)[0]
    hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"] = u("3f", 256)
    hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"] = u("3f", 268)
    hdr["srow_x"] = np.array(u("4f", 280))
    hdr["srow_y"] = np.array(u("4f", 296))
    hdr["srow_z"] = np.array(u("4f", 312))
    hdr["magic"] = raw[344:348]
    return hdr


def _nifti_affine(hdr: dict) -> np.ndarray:
    if hdr["sform_code"] > 0:
        aff = np.eye(4)
        aff[0] = hdr["srow_x"]
        aff[1] = hdr["srow_y"]
        aff[2] = hdr["srow_z"]
        return aff
    if hdr["qform_code"] > 0:
        return _quaternion_to_affine(hdr)
    aff = np.diag(list(hdr["pixdim"][1:4]) + [1.0])
    return aff


def read_nifti(path: str):
    """Read a .nii / .nii.gz file -> (data, affine, header)."""
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()
    hdr = _parse_nifti1_header(raw[:_HDR_SIZE])
    ndim = int(hdr["dim"][0])
    shape = tuple(int(s) for s in hdr["dim"][1 : 1 + ndim])
    # squeeze trailing singleton dims the way nibabel reports them verbatim:
    dtype = np.dtype(_NIFTI_DTYPES[hdr["datatype"]]).newbyteorder(hdr["endian"])
    offset = int(hdr["vox_offset"])
    count = int(np.prod(shape)) if shape else 1
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")
    data = np.asarray(data, dtype=dtype.newbyteorder("="))
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if np.isfinite(slope) and slope not in (0.0, 1.0) or (np.isfinite(inter) and inter != 0.0):
        if not np.isfinite(slope) or slope == 0.0:
            slope = 1.0
        if not np.isfinite(inter):
            inter = 0.0
        data = data.astype(np.float32) * np.float32(slope) + np.float32(inter)
    aff = _nifti_affine(hdr)
    header = VolumeHeader(
        zooms=np.abs(np.asarray(hdr["pixdim"][1:4], np.float32)),
        dtype=np.dtype(_NIFTI_DTYPES[hdr["datatype"]]),
        shape=shape,
    )
    return data, aff, header


def _affine_to_quaternion(aff: np.ndarray):
    """Decompose rotation part of an affine into NIfTI quaternion fields."""
    r = np.array(aff[:3, :3], np.float64)
    zooms = np.sqrt((r ** 2).sum(axis=0))
    zooms[zooms == 0] = 1.0
    rot = r / zooms[None, :]
    qfac = 1.0
    if np.linalg.det(rot) < 0:
        rot = rot.copy()
        rot[:, 2] *= -1
        qfac = -1.0
    # orthonormalize via SVD to guard against shear
    u, _, vt = np.linalg.svd(rot)
    rot = u @ vt
    t = np.trace(rot)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (rot[2, 1] - rot[1, 2]) * s
        y = (rot[0, 2] - rot[2, 0]) * s
        z = (rot[1, 0] - rot[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(rot)))
        if i == 0:
            s = 2.0 * np.sqrt(max(1.0 + rot[0, 0] - rot[1, 1] - rot[2, 2], 1e-12))
            w = (rot[2, 1] - rot[1, 2]) / s
            x, y, z = 0.25 * s, (rot[0, 1] + rot[1, 0]) / s, (rot[0, 2] + rot[2, 0]) / s
        elif i == 1:
            s = 2.0 * np.sqrt(max(1.0 + rot[1, 1] - rot[0, 0] - rot[2, 2], 1e-12))
            w = (rot[0, 2] - rot[2, 0]) / s
            x, y, z = (rot[0, 1] + rot[1, 0]) / s, 0.25 * s, (rot[1, 2] + rot[2, 1]) / s
        else:
            s = 2.0 * np.sqrt(max(1.0 + rot[2, 2] - rot[0, 0] - rot[1, 1], 1e-12))
            w = (rot[1, 0] - rot[0, 1]) / s
            x, y, z = (rot[0, 2] + rot[2, 0]) / s, (rot[1, 2] + rot[2, 1]) / s, 0.25 * s
    if w < 0:
        w, x, y, z = -w, -x, -y, -z
    return (x, y, z), zooms, qfac


def write_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None,
                dtype=None) -> None:
    """Write a .nii / .nii.gz file with an sform+qform affine."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if dtype is not None:
        dt = np.dtype(dtype)
        if np.issubdtype(dt, np.integer):
            data = np.rint(data)
        data = data.astype(dt)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _NIFTI_CODES:
        data = data.astype(np.float32)

    ndim = data.ndim
    dim = np.ones(8, np.int16)
    dim[0] = ndim
    dim[1 : 1 + ndim] = data.shape

    (qb, qc, qd), zooms, qfac = _affine_to_quaternion(affine)
    pixdim = np.ones(8, np.float32)
    pixdim[0] = qfac
    pixdim[1 : 1 + min(ndim, 3)] = zooms[: min(ndim, 3)]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<b", hdr, 39, 0)  # dim_info
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<b", hdr, 123, 10)  # xyzt_units: mm | sec
    struct.pack_into("<h", hdr, 252, 1)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<3f", hdr, 256, qb, qc, qd)
    struct.pack_into("<3f", hdr, 268, *affine[:3, 3])
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    body = data.tobytes(order="F")
    payload = bytes(hdr) + b"\x00" * 4 + body
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# FreeSurfer MGH / MGZ
# ---------------------------------------------------------------------------

def read_mgh(path: str):
    """Read a FreeSurfer .mgh/.mgz file -> (data, affine, header)."""
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()
    (version, width, height, depth, nframes, mtype, _dof, goodras) = struct.unpack(
        ">7ih", raw[:30]
    )
    if version != 1:
        raise ValueError(f"unsupported MGH version {version}")
    zooms = np.ones(3, np.float32)
    mdc = np.array([[-1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64).T
    c_ras = np.zeros(3)
    if goodras == 1:
        vals = struct.unpack(">15f", raw[30:90])
        zooms = np.array(vals[0:3], np.float32)
        mdc = np.array(vals[3:12], np.float64).reshape(3, 3).T  # columns = x/y/z dir cosines
        c_ras = np.array(vals[12:15])
    dtype = np.dtype(_MGH_DTYPES[mtype]).newbyteorder(">")
    shape = (width, height, depth) if nframes <= 1 else (width, height, depth, nframes)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=_MGH_HDR_SIZE)
    data = data.reshape(shape, order="F")
    data = np.asarray(data, dtype=dtype.newbyteorder("="))
    aff = np.eye(4)
    aff[:3, :3] = mdc * np.asarray(zooms, np.float64)[None, :]
    dims = np.array([width, height, depth], np.float64)
    aff[:3, 3] = c_ras - aff[:3, :3] @ (dims / 2.0)
    header = VolumeHeader(zooms=zooms, dtype=np.dtype(_MGH_DTYPES[mtype]), shape=shape)
    return data, aff, header


def write_mgh(path: str, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if np.dtype(data.dtype) not in _MGH_CODES:
        data = data.astype(np.float32)
    if data.ndim == 3:
        nframes = 1
    elif data.ndim == 4:
        nframes = data.shape[3]
    else:
        raise ValueError("MGH supports 3D/4D volumes only")
    w, h, d = data.shape[:3]
    zooms = np.sqrt((np.asarray(affine[:3, :3], np.float64) ** 2).sum(axis=0))
    zooms[zooms == 0] = 1.0
    mdc = np.asarray(affine[:3, :3], np.float64) / zooms[None, :]
    c_ras = affine[:3, :3] @ (np.array([w, h, d], np.float64) / 2.0) + affine[:3, 3]
    hdr = bytearray(_MGH_HDR_SIZE)
    struct.pack_into(">7ih", hdr, 0, 1, w, h, d, nframes, _MGH_CODES[np.dtype(data.dtype)], 0, 1)
    struct.pack_into(">15f", hdr, 30, *zooms.astype(np.float32),
                     *mdc.T.ravel().astype(np.float32), *c_ras.astype(np.float32))
    payload = bytes(hdr) + np.ascontiguousarray(data, dtype=data.dtype.newbyteorder(">")).tobytes(order="F")
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


# ---------------------------------------------------------------------------
# Unified load/save (the reference's utils.load_volume/save_volume surface)
# ---------------------------------------------------------------------------

def read_volume_file(path: str):
    """Dispatch on extension -> (data, affine, header)."""
    if path.endswith((".nii", ".nii.gz")):
        return read_nifti(path)
    if path.endswith((".mgz", ".mgh", ".mgh.gz")):
        return read_mgh(path)
    if path.endswith(".npz"):
        data = np.load(path)["vol_data"]
        return data, np.eye(4), VolumeHeader(shape=data.shape, dtype=data.dtype)
    if path.endswith(".npy"):
        data = np.load(path)
        return data, np.eye(4), VolumeHeader(shape=data.shape, dtype=data.dtype)
    raise ValueError(f"unsupported volume format: {path}")


def write_volume_file(path: str, data: np.ndarray, affine: np.ndarray | None = None,
                      dtype=None) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if path.endswith((".nii", ".nii.gz")):
        write_nifti(path, data, affine, dtype=dtype)
    elif path.endswith((".mgz", ".mgh", ".mgh.gz")):
        write_mgh(path, np.asarray(data) if dtype is None else np.asarray(data).astype(dtype))
    elif path.endswith(".npz"):
        np.savez_compressed(path, vol_data=np.asarray(data))
    elif path.endswith(".npy"):
        np.save(path, np.asarray(data))
    else:
        raise ValueError(f"unsupported volume format: {path}")
