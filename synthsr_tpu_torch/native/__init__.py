"""The C++ NIfTI loader behind ``io/volume.load_volume(fast=True)``: the
port's copy of ``synthsr_tpu/native/`` (the same ``nifti_loader.cpp``,
bound with ctypes).  A host loader (gzip inflate, header parse and one cast
pass, with the interpreter lock released), not a device kernel.

It is built with ``g++ -O3 -shared -fPIC -lz`` on first use, into
``synthsr_tpu_torch/_build/native/<hash of the source>/`` (a directory git
ignores), by the build steps of the CUDA kernels (``ops/cuda_build.py``:
a temporary file renamed into place, so concurrent first uses cannot load a
half-written library).  As in the JAX package, a missing
toolchain or zlib leaves the loader unavailable and every entry point
returns None, so ``load_volume`` reads through ``io/nifti.py``; so do files
the loader does not take (big-endian or foreign headers, other datatypes).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading

import numpy as np

from ..ops.cuda_build import build_library, digest, load_library

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "nifti_loader.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build", "native")
_SIGNATURES = {
    "nifti_read_header": ([ctypes.c_char_p, ctypes.c_char_p], ctypes.c_int),
    "nifti_read": ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int],
                   ctypes.c_int64),
}
_lock = threading.Lock()
_state = {"lib": None, "failed": False}


def library_path() -> str:
    """Where the built library lives: one directory per source hash."""
    return os.path.join(_BUILD, digest([_SRC]), "libnifti_loader.so")


def _build(so: str) -> bool:
    try:
        ok, _, _ = build_library(
            so, lambda tmp: [[["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), _SRC, "-lz"]]],
            timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return ok


def get_lib():
    """Load (building if needed) the native library, or None if unavailable."""
    if _state["lib"] is not None or _state["failed"]:
        return _state["lib"]
    with _lock:
        if _state["lib"] is not None or _state["failed"]:
            return _state["lib"]
        so = library_path()
        if not os.path.isfile(so) and not _build(so):
            _state["failed"] = True
            return None
        try:
            lib = load_library(so, _SIGNATURES)
        except OSError:
            _state["failed"] = True
            return None
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return get_lib() is not None


def read_nifti_fast(path: str, dtype: str = "float32"):
    """Fast NIfTI read -> (F-ordered array, affine, VolumeHeader), or None if
    the native path can't handle this file (the caller reads it with numpy).

    dtype: 'float32' (scl_slope applied) or 'int32' (raw cast).
    """
    lib = get_lib()
    if lib is None:
        return None
    hdr = ctypes.create_string_buffer(348)
    if lib.nifti_read_header(path.encode(), hdr) != 0:
        return None
    raw = hdr.raw
    if struct.unpack("<i", raw[0:4])[0] != 348:
        return None  # big-endian or foreign file: the numpy path reads it

    from ..io.nifti import VolumeHeader, _nifti_affine, _parse_nifti1_header

    parsed = _parse_nifti1_header(raw)
    ndim = int(parsed["dim"][0])
    shape = tuple(int(s) for s in parsed["dim"][1:1 + ndim])
    n = int(np.prod(shape)) if shape else 1

    out_code = 0 if dtype == "float32" else 1
    out = np.empty(n, dtype=np.float32 if out_code == 0 else np.int32)
    got = lib.nifti_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                         out_code)
    if got != n:
        return None
    data = out.reshape(shape, order="F")
    aff = _nifti_affine(parsed)
    header = VolumeHeader(zooms=np.abs(np.asarray(parsed["pixdim"][1:4], np.float32)),
                          dtype=data.dtype, shape=shape)
    return data, aff, header
