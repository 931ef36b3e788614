"""Build and load the hand-written CUDA kernels of ``synthsr_tpu_torch/csrc``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object file, all
of them at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  The library lands in
``synthsr_tpu_torch/_build/<hash of the sources and flags>/``, a directory git
ignores, on first use; later processes reuse it.  A missing ``nvcc`` or a
failed compile raises: there is no fallback.

:func:`digest`, :func:`build_library` and :func:`load_library` are the
build-on-first-use steps themselves; the host NIfTI loader (``native/``)
builds its g++ library with them too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("conv3d_fwd_wg.cu", "conv3d_wgrad_wg.cu", "conv3d_first_x3.cu", "conv3d_wgrad.cu",
           "conv3d_fwd_mma.cu", "conv3d_wgrad_mma.cu", "conv3d_first_mma.cu", "conv3d_fwd_x3.cu",
           "conv3d_wgrad_x3.cu")
HEADERS = ("mma_common.cuh", "wg_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "conv3d_fwd_mma_launch": ([_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                               _P, _P, _I, _I, _P, _P], _I),
    "conv3d_fwd_wg_launch": ([_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P,
                              _P, _I, _I, _P, _P], _I),
    "conv3d_fwd_x3_launch": ([_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                              _P, _P, _I, _I, _P, _P], _I),
    "conv3d_first_x3_launch": ([_P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I,
                                _P, _P], _I),
    "conv3d_first_mma_launch": ([_P, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I, _P,
                                 _P], _I),
    "conv3d_wgrad_mma_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                 _P], _I),
    "conv3d_wgrad_x3_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                _P], _I),
    "conv3d_wgrad_wg_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                _P], _I),
    "conv3d_fwd_mma_steps": ([], _I),
    "conv3d_fwd_wg_config": ([_I], _I),
    "conv3d_wgrad_wg_config": ([_I], _I),
    "conv3d_first_mma_kpad": ([_I], _I),
    "conv3d_first_mma_max_cout": ([], _I),
    "conv3d_first_x3_steps": ([_I], _I),
    "conv3d_first_x3_max_cout": ([], _I),
    "conv3d_first_x3_max_planes": ([], _I),
    "conv3d_error_string": ([_I], ctypes.c_char_p),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``nvcc``
    on ``PATH``."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from source on first use")
    return found


def digest(paths, extra=()) -> str:
    """16 hex digits of a SHA-256 over the strings ``extra`` and the bytes of
    the files ``paths``: the name of a build's directory."""
    h = hashlib.sha256(" ".join(extra).encode())
    for path in paths:
        h.update(Path(path).read_bytes())
    return h.hexdigest()[:16]


def source_hash() -> str:
    return digest([CSRC_DIR / name for name in SOURCES + HEADERS], NVCC_FLAGS)


def build_library(lib: Path, stages, timeout=None) -> tuple[bool, float, list]:
    """Build the shared library ``lib``: ``stages(tmp)`` gives lists of
    commands for a temporary library path ``tmp`` beside ``lib``; the
    commands of one list run in parallel processes, a list only when the one
    before succeeded, each within ``timeout`` seconds.  When all succeed
    ``tmp`` is renamed onto ``lib`` (atomic: concurrent builders never load
    a partial file).  Returns (ok, seconds, [(command, return code, its
    output)])."""
    lib = Path(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    t0, logs, ok = time.perf_counter(), [], True
    try:
        for cmds in stages(tmp):
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            try:
                outs = [p.communicate(timeout=timeout)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            logs += [(c, p.returncode, out) for c, p, out in zip(cmds, procs, outs)]
            if any(p.returncode for p in procs):
                ok = False
                break
        if ok:
            os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return ok, time.perf_counter() - t0, logs


def build() -> tuple[Path, float]:
    """Compile the library unless a build of the same sources exists.

    Returns (path, seconds spent compiling; 0.0 when reused).  The compilers'
    output, ``-Xptxas -v`` register and spill counts included, is kept beside
    the library as ``build.log``."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / "libsynthsr_conv.so"
    if lib.is_file():
        return lib, 0.0
    nvcc = find_nvcc()
    objs = [out_dir / f"{Path(s).stem}.tmp{os.getpid()}.o" for s in SOURCES]

    def stages(tmp):
        return [[[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o), str(CSRC_DIR / s)]
                 for s, o in zip(SOURCES, objs)],
                [[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                  *map(str, objs)]]]

    try:
        ok, seconds, logs = build_library(lib, stages)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("\n".join(" ".join(c) + "\n" + out for c, _, out in logs))
    if not ok:
        failed = [" ".join(c) + "\n" + out for c, rc, out in logs if rc]
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
    # ptxas serialised a wgmma kernel (C7514, C7510, ...): it would run far below its rate
    serialised = [line for _, _, out in logs for line in out.splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
    if serialised:
        lib.unlink()
        raise RuntimeError("ptxas serialised wgmma:\n" + "\n".join(serialised)[-4000:])
    return lib, seconds


def load_library(path, signatures) -> ctypes.CDLL:
    """``ctypes.CDLL(path)`` with ``signatures`` {name: (argtypes, restype)}
    set on its functions."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load(path: Path) -> ctypes.CDLL:
    return load_library(path, _SIGNATURES)
