"""Build and load the hand-written CUDA kernels of ``synthsr_tpu_torch/csrc``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object file, all
of them at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  The library lands in
``synthsr_tpu_torch/_build/<hash of the sources and flags>/``, a directory git
ignores, on first use; later processes reuse it.  A missing ``nvcc`` or a
failed compile raises: there is no fallback.
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
SOURCES = ("conv3d_cf.cu", "conv3d_wgrad.cu", "conv3d_fwd_mma.cu", "conv3d_wgrad_mma.cu",
           "conv3d_first_mma.cu")
HEADERS = ("mma_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "conv3d_fwd_launch": ([_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P,
                           _P, _P, _I, _P, _P], _I),
    "conv3d_fwd_mma_launch": ([_P, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                               _P, _P, _I, _I, _P, _P], _I),
    "conv3d_first_launch": ([_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _P,
                             _P], _I),
    "conv3d_first_mma_launch": ([_P, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I, _P,
                                 _P], _I),
    "conv3d_wgrad_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                             _P], _I),
    "conv3d_wgrad_mma_launch": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                 _P], _I),
    "conv3d_fwd_chunk": ([], _I),
    "conv3d_fwd_mma_steps": ([], _I),
    "conv3d_first_mma_kpad": ([_I], _I),
    "conv3d_first_mma_max_cout": ([], _I),
    "conv3d_wgrad_chunk": ([], _I),
    "conv3d_wgrad_max_tile": ([], _I),
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


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


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
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(o), str(CSRC_DIR / s)]
            for s, o in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out_dir / f"libsynthsr_conv.so.{tag}"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
            *map(str, objs)]
    failed = [" ".join(c) + "\n" + log for c, p, log in zip(cmds, procs, logs) if p.returncode]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True, check=False)
        logs.append(res.stdout + res.stderr)
        if res.returncode:
            failed.append(" ".join(link) + "\n" + res.stdout + res.stderr)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        "\n".join(" ".join(c) + "\n" + log for c, log in zip(cmds + [link], logs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib, seconds


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
