"""What the A/B tools under ``tools/`` share: the card's name and power limit,
variant libraries built from a kernel source by substitution, and checkouts
run in turns, each in a worker process of its own.

- :func:`build_variants`: one library per distinct variant of a source in
  ``synthsr_tpu_torch/csrc`` (a list of ``(old, new)`` substitutions, every
  ``old`` present), compiled by nvcc in parallel into the kernels' git-ignored
  build directory, with the ctypes signatures of ``cuda_build``.
- :func:`run_in_turns`: runs ``script --worker CHECKOUT`` for each checkout in
  the order given and then reversed (A B B A for two) and returns the JSON
  object each worker prints last; :func:`open_checkout` is the worker's
  first step (import the checkout's port, load ``chip_smoke.py``'s inputs).
- :func:`warm`: matrix products that bring the card's clocks up before the
  first timed row.

Needs one CUDA GPU and nvcc where a tool runs; importing this module needs
neither.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WARM_MATMULS = 100  # 4096^2 products run before anything is timed


def device_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def build_variants(source: str, variants, symbols, extra_sources=()):
    """Build one library per distinct variant of ``csrc/<source>``.

    ``variants``: for each variant its list of ``(old, new)`` substitutions
    (``old`` must occur; every occurrence is replaced).  ``symbols``: the
    functions whose ctypes signatures (``cuda_build._SIGNATURES``) are set.
    ``extra_sources``: other ``csrc`` files linked into each library.
    Returns, per variant, ``(library, ptxas summary)``."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_summary
    from synthsr_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC_DIR / source).read_text()
    nvcc = cuda_build.find_nvcc()
    extra = [str(cuda_build.CSRC_DIR / s) for s in extra_sources]
    jobs, keys = {}, []
    for subs in variants:
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{old!r} is not in {source}")
            src = src.replace(old, new)
        key = hashlib.sha256((src + "\0".join(extra)).encode()).hexdigest()[:16]
        keys.append(key)
        if key in jobs:
            continue
        out = cuda_build.BUILD_DIR / "variants" / key
        out.mkdir(parents=True, exist_ok=True)
        (out / "v.cu").write_text(src)
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-shared", "-o",
               str(out / "v.so"), str(out / "v.cu"), *extra]
        jobs[key] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {out / 'v.cu'}\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / "v.so"))
        for name in symbols:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = cuda_build._SIGNATURES[name]
        built[key] = (lib, ptxas_summary(log))
    return [built[k] for k in keys]


def open_checkout(checkout):
    """A worker's first step: put ``checkout`` first on ``sys.path``, check
    that its ``synthsr_tpu_torch`` is the one imported, and return this
    repository's ``chip_smoke.py`` loaded as a module (its seeded inputs)."""
    checkout = Path(checkout).resolve()
    sys.path.insert(0, str(checkout))
    import synthsr_tpu_torch

    if checkout not in Path(synthsr_tpu_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {synthsr_tpu_torch.__file__}, not from {checkout}")
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def warm(dtype) -> None:
    """``WARM_MATMULS`` products of two 4096^2 matrices of ``dtype`` on the card."""
    import torch

    a = torch.randn(4096, 4096, device="cuda").to(dtype)
    for _ in range(WARM_MATMULS):
        a @ a
    torch.cuda.synchronize()


def run_in_turns(script: str, checkouts):
    """Print the card's line, run ``script --worker C`` for each checkout C of
    ``checkouts`` and then of the list reversed, print each worker's last line
    (a JSON object) and return them parsed; a worker that fails ends the run."""
    print(device_line(), flush=True)
    runs = []
    for checkout in list(checkouts) + list(checkouts)[::-1]:
        proc = subprocess.run([sys.executable, script, "--worker", checkout],
                              capture_output=True, text=True, check=False)
        if proc.returncode:
            sys.exit(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    return runs


def turns_main(doc: str, worker, main) -> None:
    """The command line of a tool that runs checkouts in turns:
    ``--worker CHECKOUT`` runs ``worker``, two or more checkouts run ``main``."""
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) >= 3 and not sys.argv[1].startswith("-"):
        main(sys.argv[1:])
    else:
        sys.exit(doc)
