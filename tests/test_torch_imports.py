"""The import fence: no module of synthsr_tpu_torch (the ``native`` loader
package and the ``examples`` tutorial entry points included), and not
chip_smoke.py, imports jax, flax or the JAX package synthsr_tpu."""

import ast
import os
import subprocess
import sys
import textwrap

import synthsr_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "synthsr_tpu")
# modules that must exist and pass the fence (a few of each package)
REQUIRED = ("parallel.halo", "parallel.halo_train", "models.autoencoder", "io.label_edit",
            "io.dataset_tools", "synth.estimate_priors", "synth.label_ops", "synth.lab2im",
            "cli.parity", "utils.profiling", "native", "examples.common",
            *(f"examples.tutorial_{n}" for n in ("1_sr_real", "2_sr_synthetic",
                                                 "3_synthesis_real", "4_synthesis_synthetic",
                                                 "5_sr_synthesis_multimodal_real",
                                                 "6_sr_synthesis_multimodal_synthetic",
                                                 "7_training", "8_estimate_priors",
                                                 "9_log_tensor_diffusion")))


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    pkg = synthsr_tpu_torch.__path__[0]
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def test_no_forbidden_import_in_the_sources():
    """An AST scan of every module of the port and of chip_smoke.py finds no
    import of jax, flax or synthsr_tpu (absolute imports; relative ones stay
    inside the package)."""
    found = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, REPO), n) for n in names if _forbidden(n)]
    assert len(_sources()) > 60
    scanned = {os.path.relpath(p, os.path.join(REPO, "synthsr_tpu_torch")) for p in _sources()}
    for name in REQUIRED:
        path = name.replace(".", "/")
        assert f"{path}.py" in scanned or f"{path}/__init__.py" in scanned, name
    assert not found, found


def test_every_module_imports_behind_a_fence():
    """In a fresh interpreter whose import system refuses jax, flax and
    synthsr_tpu, every module of synthsr_tpu_torch (walked with pkgutil) and
    chip_smoke (as a module, without running main) imports."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys

        FORBIDDEN = {FORBIDDEN!r}

        class Fence(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
                    raise ImportError(f"fenced: {{name}}")
                return None

        sys.meta_path.insert(0, Fence())
        import synthsr_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(synthsr_tpu_torch.__path__,
                                                       "synthsr_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        missing = [r for r in {REQUIRED!r} if "synthsr_tpu_torch." + r not in names]
        assert not missing, missing
        import chip_smoke
        assert callable(chip_smoke.main)
        leaked = [m for m in sys.modules if any(m == f or m.startswith(f + ".")
                                                for f in FORBIDDEN)]
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=False)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 60
