"""The import fence: nothing under ``benchmark/`` imports JAX, flax or the
JAX package (top-level names compared whole, so ``synthsr_tpu_torch``
passes), and nothing under ``benchmark/reference/`` imports the program."""

import ast
import os

import pytest

from bench_common import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.HERE)
               for f in fs if f.endswith(".py"))


def imported(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "numpy", "torch", "math"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "synthsr_tpu_torch_fake", types.ModuleType("x"))
    assert "synthsr_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "synthsr_tpu.fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["synthsr_tpu.fake"]
