"""Each cell's entry and its reference, driven on the CPU at a tiny size
through the whole of a run but the look for a card (``run.run_cell``): a
sound run reads correct; a run with the timed path broken underneath (each
fault its entry can have) reads not correct; and the lower-precision
control, the reference in float8 in the program's place, fails the cell's
committed limits."""

import pytest
import torch

from bench_common import cells, harness, tiny
import run
from reference.precision import fp8

torch.set_num_threads(2)
CELLS = cells()


def run_tiny(cell, fault=None, seed=1234567890123):
    wl, cfg = tiny(cell)
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", "0"])
    result, lines = run.run_cell(args, device="cpu", wl=wl, cfg=cfg, fault=fault,
                                 log=lambda *a: None)
    return result, lines, wl


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, lines, wl = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(wl["check"]["limits"])
    assert len(lines) == len(result["checks"])
    e2e, _ = harness.cell_metrics(harness.load_json(harness.ROOT / "BENCHMARK.json"), cell)
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in result["metrics"].values())


FAULTS = [(c, f) for c in CELLS for f in harness.entry(harness.workload(c)["entry"]).FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_run_is_not_correct(cell, fault):
    result, _, _ = run_tiny(cell, fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    wl, cfg = tiny(cell)
    b = harness.entry(wl["entry"]).Bench(cfg, wl, 98765, "cpu")
    harness.closed_loop(b.unit, 0.5, b.sync)
    b.release()
    control = b.control(fp8)
    limits = wl["check"]["limits"]
    assert control and set(control) <= set(limits)
    assert any(control[k] > limits[k] for k in control), (control, limits)


def test_train_checks_a_step_of_the_window():
    wl, cfg = tiny("train-128")
    b = harness.entry(wl["entry"]).Bench(cfg, wl, 4242, "cpu")
    b.open_window(1.5)
    times, _ = harness.closed_loop(b.unit, 1.5, b.sync)
    assert b.late is not None and b.after_window(len(times)) == 0
    assert len(b.records) == wl["check"]["steps"] + 1
    b.release()
    checks, failed = b.check()
    assert failed == 0, checks
