"""The port's Hyperfine T1+T2 predict (synthsr_tpu_torch/cli/predict_hyperfine.py)
against the JAX package's, with the same seeded 2-channel weights through a
Keras .h5 file; mirrors tests/test_predict_hyperfine.py:29,53,69."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from synthsr_tpu.io.volume import load_volume, save_volume
from synthsr_tpu.models.h5_import import export_keras_unet_weights
from synthsr_tpu_torch.cli import predict_hyperfine as torch_hyperfine
from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

torch.set_num_threads(2)


def _oblique_t2_affine():
    c, s = np.cos(np.deg2rad(10.0)), np.sin(np.deg2rad(10.0))
    aff = np.eye(4)
    aff[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag([1.5, 1.5, 5.0])
    aff[:3, 3] = [-2.0, 1.0, -3.0]
    return aff


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded full-width 2-channel weights as a Keras .h5 and a state dict,
    and an all-zero network (BatchNorm variance 1) as a state dict."""
    d = tmp_path_factory.mktemp("hyperfine_weights")
    variables = random_variables(in_channels=2, seed=6)
    h5 = str(d / "hyper.h5")
    export_keras_unet_weights(h5, variables)
    pt = str(d / "hyper.pt")
    torch.save(variables_to_state_dict(variables), pt)
    zero = {k: torch.ones_like(v) if k.endswith("running_var") else torch.zeros_like(v)
            for k, v in variables_to_state_dict(variables).items()}
    zero_pt = str(d / "zero.pt")
    torch.save(zero, zero_pt)
    return h5, pt, zero_pt


def test_hyperfine_residual_formula(weights):
    """pred = minimum + spread·(residual + t1_normalised), clipped at 0: with
    a zero network the output is the T1 input after the 1 mm resample, whose
    blur has sigma 0.25 even at factor 1 (tests/test_predict_hyperfine.py:29,
    same bar: rtol 1e-3, atol 0.05)."""
    _, _, zero_pt = weights
    pred = torch_hyperfine.HyperfinePredictor(model_path=zero_pt, compute_dtype="float32",
                                              device="cpu")
    rng = np.random.default_rng(0)
    t1 = rng.uniform(50, 500, (32, 32, 32)).astype(np.float32)
    t2 = rng.uniform(0, 300, (32, 32, 32)).astype(np.float32)
    out, aff = pred.predict_pair(t1, np.eye(4), t2, np.eye(4))
    np.testing.assert_allclose(out, gaussian_filter(t1, 0.25, mode="reflect"), rtol=1e-3,
                               atol=0.05)
    np.testing.assert_allclose(aff, np.eye(4), atol=1e-12)


@pytest.mark.parametrize("t2_grid", ["aligned", "oblique"])
def test_hyperfine_t2_reslicing_matches_jax(weights, t2_grid):
    """A T2 on its own 1.5 x 1.5 x 5 mm grid is resliced into the T1's 1 mm
    grid (per-axis matrices when the grids are axis-aligned, the host
    resample when oblique): the port's float32 pipeline equals the JAX
    predictor's plain float32 one within 1e-5 of the output's range (the
    float32 network, summed in another order, times spread = max(T1)/3;
    measured 4e-7)."""
    from synthsr_tpu.cli.predict_hyperfine import HyperfinePredictor as JaxPredictor

    h5, _, _ = weights
    rng = np.random.default_rng(1)
    t1 = rng.uniform(0, 500, (32, 32, 32)).astype(np.float32)
    t2 = rng.uniform(0, 300, (24, 24, 8)).astype(np.float32)
    aff2 = np.diag([1.5, 1.5, 5.0, 1.0]) if t2_grid == "aligned" else _oblique_t2_affine()
    ours = torch_hyperfine.HyperfinePredictor(model_path=h5, compute_dtype="float32",
                                              device="cpu")
    a, aff_a = ours.predict_pair(t1, np.eye(4), t2, aff2)
    b, aff_b = JaxPredictor(model_path=h5, compute_dtype="float32",
                            fast_inference="off").predict_pair(t1, np.eye(4), t2, aff2)
    assert a.shape == b.shape == (32, 32, 32)
    assert np.all(a >= 0) and np.isfinite(a).all()
    np.testing.assert_allclose(aff_a, aff_b, atol=1e-12)
    np.testing.assert_allclose(a, b, atol=1e-5 * float(b.max()))


def test_hyperfine_cli_end_to_end_matches_jax(tmp_path, weights):
    """main() on a small synthetic T1/T2 pair, both CLIs at their defaults on
    the CPU (bf16 network; the JAX one through fast_inference='off'): same
    shape and affine, non-negative, and equal within 1% of the output's range
    (bf16 rounding of the residual network, times spread = max(T1)/3;
    measured 0.24%)."""
    from synthsr_tpu.cli.predict_hyperfine import main as jax_main

    h5, pt, _ = weights
    rng = np.random.default_rng(2)
    p1, p2 = str(tmp_path / "t1.nii.gz"), str(tmp_path / "t2.nii.gz")
    save_volume(rng.uniform(0, 400, (32, 32, 32)).astype(np.float32), np.eye(4), None, p1)
    save_volume(rng.uniform(0, 200, (32, 32, 32)).astype(np.float32), np.eye(4), None, p2)
    ours, theirs = str(tmp_path / "torch.nii.gz"), str(tmp_path / "jax.nii.gz")
    torch_hyperfine.main([p1, p2, ours, "--model", pt, "--cpu", "--threads", "2"])
    jax_main([p1, p2, theirs, "--model", h5, "--cpu", "--fast_inference", "off"])
    a, aff_a, _ = load_volume(ours, im_only=False)
    b, aff_b, _ = load_volume(theirs, im_only=False)
    assert a.shape == b.shape == (32, 32, 32)
    np.testing.assert_allclose(aff_a, aff_b, atol=1e-6)
    assert a.min() >= 0
    np.testing.assert_allclose(a, b, atol=1e-2 * float(b.max()))


def test_hyperfine_no_silent_cpu_fallback(tmp_path, weights, monkeypatch):
    """Without a GPU the default device raises; the plain forward is refused
    on a CUDA device; T1 and T2 folders of different sizes are refused."""
    _, pt, _ = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        torch_hyperfine.HyperfinePredictor(model_path=pt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError):
        torch_hyperfine.HyperfinePredictor(model_path=pt, fast_inference="off", device="cuda")
    (tmp_path / "t1").mkdir()
    (tmp_path / "t2").mkdir()
    for name in ("a.nii.gz", "b.nii.gz"):
        save_volume(np.zeros((11, 11, 11), np.float32), np.eye(4), None,
                    str(tmp_path / "t1" / name))
    save_volume(np.zeros((11, 11, 11), np.float32), np.eye(4), None,
                str(tmp_path / "t2" / "a.nii.gz"))
    with pytest.raises(ValueError):
        torch_hyperfine.main([str(tmp_path / "t1"), str(tmp_path / "t2"),
                              str(tmp_path / "out"), "--model", pt, "--cpu"])
