"""The port's predict pipeline (synthsr_tpu_torch/cli/predict.py) against the
JAX predict CLI, with the same seeded weights through a Keras .h5 file."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from synthsr_tpu.io.volume import load_volume, save_volume
from synthsr_tpu.models.h5_import import export_keras_unet_weights
from synthsr_tpu_torch.cli import predict as torch_predict
from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The same seeded full-width weights as a Keras .h5 and a state dict."""
    d = tmp_path_factory.mktemp("weights")
    variables = random_variables(seed=2)
    h5 = str(d / "rand.h5")
    export_keras_unet_weights(h5, variables)
    pt = str(d / "rand.pt")
    torch.save(variables_to_state_dict(variables), pt)
    return h5, pt


def _make_input(path, shape=(20, 22, 18), zooms=(2.0, 1.5, 3.0), seed=7):
    rng = np.random.default_rng(seed)
    vol = rng.uniform(0, 800, size=shape).astype(np.float32)
    aff = np.diag(list(zooms) + [1.0])
    aff[:3, 3] = [-20, 10, 5]
    save_volume(vol, aff, None, str(path))
    return vol, aff


def test_predict_file_matches_jax_predictor(tmp_path, weights):
    """The whole slice on the CPU (fast forward, float32) against the JAX
    predictor's plain float32 path, on the input of tests/test_predict.py:111
    (resamples to (40, 33, 54), pads to 64³): same values (atol 0.05 output
    units = 2e-4 x 255), shape and 1 mm RAS affine."""
    from synthsr_tpu.cli.predict import Predictor as JaxPredictor

    h5, _ = weights
    pin = tmp_path / "input.nii.gz"
    vol, _ = _make_input(pin)
    ours, theirs = str(tmp_path / "torch.nii.gz"), str(tmp_path / "jax.nii.gz")
    torch_predict.Predictor(model_path=h5, compute_dtype="float32",
                            device="cpu").predict_file(str(pin), ours)
    JaxPredictor(model_path=h5, fast_inference="off",
                 compute_dtype="float32").predict_file(str(pin), theirs)
    a, aff_a, _ = load_volume(ours, im_only=False)
    b, aff_b, _ = load_volume(theirs, im_only=False)
    expected = tuple(int(np.ceil(s * z)) for s, z in zip(vol.shape, (2.0, 1.5, 3.0)))
    assert a.shape == b.shape == expected
    np.testing.assert_allclose(aff_a, aff_b, atol=1e-6)
    np.testing.assert_allclose(np.diag(aff_a)[:3], 1.0, atol=1e-6)
    assert a.min() >= 0.0 and a.max() <= 128.0
    assert 0.0 < a.mean() < 128.0  # the weights' head puts most voxels inside the window
    np.testing.assert_allclose(a, b, atol=0.05)


def test_plain_path_tta_matches_fast_path(weights):
    """--fast_inference off (plain forward, input and output flipped) and the
    fast forward (D-flipped weights, no flips) give the same TTA prediction."""
    _, pt = weights
    rng = np.random.default_rng(8)
    vol = rng.uniform(0, 1, size=(32, 32, 32)).astype(np.float32)
    fast = torch_predict.Predictor(model_path=pt, compute_dtype="float32", device="cpu")
    plain = torch_predict.Predictor(model_path=pt, fast_inference="off", device="cpu")
    a, _ = fast.predict_volume(vol, np.eye(4))
    b, _ = plain.predict_volume(vol, np.eye(4))
    np.testing.assert_allclose(a, b, atol=1e-3)
    no_flip = torch_predict.Predictor(model_path=pt, compute_dtype="float32",
                                      disable_flipping=True, device="cpu")
    c, _ = no_flip.predict_volume(vol, np.eye(4))
    assert np.abs(a - c).max() > 1e-3


def test_predict_ct_clipping(weights):
    """--ct clips the input to [0, 80] HU first (tests/test_predict.py:177)."""
    _, pt = weights
    rng = np.random.default_rng(3)
    vol = rng.uniform(-1000, 2000, size=(32, 32, 32)).astype(np.float32)
    ct = torch_predict.Predictor(model_path=pt, ct=True, compute_dtype="float32",
                                 device="cpu")
    mr = torch_predict.Predictor(model_path=pt, compute_dtype="float32", device="cpu")
    a, _ = ct.predict_volume(vol, np.eye(4))
    b, _ = mr.predict_volume(np.clip(vol, 0, 80), np.eye(4))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_main_directory_naming(tmp_path, weights):
    """Directory mode through main(): one output per input, named with the
    _SynthSR suffix (tests/test_predict.py:211), each on the 1 mm grid."""
    _, pt = weights
    d_in = tmp_path / "in"
    d_in.mkdir()
    rng = np.random.default_rng(9)
    for n in ("a.nii.gz", "b.nii", "c.mgz"):
        save_volume(rng.uniform(0, 100, (12, 12, 12)).astype(np.float32), np.eye(4), None,
                    str(d_in / n))
    d_out = tmp_path / "out"
    torch_predict.main([str(d_in), str(d_out), "--cpu", "--threads", "2", "--model", pt])
    assert sorted(os.listdir(d_out)) == ["a_SynthSR.nii.gz", "b_SynthSR.nii", "c_SynthSR.mgz"]
    for n in os.listdir(d_out):
        assert load_volume(str(d_out / n)).shape == (12, 12, 12)


def test_no_silent_cpu_fallback(tmp_path, weights, monkeypatch):
    """Without a GPU the default device raises; the plain forward is refused on
    a CUDA device; an unknown device raises."""
    _, pt = weights
    pin = tmp_path / "in.nii.gz"
    _make_input(pin, shape=(12, 12, 12))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        torch_predict.Predictor(model_path=pt)
    with pytest.raises(RuntimeError):
        torch_predict.main([str(pin), str(tmp_path / "out.nii.gz"), "--model", pt])
    assert not (tmp_path / "out.nii.gz").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError):
        torch_predict.Predictor(model_path=pt, fast_inference="off", device="cuda")
    with pytest.raises(ValueError):
        torch_predict.Predictor(model_path=pt, device="meta")


def test_port_never_imports_jax(tmp_path, weights):
    """A 32³ CPU predict through main() in a fresh interpreter leaves jax and
    flax out of sys.modules."""
    _, pt = weights
    pin, pout = tmp_path / "in.nii.gz", tmp_path / "out.nii.gz"
    _make_input(pin, shape=(32, 32, 32), zooms=(1.0, 1.0, 1.0))
    code = textwrap.dedent(f"""
        import sys
        from synthsr_tpu_torch.cli.predict import main
        main([{str(pin)!r}, {str(pout)!r}, "--cpu", "--threads", "2", "--model", {pt!r}])
        bad = [m for m in ("jax", "flax") if m in sys.modules]
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300, check=False)
    assert res.returncode == 0, res.stderr[-2000:]
    assert load_volume(str(pout)).shape == (32, 32, 32)
