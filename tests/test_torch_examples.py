"""The port's tutorial entry points (synthsr_tpu_torch/examples/), one per
examples/1-9 script: each runs as ``python -m
synthsr_tpu_torch.examples.tutorial_N_...`` with ``SYNTHSR_SMOKE=1`` and
``SYNTHSR_DEVICE=cpu`` on a ``SYNTHSR_DATA`` directory of seeded synthetic
label maps and priors that the test writes (the reference's data is not
used), and writes its outputs."""

import os
import subprocess
import sys

import numpy as np
import pytest

from synthsr_tpu_torch.examples.common import write_synthetic_data
from synthsr_tpu_torch.io.volume import load_volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds for one tutorial

TUTORIALS = {
    "tutorial_1_sr_real": ("1-SR_real", ["input_0.nii.gz", "reliability_0.nii.gz",
                                         "target_0.nii.gz"]),
    "tutorial_2_sr_synthetic": ("2-SR_synthetic", ["input_0.nii.gz", "target_0.nii.gz"]),
    "tutorial_3_synthesis_real": ("3-synthesis_real", ["input_0.nii.gz", "target_0.nii.gz"]),
    "tutorial_4_synthesis_synthetic": ("4-synthesis_synthetic",
                                       ["input_t2_0.nii.gz", "target_t1_0.nii.gz"]),
    "tutorial_5_sr_synthesis_multimodal_real": (
        "5-SR_synthesis_multimodal_real",
        ["input_t1_0.nii.gz", "input_t2_0.nii.gz", "target_0.nii.gz"]),
    "tutorial_6_sr_synthesis_multimodal_synthetic": ("6-SR_synthesis_multimodal_synthetic",
                                                     ["target_0.nii.gz"]),
    "tutorial_7_training": ("7-training", ["001.pt"]),
    "tutorial_8_estimate_priors": ("8-priors", ["prior_means.npy", "prior_stds.npy"]),
    "tutorial_9_log_tensor_diffusion": ("9-log-tensor", ["001.pt"]),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tutorial_data")
    write_synthetic_data(str(root))
    return str(root)


@pytest.mark.parametrize("name", sorted(TUTORIALS))
def test_tutorial_runs_in_smoke_mode_on_the_cpu(name, data, tmp_path):
    results = str(tmp_path / "results")
    env = dict(os.environ, SYNTHSR_DATA=data, SYNTHSR_RESULTS=results, SYNTHSR_SMOKE="1",
               SYNTHSR_DEVICE="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", f"synthsr_tpu_torch.examples.{name}"], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=TIMEOUT,
                         check=False)
    assert res.returncode == 0, res.stderr[-3000:]
    sub, files = TUTORIALS[name]
    for f in files:
        path = os.path.join(results, sub, f)
        assert os.path.isfile(path), (path, res.stdout[-2000:])
        if f.endswith(".nii.gz"):
            vol = load_volume(path)
            assert vol.ndim == 3 and np.isfinite(vol).all(), (f, vol.shape)


def test_tutorials_need_a_gpu_unless_asked_for_the_cpu(data, tmp_path):
    """Without SYNTHSR_DEVICE=cpu a tutorial raises where there is no GPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, SYNTHSR_DATA=data, SYNTHSR_RESULTS=str(tmp_path), SYNTHSR_SMOKE="1",
               PYTHONPATH=REPO)
    env.pop("SYNTHSR_DEVICE", None)
    res = subprocess.run([sys.executable, "-m",
                          "synthsr_tpu_torch.examples.tutorial_2_sr_synthetic"], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=TIMEOUT,
                         check=False)
    assert res.returncode != 0 and "SYNTHSR_DEVICE=cpu" in res.stderr
