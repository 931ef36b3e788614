"""``Predictor.prepare`` (``synthsr_tpu_torch/cli/predict.py``) on the device
against the host prepare it replaced, kept here as the oracle: the device
resample copied back to numpy (``device_axis_ops``), the RAS alignment as
``align_volume_to_ref`` read before (frozen here), numpy's min-max and the
zero pad.  The two must agree bit for bit, on the
CPU and on the card.  The ``cuda`` cases also run the device prepare with
PyTorch's sync debug mode set to raise, and count the bytes the predict
path copies each way.

This file imports nothing of JAX, so its ``cuda`` cases run on the card with
``--noconftest``.
"""

import itertools

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.cli.predict import Predictor, device_axis_ops, pad_to_32
from synthsr_tpu_torch.io.volume import get_ras_axes
from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
from synthsr_tpu_torch.ops.host_matrices import resample_volume_matrices
from synthsr_tpu_torch.utils import profiling

torch.set_num_threads(2)


def align_to_ras(volume, aff):
    """``align_volume_to_ref(volume, aff, aff_ref=np.eye(4), return_aff=True,
    n_dims=3)`` as it read before its axis logic was shared with the device
    prepare, so that this oracle does not go through that logic."""
    new_volume = volume.copy()
    aff_flo = np.array(aff, dtype=float, copy=True)
    aff_ref = np.eye(4)
    ras_ref = get_ras_axes(aff_ref, n_dims=3)
    ras_flo = get_ras_axes(aff_flo, n_dims=3)
    aff_flo[:, ras_ref] = aff_flo[:, ras_flo]
    for i in range(3):
        if ras_flo[i] != ras_ref[i]:
            new_volume = np.swapaxes(new_volume, ras_flo[i], ras_ref[i])
            j = int(np.where(ras_flo == ras_ref[i])[0][0])
            ras_flo[j], ras_flo[i] = ras_flo[i], ras_flo[j]
    dots = np.sum(aff_flo[:3, :3] * aff_ref[:3, :3], axis=0)
    for i in range(3):
        if dots[i] < 0:
            new_volume = np.flip(new_volume, axis=i)
            aff_flo[:, i] = -aff_flo[:, i]
            aff_flo[:3, 3] = aff_flo[:3, 3] - aff_flo[:3, i] * (new_volume.shape[i] - 1)
    return new_volume, aff_flo


def host_prepare(im, aff, ct, device):
    """The numpy prepare the device prepare replaced: numpy between a device
    resample and the upload.  (padded (1, 1, D, H, W) float32 numpy, crop
    slices, aff)."""
    im = np.asarray(im, np.float32)
    if ct:
        im = np.clip(im, 0.0, 80.0)
    mats, _, aff = resample_volume_matrices(im.shape, aff, [1.0, 1.0, 1.0])
    im = device_axis_ops(im, mats, device)
    im, aff2 = align_to_ras(im, aff)
    im = im - np.min(im)
    mx = np.max(im)
    if mx > 0:
        im = im / mx
    padded, crop = pad_to_32(im.shape)
    s = np.zeros((1, 1, *padded), np.float32)
    s[(0, 0) + crop] = im
    return s, crop, aff2


def scan_affine(zooms, axes=(0, 1, 2), flips=(False, False, False), degrees=0.0):
    """Voxel axis i along RAS axis ``axes[i]``, reversed where ``flips[i]``,
    then turned by ``degrees`` about S; centred near the origin."""
    lin = np.zeros((3, 3))
    for i, (a, z, f) in enumerate(zip(axes, zooms, flips)):
        lin[a, i] = -z if f else z
    t = np.deg2rad(degrees)
    rot = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]])
    aff = np.eye(4)
    aff[:3, :3] = rot @ lin
    aff[:3, 3] = [-20.0, 10.0, 5.0]
    return aff


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "rand.pt"
    torch.save(variables_to_state_dict(random_variables(seed=0)), str(path))
    return str(path)


@pytest.fixture(scope="module")
def cpu_predictors(weights):
    return {ct: Predictor(model_path=weights, compute_dtype="float32", ct=ct,
                          disable_flipping=True, device="cpu") for ct in (False, True)}


ODD = (13, 17, 11)
MIXED = (1.3, 0.8, 2.1)  # upsampled, blurred and shrunk, upsampled
# (shape, zooms, axes, flips, degrees, ct, fill): the 48 orientations of RAS
# at odd sizes, then single cases
CASES = [(ODD, MIXED, axes, flips, 0.0, False, None)
         for axes in itertools.permutations(range(3))
         for flips in itertools.product((False, True), repeat=3)]
CASES += [
    ((32, 16, 64), (1.0, 2.0, 0.5), (0, 1, 2), (False, False, False), 0.0, False, None),
    ((33, 31, 29), (1.0, 1.0, 1.0), (2, 0, 1), (True, False, True), 0.0, False, None),
    ((30, 26, 22), (0.6, 0.7, 0.8), (0, 1, 2), (False, True, False), 0.0, False, None),
    ((12, 14, 5), (1.0, 1.2, 4.0), (1, 2, 0), (False, True, True), 10.0, False, None),
    ((16, 18, 9), (1.1, 0.9, 3.0), (0, 2, 1), (True, False, False), 0.0, True, None),
    ((20, 21, 19), (1.0, 1.0, 2.0), (0, 1, 2), (True, True, False), 0.0, False, 0.0),
]
IDS = [f"{'x'.join(map(str, c[0]))}-axes{''.join(map(str, c[2]))}-flip"
       f"{''.join(str(int(f)) for f in c[3])}" + ("-oblique" if c[4] else "")
       + ("-ct" if c[5] else "") + ("-empty" if c[6] is not None else "")
       for c in CASES]


@pytest.mark.parametrize("shape,zooms,axes,flips,degrees,ct,fill", CASES, ids=IDS)
def test_prepare_matches_host_prepare(cpu_predictors, shape, zooms, axes, flips, degrees, ct,
                                      fill):
    """Bit-equal input, crop and affine over every RAS orientation, odd and
    already-padded sizes, up- and downsampling (the blur), an oblique scan,
    the CT clip and an empty volume (max 0: no division)."""
    rng = np.random.default_rng(sum(shape) + 7 * int(ct))
    lo, hi = (-1000.0, 2000.0) if ct else (0.0, 800.0)
    vol = rng.uniform(lo, hi, size=shape).astype(np.float32) if fill is None \
        else np.full(shape, fill, np.float32)
    aff = scan_affine(zooms, axes, flips, degrees)
    want, crop_want, aff_want = host_prepare(vol, aff, ct, torch.device("cpu"))
    x, crop, aff2 = cpu_predictors[ct].prepare(vol, aff)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert np.array_equal(x.numpy(), want)
    assert crop == crop_want
    assert np.array_equal(aff2, aff_want)
    if fill is not None:
        assert not want.any()
    if shape == (32, 16, 64):
        assert x.shape[2:] == (32, 32, 32)  # already a multiple of 32: no pad


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,zooms,flips", [
    ((256, 256, 128), (1.0, 1.0, 2.0), (False, False, False)),
    ((176, 208, 36), (1.0, 1.0, 5.0), (True, True, False)),
], ids=["t1-256", "axial-5mm-flipped"])
def test_prepare_on_card_matches_host_prepare_without_sync(weights, shape, zooms, flips):
    """The predict cells' scans: bit-equal to the host prepare on the card,
    and no host synchronisation from the raw scan's copy on (PyTorch's sync
    debug mode raises on one)."""
    dev = _card()
    rng = np.random.default_rng(1)
    vol = rng.uniform(0.0, 800.0, size=shape).astype(np.float32)
    aff = scan_affine(zooms, flips=flips)
    pred = Predictor(model_path=weights, disable_flipping=True, device=dev)
    pred.prepare(vol, aff)  # the first matrix products set up the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, crop, aff2 = pred.prepare(vol, aff)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want, crop_want, aff_want = host_prepare(vol, aff, False, dev)
    assert x.device.type == "cuda"
    assert np.array_equal(x.cpu().numpy(), want)
    assert crop == crop_want
    assert np.array_equal(aff2, aff_want)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_predict_byte_counters(weights, device):
    """While tracing, one volume counts its raw scan's bytes up and its
    padded output's bytes down; off, nothing."""
    dev = _card() if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        from synthsr_tpu_torch.ops import conv_cf

        conv_cf.build_kernels()
    shape = (20, 26, 12)
    vol = np.random.default_rng(2).uniform(0.0, 500.0, size=shape).astype(np.float32)
    aff = scan_affine((1.0, 1.0, 2.0))
    pred = Predictor(model_path=weights, compute_dtype="float32", device=dev)
    profiling.reset()
    pred.predict_volume(vol, aff)
    assert profiling.snapshot()["counters"] == {}
    was = profiling.tracing(True)
    try:
        out, _ = pred.predict_volume(vol, aff)
    finally:
        profiling.tracing(was)
    counters = {k: v for k, v in profiling.snapshot()["counters"].items()
                if k.startswith("predict.")}  # on a card the conv counters count too
    profiling.reset()
    assert out.shape == (20, 26, 24)
    assert counters == {"predict.h2d_bytes": vol.nbytes, "predict.d2h_bytes": 32 ** 3 * 4}
