"""The port's conv (synthsr_tpu_torch/ops/conv_cf.py) against the JAX package's
Pallas conv family, run in interpret mode on the same numpy inputs.

On the CPU ``conv3d_cf`` is its plain version, so these tests pin the
semantics both CUDA kernels are held to on the card (chip_smoke.py and the
``cuda``-marked test below): SAME padding, multi-source inputs, ``accum``,
bias, activation, ``post`` affine and the folded ``head``, in the JAX order.
JAX is imported inside the tests that compare against it, so the ``cuda``
test also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.ops import conv_cf
from synthsr_tpu_torch.ops.conv_cf import (LAUNCHES, conv3d_cf, conv3d_cf_reference,
                                           pack_conv, reset_launch_counts)

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-5)
HEAD_TOL = dict(rtol=2e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("cin,cout,d,activation", [(1, 8, 8, "relu"), (8, 16, 8, "elu")])
def test_reference_matches_pallas_planes(cin, cout, d, activation):
    """conv3d_cf_planes (K1 for cin=1, K2 otherwise) with bias, activation and
    the post-activation affine (tests/test_ops_core.py:238-269)."""
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_pallas import conv3d_cf_planes

    rng = np.random.default_rng(10 + cin)
    x = rng.normal(size=(cin, d, 16, 128)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.1
    b = rng.normal(size=(cout,)).astype(np.float32)
    post = rng.normal(size=(2, cout)).astype(np.float32)
    want = np.asarray(conv3d_cf_planes(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                                       activation=activation, post=jnp.asarray(post),
                                       interpret=True))
    got = conv3d_cf(_t(x), _t(w), bias=_t(b), activation=activation, post=_t(post))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reference_matches_pallas_grouped_multisource_head():
    """conv3d_cf_grouped on [skip, up] sources with the folded likelihood head
    (tests/test_ops_core.py:305-344): f32 (1, D, H, W) output."""
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_pallas import conv3d_cf_grouped

    rng = np.random.default_rng(3)
    x = rng.normal(size=(24, 8, 16, 128)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 24, 8)).astype(np.float32) * 0.1
    b = rng.normal(size=(8,)).astype(np.float32)
    ha = rng.normal(size=(8,)).astype(np.float32)
    hb = np.float32(rng.normal())
    want = np.asarray(conv3d_cf_grouped(
        [jnp.asarray(x[:8]), jnp.asarray(x[8:])], jnp.asarray(w), bias=jnp.asarray(b),
        activation="elu", head=(jnp.asarray(ha), jnp.asarray(hb)), interpret=True))
    got = conv3d_cf([_t(x[:8]), _t(x[8:])], _t(w), bias=_t(b), activation="elu",
                    head=(_t(ha), torch.tensor(hb)))
    assert got.shape == (1, 8, 16, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **HEAD_TOL)


@pytest.mark.parametrize("cins,cout,width", [((16,), 8, 96), ((8, 16), 8, 96),
                                             ((8,), 8, 160), ((4, 4), 8, 160)])
def test_reference_matches_pallas_flat(cins, cout, width):
    """conv3d_cf_flat (K4), single and multi-source, at the pad-to-32 widths
    W = 96 and W = 160 (tests/test_ops_core.py:369-404)."""
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_pallas import conv3d_cf_flat

    rng = np.random.default_rng(width + len(cins))
    ci = sum(cins)
    srcs = [rng.normal(size=(c, 4, 32, width)).astype(np.float32) for c in cins]
    w = rng.normal(size=(3, 3, 3, ci, cout)).astype(np.float32) * 0.2
    b = rng.normal(size=(cout,)).astype(np.float32)
    jx = [jnp.asarray(s) for s in srcs]
    want = np.asarray(conv3d_cf_flat(jx if len(jx) > 1 else jx[0], jnp.asarray(w),
                                     bias=jnp.asarray(b), activation="elu",
                                     interpret=True))
    tx = [_t(s) for s in srcs]
    got = conv3d_cf(tx if len(tx) > 1 else tx[0], _t(w), bias=_t(b), activation="elu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reference_matches_pallas_accum():
    """``accum`` seeds the sum before bias and activation: a half-cin partial
    conv chained into the other half (tests/test_ops_core.py:407-432)."""
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_pallas import conv3d_cf_flat

    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 4, 32, 96)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 12, 8)).astype(np.float32) * 0.2
    b = rng.normal(size=(8,)).astype(np.float32)
    y1 = conv3d_cf_flat(jnp.asarray(x[:6]), jnp.asarray(w[:, :, :, :6]), interpret=True)
    want = np.asarray(conv3d_cf_flat(jnp.asarray(x[6:]), jnp.asarray(w[:, :, :, 6:]),
                                     bias=jnp.asarray(b), activation="elu",
                                     accum=y1, interpret=True))
    got = conv3d_cf(_t(x[6:]), _t(w[:, :, :, 6:]), bias=_t(b), activation="elu",
                    accum=_t(np.asarray(y1)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_dispatch_is_plain_and_launches_nothing():
    """A CPU tensor runs the plain version, bit for bit, and no kernel; a
    tensor on any other device raises instead of falling back."""
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(3, 4, 8, 8)))
    w = _t(rng.normal(size=(3, 3, 3, 3, 5)))
    reset_launch_counts()
    got = conv3d_cf(x, pack_conv(w, torch.float32), activation="elu")
    want = conv3d_cf_reference(x, w, activation="elu")
    assert torch.equal(got, want)
    assert LAUNCHES == {"first": 0, "fwd": 0, "wgrad": 0}
    with pytest.raises(ValueError):
        conv3d_cf(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("cin,cout", [(1, 24), (2, 8), (13, 40), (72, 24)])
def test_pack_conv_layout(cin, cout):
    """The kernels' weight layout: (cin_pad, 27, cout_pad), tap = kd*9+kh*3+kw,
    zero padding to the channel chunk and the cout tile, values rounded to
    the compute dtype."""
    rng = np.random.default_rng(cin)
    w = _t(rng.normal(size=(3, 3, 3, cin, cout)))
    pc = pack_conv(w, torch.bfloat16)
    ng = conv_cf.cout_groups(cout)
    cin_pad, taps, cout_pad = pc.packed.shape
    assert taps == 27 and cin_pad % conv_cf.FWD_CHUNK == 0 and cout_pad % (8 * ng) == 0
    assert cin_pad - cin < conv_cf.FWD_CHUNK and cout_pad - cout < 8 * ng
    wr = w.to(torch.bfloat16).float()
    for kd, kh, kw in ((0, 0, 0), (1, 2, 0), (2, 1, 2)):
        assert torch.equal(pc.packed[:cin, kd * 9 + kh * 3 + kw, :cout], wr[kd, kh, kw])
    assert not pc.packed[cin:].any() and not pc.packed[:, :, cout:].any()
    assert torch.equal(pc.w, wr)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc, no kernels: the build raises before it writes anything."""
    from synthsr_tpu_torch.ops import cuda_build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()
    assert not (tmp_path / "_build").exists()


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """H-first and H-fwd against conv3d_cf_reference on the card, in bf16 and
    float32, at one small shape per feature (first conv with and without its
    epilogue, [skip, up] sources with bias + elu + post, accum + relu, head;
    W = 48 and H = 12 leave ragged tiles).  The
    reference is float32 with TF32 off, on the same rounded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(6)
        dev = torch.device("cuda")
        d, h, w = 8, 12, 48

        def r(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            post = r(2, 24)
            cases = [
                (dict(x=r(1, d, h, w).to(dtype), w=r(3, 3, 3, 1, 24), bias=r(24),
                      activation="elu", post=post), "first"),
                (dict(x=r(2, d, h, w).to(dtype), w=r(3, 3, 3, 2, 8)), "first"),
                (dict(x=[r(8, d, h, w).to(dtype), r(16, d, h, w).to(dtype)],
                      w=r(3, 3, 3, 24, 24) * 0.1, bias=r(24), activation="elu",
                      post=post), "fwd"),
                (dict(x=r(13, d, h, w).to(dtype), w=r(3, 3, 3, 13, 40) * 0.1,
                      accum=r(40, d, h, w).to(dtype), activation="relu"), "fwd"),
                (dict(x=r(24, d, h, w).to(dtype), w=r(3, 3, 3, 24, 24) * 0.1, bias=r(24),
                      activation="elu", post=post, head=(r(24), r(1)[0])), "fwd"),
            ]
            for kw, kernel in cases:
                before = LAUNCHES[kernel]
                got = conv3d_cf(**kw)
                torch.cuda.synchronize()
                assert LAUNCHES[kernel] == before + 1
                want = conv3d_cf_reference(**kw)
                err = (got.float() - want.float()).abs().max() / want.float().abs().max()
                assert float(err) <= tol, (kernel, dtype, float(err))
    finally:
        torch.backends.cudnn.allow_tf32 = old
