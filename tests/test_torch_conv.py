"""The port's conv (synthsr_tpu_torch/ops/conv_cf.py) against the JAX package's
Pallas conv family, run in interpret mode on the same numpy inputs.

On the CPU ``conv3d_cf`` is its plain version, so these tests pin the
semantics the CUDA kernels are held to on the card (chip_smoke.py and the
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


@pytest.mark.parametrize("cin,cout,d,activation", [(1, 8, 8, "relu"), (8, 16, 8, "elu"),
                                                    (2, 24, 8, "elu")])
def test_reference_matches_pallas_planes(cin, cout, d, activation):
    """conv3d_cf_planes (K1 for cin <= 2: the 1-channel first conv and the
    Hyperfine 2-channel one; K2 otherwise) with bias, activation and the
    post-activation affine (tests/test_ops_core.py:238-269)."""
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
    assert LAUNCHES == {"first_x3": 0, "first_mma": 0, "fwd_mma": 0, "wgrad_mma": 0, "fwd_x3": 0,
                        "wgrad_x3": 0, "fwd_wg": 0, "wgrad_wg": 0}
    with pytest.raises(ValueError):
        conv3d_cf(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("cin,cout", [(1, 24), (2, 8), (13, 40), (72, 24), (2, 24), (1, 32),
                                      (2, 40)])
def test_pack_conv_layout(cin, cout):
    """The kernels' weight layouts, values rounded to the compute dtype.

    float32 with C_in <= 2 and C_out <= 32 (H-first-x3): the split-TF32 B
    fragments (n8 tiles, steps, g, tq, part, half): unpacked, row k =
    8s+4half+tq of step s is tap (8/C_in)*s + kk % (8/C_in) of channel
    kk // (8/C_in) (kk = 4half+tq), column 8j+g an output channel; part 0 is
    tf32(w), part 1 tf32(w - part 0), their sum w within 2^-22; columns past
    C_out and taps past 26 zero.  float32 (H-fwd-x3):
    the split-TF32 B fragments (n_tiles, groups, 27, ng, g, tq, part, half):
    part 0 is tf32(w) (round to nearest, ties away), part 1 tf32(w - part 0),
    lane 4g+tq output channel 8j+g, channels 8k+tq (half 0) and 8k+tq+4
    (half 1); everything past the weight is zero.  bf16 (H-fwd-mma):
    the B fragments (n_tiles, groups, steps, ng, lanes, 4): unpacked, step s
    of group k holds tap 2s (k 0-7) and tap 2s+1 (k 8-15) of channels
    8k..8k+7, lane 4g+tq output channel 8j+g, k 2tq, 2tq+1, 2tq+8, 2tq+9;
    everything past the weight is zero.  bf16 with C_in <= 2 and C_out <= 32
    (H-first-mma): the A fragments (m-tiles, steps, g, tq, kh, rh, e):
    unpacked, row 16mt+8rh+g is an output channel, column k = tap*C_in+c then
    the bias's ones column k = 27*C_in and padding to 32 / 64, all zero."""
    rng = np.random.default_rng(cin)
    w = _t(rng.normal(size=(3, 3, 3, cin, cout)))
    for dtype in (torch.float32, torch.bfloat16):
        pc = pack_conv(w, dtype)
        wr = w.to(dtype).float()
        assert torch.equal(pc.w, wr) and pc.splits == (cin,)
        if dtype == torch.bfloat16 and cin <= 2 and cout <= conv_cf.FIRST_MMA_MAX_COUT:
            kpad = conv_cf.FIRST_MMA_KPAD[cin]
            f = pc.first_frags
            assert f.dtype == torch.bfloat16 and f.shape == (2, kpad // 16, 8, 4, 2, 2, 2)
            a = f.float().permute(0, 5, 2, 1, 4, 3, 6).reshape(32, kpad)  # (channel, k)
            want = wr.reshape(27 * cin, cout).t()
            assert torch.equal(a[:cout, :27 * cin], want)
            assert not a[cout:].any() and not a[:, 27 * cin:].any()
            # lane 4g+tq = 4*5+2 of m-tile 0, step 1, register 2kh+rh = 3: channel 8+5, k 16+8+4+e
            got = f[0, 1, 5, 2].reshape(4, 2)[3]
            assert torch.equal(got.float(), torch.stack([
                want[13, k] if k < 27 * cin and 13 < cout else torch.tensor(0.0)
                for k in (28, 29)]))
        elif dtype == torch.float32 and cin <= 2 and cout <= conv_cf.FIRST_MMA_MAX_COUT:
            steps, tps, nt = conv_cf.FIRST_X3_STEPS[cin], 8 // cin, -(-cout // 8)
            f = pc.first_frags
            assert f.dtype == torch.float32 and f.shape == (nt, steps, 8, 4, 2, 2)
            # (j, s, g, tq, part, half) -> (part, s, c, tap in step, n = 8j + g)
            b = f.permute(4, 1, 5, 3, 0, 2).reshape(2, steps, cin, tps, 8 * nt)
            full = b.permute(0, 1, 3, 2, 4).reshape(2, steps * tps, cin, 8 * nt)
            big, small = full[0, :27, :, :cout], full[1, :27, :, :cout]
            w27 = wr.reshape(27, cin, cout)
            assert torch.equal(big, conv_cf.tf32_round(w27))
            assert torch.equal(small, conv_cf.tf32_round(w27 - big))
            assert float(((big.double() + small.double() - w27.double()).abs()
                          - 2.0 ** -22 * w27.double().abs()).max()) <= 0
            assert not (full.view(torch.int32) & 0x1FFF).any()
            assert not full[:, 27:].any() and not full[..., cout:].any()
            # lane 4g+tq = 4*5+2 of n8 tile 0, step 1, big b1: output channel 5,
            # row k = 8 + 2 + 4 = tap tps + 6 % tps of channel 6 // tps
            tap, c = tps + 6 % tps, 6 // tps
            assert torch.equal(f[0, 1, 5, 2, 0, 1], conv_cf.tf32_round(w27[tap, c, 5]))
        else:
            assert pc.first_frags is None
        if dtype == torch.float32:
            ng = conv_cf.cout_groups(cout)
            n_tiles, groups = -(-cout // (8 * ng)), -(-cin // 8)
            f = pc.frags
            assert f.dtype == torch.float32 and pc.ng == ng
            assert f.shape == (n_tiles, groups, 27, ng, 8, 4, 2, 2)
            # (tile, k, tap, j, g, tq, part, half) -> part, taps, channels, cout
            full = f.permute(6, 2, 1, 7, 5, 0, 3, 4).reshape(2, 27, 8 * groups, 8 * ng * n_tiles)
            big, small = full[0, :, :cin, :cout], full[1, :, :cin, :cout]
            w27 = wr.reshape(27, cin, cout)
            assert torch.equal(big, conv_cf.tf32_round(w27))
            assert torch.equal(small, conv_cf.tf32_round(w27 - big))
            assert not (full.view(torch.int32) & 0x1FFF).any()
            assert not full[:, :, cin:].any() and not full[:, :, :, cout:].any()
            lane = 4 * 3 + 1  # g = 3, tq = 1: channels 1 and 5 of output channel 8j + 3
            j = ng - 1
            got = f[0, 0, 7, j].reshape(32, 4)[lane]
            want = [w27[7, c, 8 * j + 3] if c < cin and 8 * j + 3 < cout else torch.tensor(0.0)
                    for c in (1, 5)]
            want = torch.stack(want)
            assert torch.equal(got, torch.cat(conv_cf.split_tf32(want)))
            continue
        ng = conv_cf.mma_groups(cout)
        n_tiles, groups = -(-cout // (8 * ng)), -(-cin // 8)
        f = pc.frags
        assert f.dtype == torch.bfloat16
        assert f.shape == (n_tiles, groups, conv_cf.MMA_STEPS, ng, 8, 4, 2, 2)
        # (tile, k, s, j, g, tq, half, e) -> taps (28), channels, cout
        full = f.float().permute(2, 6, 1, 5, 7, 0, 3, 4).reshape(28, 8 * groups, 8 * ng * n_tiles)
        assert torch.equal(full[:27, :cin, :cout], wr.reshape(27, cin, cout))
        assert not full[27].any() and not full[:, cin:].any() and not full[:, :, cout:].any()
        lane = 4 * 3 + 1  # g = 3, tq = 1: b0 = k (2, 3), b1 = k (10, 11), i.e. taps 2s and 2s+1
        s, j = 5, ng - 1
        got = f[0, 0, s, j].reshape(32, 4)[lane].float()
        want = torch.stack([wr.reshape(27, cin, cout)[tap, c, 8 * j + 3] if c < cin
                            and 8 * j + 3 < cout else torch.tensor(0.0)
                            for tap in (2 * s, 2 * s + 1) for c in (2, 3)])
        assert torch.equal(got, want)


def test_pack_conv_pads_each_source_to_eight():
    """Two sources of 5 and 11 channels: 1 + 2 groups, the first source's
    channels 5-7 zero; the layout records the split, and a launch with
    another split is refused before anything runs."""
    rng = np.random.default_rng(9)
    w = _t(rng.normal(size=(3, 3, 3, 16, 24)))
    pc = pack_conv(w, torch.bfloat16, (5, 11))
    assert pc.splits == (5, 11) and pc.frags.shape[1] == 3
    full = pc.frags.float().permute(2, 6, 1, 5, 7, 0, 3, 4).reshape(28, 24, 24)
    wr = w.to(torch.bfloat16).float().reshape(27, 16, 24)
    assert torch.equal(full[:27, :5], wr[:, :5]) and not full[:, 5:8].any()
    assert torch.equal(full[:27, 8:19], wr[:, 5:]) and not full[:, 19:].any()
    assert conv_cf._split_key((5, 11)) != conv_cf._split_key((16,))
    assert conv_cf._split_key((8, 8)) == conv_cf._split_key((16,))
    with pytest.raises(ValueError):
        pack_conv(w, torch.bfloat16, (5, 10))


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
    """H-first-mma, H-fwd-mma (bf16), H-first-x3 and H-fwd-x3 (float32) against
    conv3d_cf_reference on the card, at one small shape per feature: first
    conv (C_in 1 and 2) with and without its epilogue, with post, with 11
    planes (a ragged block), and with C_out = 40 (past the first-conv
    kernels' 32: H-fwd-mma, H-fwd-x3), [skip, up] sources of [8,16] and
    [5,11] (each padded to 8 in shared memory) with bias + elu + post, C_in 4
    and 13 with accum + relu, head; H = 12 and W = 48 / 20 leave ragged tiles
    (W = 20 takes the 2-byte load path); the flipped, transposed weights of an
    input gradient; the critic's LeakyReLU convs (C_out 32 on the first-conv
    kernels, 32 -> 64) and its first conv's input gradient (C_out 1).  The
    bf16 calls that ``conv_cf.fwd_wg_ok`` passes (W = 48, C_out % 8 == 0, no
    accum) run H-fwd-wg, the rest H-fwd-mma.  The reference is float32 with
    TF32 off, on the same rounded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(6)
        dev = torch.device("cuda")
        d, h = 8, 12

        def r(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

        for dtype, tol, kernel, first in ((torch.bfloat16, 1e-2, "fwd_mma", "first_mma"),
                                          (torch.float32, 1e-5, "fwd_x3", "first_x3")):
            post = r(2, 24)
            for w in (48, 20):
                cases = [
                    (dict(x=r(1, d, h, w).to(dtype), w=r(3, 3, 3, 1, 24), bias=r(24),
                          activation="elu", post=post), first),
                    (dict(x=r(2, d, h, w).to(dtype), w=r(3, 3, 3, 2, 8)), first),
                    (dict(x=r(2, 11, h, w).to(dtype), w=r(3, 3, 3, 2, 24), bias=r(24),
                          activation="relu", post=post), first),
                    (dict(x=r(1, d, h, w).to(dtype), w=r(3, 3, 3, 1, 40), bias=r(40),
                          activation="elu"), kernel),
                    (dict(x=[r(8, d, h, w).to(dtype), r(16, d, h, w).to(dtype)],
                          w=r(3, 3, 3, 24, 24) * 0.1, bias=r(24), activation="elu",
                          post=post), kernel),
                    (dict(x=[r(5, d, h, w).to(dtype), r(11, d, h, w).to(dtype)],
                          w=r(3, 3, 3, 16, 24) * 0.1, bias=r(24), activation="elu",
                          post=post), kernel),
                    (dict(x=r(4, d, h, w).to(dtype), w=r(3, 3, 3, 4, 24) * 0.1, bias=r(24),
                          activation="elu"), kernel),
                    (dict(x=r(13, d, h, w).to(dtype), w=r(3, 3, 3, 13, 40) * 0.1,
                          accum=r(40, d, h, w).to(dtype), activation="relu"), kernel),
                    (dict(x=r(24, d, h, w).to(dtype), w=r(3, 3, 3, 24, 24) * 0.1, bias=r(24),
                          activation="elu", post=post, head=(r(24), r(1)[0])), kernel),
                    (dict(x=r(96, d, h, w).to(dtype), w=r(3, 3, 3, 96, 48) * 0.05, bias=r(48),
                          activation="elu"), kernel),
                    (dict(x=r(24, d, h, w).to(dtype),
                          w=torch.flip(r(3, 3, 3, 72, 24) * 0.1, (0, 1, 2)).transpose(3, 4)),
                     kernel),
                    # the critic's: LeakyReLU on the first conv (C_out 32) and a
                    # trunk conv, and its first conv's input gradient (C_out 1)
                    (dict(x=r(1, d, h, w).to(dtype), w=r(3, 3, 3, 1, 32), bias=r(32),
                          activation="leaky"), first),
                    (dict(x=r(32, d, h, w).to(dtype), w=r(3, 3, 3, 32, 64) * 0.1, bias=r(64),
                          activation="leaky"), kernel),
                    (dict(x=r(32, d, h, w).to(dtype),
                          w=torch.flip(r(3, 3, 3, 1, 32) * 0.1, (0, 1, 2)).transpose(3, 4)),
                     kernel),
                ]
                for kw, name in cases:
                    if name == "fwd_mma" and conv_cf.fwd_wg_ok(kw["x"], kw["w"].shape[-1],
                                                               kw.get("accum"), kw.get("head")):
                        name = "fwd_wg"  # the gate gives the call to H-fwd-wg
                    before = dict(LAUNCHES)
                    got = conv3d_cf(**kw)
                    torch.cuda.synchronize()
                    assert [k for k in LAUNCHES if LAUNCHES[k] != before[k]] == [name]
                    want = conv3d_cf_reference(**kw)
                    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
                    bound = 1e-4 if "head" in kw and dtype == torch.bfloat16 else tol
                    assert float(err) <= bound, (name, dtype, w, float(err))
    finally:
        torch.backends.cudnn.allow_tf32 = old
