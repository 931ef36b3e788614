"""Plain-torch twins of the float32 tensor-core kernels H-fwd-x3
(csrc/conv3d_fwd_x3.cu) and H-wgrad-x3 (csrc/conv3d_wgrad_x3.cu), held
against the plain float32 versions on the CPU.

Both kernels take float32 operands to the TF32 tensor cores by split TF32:
``a = big + small``, ``big = tf32(a)`` and ``small = tf32(a - big)``, each
rounded as ``cvt.rna.tf32.f32`` rounds (ties away from zero), and each
product as ``small_a·big_b + big_a·small_b + big_a·big_b`` in float32,
chained over a stage of steps (H-fwd-x3: one dz of one group; H-wgrad-x3:
one item) into a partial that is then added to the running sum.
The twins restate that arithmetic and the layouts it rests on:

- H-fwd-x3: each source padded to a multiple of 8 channels on its own, the
  zero-padded halo of 8 x 32 tiles (ragged tiles run over the volume's edge
  and are cut at the store), K walked per 8-channel group and within it per
  tap (one m16n8k8 step each), the split B fragments read back from
  ``pack_conv`` in the lanes' order, then the epilogue (accum, bias,
  activation, post, head);
- H-wgrad-x3: (plane, 4 x 32 tile) items, g zero outside the volume, 27
  GEMMs per item over its 128 voxels with x shifted by the tap, the items
  split over ``wgrad_plan``'s n_split blocks and the partials summed in split
  order.

Tolerances: relative L2 <= 1e-5 (``F32_BOUND``, the card's bound for the
float32 kernels) and elementwise ``tests/test_torch_mma.py``'s TOL, atol and
rtol 1e-4 (float32 sums in another order plus the ~2^-22 split residue).
Plain TF32 (``big·big`` alone) is shown to miss the 1e-5 bound.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from synthsr_tpu_torch.ops import conv_cf
from synthsr_tpu_torch.ops.conv_cf import (LAUNCHES, conv3d_cf, conv3d_cf_reference,
                                           conv3d_cf_wgrad, conv3d_cf_wgrad_reference, pack_conv,
                                           split_tf32, tf32_round, wgrad_plan)

torch.set_num_threads(2)

F32_BOUND = 1e-5  # relative L2 (chip_smoke.F32_BOUND)
TOL = dict(atol=1e-4, rtol=1e-4)
HEAD_TOL = dict(rtol=2e-4, atol=1e-4)


def _tap(t):
    return t // 9, t // 3 % 3, t % 3


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _epilogue(y, bias, activation, post, head, accum):
    if accum is not None:
        y = y + accum.float()
    if bias is not None:
        y = y + bias.float().reshape(-1, 1, 1, 1)
    if activation == "elu":
        y = torch.where(y > 0, y, torch.exp(y) - 1)
    elif activation == "relu":
        y = y.clamp_min(0)
    elif activation == "leaky":
        y = torch.where(y >= 0, y, 0.2 * y)
    if post is not None:
        y = y * post[0].reshape(-1, 1, 1, 1) + post[1].reshape(-1, 1, 1, 1)
    if head is not None:
        return (y * head[0].reshape(-1, 1, 1, 1)).sum(0, keepdim=True) + head[1]
    return y


def fwd_x3_twin(srcs, pc, bias=None, activation=None, post=None, head=None, accum=None,
                plain_tf32=False):
    """H-fwd-x3's arithmetic on float32 sources, (C_out, D, H, W) float32
    ((1, D, H, W) with ``head``); ``plain_tf32`` keeps only big·big."""
    cins = [s.shape[0] for s in srcs]
    assert conv_cf._split_key(cins) == conv_cf._split_key(pc.splits)
    d, h, w = srcs[0].shape[1:]
    ty, tx = conv_cf.MMA_TILE
    hp, wp = -(-h // ty) * ty, -(-w // tx) * tx
    x = torch.cat([F.pad(s.float(), (0, 0, 0, 0, 0, 0, 0, -c % 8)) for s, c in zip(srcs, cins)])
    x = F.pad(x.permute(1, 2, 3, 0), (0, 0, 1, wp - w + 1, 1, hp - h + 1, 1, 1))
    xb, xs = split_tf32(x)  # the lanes split each A element as they load it
    f = pc.frags  # (tile, group, tap, j, g, tq, part, half)
    n_tiles, groups, taps, ng = f.shape[:4]
    assert f.dtype == torch.float32 and taps == 27
    # (group, tap, part, channel = 4·half + tq, output channel = tile·8ng + 8j + g)
    b = f.permute(1, 2, 6, 7, 5, 0, 3, 4).reshape(groups, 27, 2, 8, n_tiles * 8 * ng)
    acc = torch.zeros(d, hp, wp, n_tiles * 8 * ng)
    for k in range(groups):
        for dz in range(3):  # a stage: 9 steps chained into a partial, then added to acc
            part = torch.zeros_like(acc)
            for tap in range(9 * dz, 9 * dz + 9):
                _, dy, dx = _tap(tap)
                view = (slice(dz, dz + d), slice(dy, dy + hp), slice(dx, dx + wp),
                        slice(8 * k, 8 * k + 8))
                bb, bs = b[k, tap]
                if not plain_tf32:
                    part += xs[view] @ bb
                    part += xb[view] @ bs
                part += xb[view] @ bb
            acc += part
    y = acc[:, :h, :w, :pc.cout].permute(3, 0, 1, 2)
    return _epilogue(y, bias, activation, post, head, accum)


def _fwd_case(rng, cins, cout, spatial, epilogue):
    cin = sum(cins)
    srcs = [_f32(rng, c, *spatial) for c in cins]
    if epilogue == "dx":  # an input gradient: flipped, transposed weights, no epilogue
        w = torch.flip(_f32(rng, 3, 3, 3, cout, cin, scale=0.2), (0, 1, 2)).transpose(3, 4)
        return srcs, pack_conv(w, torch.float32, cins), {}
    pc = pack_conv(_f32(rng, 3, 3, 3, cin, cout, scale=0.2), torch.float32, cins)
    kw = {"activation": next((a for a in ("elu", "relu", "leaky") if a in epilogue), None)}
    if "bias" in epilogue:
        kw["bias"] = _f32(rng, cout)
    if "post" in epilogue:
        kw["post"] = _f32(rng, 2, cout)
    if "head" in epilogue:
        kw["head"] = (_f32(rng, cout), torch.tensor(0.25))
    if "accum" in epilogue:
        kw["accum"] = _f32(rng, cout, *spatial)
    return srcs, pc, kw


@pytest.mark.parametrize("cins,cout,spatial,epilogue", [
    ((4,), 24, (3, 12, 40), "bias+elu"),           # the train step's first conv: K padded 4 -> 8
    ((13,), 40, (2, 9, 20), "accum+relu"),         # ragged H and W, 2 cout tiles of 32
    ((8, 16), 24, (3, 8, 32), "bias+elu+post"),    # [skip, up]
    ((5, 11), 24, (2, 11, 37), "bias+leaky+post"),  # each source padded to 8 on its own
    ((24,), 24, (2, 10, 33), "bias+elu+post+head"),
    ((24,), 72, (2, 8, 32), "dx"),                 # the decoder's input gradient, 24 -> 72
    ((32,), 1, (2, 9, 20), "dx"),                  # the critic's first conv's, C_out 1
])
def test_fwd_x3_twin_matches_plain(cins, cout, spatial, epilogue):
    rng = np.random.default_rng(sum(cins) * 7 + cout)
    srcs, pc, kw = _fwd_case(rng, cins, cout, spatial, epilogue)
    got = fwd_x3_twin(srcs, pc, **kw)
    want = conv3d_cf_reference(srcs if len(srcs) > 1 else srcs[0], pc.w, **kw)
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= F32_BOUND
    np.testing.assert_allclose(got.numpy(), want.numpy(), **(HEAD_TOL if "head" in kw else TOL))


def test_plain_tf32_misses_the_float32_bound():
    """A seeded 24 -> 24 conv: big·big alone (plain TF32) lands above 1e-5
    relative L2 of plain float32, the split passes it."""
    rng = np.random.default_rng(24)
    srcs, pc, kw = _fwd_case(rng, (24,), 24, (4, 16, 32), "bias")
    want = conv3d_cf_reference(srcs[0], pc.w, **kw)
    plain = _rel_l2(fwd_x3_twin(srcs, pc, plain_tf32=True, **kw), want)
    split = _rel_l2(fwd_x3_twin(srcs, pc, **kw), want)
    assert plain > F32_BOUND and split <= F32_BOUND, (plain, split)
    assert split < plain / 50


def test_split_is_exact_to_float32():
    """big + small equals x within 2^-22 relative on random, tiny and huge
    values; both halves are tf32 (the low 13 bits zero); the rounding is to
    nearest, ties away from zero."""
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-30, 1e30):
        x = _f32(rng, 4096, scale=scale)
        big, small = split_tf32(x)
        for part in (big, small):
            assert not (part.view(torch.int32) & 0x1FFF).any()
        rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
        assert float(rel) <= 2.0 ** -22, (scale, float(rel))
        assert float(((big - x).abs() / x.abs()).max()) <= 2.0 ** -11
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -12])
    assert tf32_round(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0]


def wgrad_x3_twin(x, g, n_sm=132, plain_tf32=False):
    """H-wgrad-x3's arithmetic: per-item split-TF32 partials of 27 GEMMs,
    summed over each split's item range, then over the splits in order.
    Returns (dw, n_split)."""
    ci, d, h, w = x.shape
    co = g.shape[0]
    plan = wgrad_plan(ci, co, d, h, w, n_sm, torch.float32)
    th, tw = plan.th, plan.tw
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    ci_pad, co_pad = -(-ci // 8) * 8, -(-co // plan.co_tile) * plan.co_tile
    xs = F.pad(x.float(), (0, 0, 0, 0, 0, 0, 0, ci_pad - ci)).permute(1, 2, 3, 0)
    xs = F.pad(xs, (0, 0, 1, wp - w + 1, 1, hp - h + 1, 1, 1))
    gs = F.pad(g.float(), (0, wp - w, 0, hp - h, 0, 0, 0, co_pad - co))
    gb, gsm = split_tf32(gs.reshape(co_pad, d, hp // th, th, wp // tw, tw))
    xb, xsm = split_tf32(xs)
    taps = []
    for tap in range(27):
        dz, dy, dx = _tap(tap)

        def view(t):
            return t[dz:dz + d, dy:dy + hp, dx:dx + wp].reshape(d, hp // th, th, wp // tw, tw,
                                                                ci_pad)

        def gemm(xt, gt):
            return torch.einsum("zAaBbc,ozAaBb->zABco", view(xt), gt)

        item = gemm(xb, gb)
        if not plain_tf32:  # small_g·big_x + big_g·small_x, then big·big
            item = gemm(xb, gsm) + gemm(xsm, gb) + item
        taps.append(item.reshape(-1, ci_pad, co_pad))
    items = torch.stack(taps, 1)  # (item = (z, tile), 27, ci_pad, co_pad)
    n = items.shape[0]
    dw = torch.zeros(27, ci_pad, co_pad)
    for split in range(plan.n_split):
        dw = dw + items[n * split // plan.n_split:n * (split + 1) // plan.n_split].sum(0)
    return dw[:, :ci, :co].reshape(3, 3, 3, ci, co), plan.n_split


@pytest.mark.parametrize("ci,co,d,h,w,n_sm", [
    (5, 13, 3, 9, 20, 132),   # ragged everything, co tile 16
    (4, 24, 4, 8, 64, 2),     # the train step's first conv; few splits of many items
    (8, 48, 2, 6, 40, 132),   # co tile 48
    (24, 72, 2, 5, 33, 1),    # one split of all items
    (1, 32, 2, 8, 32, 132),   # C_in 1 (the critic's first conv), padded to 8
    (32, 1, 2, 8, 32, 132),   # C_out 1 (the penalty's 32 -> 1 conv), padded to 16
])
def test_wgrad_x3_twin_matches_plain(ci, co, d, h, w, n_sm):
    rng = np.random.default_rng(ci * co + w)
    x, g = _f32(rng, ci, d, h, w), _f32(rng, co, d, h, w)
    got, n_split = wgrad_x3_twin(x, g, n_sm)
    assert n_split >= 1
    want = conv3d_cf_wgrad_reference(x, g)
    assert _rel_l2(got, want) <= F32_BOUND
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_wgrad_plain_tf32_misses_the_float32_bound():
    rng = np.random.default_rng(3)
    x, g = _f32(rng, 24, 2, 8, 32), _f32(rng, 24, 2, 8, 32)
    want = conv3d_cf_wgrad_reference(x, g)
    plain = _rel_l2(wgrad_x3_twin(x, g, plain_tf32=True)[0], want)
    split = _rel_l2(wgrad_x3_twin(x, g)[0], want)
    assert plain > F32_BOUND and split <= F32_BOUND, (plain, split)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    return old


@pytest.mark.cuda
def test_fwd_x3_matches_plain_on_card():
    """H-fwd-x3 against conv3d_cf_reference (float32, TF32 off) at the twin's
    cases, at W % 4 == 0 (16-byte staging) and not (4-byte)."""
    old = _on_card()
    try:
        rng = np.random.default_rng(9)
        for cins, cout, spatial, epilogue in (
                ((4,), 24, (3, 12, 40), "bias+elu"), ((13,), 40, (2, 9, 20), "accum+relu"),
                ((5, 11), 24, (2, 11, 37), "bias+leaky+post"),
                ((24,), 24, (2, 10, 33), "bias+elu+post+head"), ((32,), 1, (2, 9, 20), "dx")):
            srcs, pc, kw = _fwd_case(rng, cins, cout, spatial, epilogue)
            srcs = [s.cuda() for s in srcs]
            pc = pack_conv(pc.w.cuda(), torch.float32, cins)
            kw = {k: (tuple(t.cuda() for t in v) if isinstance(v, tuple) else
                      v.cuda() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
            x = srcs if len(srcs) > 1 else srcs[0]
            before = LAUNCHES["fwd_x3"]
            got = conv3d_cf(x, pc, **kw)
            torch.cuda.synchronize()
            assert LAUNCHES["fwd_x3"] == before + 1
            want = conv3d_cf_reference(x, pc, **kw)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= F32_BOUND, (cins, cout, epilogue, err)
    finally:
        torch.backends.cudnn.allow_tf32 = old


@pytest.mark.cuda
def test_wgrad_x3_matches_plain_on_card():
    """H-wgrad-x3 against conv3d_cf_wgrad_reference (float32, TF32 off),
    ragged and C_in / C_out 1, and two calls bit-equal."""
    old = _on_card()
    try:
        rng = np.random.default_rng(10)
        for ci, co, d, h, w in ((5, 13, 3, 9, 20), (24, 72, 4, 12, 48), (1, 32, 4, 8, 32),
                                (32, 1, 4, 8, 32)):
            x, g = _f32(rng, ci, d, h, w).cuda(), _f32(rng, co, d, h, w).cuda()
            before = LAUNCHES["wgrad_x3"]
            got, again = conv3d_cf_wgrad(x, g), conv3d_cf_wgrad(x, g)
            torch.cuda.synchronize()
            assert LAUNCHES["wgrad_x3"] == before + 2
            want = conv3d_cf_wgrad_reference(x, g)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= F32_BOUND, (ci, co, err)
            assert torch.equal(got, again)
    finally:
        torch.backends.cudnn.allow_tf32 = old
