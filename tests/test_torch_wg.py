"""H-fwd-wg (synthsr_tpu_torch/csrc/conv3d_fwd_wg.cu), the bf16 forward conv
on wgmma and TMA: a plain-torch twin of its formulation held against the
plain version and the JAX package's Pallas conv on the CPU, its gate and
launch plan, and (``cuda``-marked) the kernel itself on the card.

The kernel runs only on the card.  ``fwd_wg_twin`` restates in float32 torch
what it computes and in which layout, so that the index arithmetic it rests
on is tested here:

- the launch plan of ``conv_cf.wg_plan``: N tiles of C_out, blocks of TX x
  TY voxels and NZ output planes, 2·MTW M tiles of 8 x 8 voxels per plane;
- the stages: per 8-channel group (each source padded to 8 on its own by the
  TMA box running past its channels) the NZ + 2 input planes z0-1 .. z0+NZ,
  each one TMA box of (8 channels, TY + 2 rows, TX + 16 voxels) from (x0-8,
  y0-1) (a box's innermost start is 16-byte aligned) with zeros outside the
  volume, transposed to channels-last rows;
- the products: per input plane, for each output plane it feeds (tap plane
  dz = ip - zo), 5 k16 steps pairing the plane's taps (0,1) (2,3) (4,5)
  (6,7) (8, zero weights), A read as the kernel's descriptors address it
  (start = the M tile's origin shifted by the first tap, 8 core matrices one
  staged row apart (SBO), the second K half LBO further), B read back from
  ``pack_conv``'s ``wg`` in the order the producer copies it (5 pieces of
  N·16 values per (group, dz) slice, the N tile's run of each k16 step);
- the epilogue (bias, activation, post, head) and the store, which clips the
  ragged edges.
"""

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.ops import conv_cf
from synthsr_tpu_torch.ops.conv_cf import conv3d_cf_reference, fwd_wg_ok, pack_conv, wg_plan

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)  # float32 sums in another order
JAX_TOL = dict(atol=2e-4, rtol=2e-4)  # the ROADMAP's bound against the JAX kernels


def _box(src, ch, z, y0, x0, ty, rowx):
    """One TMA box: channels ch .. ch+7, plane z, rows y0 .. y0+ty+1, voxels
    x0 .. x0+rowx-1 of a (C, D, H, W) source, zero outside it."""
    c, d, h, w = src.shape
    out = torch.zeros(8, ty + 2, rowx)
    if not 0 <= z < d:
        return out
    cs, ys, xs = slice(max(ch, 0), min(ch + 8, c)), slice(max(y0, 0), min(y0 + ty + 2, h)), \
        slice(max(x0, 0), min(x0 + rowx, w))
    if cs.start < cs.stop and ys.start < ys.stop and xs.start < xs.stop:
        out[cs.start - ch:cs.stop - ch, ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = \
            src[cs, z, ys, xs].float()
    return out


def fwd_wg_twin(srcs, pc, bias=None, activation=None, post=None, head=None):
    """H-fwd-wg's arithmetic on float32 sources: (C_out, D, H, W) float32
    ((1, D, H, W) with ``head``), the sources padded by ``wg_sources`` and
    the output cut back to W as the wrapper does."""
    w_in = srcs[0].shape[3]
    srcs = conv_cf.wg_sources(srcs)
    cins = [s.shape[0] for s in srcs]
    d, h, w = srcs[0].shape[1:]
    cout = pc.cout
    plan = wg_plan(cout)
    n, tx, ty, mtw, nz = plan.n, plan.tx, plan.ty, plan.mtw, plan.nz
    assert (tx // 8) * (ty // 8) == 2 * mtw
    rowx = tx + 16
    g0 = -(-cins[0] // 8)
    groups = g0 + (-(-cins[1] // 8) if len(cins) == 2 else 0)
    jt = cout // 8
    wg = pc.wg.float()
    tiles_x, tiles_y = -(-w // tx), -(-h // ty)
    full = torch.zeros(plan.tiles * n, -(-d // nz) * nz, tiles_y * ty, tiles_x * tx)
    for t in range(plan.tiles):
        for bz in range(-(-d // nz)):
            for by in range(tiles_y):
                for bx in range(tiles_x):
                    z0, y0, x0 = bz * nz, by * ty, bx * tx
                    acc = torch.zeros(nz, 2 * mtw, 64, n)
                    for c in range(groups):
                        src = srcs[0] if c < g0 else srcs[1]
                        ch = 8 * (c if c < g0 else c - g0)
                        # the (group, dz) weight slices: 5 pieces of the N tile's run
                        b = []
                        for dz in range(3):
                            k = 3 * c + dz
                            pieces = []
                            for p in range(conv_cf.WG_PAIRS):
                                o = ((k * conv_cf.WG_PAIRS + p) * jt + t * n // 8) * 128
                                piece = wg[o:o + 16 * n].reshape(n // 8, 2, 8, 8)  # j, h, n, k
                                pieces.append(piece.permute(1, 3, 0, 2).reshape(16, n))
                            b.append(pieces)
                        for ip in range(nz + 2):
                            raw = _box(src, ch, z0 - 1 + ip, y0 - 1, x0 - 8, ty, rowx)
                            cl = raw.permute(1, 2, 0).reshape(-1, 8)  # channels-last rows
                            for zo in range(nz):
                                dz = ip - zo
                                if not 0 <= dz <= 2:
                                    continue
                                for p in range(conv_cf.WG_PAIRS):
                                    t0 = 2 * p
                                    o0 = (t0 // 3) * rowx + t0 % 3 + 7  # column 0 is x0-8
                                    lbo = (2 * p + 1) // 3 * rowx + (2 * p + 1) % 3 + 7 - o0 \
                                        if p < 4 else 1
                                    for mt in range(2 * mtw):
                                        a0 = (mt // (tx // 8)) * 8 * rowx + (mt % (tx // 8)) * 8
                                        rows = (a0 + o0 + torch.arange(8)[:, None] * rowx
                                                + torch.arange(8)[None]).reshape(-1)
                                        a = torch.cat([cl[rows], cl[rows + lbo]], 1)  # (64, 16)
                                        acc[zo, mt] += a @ b[dz][p]
                    # M row 8i + r of tile mt is voxel (8·(mt // cols) + i, 8·(mt % cols) + r)
                    v = acc.reshape(nz, ty // 8, tx // 8, 8, 8, n).permute(5, 0, 1, 3, 2, 4)
                    full[t * n:(t + 1) * n, z0:z0 + nz, y0:y0 + ty, x0:x0 + tx] = \
                        v.reshape(n, nz, ty, tx)
    y = full[:cout, :d, :h, :w_in]
    if bias is not None:
        y = y + bias.to(pc.dtype).float().reshape(-1, 1, 1, 1)
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


def _bf16(rng, *shape, scale=1.0):
    """float32 values that bf16 holds exactly."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale) \
        .to(torch.bfloat16).float()


def _epilogue(rng, cout, epilogue):
    kw = {}
    if "bias" in epilogue:
        kw["bias"] = _bf16(rng, cout)
    for act in ("elu", "relu", "leaky"):
        if act in epilogue:
            kw["activation"] = act
    if "post" in epilogue:
        kw["post"] = torch.from_numpy(rng.normal(size=(2, cout)).astype(np.float32))
    if "head" in epilogue:
        kw["head"] = (torch.from_numpy(rng.normal(size=cout).astype(np.float32)),
                      torch.tensor(0.25))
    return kw


@pytest.mark.parametrize("cins,cout,spatial,epilogue", [
    ((24,), 24, (3, 13, 40), "bias+elu"),          # ragged H, W and D (NZ = 2)
    ((8, 16), 24, (4, 9, 24), "bias+elu+post"),    # [skip, up]
    ((5, 11), 24, (2, 11, 16), "bias+elu+post"),   # each source padded to 8 by the box
    ((24,), 24, (3, 10, 32), "bias+elu+post+head"),
    ((16,), 40, (2, 8, 16), "bias+relu"),          # the N tile (48) runs past C_out
    ((32,), 64, (3, 8, 16), "bias+leaky"),         # the critic's
    ((12,), 72, (3, 8, 8), "none"),                # an input gradient's shape, W = 8 < TX
    ((8,), 256, (2, 9, 16), "bias+elu"),           # two N tiles of 128
    ((16,), 24, (3, 8, 20), "bias+elu+post+head"),  # W % 8 != 0: padded to 24, cut back
    ((24, 48), 48, (2, 4, 4), "bias+elu"),          # a tutorial's 4^3 level
])
def test_fwd_wg_twin_matches_plain(cins, cout, spatial, epilogue):
    rng = np.random.default_rng(sum(cins) + cout)
    cin = sum(cins)
    srcs = [_bf16(rng, c, *spatial) for c in cins]
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2)
    pc = pack_conv(w, torch.bfloat16, cins)
    kw = _epilogue(rng, cout, epilogue)
    got = fwd_wg_twin(srcs, pc, **kw)
    want = conv3d_cf_reference(srcs if len(srcs) > 1 else srcs[0], pc.w, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), **TOL)


def test_fwd_wg_twin_matches_pallas_two_sources():
    """The twin against the JAX package's K2 with [skip, up] sources
    (``conv3d_cf_planes(..., interpret=True)``; W % 128 == 0, D % 4 == 0) on
    the same numpy inputs, weights and bias rounded to bf16 for both."""
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_pallas import conv3d_cf_planes

    rng = np.random.default_rng(13)
    x = rng.normal(size=(24, 4, 16, 128)).astype(np.float32)
    w = _bf16(rng, 3, 3, 3, 24, 24, scale=0.1).numpy()
    b = _bf16(rng, 24).numpy()
    post = rng.normal(size=(2, 24)).astype(np.float32)
    want = np.asarray(conv3d_cf_planes([jnp.asarray(x[:8]), jnp.asarray(x[8:])], jnp.asarray(w),
                                       bias=jnp.asarray(b), activation="elu",
                                       post=jnp.asarray(post), interpret=True))
    srcs = [torch.from_numpy(x[:8]), torch.from_numpy(x[8:])]
    got = fwd_wg_twin(srcs, pack_conv(torch.from_numpy(w), torch.bfloat16, (8, 16)),
                      bias=torch.from_numpy(b), activation="elu", post=torch.from_numpy(post))
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


def test_gate_and_plan():
    """The gate takes bf16 calls without accum at C_out % 8 == 0 and W % 8 ==
    0 from aligned sources (a head only in one N tile); the plan's N tiles
    cover C_out with an instance of the kernel, and its tiles hold 2·MTW M
    tiles."""
    x = torch.zeros(24, 2, 8, 32, dtype=torch.bfloat16)
    assert fwd_wg_ok(x, 24)
    assert fwd_wg_ok([x, x], 24, head=(None, None))
    assert not fwd_wg_ok(x.float(), 24)
    assert not fwd_wg_ok(x, 24, accum=x)
    assert not fwd_wg_ok(x, 1)                                          # the critic's 32->1 dx
    assert not fwd_wg_ok(x, 384, head=(None, None))
    # the layout H-fwd-wg reads: W % 8 == 0 and 16-byte aligned, else a padded copy
    assert conv_cf.wg_sources([x])[0] is x
    odd = torch.ones(24, 2, 8, 20, dtype=torch.bfloat16)
    shifted = torch.ones(24 * 2 * 8 * 32 + 1, dtype=torch.bfloat16)[1:].view(24, 2, 8, 32)
    for src, w8 in ((odd, 24), (shifted, 32)):
        got = conv_cf.wg_sources([src])[0]
        assert got.shape == (24, 2, 8, w8) and got.data_ptr() % 16 == 0
        assert torch.equal(got[..., :src.shape[3]], src) and not got[..., src.shape[3]:].any()
    for cout in range(8, 600, 8):
        plan = wg_plan(cout)
        assert (plan.mtw, plan.nz) == conv_cf.WG_CONFIGS[plan.n]
        assert plan.tiles * plan.n >= cout > (plan.tiles - 1) * plan.n
        assert plan.n <= conv_cf.WG_MAX_N
        assert (plan.tx // 8) * (plan.ty // 8) == 2 * plan.mtw
    # the predict path's level-0 and level-4 convs
    assert wg_plan(24) == conv_cf.WgPlan(24, 1, 32, 16, 4, 2)
    assert wg_plan(384) == conv_cf.WgPlan(192, 2, 16, 8, 1, 1)


def test_wg_weights_layout():
    """``pack_conv``'s ``wg``: element (group, dz, p, j, h, n, k) is the
    weight of tap (dz, 2p + h) (zero for tap 9) from input channel 8·group
    + k of its source (each source padded to 8) to output channel 8j + n;
    then the tail of zeros."""
    rng = np.random.default_rng(2)
    w = _bf16(rng, 3, 3, 3, 13, 16)
    pc = pack_conv(w, torch.bfloat16, (5, 8))
    jt, tail = 2, conv_cf.WG_MAX_N * 16
    body = pc.wg[:-tail].float().reshape(2, 3, conv_cf.WG_PAIRS, jt, 2, 8, 8)
    assert torch.all(pc.wg[-tail:] == 0)
    chans = list(range(5)) + [None] * 3 + list(range(5, 13))  # source 0 padded to 8
    for grp in range(2):
        for dz in range(3):
            for t in range(10):
                for k in range(8):
                    ci = chans[8 * grp + k]
                    got = body[grp, dz, t // 2, :, t % 2, :, k].reshape(16)
                    want = w[dz, t // 3, t % 3, ci] if t < 9 and ci is not None else \
                        torch.zeros(16)
                    assert torch.equal(got, want), (grp, dz, t, k)
    assert pack_conv(w, torch.float32, (5, 8)).wg is None


@pytest.mark.cuda
def test_fwd_wg_matches_plain_and_mma_on_card():
    """H-fwd-wg on the card against the plain float32 version and against
    H-fwd-mma on the same bf16 inputs (relative L2 within 1e-2), at the
    twin's shapes and two main-path ones, two calls bit-equal; the gate
    routes each call to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = torch.device("cuda")
        rng = np.random.default_rng(21)
        cases = [((24,), 24, (3, 13, 40), "bias+elu"), ((8, 16), 24, (4, 9, 24), "bias+elu+post"),
                 ((5, 11), 24, (2, 11, 16), "bias+elu+post"),
                 ((24,), 24, (3, 10, 32), "bias+elu+post+head"),
                 ((16,), 40, (2, 8, 16), "bias+relu"),
                 ((32,), 64, (3, 8, 16), "bias+leaky"), ((12,), 72, (3, 8, 8), "none"),
                 ((8,), 256, (2, 9, 16), "bias+elu"), ((16,), 24, (3, 8, 20), "bias+elu+post+head"),
                 ((24, 48), 48, (2, 4, 4), "bias+elu"), ((24, 48), 24, (8, 64, 64), "bias+elu"),
                 ((192, 384), 192, (8, 32, 32), "bias+elu+post")]
        for cins, cout, spatial, epilogue in cases:
            cin = sum(cins)
            srcs = [_bf16(rng, c, *spatial).to(dev).to(torch.bfloat16) for c in cins]
            w = torch.from_numpy(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32)
                                 * (2 / (27 * cin)) ** 0.5).to(dev)
            pc = pack_conv(w, torch.bfloat16, cins)
            kw = {k: (tuple(t.to(dev) for t in v) if isinstance(v, tuple) else
                      v.to(dev) if torch.is_tensor(v) else v)
                  for k, v in _epilogue(rng, cout, epilogue).items()}
            x = srcs if len(srcs) > 1 else srcs[0]
            assert fwd_wg_ok(x, cout, head=kw.get("head"))
            before = dict(conv_cf.LAUNCHES)
            got = conv_cf.conv3d_cf(x, pc, **kw)
            again = conv_cf.conv3d_cf(x, pc, **kw)
            torch.cuda.synchronize()
            assert conv_cf.LAUNCHES["fwd_wg"] - before["fwd_wg"] == 2
            mma = conv_cf.conv3d_cf(x, pc, **kw, kernel="fwd_mma")
            want = conv3d_cf_reference(x, pc, **kw).float()
            bound = 1e-4 if "head" in kw else 1e-2
            for other in (want, mma.float()):
                rel = float((got.float() - other).norm() / other.norm())
                assert rel <= bound, (cins, cout, spatial, epilogue, rel)
            assert torch.equal(got, again)
    finally:
        torch.backends.cudnn.allow_tf32 = old
