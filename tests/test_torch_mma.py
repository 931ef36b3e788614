"""Plain-torch twins of the tensor-core kernels' formulations, held against
the plain versions on the CPU.

H-fwd-mma (csrc/conv3d_fwd_mma.cu) and H-wgrad-mma (csrc/conv3d_wgrad_mma.cu)
run only on the card; these twins restate, in float32 torch, what they
compute and in which layout, so that the layout and the index arithmetic the
kernels rest on are tested here:

- H-fwd-mma: each source padded to a multiple of 8 channels on its own,
  channels-last zero-padded halo tiles of 8 x 32 voxels (ragged tiles run
  over the volume's edge and are cut at the store), K walked per 8-channel
  group in k16 steps that pair taps (2s, 2s+1), B read back from the packed
  fragments of ``pack_conv`` (the lane order the kernel reads), then the
  epilogue (accum, bias, activation, post, head);
- H-wgrad-mma: (plane, 4 x 32 tile) items, g zero outside the volume, 27
  GEMMs per item over its 128 voxels with x shifted by the tap, the items
  split over ``wgrad_plan``'s n_split blocks and the partials summed in
  split order;
- H-first-mma (csrc/conv3d_first_mma.cu): one GEMM of A (32 channels x K)
  read back from ``pack_conv``'s fragments in the lanes' order, with the bias
  written into the ones column's fragment slot as the kernel writes it, by
  B = im2col of the zero-padded volume (k = tap·C_in + c, then a row of
  ones, then zeros to K = 32 / 64), then the epilogue
  (activation, post).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from synthsr_tpu_torch.ops import conv_cf
from synthsr_tpu_torch.ops.conv_cf import (conv3d_cf_reference, conv3d_cf_wgrad_reference,
                                           pack_conv, wgrad_plan)

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)  # float32 sums in another order
HEAD_TOL = dict(rtol=2e-4, atol=1e-4)


def _tap(t):
    return t // 9, t // 3 % 3, t % 3


def fwd_mma_twin(srcs, pc, bias=None, activation=None, post=None, head=None, accum=None):
    """H-fwd-mma's arithmetic on float32 sources, (C_out, D, H, W) float32
    ((1, D, H, W) with ``head``)."""
    cins = [s.shape[0] for s in srcs]
    assert conv_cf._split_key(cins) == conv_cf._split_key(pc.splits)
    d, h, w = srcs[0].shape[1:]
    ty, tx = conv_cf.MMA_TILE
    hp, wp = -(-h // ty) * ty, -(-w // tx) * tx
    x = torch.cat([F.pad(s.float(), (0, 0, 0, 0, 0, 0, 0, -c % 8)) for s, c in zip(srcs, cins)])
    x = F.pad(x.permute(1, 2, 3, 0), (0, 0, 1, wp - w + 1, 1, hp - h + 1, 1, 1))
    frags = pc.frags.float()  # (tile, group, step, j, g, tq, half, e)
    n_tiles, groups, steps, ng = frags.shape[:4]
    nt = 8 * ng
    b = frags.permute(1, 2, 6, 5, 7, 0, 3, 4).reshape(groups, steps, 16, n_tiles * nt)
    acc = torch.zeros(d, hp, wp, n_tiles * nt)
    for k in range(groups):
        for s in range(steps):
            views = []
            for tap in (2 * s, min(2 * s + 1, 26)):  # the 28th tap's weights are zero
                dz, dy, dx = _tap(tap)
                views.append(x[dz:dz + d, dy:dy + hp, dx:dx + wp, 8 * k:8 * k + 8])
            acc += torch.cat(views, -1) @ b[k, s]
    cout = pc.cout
    y = acc[:, :h, :w, :cout].permute(3, 0, 1, 2)
    if accum is not None:
        y = y + accum.float()
    if bias is not None:
        y = y + bias.to(pc.dtype).float().reshape(-1, 1, 1, 1)
    if activation == "elu":
        y = torch.where(y > 0, y, torch.exp(y) - 1)
    elif activation == "relu":
        y = y.clamp_min(0)
    if post is not None:
        y = y * post[0].reshape(-1, 1, 1, 1) + post[1].reshape(-1, 1, 1, 1)
    if head is not None:
        return (y * head[0].reshape(-1, 1, 1, 1)).sum(0, keepdim=True) + head[1]
    return y


def _bf16(rng, *shape, scale=1.0):
    """float32 values that bf16 holds exactly."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale) \
        .to(torch.bfloat16).float()


@pytest.mark.parametrize("cins,cout,spatial,epilogue", [
    ((4,), 24, (3, 12, 40), "bias+elu"),          # the train step's first conv: K padded 4 -> 8
    ((13,), 40, (2, 9, 20), "accum+relu"),        # ragged H and W, 2 cout tiles
    ((8, 16), 24, (3, 8, 32), "bias+elu+post"),   # [skip, up]
    ((5, 11), 24, (2, 11, 37), "bias+elu+post"),  # each source padded to 8 on its own
    ((24,), 24, (2, 10, 33), "bias+elu+post+head"),
    ((24,), 48, (2, 8, 32), "bias+elu"),          # ng = 6
])
def test_fwd_mma_twin_matches_plain(cins, cout, spatial, epilogue):
    rng = np.random.default_rng(sum(cins) + cout)
    cin = sum(cins)
    srcs = [_bf16(rng, c, *spatial) for c in cins]
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2)
    pc = pack_conv(w, torch.bfloat16, cins)
    kw = {}
    if "bias" in epilogue:
        kw["bias"] = _bf16(rng, cout)
    kw["activation"] = "elu" if "elu" in epilogue else "relu"
    if "post" in epilogue:
        kw["post"] = torch.from_numpy(rng.normal(size=(2, cout)).astype(np.float32))
    if "head" in epilogue:
        kw["head"] = (torch.from_numpy(rng.normal(size=cout).astype(np.float32)),
                      torch.tensor(0.25))
    if "accum" in epilogue:
        kw["accum"] = _bf16(rng, cout, *spatial)
    got = fwd_mma_twin(srcs, pc, **kw)
    want = conv3d_cf_reference(srcs if len(srcs) > 1 else srcs[0], pc.w, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **(HEAD_TOL if "head" in kw else TOL))


def wgrad_mma_twin(x, g, n_sm=132):
    """H-wgrad-mma's arithmetic: per-item partials of 27 GEMMs, summed over
    each split's item range, then over the splits in order.  Returns (dw,
    n_split)."""
    ci, d, h, w = x.shape
    co = g.shape[0]
    plan = wgrad_plan(ci, co, d, h, w, n_sm, torch.bfloat16)
    th, tw = plan.th, plan.tw
    hp, wp = -(-h // th) * th, -(-w // tw) * tw
    ci_pad, co_pad = -(-ci // 8) * 8, -(-co // plan.co_tile) * plan.co_tile
    xs = F.pad(x.float(), (0, 0, 0, 0, 0, 0, 0, ci_pad - ci)).permute(1, 2, 3, 0)
    xs = F.pad(xs, (0, 0, 1, wp - w + 1, 1, hp - h + 1, 1, 1))
    gs = F.pad(g.float(), (0, wp - w, 0, hp - h, 0, 0, 0, co_pad - co))
    gt = gs.reshape(co_pad, d, hp // th, th, wp // tw, tw)
    taps = []
    for tap in range(27):
        dz, dy, dx = _tap(tap)
        xt = xs[dz:dz + d, dy:dy + hp, dx:dx + wp].reshape(d, hp // th, th, wp // tw, tw, ci_pad)
        taps.append(torch.einsum("zAaBbc,ozAaBb->zABco", xt, gt).reshape(-1, ci_pad, co_pad))
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
])
def test_wgrad_mma_twin_matches_plain(ci, co, d, h, w, n_sm):
    rng = np.random.default_rng(ci * co + w)
    x, g = _bf16(rng, ci, d, h, w), _bf16(rng, co, d, h, w)
    got, n_split = wgrad_mma_twin(x, g, n_sm)
    assert n_split >= 1
    want = conv3d_cf_wgrad_reference(x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def first_mma_twin(x, pc, bias=None, activation=None, post=None):
    """H-first-mma's arithmetic on a float32 (C_in, D, H, W) source, (C_out, D,
    H, W) float32."""
    cin, d, h, w = x.shape
    taps, kpad = 27 * cin, conv_cf.FIRST_MMA_KPAD[cin]
    xp = F.pad(x.float(), (1, 1, 1, 1, 1, 1))
    f = pc.first_frags.float().clone()  # (mt, s, g, tq, kh, rh, e)
    if bias is not None:  # the kernel's (SB, RB = 2kh, TB, EB) slot of k = taps
        sb, kb = divmod(taps, 16)
        kh, tq, e = kb // 8, (kb & 7) >> 1, kb & 1
        b = F.pad(bias.to(pc.dtype).float(), (0, conv_cf.FIRST_MMA_MAX_COUT - pc.cout))
        f[:, sb, :, tq, kh, :, e] = b.reshape(2, 2, 8).permute(0, 2, 1)  # (mt, g, rh)
    a = f.permute(0, 5, 2, 1, 4, 3, 6).reshape(conv_cf.FIRST_MMA_MAX_COUT, kpad)
    rows = [xp[c, dz:dz + d, dy:dy + h, dx:dx + w]
            for dz, dy, dx in map(_tap, range(27)) for c in range(cin)]
    rows += [torch.ones(d, h, w)] + [torch.zeros(d, h, w)] * (kpad - taps - 1)
    y = (a @ torch.stack(rows).reshape(kpad, -1)).reshape(-1, d, h, w)[:pc.cout]
    if activation == "elu":
        y = torch.where(y > 0, y, torch.exp(y) - 1)
    elif activation == "relu":
        y = y.clamp_min(0)
    if post is not None:
        y = y * post[0].reshape(-1, 1, 1, 1) + post[1].reshape(-1, 1, 1, 1)
    return y


@pytest.mark.parametrize("cin,cout,spatial,epilogue", [
    (1, 24, (3, 12, 40), "bias+elu"),          # the shipped first conv
    (2, 24, (9, 11, 37), "bias+elu+post"),     # Hyperfine's; ragged D (9 planes), H and W
    (1, 24, (2, 9, 20), "bias+relu+post"),     # W = 20: the 2-byte path's width
    (2, 24, (3, 8, 32), ""),                   # no bias, no activation: K padding only
    (1, 8, (2, 5, 20), "bias+elu+post"),       # one channel row of m-tile 0
    (2, 32, (2, 8, 33), "bias+relu"),          # both m-tiles full
])
def test_first_mma_twin_matches_plain(cin, cout, spatial, epilogue):
    rng = np.random.default_rng(100 * cin + cout)
    x = _bf16(rng, cin, *spatial)
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.3)
    pc = pack_conv(w, torch.bfloat16)
    kw = {}
    if "bias" in epilogue:
        kw["bias"] = _bf16(rng, cout)
    kw["activation"] = "elu" if "elu" in epilogue else "relu" if "relu" in epilogue else None
    if "post" in epilogue:
        kw["post"] = torch.from_numpy(rng.normal(size=(2, cout)).astype(np.float32))
    got = first_mma_twin(x, pc, **kw)
    want = conv3d_cf_reference(x, pc.w, **kw).float()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
