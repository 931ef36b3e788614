"""H-wgrad-wg (synthsr_tpu_torch/csrc/conv3d_wgrad_wg.cu), the bf16 weight
gradient on wgmma and TMA: a plain-torch twin of its formulation held against
the plain version and the JAX package's Pallas weight gradients (K6, K7) on
the CPU, its gate and launch plan, and (``cuda``-marked) the kernel itself on
the card.

The kernel runs only on the card.  ``wgrad_wg_twin`` restates in float32
torch what it computes and in which layout, so that the index arithmetic it
rests on is tested here:

- the launch plan of ``conv_cf.wgrad_wg_plan``: column tiles of TX x TY
  voxels, C_out in tiles of CT <= 64 channels, the (tile, plane) items
  (planes fastest) split over n_split blocks per (8-channel group, co tile);
- the runs: a block's items cut at column ends; a run of n g planes stages
  the n + 2 x planes z0-1 .. z0+n, each one TMA box of (8 channels, TY + 2
  rows, x_row(TX) voxels) from (x0-8, y0-1), zero outside the volume and
  past C_in, transposed to channels-last rows of TX + 16 voxel slots; and
  per g plane one box of g as [row][channel][voxel] (CT channels, g_row(TX)
  voxels a row), zero past C_out;
- the products: per g plane and k16 step (voxels 16c .. 16c+15 of the tile),
  A = 64 rows of g (rows past CT are whatever the clamped lanes read, and
  never stored), B read as the kernel's descriptors address it (start = the
  step's slot shifted by (dz, dy) and x + 7, element (k, n) at slot start +
  n // 8 (SBO one slot: the dx taps) + k % 8 + (k // 8)·LBO, channel n % 8),
  one m64n24k16 product per (dz, dy); in the stacked layout (CT <= 32, the g
  box from y0-1) two per dz, both at the dy 1 descriptor: A rows 0-31 = g
  row r (tap dy 1) and 32-63 = g row r + 1 (tap dy 0), then rows 0-31 = g
  row r - 1 (tap dy 2);
- the two consumer warpgroups' sums (even and odd g planes) added 0 + 1,
  each block's partial, and the partials summed over the splits in order;
- a call whose C_out is not a multiple of 8 but C_in is, run as the weight
  gradient of (g, x) with the taps mirrored and the channels transposed, as
  the wrapper runs it.

Tolerances: against the plain version, max |twin - plain| within 1e-4 of
max |plain| and elementwise rtol 1e-4 (float32 sums in another order);
against JAX's K6/K7 in interpret mode the same at 2e-4 (``ROADMAP.md``'s
bound against the JAX kernels).

``ring_model`` restates the kernel's mbarrier protocol (the producer, the
transposers and the two consumer warpgroups, with the ring sizes read from
the source) and runs it under random schedules, the TMA boxes landing in
the order issued or in any order (PTX promises no order): every wait must
find the plane it expects in its slot, no box or transpose may overwrite a
slot while it is read, and the run must end with every barrier's arrivals
balanced and no deadlock.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.ops import conv_cf
from synthsr_tpu_torch.ops.conv_cf import (LAUNCHES, conv3d_cf_wgrad, conv3d_cf_wgrad_reference,
                                           wgrad_wg_ok, wgrad_wg_plan)

torch.set_num_threads(2)

TOL = 1e-4      # relative to max |plain|, and elementwise rtol
JAX_TOL = 2e-4  # the same against the JAX kernels


def x_row(tx):
    """Voxels of a raw x row (conv3d_wgrad_wg.cu's x_row)."""
    return tx + 16


def g_row(tx):
    """Voxels of a g channel row (conv3d_wgrad_wg.cu's g_row)."""
    return tx + (8 if tx // 8 % 2 == 0 else 0)


def _box(t, starts, sizes):
    """A TMA box of ``t`` (dims outermost first) at ``starts``, zero outside."""
    out = torch.zeros(sizes)
    src, dst = [], []
    for s, n, full in zip(starts, sizes, t.shape):
        lo, hi = max(s, 0), min(s + n, full)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = t[tuple(src)].float()
    return out


def _tap_slots(tx, ty, rowc):
    """(steps, 3 dy, 16 k, 24 n) channels-last slot and (24 n,) channel of
    B's elements as the descriptors address them, from the step's (dz) plane;
    (steps, 16 k) g box (row, voxel) of A's columns."""
    dr, dc = (0, 8) if tx >= 16 else (1, 0)  # the step's second 8 voxels
    lbo = dr * rowc + dc                     # in slots
    k, n = torch.arange(16), torch.arange(24)
    slots, a_rows, a_cols = [], [], []
    for c in range(tx * ty // 16):
        r0, c0 = 16 * c // tx, 16 * c % tx
        per_dy = []
        for dy in range(3):
            start = (r0 + dy) * rowc + c0 + 7
            per_dy.append(start + (n // 8)[None] + (k % 8)[:, None] + (k // 8)[:, None] * lbo)
        slots.append(torch.stack(per_dy))
        a_rows.append(r0 + (k // 8) * dr)
        a_cols.append(c0 + (k // 8) * dc + k % 8)
    return torch.stack(slots), n % 8, torch.stack(a_rows), torch.stack(a_cols)


def _a_block(gbox, a_rows, a_cols, rows, shift):
    """A rows of one block: g box rows ``a_rows + shift`` (the step's voxels),
    ``rows`` rows, those past the box's channels read as row 0 (the kernel's
    clamped lanes)."""
    a = gbox[a_rows + shift, :, a_cols].permute(0, 2, 1)  # (steps, ct, 16)
    return torch.cat([a, a[:, :1].expand(-1, rows - a.shape[1], -1)], 1)


def wgrad_wg_twin(x, g, n_sm=132):
    """H-wgrad-wg's arithmetic on float32 operands (values bf16 holds):
    (3, 3, 3, ci, co) float32, x and g padded by ``wg_sources`` as the
    wrapper does."""
    if g.shape[0] % 8 and x.shape[0] % 8 == 0:  # the wrapper's mirrored call
        return wgrad_wg_twin(g, x, n_sm).flip((0, 1, 2)).transpose(3, 4)
    x, g = conv_cf.wg_sources([x.float(), g.float()])
    ci, d, h, w = x.shape
    co = g.shape[0]
    plan = wgrad_wg_plan(ci, co, d, h, w, n_sm)
    tx, ty, ct, stack = plan.tx, plan.ty, plan.ct, plan.stack
    assert w % tx == 0 and ct % 8 == 0 and ct <= conv_cf.WGRAD_WG_MAX_CT
    assert stack == (ct <= conv_cf.WGRAD_WG_STACK_CT)
    rowx, rowc, txg = x_row(tx), tx + 16, g_row(tx)
    gr, g_y0 = (ty + 2, -1) if stack else (ty, 0)  # the g box: rows y0-1 .. y0+ty if stacked
    tiles_x, tiles_y = w // tx, -(-h // ty)
    items = tiles_x * tiles_y * d
    groups = -(-ci // 8)
    ci_pad, co_pad = 8 * groups, ct * plan.co_tiles
    slots, chans, a_rows, a_cols = _tap_slots(tx, ty, rowc)
    n_tiles = 6 if stack else 9
    partial = torch.zeros(plan.n_split, 27, ci_pad, co_pad)
    for split in range(plan.n_split):
        i0, i1 = items * split // plan.n_split, items * (split + 1) // plan.n_split
        for cg in range(groups):
            for tile_co in range(plan.co_tiles):
                co0 = tile_co * ct
                acc = torch.zeros(2, n_tiles, 64, 24)  # per consumer warpgroup: tile, M, N
                it, gs = i0, 0
                while it < i1:
                    tile, za = divmod(it, d)
                    n = min(i1, (tile + 1) * d) - it
                    x0, y0 = tile % tiles_x * tx, tile // tiles_x * ty
                    cl = []  # the run's x planes za-1 .. za+n, channels-last slots
                    for i in range(n + 2):
                        raw = _box(x, (8 * cg, za - 1 + i, y0 - 1, x0 - 8), (8, 1, ty + 2, rowx))
                        cl.append(raw[:, 0, :, :rowc].permute(1, 2, 0).reshape(-1, 8))
                    for j in range(n):
                        gbox = _box(g, (co0, za + j, y0 + g_y0, x0), (ct, 1, gr, txg))[:, 0]
                        gbox = gbox.permute(1, 0, 2)  # [row][channel][voxel]
                        wg = acc[gs % 2]
                        if stack:  # rows 0-31: g row r, 32-63: r + 1; second product r - 1
                            a1 = torch.cat([_a_block(gbox, a_rows, a_cols, 32, 1),
                                            _a_block(gbox, a_rows, a_cols, 32, 2)], 1)
                            a2 = torch.cat([_a_block(gbox, a_rows, a_cols, 32, 0),
                                            torch.zeros(a1.shape[0], 32, 16)], 1)
                            for dz in range(3):
                                b = cl[j + dz][slots[:, 1], chans]  # the dy 1 descriptor
                                wg[2 * dz] += torch.einsum("cmk,ckn->mn", a1, b)
                                wg[2 * dz + 1] += torch.einsum("cmk,ckn->mn", a2, b)
                        else:
                            a = _a_block(gbox, a_rows, a_cols, 64, 0)
                            for dz in range(3):
                                b = cl[j + dz][slots, chans]  # (steps, 3 dy, 16, 24)
                                wg[3 * dz:3 * dz + 3] += torch.einsum("cmk,cykn->ymn", a, b)
                        gs += 1
                    it += n
                total = (acc[0] + acc[1]).reshape(n_tiles, 64, 3, 8)  # t, M row, dx, ci
                taps = torch.zeros(3, 3, 3, 8, ct)  # dz, dy, dx, ci, co
                for t in range(n_tiles):
                    if stack:
                        dz = t // 2
                        blocks = [(2, 0)] if t % 2 else [(1, 0), (0, 32)]  # (dy, first row)
                    else:
                        dz, blocks = t // 3, [(t % 3, 0)]
                    for dy, r in blocks:
                        taps[dz, dy] = total[t, r:r + ct].permute(1, 2, 0)
                partial[split, :, 8 * cg:8 * cg + 8, co0:co0 + ct] = taps.reshape(27, 8, ct)
    dw = torch.zeros(27, ci_pad, co_pad)
    for split in range(plan.n_split):
        dw = dw + partial[split]
    return dw[:, :ci, :co].reshape(3, 3, 3, ci, co)


SOURCE = Path(conv_cf.__file__).resolve().parent.parent / "csrc" / "conv3d_wgrad_wg.cu"


def _ring_sizes():
    """RS, CLS and GS of the kernel's source."""
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("RS", "CLS", "GS"))


class _Barrier:
    """An mbarrier: ``count`` arrivals and the expected bytes complete a
    phase; a parity wait returns once the phase of that parity before the
    current one has completed (so the current phase's parity blocks)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, n=1):
        self.pending -= n
        self._complete()

    def expect_tx(self, nbytes):  # mbarrier.arrive.expect_tx
        self.tx += nbytes
        self.arrive()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        if self.pending <= 0 and self.tx == 0:
            self.pending += self.count
            self.phase += 1

    def done(self, parity):
        return (self.phase & 1) != parity


def _runs(i0, i1, d):
    """The kernel's runs of a block's items [i0, i1): cut at column ends."""
    it = i0
    while it < i1:
        n = min(i1, (it // d + 1) * d) - it
        yield n
        it += n


def _missing_users(i, n):
    lo, hi = max(i - 2, 0), min(i, n - 1)
    return 3 - (hi - lo + 1)


def ring_model(d, i0, i1, seed, in_order=False, shared_full=False):
    """One block's rings (conv3d_wgrad_wg.cu) under a random schedule; raises
    AssertionError where the protocol breaks.  ``shared_full``: one full
    barrier per g slot for both consumer warpgroups, as the kernel had before
    each warpgroup got its own."""
    rs_n, cls_n, gs_n = _ring_sizes()
    cycle = gs_n if gs_n % 2 == 0 or shared_full else 2 * gs_n
    rnd = random.Random(seed)
    raw_full = [_Barrier(1) for _ in range(rs_n)]
    raw_empty = [_Barrier(3) for _ in range(rs_n)]
    cl_full = [_Barrier(3) for _ in range(cls_n)]
    cl_empty = [_Barrier(12) for _ in range(cls_n)]
    g_full = [[_Barrier(1) for _ in range(gs_n)] for _ in range(2)]
    g_empty = [_Barrier(4) for _ in range(gs_n)]
    # slot contents (the plane that landed), boxes in flight, readers
    raw, cl, g = [None] * rs_n, [None] * cls_n, [None] * gs_n
    writing = {"raw": set(), "cl": set(), "g": set()}
    reading = {"raw": [0] * rs_n, "cl": [0] * cls_n, "g": [0] * gs_n}
    flight = []  # (ring, slot, plane, barrier)
    contents = {"raw": raw, "cl": cl, "g": g}

    def full_of(cw, sl):
        return g_full[0][sl] if shared_full else g_full[cw][sl]

    def issue(ring, slot, plane, barrier):
        assert reading[ring][slot] == 0, f"a {ring} box overwrites slot {slot} while it is read"
        barrier.expect_tx(1)
        writing[ring].add(slot)
        flight.append((ring, slot, plane, barrier))

    def check(ring, slot, plane):
        assert slot not in writing[ring] and contents[ring][slot] == plane, \
            f"{ring} slot {slot} holds {contents[ring][slot]}, not plane {plane}"

    def producer():
        xs = gs = 0
        for n in _runs(i0, i1, d):
            for i in range(n + 2):
                rs = xs % rs_n
                if xs >= rs_n:
                    yield raw_empty[rs], ((xs // rs_n) - 1) & 1
                issue("raw", rs, xs, raw_full[rs])
                xs += 1
                if i >= 2:
                    sl = gs % gs_n
                    if gs >= gs_n:
                        yield g_empty[sl], ((gs // gs_n) - 1) & 1
                    issue("g", sl, gs, full_of(gs & 1, sl))
                    gs += 1

    def transposers():
        s = 0
        for n in _runs(i0, i1, d):
            for i in range(n + 2):
                rs, cs = s % rs_n, s % cls_n
                yield raw_full[rs], (s // rs_n) & 1
                check("raw", rs, s)
                if s >= cls_n:
                    yield cl_empty[cs], ((s // cls_n) - 1) & 1
                assert reading["cl"][cs] == 0, f"a transpose overwrites cl slot {cs} while read"
                reading["raw"][rs] += 1
                writing["cl"].add(cs)
                yield None
                check("raw", rs, s)
                reading["raw"][rs] -= 1
                writing["cl"].discard(cs)
                cl[cs] = s
                raw_empty[rs].arrive(3)
                cl_full[cs].arrive(3)
                miss = _missing_users(i, n)
                if miss:
                    cl_empty[cs].arrive(4 * miss)
                s += 1

    def consumer(cw):
        xs = gs = 0
        for n in _runs(i0, i1, d):
            for j in range(n):
                if gs & 1 == cw:
                    sl = gs % gs_n
                    yield full_of(cw, sl), (gs // (gs_n if shared_full else cycle)) & 1
                    check("g", sl, gs)
                    planes = [xs + j + q for q in range(3)]
                    for x in planes:
                        yield cl_full[x % cls_n], (x // cls_n) & 1
                        check("cl", x % cls_n, x)
                    reading["g"][sl] += 1
                    for x in planes:
                        reading["cl"][x % cls_n] += 1
                    yield None  # the plane's products
                    check("g", sl, gs)
                    reading["g"][sl] -= 1
                    for x in planes:
                        check("cl", x % cls_n, x)
                        reading["cl"][x % cls_n] -= 1
                    g_empty[sl].arrive(4)
                    for x in planes:
                        cl_empty[x % cls_n].arrive(4)
                gs += 1
            xs += n + 2

    agents = [producer(), transposers(), consumer(0), consumer(1)]
    waits = [next(a, "end") for a in agents]
    # the schedule: each agent's speed, and how often a box lands, drawn per seed
    speed = [rnd.uniform(0.05, 1.0) for _ in agents]
    land = rnd.uniform(0.02, 0.5)
    while True:
        ready = [k for k, w in enumerate(waits) if w != "end" and (w is None or w[0].done(w[1]))]
        if not ready and not flight:
            assert all(w == "end" for w in waits), "deadlock"
            break
        if flight and (not ready or rnd.random() < land):
            ring, slot, plane, barrier = flight.pop(0 if in_order else rnd.randrange(len(flight)))
            writing[ring].discard(slot)
            contents[ring][slot] = plane
            barrier.complete_tx(1)
        else:
            k = rnd.choices(ready, [speed[k] for k in ready])[0]
            waits[k] = next(agents[k], "end")
    for b in raw_full + raw_empty + cl_full + cl_empty + g_full[0] + g_full[1] + g_empty:
        assert b.pending == b.count and b.tx == 0, "arrivals left unbalanced"


# (planes a column, a block's items [i0, i1)): runs of one plane, runs cut at
# both ends, one long run, runs of two
RING_CASES = [(1, 0, 9), (5, 3, 17), (16, 0, 40), (2, 1, 12), (3, 2, 4), (7, 0, 7)]


def _bf16(rng, *shape):
    """float32 values that bf16 holds exactly."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16).float()


def _close(got, want, tol):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("ci,co,d,h,w,n_sm", [
    (5, 24, 3, 11, 40, 132),   # ci < 8, ragged H, W % 32 != 0 (TX 8), runs cut mid-column;
                               # C_out <= 32: the stacked layout
    (13, 16, 4, 9, 48, 7),     # ci not a multiple of 8, TX 16, few splits
    (8, 72, 3, 8, 64, 132),    # two co tiles of 40 (the second past C_out), TX 32, unstacked
    (6, 48, 2, 9, 16, 132),    # one unstacked co tile of 48, TX 16, H past the tile
    (16, 24, 5, 8, 20, 2),     # W % 8 != 0: padded to 24 and cut back; long runs
    (24, 8, 8, 8, 8, 132),     # a narrow volume: TX 8 (steps of two rows), one run a split
    (3, 32, 2, 16, 16, 1),     # one split of every item, both planes in one run
    (5, 13, 3, 9, 24, 132),    # C_out 13: the g box zero-filled to a co tile of 16
    (32, 1, 4, 10, 40, 132),   # the penalty's 32 -> 1: run as (1, 32), taps mirrored
])
def test_wgrad_wg_twin_matches_plain(ci, co, d, h, w, n_sm):
    rng = np.random.default_rng(ci * co + w)
    x, g = _bf16(rng, ci, d, h, w), _bf16(rng, co, d, h, w)
    got = wgrad_wg_twin(x, g, n_sm)
    want = conv3d_cf_wgrad_reference(x, g)
    assert got.shape == want.shape == (3, 3, 3, ci, co)
    _close(got, want, TOL)


@pytest.mark.parametrize("ci,co,d,h,w", [
    (4, 8, 8, 16, 128), (24, 8, 8, 16, 128),   # K6 shapes (tests/test_torch_wgrad.py)
    (6, 4, 8, 32, 96), (4, 4, 8, 32, 160),     # K7 shapes (the twin's C_out box padded to 8)
])
def test_wgrad_wg_twin_matches_pallas(ci, co, d, h, w):
    """The twin against JAX's K6 / K7 (``conv3d_cf_wgrad(..., interpret=True)``)
    on the same numpy inputs (values bf16 holds, so both sum exact products)."""
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_pallas import conv3d_cf_wgrad as jax_wgrad

    rng = np.random.default_rng(ci * 100 + w)
    x, g = _bf16(rng, ci, d, h, w), _bf16(rng, co, d, h, w)
    want = np.array(jax_wgrad(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()), interpret=True))
    _close(wgrad_wg_twin(x, g), torch.from_numpy(want), JAX_TOL)


def test_gate_and_plan():
    """The gate takes bf16 with W >= 8, whatever C_in and C_out; the plan
    tiles W exactly, covers C_out in the fewest tiles of at most 64 channels
    (multiples of 8), gives every split an item, and counts waves of one
    block per SM."""
    x = torch.zeros(5, 2, 4, 20, dtype=torch.bfloat16)
    assert wgrad_wg_ok(x, torch.zeros(24, 2, 4, 20))
    assert wgrad_wg_ok(x, torch.zeros(1, 2, 4, 20))           # the penalty's 32 -> 1
    assert not wgrad_wg_ok(x.float(), torch.zeros(24, 2, 4, 20))
    assert not wgrad_wg_ok(x[..., :4], torch.zeros(24, 2, 4, 4))    # a tutorial's 4^3 level
    for ci, co, n in ((4, 24, 128), (48, 24, 128), (96, 48, 64), (192, 96, 32), (384, 192, 16),
                      (384, 384, 8), (1, 32, 128), (256, 128, 16), (8, 24, 2), (24, 48, 4)):
        w8 = -(-n // 8) * 8
        plan = wgrad_wg_plan(ci, co, n, n, w8, 132)
        assert w8 % plan.tx == 0 and conv_cf.WGRAD_WG_TILES[plan.tx] == plan.ty
        assert plan.ct % 8 == 0 and plan.ct <= conv_cf.WGRAD_WG_MAX_CT
        assert plan.co_tiles * plan.ct >= co > (plan.co_tiles - 1) * plan.ct
        assert plan.co_tiles == -(-co // conv_cf.WGRAD_WG_MAX_CT)
        assert plan.stack == (plan.ct <= conv_cf.WGRAD_WG_STACK_CT)
        items = w8 // plan.tx * -(-n // plan.ty) * n
        assert 1 <= plan.n_split <= items
    # the train step's level-0 and 8^3 shapes: many splits of K, one split of all
    assert wgrad_wg_plan(24, 24, 128, 128, 128, 132) == \
        conv_cf.WgradWgPlan(32, 8, 24, 1, 44, True)
    assert wgrad_wg_plan(384, 384, 8, 8, 8, 132) == conv_cf.WgradWgPlan(8, 8, 64, 6, 1, False)
    assert wgrad_wg_plan(192, 96, 32, 32, 32, 132).ct == 48            # two even co tiles
    assert wgrad_wg_plan(384, 192, 16, 16, 16, 132).tx == 16           # W 16: no masked half
    # a CPU tensor runs the plain version whatever ``kernel`` says
    assert torch.equal(conv3d_cf_wgrad(x.float(), torch.ones(8, 2, 4, 20), kernel="wgrad_mma"),
                       conv3d_cf_wgrad_reference(x.float(), torch.ones(8, 2, 4, 20)))
    with pytest.raises(ValueError):
        conv3d_cf_wgrad(x.to("meta"), torch.ones(8, 2, 4, 20, device="meta"), kernel="other")


@pytest.mark.parametrize("in_order", [True, False])
@pytest.mark.parametrize("d,i0,i1", RING_CASES)
def test_ring_protocol(d, i0, i1, in_order):
    """The kernel's rings under 40 random schedules: each wait finds its
    plane, no slot is overwritten while read, no deadlock, balanced arrivals;
    the TMA boxes land in the order issued or in any order."""
    for seed in range(40):
        ring_model(d, i0, i1, seed, in_order=in_order)


def test_ring_model_sees_a_shared_full_barrier():
    """The model is strict enough to matter: with one full barrier per g slot
    for both warpgroups (GS odd), a warpgroup's parity wait may pass on a
    slot whose earlier box has not landed.  That holds up only while boxes
    land in the order issued; some schedule with boxes out of order breaks
    it."""
    for d, i0, i1 in RING_CASES:
        for seed in range(10):
            ring_model(d, i0, i1, seed, in_order=True, shared_full=True)
    failures = 0
    for seed in range(200):
        try:
            ring_model(5, 3, 17, seed, shared_full=True)
        except AssertionError:
            failures += 1
    assert failures > 0


@pytest.mark.cuda
def test_wgrad_wg_matches_plain_and_mma_on_card():
    """H-wgrad-wg on the card against the plain float32 version and against
    H-wgrad-mma on the same bf16 inputs (max |diff| within 1e-4 of max
    |plain|), at the twin's ragged shapes and main-path ones (C_out 1 and 3
    mirrored), two calls bit-equal; the gate routes each call to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = torch.device("cuda")
        rng = np.random.default_rng(23)
        for ci, co, d, h, w in ((5, 24, 3, 11, 40), (13, 16, 4, 9, 48), (8, 72, 3, 8, 64),
                                (16, 24, 5, 8, 20), (24, 8, 8, 8, 8), (3, 32, 2, 16, 16),
                                (4, 24, 16, 32, 128), (48, 24, 16, 128, 128), (96, 48, 64, 64, 64),
                                (384, 192, 16, 16, 16), (384, 384, 8, 8, 8), (48, 24, 2, 2, 8),
                                (5, 13, 3, 9, 24), (32, 1, 8, 16, 32), (16, 3, 4, 9, 24)):
            x = _bf16(rng, ci, d, h, w).to(dev, torch.bfloat16)
            g = _bf16(rng, co, d, h, w).to(dev, torch.bfloat16)
            assert wgrad_wg_ok(x, g)
            before = dict(LAUNCHES)
            got = conv3d_cf_wgrad(x, g)
            again = conv3d_cf_wgrad(x, g)
            torch.cuda.synchronize()
            assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} \
                == {"wgrad_wg": 2}
            mma = conv3d_cf_wgrad(x, g, kernel="wgrad_mma")
            want = conv3d_cf_wgrad_reference(x, g)
            for other in (want, mma):
                rel = float((got - other).abs().max() / other.abs().max())
                assert rel <= TOL, (ci, co, d, h, w, rel)
            assert torch.equal(got, again)
    finally:
        torch.backends.cudnn.allow_tf32 = old
