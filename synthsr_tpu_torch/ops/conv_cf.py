"""Channels-first SAME 3x3x3 convolution: the port of the forward family of
``synthsr_tpu/ops/conv_pallas.py`` and the only place a kernel is launched.

``conv3d_cf(x, w, bias, activation, post, head, accum)`` computes, in float32,
``head(post(act(conv(concat(x), w) + accum + bias)))`` and stores it in
``x.dtype`` ((1, D, H, W) float32 with ``head``):

- ``x``: a (C, D, H, W) tensor, or a list of sources concatenated along C
  only in concept (the decoder's [skip, up]; the concatenation never exists);
- ``w``: DHWIO (3, 3, 3, C_in, C_out), as in the JAX functions, or a
  :class:`PackedConv` made once per weight set by :func:`pack_conv`.  ``w``
  and ``bias`` are rounded to ``x.dtype`` first, as the TPU kernels do
  (conv_pallas.py:801-803);
- ``accum``: an optional (C_out, D, H, W) partial sum added before the bias;
- ``activation``: None, "elu" (``exp(x) - 1`` below zero, as on the TPU),
  "relu" or "leaky" (LeakyReLU(0.2): ``v >= 0 ? v : 0.2·v``, the critic's);
- ``post``: an optional (2, C_out) per-channel (scale, shift) applied after
  the activation (inference BatchNorm folded in);
- ``head``: an optional (a (C_out,), b scalar): the 1x1x1 likelihood conv
  folded in after ``post``.

Dispatch, by device and dtype, with no fallback: a CPU tensor goes to
:func:`conv3d_cf_reference` (plain PyTorch); a CUDA tensor that passes the
first-conv gate (one source, C_in <= 2, no ``accum``, no ``head``; K1's
shapes) with C_out <= 32 launches **H-first-mma** for bf16
(``csrc/conv3d_first_mma.cu``) or **H-first-x3** for float32
(``csrc/conv3d_first_x3.cu``), both on the tensor cores and both replacing
K1; any other bf16 conv that passes :func:`fwd_wg_ok` (no ``accum``, C_out %
8 == 0; :func:`wg_sources` pads W to a multiple of 8) launches **H-fwd-wg**
(``csrc/conv3d_fwd_wg.cu``: wgmma, TMA and mbarrier rings) and the rest
**H-fwd-mma** (``csrc/conv3d_fwd_mma.cu``: mma.sync); a float32 one
**H-fwd-x3** (``csrc/conv3d_fwd_x3.cu``); these replace K2, K3, K4 and K5;
any other device raises.

Split TF32 ("3xTF32") is how the float32 kernels H-first-x3, H-fwd-x3 and
H-wgrad-x3 keep float32 accuracy on the tensor cores: each float32 operand
``a`` is ``big = tf32(a)`` (round to nearest, ties away from zero) plus ``small =
tf32(a - big)``, and each product is ``small_a·big_b + big_a·small_b +
big_a·big_b`` summed in float32; the dropped ``small·small`` term and the
rounding of ``small`` are each about 2^-22 relative.  Plain TF32 (``big·big``
alone) keeps about three decimal digits.  :func:`pack_conv` splits the
weights once per weight set (:func:`_x3_fragments`,
:func:`_first_x3_fragments`); H-fwd-x3 splits the activations as it loads
them, H-first-x3 as it stages its halo.

K5 (``_kernel``, ``synthsr_tpu/ops/conv_pallas.py:127``, entry ``conv3d_cf``
:990) is the TPU's blocked conv for the shapes the plane and folded-plane
layouts reject: W % 128 == 0, H % 16 == 0, C_in <= 96 and C_in·W <= 96·256
(``synthsr_tpu/models/unet_cf.py:140-159``).  On the predict path these are
the level-0 convs of a large field of view, e.g. 24->24 at 192x256x512 or
256x384x384 and, unfused, 72->24 at 256x512x256, whose planes (cin·H·W over
24·256²) pass the other kernels' caps.  H-fwd-wg, H-fwd-mma and H-fwd-x3
take those shapes as they take any other, with bias and activation fused at
every C_in, so no dispatch here depends on them.

``conv3d_cf_wgrad(x, g)`` is the training backward's weight gradient,
``dw[dz, dy, dx, ci, co] = sum x[ci, z+dz-1, h+dy-1, w+dx-1] g[co, z, h, w]``
(zero padding), (3, 3, 3, ci, co) float32, with ``g`` rounded to ``x.dtype``
first as K6 does (conv_pallas.py:1230).  The same dispatch: the plain
:func:`conv3d_cf_wgrad_reference` on a CPU tensor; on a CUDA tensor a bf16
call that passes :func:`wgrad_wg_ok` (W >= 8: every main-path weight
gradient) launches **H-wgrad-wg** (``csrc/conv3d_wgrad_wg.cu``: wgmma, TMA
and mbarrier rings), the rest of bf16 (the tutorials' 4³ and 2³ levels)
**H-wgrad-mma** (``csrc/conv3d_wgrad_mma.cu``: mma.sync), float32
**H-wgrad-x3** (``csrc/conv3d_wgrad_x3.cu``, split TF32); all replace K6 and
K7.

``LAUNCHES`` counts kernel launches per kernel, under its own key, and
nothing else.  While the tracer of ``utils/profiling`` is on, the CUDA path
of :func:`conv3d_cf` and :func:`conv3d_cf_wgrad` counts each call
(``conv.calls``), its host seconds from entry to return (``conv.host_s``:
the gates, :func:`wg_sources`' copies, the tensor-map arguments and the
launch) and each weight packed at call time (``conv.packs``: a raw weight
given to a forward call, :func:`pack_conv` or :func:`_wg_weights` inside
the launch).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import cuda_build

LAUNCHES = {"first_x3": 0, "first_mma": 0, "fwd_mma": 0, "wgrad_mma": 0, "fwd_x3": 0,
            "wgrad_x3": 0, "fwd_wg": 0, "wgrad_wg": 0}

MMA_STEPS = 14  # k16 steps per 8-channel group of H-fwd-mma (FM_STEPS in csrc/conv3d_fwd_mma.cu)
MMA_TILE = (8, 32)  # H-fwd-mma output tile (H, W) of one plane
WGRAD_MMA_TILE = (4, 32)  # H-wgrad-mma item (H, W) of one plane
WGRAD_MMA_BLOCKS_PER_SM = 4  # 96-thread blocks H-wgrad-mma aims to keep on each SM
WGRAD_X3_BLOCKS_PER_SM = 2  # the same for H-wgrad-x3 (its shared memory holds two)
# H-first-mma: K (27·C_in taps + the bias's ones column) padded to k16 steps,
# and the most output channels (two m16 tiles); conv3d_first_mma.cu agrees
FIRST_MMA_KPAD = {1: 32, 2: 64}
FIRST_MMA_MAX_COUT = 32
# H-first-x3: k8 steps of K (27·C_in taps, zero-padded) and the most planes
# per block (its most output channels are FIRST_MMA_MAX_COUT: four n8 tiles);
# conv3d_first_x3.cu agrees
FIRST_X3_STEPS = {1: 4, 2: 7}
FIRST_X3_MAX_PLANES = 8
# H-fwd-wg: (M tiles of 8 x 8 voxels per consumer warpgroup, output planes
# per block) of each N tile (output channels per block), the kernel's
# instances; conv3d_fwd_wg.cu's WG_CONFIGS agrees.  Each keeps its
# accumulators (MTW·NZ·N/2 float32 a thread) at or under 96 registers.
WG_CONFIGS = {8: (4, 2), 16: (4, 2), 24: (4, 2), 32: (4, 1), 48: (2, 2), 64: (2, 1), 72: (2, 1),
              96: (2, 1), 128: (1, 1), 144: (1, 1), 192: (1, 1)}
WG_MAX_N = 192
WG_PAIRS = 5  # k16 steps per (8-channel group, input plane): taps (0,1) (2,3) (4,5) (6,7) (8,-)
# H-wgrad-wg: the tile height of each tile width (voxels of one plane), the
# kernel's instances (conv3d_wgrad_wg.cu's WW_CONFIGS agrees), the most
# output channels a block (the wgmma M), and the most for the stacked layout
# (two row blocks of g in M)
WGRAD_WG_TILES = {32: 8, 16: 8, 8: 8}
WGRAD_WG_MAX_CT = 64
WGRAD_WG_STACK_CT = 32
WGRAD_WG_STAGE_COST = 3  # a block's fixed cost in g planes (prologue, hand-off, partial)
# bytes of partials the card writes and the reduce reads in the time of one g
# voxel (about 3 TB/s x 6.25 ns, the level-0 rows' rate on an H100): prices a
# split against the planes it saves
WGRAD_WG_VOXEL_BYTES = 18750
_ACT_CODES = {None: 0, "elu": 1, "relu": 2, "leaky": 3}
_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def build_kernels() -> float:
    """Build (if needed) and load the kernels; returns the compile seconds
    (0.0 when an earlier build of the same sources was reused)."""
    global _lib
    path, seconds = cuda_build.build()
    lib = cuda_build.load(path)
    if lib.conv3d_fwd_mma_steps() != MMA_STEPS:
        raise RuntimeError("csrc/conv3d_fwd_mma.cu and conv_cf.MMA_STEPS disagree")
    if ({c: lib.conv3d_first_mma_kpad(c) for c in FIRST_MMA_KPAD} != FIRST_MMA_KPAD
            or lib.conv3d_first_mma_max_cout() != FIRST_MMA_MAX_COUT):
        raise RuntimeError("csrc/conv3d_first_mma.cu and conv_cf.FIRST_MMA_* disagree")
    if any(lib.conv3d_fwd_wg_config(n) != 16 * m + z for n, (m, z) in WG_CONFIGS.items()):
        raise RuntimeError("csrc/conv3d_fwd_wg.cu and conv_cf.WG_CONFIGS disagree")
    if any(lib.conv3d_wgrad_wg_config(tx) != ty for tx, ty in WGRAD_WG_TILES.items()):
        raise RuntimeError("csrc/conv3d_wgrad_wg.cu and conv_cf.WGRAD_WG_TILES disagree")
    if ({c: lib.conv3d_first_x3_steps(c) for c in FIRST_X3_STEPS} != FIRST_X3_STEPS
            or lib.conv3d_first_x3_max_cout() != FIRST_MMA_MAX_COUT
            or lib.conv3d_first_x3_max_planes() != FIRST_X3_MAX_PLANES):
        raise RuntimeError("csrc/conv3d_first_x3.cu and conv_cf.FIRST_X3_* disagree")
    _lib = lib
    return seconds


def _library():
    """The kernels' library, built from the sources on first use."""
    if _lib is None:
        build_kernels()
    return _lib


profiling.register("launches", LAUNCHES)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cout_groups(cout: int) -> int:
    """Output channels per H-fwd-x3 block, in groups of 8: 24 wherever it
    divides C_out (every U-Net width: 24·2^l), else up to 32."""
    if cout % 24 == 0:
        return 3
    return min(4, -(-cout // 8))


def mma_groups(cout: int) -> int:
    """Output channels per H-fwd-mma block, in n8 tiles: 48 wherever it
    divides C_out (the halo is staged once per 48 channels), else 24, else up
    to 32."""
    if cout % 48 == 0:
        return 6
    return cout_groups(cout)


def _split_key(splits) -> int:
    """What fixes the bf16 fragment layout besides C_in and C_out: where the
    second source starts when the first is not a multiple of 8 (each source
    is padded to a multiple of 8 channels), else 0."""
    return splits[0] if len(splits) == 2 and splits[0] % 8 else 0


@dataclass(frozen=True)
class PackedConv:
    """A conv weight made ready once for the plain version and the kernels.

    ``w``: DHWIO float32, values rounded to ``dtype`` (the plain version's
    operand).  ``frags``: the B fragments of H-fwd-mma (bf16, see
    :func:`_mma_fragments`) or H-fwd-x3 (float32, split TF32, see
    :func:`_x3_fragments`); ``splits`` are the source channel counts they
    were laid out for.  ``first_frags``, for C_in <= 2 and C_out <= 32, else
    None: the A fragments of H-first-mma (bf16, see
    :func:`_first_mma_fragments`) or the B fragments of H-first-x3 (float32,
    split TF32, see :func:`_first_x3_fragments`).  ``wg``, for bf16 with
    C_out % 8 == 0, else None: H-fwd-wg's B operand (see
    :func:`_wg_weights`)."""
    w: torch.Tensor
    frags: torch.Tensor | None
    dtype: torch.dtype
    ng: int
    splits: tuple
    first_frags: torch.Tensor | None
    wg: torch.Tensor | None = None

    @property
    def cin(self) -> int:
        return self.w.shape[3]

    @property
    def cout(self) -> int:
        return self.w.shape[4]


def _mma_fragments(wr: torch.Tensor, splits, ng: int) -> torch.Tensor:
    """H-fwd-mma's B operand: (n_tiles, groups, MMA_STEPS, ng, 32 lanes, 4)
    bf16, in the order the kernel's lanes read it.

    K runs over 8-channel groups (each source padded to a multiple of 8 on
    its own), and within a group over 28 taps (27 and a zero one) paired into
    k16 steps: step s holds tap 2s at k 0-7 and tap 2s+1 at k 8-15.  Lane
    4g + tq of n8 tile j holds the mma.m16n8k16 B fragment of output channel
    tile*8*ng + 8j + g: (k 2tq, 2tq+1) then (k 2tq+8, 2tq+9)."""
    cout = wr.shape[4]
    nt = 8 * ng
    n_tiles = -(-cout // nt)
    wv = F.pad(_source_padded(wr, splits), (0, n_tiles * nt - cout, 0, 0, 0, 1))
    groups = wv.shape[1] // 8
    v = wv.reshape(MMA_STEPS, 2, groups, 4, 2, n_tiles, ng, 8)  # s, half, group, tq, e, tile, j, g
    return v.permute(5, 2, 0, 6, 7, 3, 1, 4).to(torch.bfloat16).contiguous()


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 exactly as ``cvt.rna.tf32.f32`` does: round the
    magnitude to 10 mantissa bits, ties away from zero (add half of the
    dropped part, 0x1000, to the magnitude bits, then clear the low 13)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of split TF32: ``big = tf32(t)``, ``small = tf32(t - big)``
    (the subtraction is exact in float32)."""
    big = tf32_round(t)
    return big, tf32_round(t.to(torch.float32) - big)


def _source_padded(wr: torch.Tensor, splits) -> torch.Tensor:
    """(27, C_in padded, C_out): each source's channels padded to a multiple
    of 8 on its own."""
    cout = wr.shape[4]
    w27 = wr.reshape(27, -1, cout)
    parts, off = [], 0
    for c in splits:
        parts.append(F.pad(w27[:, off:off + c], (0, 0, 0, -c % 8)))
        off += c
    return torch.cat(parts, 1)


def _x3_fragments(wr: torch.Tensor, splits, ng: int) -> torch.Tensor:
    """H-fwd-x3's B operand, split TF32: (n_tiles, groups, 27, ng, 8 g, 4 tq,
    2 part, 2 half) float32, i.e. (n_tile, group, tap, n8 tile, lane) x 4
    values in the order the kernel's lanes read them.

    K runs over 8-channel groups (each source padded to a multiple of 8 on
    its own) and within a group over the 27 taps, one m16n8k8 step each.
    Lane 4g + tq of n8 tile j holds the B fragment of output channel
    tile*8*ng + 8j + g: part 0 (big) then part 1 (small) of channels 8k + tq
    (half 0, b0) and 8k + tq + 4 (half 1, b1)."""
    cout = wr.shape[4]
    nt = 8 * ng
    n_tiles = -(-cout // nt)
    wv = F.pad(_source_padded(wr, splits), (0, n_tiles * nt - cout))
    groups = wv.shape[1] // 8
    v = wv.reshape(27, groups, 2, 4, n_tiles, ng, 8)  # tap, group, half, tq, tile, j, g
    parts = [p.permute(4, 1, 0, 5, 6, 3, 2) for p in split_tf32(v)]
    return torch.stack(parts, -2).contiguous()


def _wg_weights(wr: torch.Tensor, splits) -> torch.Tensor:
    """H-fwd-wg's B operand from DHWIO weights ``wr`` (rounded to bf16 here):
    (groups, 3 dz, WG_PAIRS, C_out/8 j, 2 h, 8 n, 8 k) bf16, flat, then
    WG_MAX_N·16 zeros.

    K runs over 8-channel groups (each source padded to a multiple of 8 on
    its own), within a group over the three tap planes dz, and within a
    plane over WG_PAIRS k16 steps: step p pairs the plane's taps 3·dy + dx =
    2p (k 0-7, h = 0) and 2p + 1 (k 8-15, h = 1; tap 9 is zero).  Each k16
    step is the canonical K-major no-swizzle wgmma layout of B: core matrix
    (j, h) is 8 output channels 8j + n (rows, 16 bytes apart) by 8 input
    channels k, 128 bytes, so LBO = 128 and SBO = 256 bytes.  A block's N
    tile of a step is the contiguous run of its j; the tail keeps the last
    tile's copy in bounds when the N tile runs past C_out."""
    cout = wr.shape[4]
    wb = wr.detach().to(torch.bfloat16)
    cpad = sum(-(-c // 8) * 8 for c in splits)
    w27 = wb.reshape(27, -1, cout) if cpad == wb.shape[3] else _source_padded(wb, splits)
    groups, jt = cpad // 8, cout // 8
    out = wb.new_zeros(groups * 3 * WG_PAIRS * jt * 128 + WG_MAX_N * 16)
    dst = out[:-WG_MAX_N * 16].view(groups, 3, WG_PAIRS, jt, 2, 8, 8)  # group, dz, p, j, h, n, k
    src = w27.reshape(3, 9, groups, 8, jt, 8).permute(2, 0, 1, 4, 5, 3)  # group, dz, tap, j, n, k
    dst[:, :, :, :, 0].copy_(src[:, :, 0::2])  # taps 0, 2, 4, 6, 8
    dst[:, :, :4, :, 1].copy_(src[:, :, 1::2])  # taps 1, 3, 5, 7 (tap 9 stays zero)
    return out


def _first_mma_fragments(wr: torch.Tensor) -> torch.Tensor:
    """H-first-mma's A operand: (2 m-tiles, steps, 8 g, 4 tq, 2 kh, 2 rh, 2 e)
    bf16, i.e. (m-tile, step, lane) x 4 registers of 2 bf16, in the order the
    kernel's lanes read it.

    A is (32 output channels, K): row = channel (zero past C_out), column k =
    tap·C_in + c for the taps (tap = kd*9 + kh*3 + kw, DHWIO order: the two
    channels of a tap share one B register, one 32-bit halo word), then the
    ones column k = 27·C_in, which the kernel fills with the bias, and zeros
    up to ``FIRST_MMA_KPAD``.  Lane 4g + tq of m-tile mt, step s holds register
    2kh + rh = the mma.m16n8k16 A fragment of row 16mt + 8rh + g, k 16s + 8kh
    + 2tq + e (e the low, then the high half)."""
    cin, cout = wr.shape[3], wr.shape[4]
    kpad = FIRST_MMA_KPAD[cin]
    a = wr.reshape(27 * cin, cout).t()
    a = F.pad(a, (0, kpad - 27 * cin, 0, FIRST_MMA_MAX_COUT - cout))
    v = a.reshape(2, 2, 8, kpad // 16, 2, 4, 2)  # mt, rh, g, s, kh, tq, e
    return v.permute(0, 3, 2, 5, 4, 1, 6).to(torch.bfloat16).contiguous()


def _first_x3_fragments(wr: torch.Tensor) -> torch.Tensor:
    """H-first-x3's B operand (weights), split TF32: (nt, steps, 8 g, 4 tq,
    2 part, 2 half) float32, nt = ceil(C_out / 8) n8 tiles, i.e. (n8 tile,
    step, lane) x 4 values in the order the kernel's lanes read them.

    B is (K = 8·steps, 8·nt): column n = 8j + g is an output channel (zero
    past C_out); row k = 8s + kk of step s is tap ``8 // C_in * s + kk %
    (8 // C_in)`` (tap = kd*9 + kh*3 + kw) of channel ``kk // (8 // C_in)``,
    zero past tap 26 (so for C_in = 2 the two channels of a tap are k and
    k + 4).  Lane 4g + tq of n8 tile j, step s holds the mma.m16n8k8 tf32 B
    fragment of column 8j + g: part 0 (tf32(w)) then part 1 (tf32(w - part
    0)) of rows 8s + tq (half 0, b0) and 8s + tq + 4 (half 1, b1)."""
    cin, cout = wr.shape[3], wr.shape[4]
    steps, tps = FIRST_X3_STEPS[cin], 8 // cin
    nt = -(-cout // 8)
    w = F.pad(wr.reshape(27, cin, cout), (0, 8 * nt - cout, 0, 0, 0, steps * tps - 27))
    b = w.reshape(steps, tps, cin, 8 * nt).permute(0, 2, 1, 3)  # (s, c, tap in step, n)
    v = b.reshape(steps, 2, 4, nt, 8)  # s, half, tq, j, g
    parts = [p.permute(3, 0, 4, 2, 1) for p in split_tf32(v)]
    return torch.stack(parts, -2).contiguous()


def first_x3_planes(cin: int, d: int, h: int, w: int, n_sm: int) -> int:
    """Planes per H-first-x3 block: the most of 8, 4, 2, 1 (C_in = 2: of 4, 2,
    1; 8 planes of its 16-byte halo slots leave room for two blocks an SM, not
    three) that still gives each of the card's ``n_sm`` SMs a block.  More
    planes stage fewer halo planes per output plane; at 64³ (16 tiles a
    plane), 4 planes ran faster than 2 and 8 (tools/ab_first_x3_variants.py)."""
    tiles = -(-w // 32) * -(-h // 8)
    for nz in (8, 4, 2):
        if nz <= FIRST_X3_MAX_PLANES // cin and tiles * -(-d // nz) >= n_sm:
            return nz
    return 1


@functools.cache
def _sm_count(index: int) -> int:
    # cached: a 64³ first conv's call is host-bound, and
    # torch.cuda.get_device_properties takes microseconds of host time
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclass(frozen=True)
class WgPlan:
    """An H-fwd-wg launch: ``n`` output channels per block (the wgmma N, a
    key of WG_CONFIGS) in ``tiles`` N tiles of C_out, blocks of ``tx`` x
    ``ty`` (W x H) voxels and ``nz`` output planes, ``mtw`` 8 x 8 M tiles per
    consumer warpgroup and plane."""
    n: int
    tiles: int
    tx: int
    ty: int
    mtw: int
    nz: int


def wg_plan(cout: int) -> WgPlan:
    """H-fwd-wg's launch shape: C_out in the fewest N tiles of at most
    WG_MAX_N channels, each the smallest instance that holds an even share;
    its tiles 32 voxels wide (16 where a warpgroup has one M tile) and as
    high as 2·MTW M tiles of 8 x 8 voxels make them (the kernel's
    ``tile_x``; a narrower volume leaves the rest of a tile empty)."""
    tiles = -(-cout // WG_MAX_N)
    share = -(-cout // (8 * tiles)) * 8
    n = min(k for k in WG_CONFIGS if k >= share)
    mtw, nz = WG_CONFIGS[n]
    tx = 32 if mtw >= 2 else 16
    return WgPlan(n, -(-cout // n), tx, 128 * mtw // tx, mtw, nz)


def fwd_wg_ok(x, cout: int, accum=None, head=None) -> bool:
    """The gate of H-fwd-wg: the one place that decides which bf16 calls it
    takes (``chip_smoke.py`` and the tests read it).  bf16 sources, no
    ``accum``, C_out % 8 == 0 (wgmma's N), and with ``head`` C_out <=
    WG_MAX_N (one N tile: the head sums every channel of a voxel in one
    block); the sources' layout comes from :func:`wg_sources`.  Every other
    bf16 conv but a first conv takes H-fwd-mma: the critic's 32->1 input
    gradient (C_out 1) on the main paths."""
    srcs = _sources(x)
    return (srcs[0].dtype == torch.bfloat16 and accum is None and cout % 8 == 0
            and (head is None or cout <= WG_MAX_N))


def wg_sources(srcs) -> list:
    """The sources H-fwd-wg reads: ``srcs`` themselves where W % 8 == 0 and
    each is 16-byte aligned (a TMA row stride is a multiple of 16 bytes, a
    base address 16-byte aligned), else copies zero-padded along W to the
    next multiple of 8.  SAME padding reads zeros past W, so the first W
    columns of the conv of the padded sources are the conv of the sources;
    the caller cuts the output back to W (the U-Net's deepest levels where W
    is not a multiple of 128, and the tutorials' 4³ and 2³)."""
    wd = srcs[0].shape[3]
    if wd % 8 == 0 and _aligned(*srcs):
        return list(srcs)
    return [F.pad(s, (0, -wd % 8)) for s in srcs]


def pack_conv(w: torch.Tensor, dtype: torch.dtype, splits=None) -> PackedConv:
    """Round a DHWIO 3³ kernel to ``dtype`` and arrange it for the kernels,
    on the weight's own device.  ``splits``: the channel counts of the sources
    it will read (default: one source)."""
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"expected a (3, 3, 3, cin, cout) kernel, got {tuple(w.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype}")
    cin, cout = w.shape[3], w.shape[4]
    splits = (cin,) if splits is None else tuple(int(c) for c in splits)
    if sum(splits) != cin or not 1 <= len(splits) <= 2:
        raise ValueError(f"source channels {splits} do not add up to the kernel's {cin}")
    wr = w.detach().to(dtype).to(torch.float32).contiguous()
    bf16 = dtype == torch.bfloat16
    ng = mma_groups(cout) if bf16 else cout_groups(cout)
    frags = _mma_fragments(wr, splits, ng) if bf16 else _x3_fragments(wr, splits, ng)
    first = None
    if cin in FIRST_MMA_KPAD and cout <= FIRST_MMA_MAX_COUT:
        first = _first_mma_fragments(wr) if bf16 else _first_x3_fragments(wr)
    wg = _wg_weights(wr, splits) if bf16 and cout % 8 == 0 else None
    return PackedConv(wr, frags, dtype, ng, splits, first, wg)


def _sources(x):
    srcs = list(x) if isinstance(x, (list, tuple)) else [x]
    if not srcs or len(srcs) > 2:
        raise ValueError(f"expected 1 or 2 sources, got {len(srcs)}")
    s0 = srcs[0]
    for s in srcs:
        if s.dim() != 4:
            raise ValueError(f"sources must be (C, D, H, W), got {tuple(s.shape)}")
        if s.shape[1:] != s0.shape[1:] or s.dtype != s0.dtype or s.device != s0.device:
            raise ValueError("sources differ in spatial shape, dtype or device")
    if s0.dtype not in _DTYPES:
        raise ValueError(f"unsupported activation dtype {s0.dtype}")
    return srcs


def _weight(w, dtype) -> torch.Tensor:
    """DHWIO float32 rounded to ``dtype``."""
    if isinstance(w, PackedConv):
        if w.dtype != dtype:
            raise ValueError(f"weights packed for {w.dtype}, activations are {dtype}")
        return w.w
    return w.to(dtype).to(torch.float32)


def conv3d_cf_reference(x, w, bias=None, activation=None, post=None, head=None,
                        accum=None) -> torch.Tensor:
    """The plain version: ``F.conv3d`` in float32 on the concatenated sources,
    then accum, bias, activation, post and head in the JAX order
    (tests/test_ops_core.py:259-268,341-342)."""
    srcs = _sources(x)
    dtype = srcs[0].dtype
    xf = torch.cat([s.to(torch.float32) for s in srcs], 0)
    wf = _weight(w, dtype).to(xf.device)
    if wf.shape[3] != xf.shape[0]:
        raise ValueError(f"kernel expects {wf.shape[3]} input channels, got {xf.shape[0]}")
    y = F.conv3d(xf[None], wf.permute(4, 3, 0, 1, 2), padding=1)[0]
    if accum is not None:
        y = y + accum.to(torch.float32)
    if bias is not None:
        y = y + bias.to(dtype).to(torch.float32).reshape(-1, 1, 1, 1)
    if activation == "elu":
        y = F.elu(y)
    elif activation == "relu":
        y = F.relu(y)
    elif activation == "leaky":
        y = torch.where(y >= 0, y, 0.2 * y)
    elif activation is not None:
        raise ValueError(f"unsupported activation {activation!r}")
    if post is not None:
        post = post.to(torch.float32)
        y = y * post[0].reshape(-1, 1, 1, 1) + post[1].reshape(-1, 1, 1, 1)
    if head is not None:
        ha, hb = (torch.as_tensor(t, dtype=torch.float32, device=y.device) for t in head)
        return (y * ha.reshape(-1, 1, 1, 1)).sum(0, keepdim=True) + hb.reshape(())
    return y.to(dtype)


def conv3d_cf(x, w, bias=None, activation=None, post=None, head=None, accum=None, kernel=None):
    """SAME 3³ conv, channels-first (see the module docstring).  ``kernel``:
    None launches the dispatch's choice; "fwd_mma" runs H-fwd-mma on a bf16
    call that :func:`fwd_wg_ok` gives to H-fwd-wg (the two timed in turns);
    a CPU tensor ignores it."""
    t0 = time.perf_counter() if profiling.enabled else None
    srcs = _sources(x)
    dev = srcs[0].device
    if dev.type == "cpu":
        return conv3d_cf_reference(srcs, w, bias=bias, activation=activation,
                                   post=post, head=head, accum=accum)
    if dev.type != "cuda":
        raise ValueError(f"conv3d_cf runs on CPU (plain) or CUDA (kernels), not {dev}")
    if kernel not in (None, "fwd_mma"):
        raise ValueError(f"kernel must be None or 'fwd_mma', got {kernel!r}")
    out = _launch(srcs, w, bias, activation, post, head, accum, kernel)
    if t0 is not None:
        _count_call(t0)
    return out


def _count_call(t0: float):
    """Count one CUDA conv call and its host seconds since ``t0``."""
    profiling.count("conv.calls")
    profiling.count("conv.host_s", time.perf_counter() - t0)


def _f32_on(t, dev, shape, name):
    t = torch.as_tensor(t).to(device=dev, dtype=torch.float32).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    return t


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _launch(srcs, w, bias, activation, post, head, accum, kernel=None):
    dtype = srcs[0].dtype
    dev = srcs[0].device
    cins = [s.shape[0] for s in srcs]
    cin = sum(cins)
    if isinstance(w, PackedConv):
        pc, wshape, wdev = w, w.w.shape, w.w.device
        if pc.dtype != dtype:
            raise ValueError(f"weights packed for {pc.dtype}, activations are {dtype}")
    else:  # packed below for the kernel that runs: H-fwd-wg reads only its own operand
        if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
            raise ValueError(f"expected a (3, 3, 3, cin, cout) kernel, got {tuple(w.shape)}")
        pc, wshape, wdev = None, w.shape, dev
    if wdev != dev:
        raise ValueError(f"weights on {wdev}, activations on {dev}")
    cout = wshape[4]
    if wshape[3] != cin:
        raise ValueError(f"kernel expects {wshape[3]} input channels, got {cin}")
    d, h, wd = srcs[0].shape[1:]
    if d > 65535:
        raise ValueError(f"depth {d} exceeds the grid limit")
    if activation not in _ACT_CODES:
        raise ValueError(f"unsupported activation {activation!r}")
    for s in srcs:
        if not s.is_contiguous():
            raise ValueError("sources must be contiguous")
    if accum is not None:
        if accum.dtype != dtype or accum.device != dev or not accum.is_contiguous() \
                or tuple(accum.shape) != (cout, d, h, wd):
            raise ValueError(f"accum must be a contiguous ({cout}, {d}, {h}, {wd}) "
                             f"{dtype} tensor on {dev}")
    b = None if bias is None else \
        _f32_on(torch.as_tensor(bias).to(dev).to(dtype), dev, (cout,), "bias")
    p = None if post is None else _f32_on(post, dev, (2, cout), "post")
    hd = None
    if head is not None:
        ha, hb = head
        hd = torch.cat([_f32_on(ha, dev, (cout,), "head weights"),
                        _f32_on(hb, dev, (), "head bias").reshape(1)])
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = (lambda t: None if t is None else t.data_ptr())
        act = _ACT_CODES[activation]
        first = len(srcs) == 1 and cin <= 2 and accum is None and head is None
        if first and cin in FIRST_MMA_KPAD and cout <= FIRST_MMA_MAX_COUT:
            if pc is None:
                pc = pack_conv(w.to(dev), dtype, cins)
                profiling.count("conv.packs")
            out = torch.empty((cout, d, h, wd), dtype=dtype, device=dev)
            if dtype == torch.bfloat16:
                vec = int(wd % 8 == 0 and _aligned(srcs[0], out))
                err = lib.conv3d_first_mma_launch(
                    ptr(srcs[0]), cin, d, h, wd, ptr(pc.first_frags), cout, ptr(b), ptr(p),
                    act, vec, ptr(out), stream)
                _check(lib, err, "H-first-mma")
                LAUNCHES["first_mma"] += 1
                return out
            vec = int(wd % 4 == 0 and _aligned(srcs[0], out))
            nz = first_x3_planes(cin, d, h, wd, _sm_count(dev.index))
            err = lib.conv3d_first_x3_launch(
                ptr(srcs[0]), cin, d, h, wd, nz, ptr(pc.first_frags), cout, ptr(b), ptr(p), act,
                vec, ptr(out), stream)
            _check(lib, err, "H-first-x3")
            LAUNCHES["first_x3"] += 1
            return out
        if head is not None:
            out = torch.empty((1, d, h, wd), dtype=torch.float32, device=dev)
        else:
            out = torch.empty((cout, d, h, wd), dtype=dtype, device=dev)
        src1 = srcs[1] if len(srcs) == 2 else None
        c1 = cins[1] if src1 is not None else 0
        if pc is not None and _split_key(pc.splits) != _split_key(cins):
            raise ValueError(f"weights packed for sources {pc.splits}, got {tuple(cins)}")
        if kernel is None and fwd_wg_ok(srcs, cout, accum, head):
            if pc is not None:
                wgw = pc.wg
            else:
                wgw = _wg_weights(w.to(dev), cins)
                profiling.count("conv.packs")
            plan = wg_plan(cout)
            ks = wg_sources(srcs)
            w8 = ks[0].shape[3]
            kout = out if w8 == wd else out.new_empty(out.shape[:3] + (w8,))
            err = lib.conv3d_fwd_wg_launch(
                ptr(ks[0]), cins[0], ptr(ks[1] if src1 is not None else None), c1, d, h, w8,
                ptr(wgw), cout, plan.n, plan.tx, plan.ty, ptr(b), ptr(p), ptr(hd), act,
                _sm_count(dev.index), ptr(kout), stream)
            _check(lib, err, "H-fwd-wg")
            LAUNCHES["fwd_wg"] += 1
            return out if kout is out else kout[..., :wd].contiguous()
        if pc is None:
            pc = pack_conv(w.to(dev), dtype, cins)
            profiling.count("conv.packs")
        if head is not None and cout > 8 * pc.ng:
            raise ValueError(f"head folding needs cout <= {8 * pc.ng}, got {cout}")
        if dtype == torch.bfloat16:
            vec = int(wd % 8 == 0 and _aligned(*srcs, accum, out))
            err = lib.conv3d_fwd_mma_launch(
                ptr(srcs[0]), cins[0], ptr(src1), c1, d, h, wd, ptr(pc.frags), cout, pc.ng,
                ptr(b), ptr(accum), ptr(p), ptr(hd), act, vec, ptr(out), stream)
            _check(lib, err, "H-fwd-mma")
            LAUNCHES["fwd_mma"] += 1
            return out
        vec = int(wd % 4 == 0 and _aligned(*srcs, accum, out))
        err = lib.conv3d_fwd_x3_launch(
            ptr(srcs[0]), cins[0], ptr(src1), c1, d, h, wd, ptr(pc.frags), cout, pc.ng,
            ptr(b), ptr(accum), ptr(p), ptr(hd), act, vec, ptr(out), stream)
        _check(lib, err, "H-fwd-x3")
        LAUNCHES["fwd_x3"] += 1
        return out


def _check(lib, err, name):
    if err != 0:
        msg = lib.conv3d_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def _wgrad_operands(x, g):
    if x.dim() != 4 or g.dim() != 4 or x.shape[1:] != g.shape[1:]:
        raise ValueError(f"expected x (ci, D, H, W) and g (co, D, H, W), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported activation dtype {x.dtype}")
    if x.device != g.device:
        raise ValueError(f"x on {x.device}, g on {g.device}")
    return g.to(x.dtype)


def conv3d_cf_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version: float32 ``torch.nn.grad.conv3d_weight`` on ``x`` and
    ``g`` rounded to ``x.dtype``, as DHWIO (3, 3, 3, ci, co)."""
    g = _wgrad_operands(x, g)
    dw = torch.nn.grad.conv3d_weight(x.to(torch.float32)[None],
                                     (g.shape[0], x.shape[0], 3, 3, 3),
                                     g.to(torch.float32)[None], padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


@dataclass(frozen=True)
class WgradPlan:
    """A weight-gradient launch of H-wgrad-mma or H-wgrad-x3: items of ``nz``
    planes x ``th`` x ``tw`` voxels (128), ``co_tile`` output channels per
    block, the volume's items split over ``n_split`` blocks per (8-channel
    group of x, co tile)."""
    th: int
    tw: int
    co_tile: int
    n_split: int
    nz: int = 1


# H-wgrad-x3's items of 128 voxels (planes, H, W) by the volume's width: W >
# 16 (WGRAD_MMA_TILE), 9-16 and 8 or less, so that a narrow volume's lanes
# do not compute zeros; conv3d_wgrad_x3.cu's X3_ITEMS agrees
WGRAD_X3_ITEMS = {32: (1, 4, 32), 16: (1, 8, 16), 8: (2, 8, 8)}
WGRAD_X3_BLOCK_COST = 1  # a block's fixed cost in items (its partial, the reduce's read)


def _fewest_waves(pairs: int, items: int, slots: int, cost: int,
                  split_cost: float = 0.0) -> int:
    """Splits of ``items`` per each of ``pairs`` (channel group, co tile) for
    ``slots`` resident blocks: the n that minimises waves x (items a block +
    ``cost``) + ``split_cost`` per split past the first (the partials'
    traffic, in items), the fewest on a tie.  Counting waves keeps the last
    one from running mostly empty."""
    def time(n):
        return -(-pairs * n // slots) * (-(-items // n) + cost) + (n > 1) * n * split_cost

    return min(range(1, min(items, -(-4 * slots // pairs)) + 1), key=lambda n: (time(n), n))


@functools.lru_cache(maxsize=256)
def wgrad_plan(ci: int, co: int, d: int, h: int, w: int, n_sm: int,
               dtype: torch.dtype) -> WgradPlan:
    """The launch shape of H-wgrad-mma (bf16) or H-wgrad-x3 (float32).

    Both: co tiles of 16·mt with mt = 2 (1 for C_out <= 16), or for bf16 mt =
    3 where 48 divides C_out (H-wgrad-x3 holds twice the sums in registers:
    mt <= 2), 8 channels of x per block.  Items of 4 x 32 voxels and enough
    splits for the blocks per SM that the kernel's registers and shared
    memory keep resident (WGRAD_MMA_BLOCKS_PER_SM, WGRAD_X3_BLOCKS_PER_SM),
    one even wave; but H-wgrad-x3 on a narrow volume (W <= 16) takes the
    items of WGRAD_X3_ITEMS, whose lanes compute no zeros, and the splits
    that take the fewest waves (:func:`_fewest_waves`)."""
    bf16 = dtype == torch.bfloat16
    co_tile = 48 if bf16 and co % 48 == 0 else (32 if co > 16 else 16)
    pairs = -(-ci // 8) * -(-co // co_tile)
    if bf16 or w > 16:
        th, tw = WGRAD_MMA_TILE
        items = d * -(-w // tw) * -(-h // th)
        per_sm = WGRAD_MMA_BLOCKS_PER_SM if bf16 else WGRAD_X3_BLOCKS_PER_SM
        return WgradPlan(th, tw, co_tile, max(1, min(items, -(-per_sm * n_sm // pairs))))
    nz, th, tw = WGRAD_X3_ITEMS[16 if w > 8 else 8]
    items = -(-d // nz) * -(-w // tw) * -(-h // th)
    n_split = _fewest_waves(pairs, items, WGRAD_X3_BLOCKS_PER_SM * n_sm, WGRAD_X3_BLOCK_COST)
    return WgradPlan(th, tw, co_tile, n_split, nz)


@dataclass(frozen=True)
class WgradWgPlan:
    """An H-wgrad-wg launch: column tiles of ``tx`` x ``ty`` voxels of a
    plane, ``ct`` output channels per block in ``co_tiles`` tiles, the
    stacked layout where ``stack``, the volume's (tile, plane) items split
    over ``n_split`` blocks per (8-channel group of x, co tile)."""
    tx: int
    ty: int
    ct: int
    co_tiles: int
    n_split: int
    stack: bool


def wgrad_wg_ok(x, g) -> bool:
    """The gate of H-wgrad-wg: the one place that decides which bf16 weight
    gradients it takes (``chip_smoke.py`` and the tests read it).  bf16 x and
    W >= 8; any C_in and C_out (the boxes run past the channels), and W not a
    multiple of 8 is padded (:func:`wg_sources`).  The rest of bf16 takes
    H-wgrad-mma: the tutorials' 4³ and 2³ levels, where the padded copies and
    a mostly empty tile cost more than H-wgrad-mma's call (0.096 against 0.041
    ms at (48,24) @4³ on an H100)."""
    return x.dtype == torch.bfloat16 and x.shape[3] >= 8


@functools.lru_cache(maxsize=256)
def wgrad_wg_plan(ci: int, co: int, d: int, h: int, w: int, n_sm: int) -> WgradWgPlan:
    """H-wgrad-wg's launch shape for x (ci, D, H, W) and g (co, D, H, W), W
    already a multiple of 8: tiles 32 voxels wide (16, 8 where W is a
    multiple of no wider one) and WGRAD_WG_TILES high; C_out in the fewest
    tiles of at most WGRAD_WG_MAX_CT channels, even shares in multiples of 8,
    in the stacked layout where a tile is at most WGRAD_WG_STACK_CT (two
    thirds of the products); the splits that take the fewest waves of one
    block per SM, a split priced by its partial's traffic
    (:func:`_fewest_waves`: at 128³ many splits of K, at 16³-8³ few or
    one)."""
    tx = 32 if w % 32 == 0 else 16 if w % 16 == 0 else 8
    ty = WGRAD_WG_TILES[tx]
    co_tiles = -(-co // WGRAD_WG_MAX_CT)
    ct = 8 * -(-co // (8 * co_tiles))
    items = -(-w // tx) * -(-h // ty) * d
    partial = 27 * -(-ci // 8) * 8 * ct * co_tiles * 4 * 2  # written, then read by the reduce
    n_split = _fewest_waves(-(-ci // 8) * co_tiles, items, n_sm, WGRAD_WG_STAGE_COST,
                            partial / (WGRAD_WG_VOXEL_BYTES * tx * ty))
    return WgradWgPlan(tx, ty, ct, co_tiles, n_split, ct <= WGRAD_WG_STACK_CT)


def conv3d_cf_wgrad(x: torch.Tensor, g: torch.Tensor, kernel=None) -> torch.Tensor:
    """(3, 3, 3, ci, co) float32 weight gradient (see the module docstring).
    ``kernel``: None launches the dispatch's choice; "wgrad_mma" runs
    H-wgrad-mma on a bf16 call that :func:`wgrad_wg_ok` gives to H-wgrad-wg
    (the two timed in turns); a CPU tensor ignores it.

    H-wgrad-wg pads C_out to rows of M in eights and C_in only in the x box,
    so a call whose C_out is not a multiple of 8 but C_in is (the penalty's
    32->1) runs as the weight gradient of (g, x), whose taps are mirrored
    and channels transposed: ``dw(x, g)[dz, dy, dx, i, o] = dw(g, x)[2 - dz,
    2 - dy, 2 - dx, o, i]`` (SAME padding is symmetric).  At (32,1) @128³ on
    an H100 0.100 ms, against 0.318 unswapped and H-wgrad-mma's 0.462
    (``tools/ab_wgrad_wg_variants.py``)."""
    t0 = time.perf_counter() if profiling.enabled else None
    dev = x.device
    if dev.type == "cpu":
        return conv3d_cf_wgrad_reference(x, g)
    if dev.type != "cuda":
        raise ValueError(f"conv3d_cf_wgrad runs on CPU (plain) or CUDA (kernel), not {dev}")
    if kernel not in (None, "wgrad_mma"):
        raise ValueError(f"kernel must be None or 'wgrad_mma', got {kernel!r}")
    dw = _wgrad_launch(x, g, kernel)
    if t0 is not None:
        _count_call(t0)
    return dw


def _wgrad_launch(x, g, kernel):
    dev = x.device
    g = _wgrad_operands(x, g).contiguous()
    x = x.contiguous()
    ci, d, h, wd = x.shape
    co = g.shape[0]
    bf16 = x.dtype == torch.bfloat16
    lib = _library()
    if bf16 and kernel is None and wgrad_wg_ok(x, g):
        if co % 8 and ci % 8 == 0:
            return _wgrad_launch(g, x, None).flip((0, 1, 2)).transpose(3, 4).contiguous()
        xs, gs = wg_sources([x, g])
        w8 = xs.shape[3]
        plan = wgrad_wg_plan(ci, co, d, h, w8, _sm_count(dev.index))
        ci_pad, co_pad = -(-ci // 8) * 8, plan.co_tiles * plan.ct
        direct = plan.n_split == 1 and ci_pad == ci and co_pad == co
        dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
        partial = dw if direct else torch.empty((plan.n_split, 27, ci_pad, co_pad),
                                                dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.conv3d_wgrad_wg_launch(
                xs.data_ptr(), gs.data_ptr(), ci, co, d, h, w8, plan.tx, plan.ct, int(plan.stack),
                plan.n_split, partial.data_ptr(), dw.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _check(lib, err, "H-wgrad-wg")
        LAUNCHES["wgrad_wg"] += 1
        return dw
    plan = wgrad_plan(ci, co, d, h, wd, _sm_count(dev.index), x.dtype)
    ci_pad = -(-ci // 8) * 8
    co_pad = -(-co // plan.co_tile) * plan.co_tile
    partial = torch.empty((plan.n_split, 27, ci_pad, co_pad), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        vec = int(wd % (8 if bf16 else 4) == 0 and _aligned(x, g))
        if bf16:
            err = lib.conv3d_wgrad_mma_launch(x.data_ptr(), g.data_ptr(), ci, co, d, h, wd,
                                              plan.co_tile // 16, plan.n_split, vec,
                                              partial.data_ptr(), dw.data_ptr(), stream)
        else:
            err = lib.conv3d_wgrad_x3_launch(x.data_ptr(), g.data_ptr(), ci, co, d, h, wd,
                                             plan.co_tile // 16, plan.tw, plan.n_split, vec,
                                             partial.data_ptr(), dw.data_ptr(), stream)
    _check(lib, err, "H-wgrad-mma" if bf16 else "H-wgrad-x3")
    LAUNCHES["wgrad_mma" if bf16 else "wgrad_x3"] += 1
    return dw
