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
shapes) launches **H-first-mma** for bf16 with C_out <= 32 (tensor cores,
``csrc/conv3d_first_mma.cu``) or **H-first** for float32 (CUDA cores,
``csrc/conv3d_cf.cu``), both replacing K1; any other conv launches
**H-fwd-mma** for bf16 (tensor cores, ``csrc/conv3d_fwd_mma.cu``; replaces
K2, K3, K4 and K5) or **H-fwd** for float32 (CUDA cores,
``csrc/conv3d_cf.cu``); any other device raises.

K5 (``_kernel``, ``synthsr_tpu/ops/conv_pallas.py:127``, entry ``conv3d_cf``
:990) is the TPU's blocked conv for the shapes the plane and folded-plane
layouts reject: W % 128 == 0, H % 16 == 0, C_in <= 96 and C_in·W <= 96·256
(``synthsr_tpu/models/unet_cf.py:140-159``).  On the predict path these are
the level-0 convs of a large field of view, e.g. 24->24 at 192x256x512 or
256x384x384 and, unfused, 72->24 at 256x512x256, whose planes (cin·H·W over
24·256²) pass the other kernels' caps.  H-fwd takes those shapes as it takes
any other (64-bit offsets; grid (W/32·H/8, D, C_out tiles)), with bias and
activation fused at every C_in, so no dispatch here depends on them.  H-fwd-mma
tiles the same way.

``conv3d_cf_wgrad(x, g)`` is the training backward's weight gradient,
``dw[dz, dy, dx, ci, co] = sum x[ci, z+dz-1, h+dy-1, w+dx-1] g[co, z, h, w]``
(zero padding), (3, 3, 3, ci, co) float32, with ``g`` rounded to ``x.dtype``
first as K6 does (conv_pallas.py:1230).  The same dispatch: the plain
:func:`conv3d_cf_wgrad_reference` on a CPU tensor; on a CUDA tensor
**H-wgrad-mma** for bf16 (``csrc/conv3d_wgrad_mma.cu``) or **H-wgrad** for
float32 (``csrc/conv3d_wgrad.cu``), both replacing K6 and K7.

``LAUNCHES`` counts kernel launches per kernel, under its own key, and
nothing else.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import cuda_build

LAUNCHES = {"first": 0, "first_mma": 0, "fwd_mma": 0, "wgrad_mma": 0, "fwd": 0, "wgrad": 0}

FWD_CHUNK = 8  # input channels per H-fwd chunk (FWD_CK in csrc/conv3d_cf.cu)
MMA_STEPS = 14  # k16 steps per 8-channel group of H-fwd-mma (FM_STEPS in csrc/conv3d_fwd_mma.cu)
MMA_TILE = (8, 32)  # H-fwd-mma output tile (H, W) of one plane
WGRAD_MMA_TILE = (4, 32)  # H-wgrad-mma item (H, W) of one plane
WGRAD_MMA_BLOCKS_PER_SM = 4  # 96-thread blocks H-wgrad-mma aims to keep on each SM
WGRAD_CHUNK = 8  # input channels per H-wgrad block (WG_CK in csrc/conv3d_wgrad.cu)
WGRAD_MAX_TILE = 128  # voxels per H-wgrad tile (WG_MAXVOX)
# H-first-mma: K (27·C_in taps + the bias's ones column) padded to k16 steps,
# and the most output channels (two m16 tiles); conv3d_first_mma.cu agrees
FIRST_MMA_KPAD = {1: 32, 2: 64}
FIRST_MMA_MAX_COUT = 32
_ACT_CODES = {None: 0, "elu": 1, "relu": 2, "leaky": 3}
_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def build_kernels() -> float:
    """Build (if needed) and load the kernels; returns the compile seconds
    (0.0 when an earlier build of the same sources was reused)."""
    global _lib
    path, seconds = cuda_build.build()
    lib = cuda_build.load(path)
    if lib.conv3d_fwd_chunk() != FWD_CHUNK or lib.conv3d_fwd_mma_steps() != MMA_STEPS:
        raise RuntimeError("csrc/conv3d_cf.cu, csrc/conv3d_fwd_mma.cu and conv_cf disagree")
    if (lib.conv3d_wgrad_chunk(), lib.conv3d_wgrad_max_tile()) != (WGRAD_CHUNK, WGRAD_MAX_TILE):
        raise RuntimeError("csrc/conv3d_wgrad.cu and conv_cf.WGRAD_* disagree")
    if ({c: lib.conv3d_first_mma_kpad(c) for c in FIRST_MMA_KPAD} != FIRST_MMA_KPAD
            or lib.conv3d_first_mma_max_cout() != FIRST_MMA_MAX_COUT):
        raise RuntimeError("csrc/conv3d_first_mma.cu and conv_cf.FIRST_MMA_* disagree")
    _lib = lib
    return seconds


def _library():
    """The kernels' library, built from the sources on first use."""
    if _lib is None:
        build_kernels()
    return _lib


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cout_groups(cout: int) -> int:
    """Output channels per H-fwd block, in groups of 8: 24 wherever it
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
    operand).  ``packed``: (cin_pad, 27, cout_pad) float32, zero-padded to
    the CUDA-core kernels' channel chunk and cout tile (H-first, H-fwd);
    made for float32, else None.  ``frags``: the bf16 B fragments of
    H-fwd-mma (see :func:`_mma_fragments`), for bf16, else None; ``splits``
    are the source channel counts they were laid out for.  ``first_frags``:
    the bf16 A fragments of H-first-mma (see :func:`_first_mma_fragments`),
    for bf16 with C_in <= 2 and C_out <= 32, else None."""
    w: torch.Tensor
    packed: torch.Tensor | None
    frags: torch.Tensor | None
    dtype: torch.dtype
    ng: int
    splits: tuple
    first_frags: torch.Tensor | None

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
    w27 = wr.reshape(27, -1, cout)
    parts, off = [], 0
    for c in splits:
        parts.append(F.pad(w27[:, off:off + c], (0, 0, 0, -c % 8)))
        off += c
    wv = F.pad(torch.cat(parts, 1), (0, n_tiles * nt - cout, 0, 0, 0, 1))
    groups = wv.shape[1] // 8
    v = wv.reshape(MMA_STEPS, 2, groups, 4, 2, n_tiles, ng, 8)  # s, half, group, tq, e, tile, j, g
    return v.permute(5, 2, 0, 6, 7, 3, 1, 4).to(torch.bfloat16).contiguous()


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
    packed = None
    if not bf16:
        ng = cout_groups(cout)
        cin_pad = -(-cin // FWD_CHUNK) * FWD_CHUNK
        cout_pad = -(-cout // (8 * ng)) * (8 * ng)
        packed = torch.zeros((cin_pad, 27, cout_pad), dtype=torch.float32, device=w.device)
        packed[:cin, :, :cout] = wr.reshape(27, cin, cout).permute(1, 0, 2)
    ng = mma_groups(cout) if bf16 else cout_groups(cout)
    frags = _mma_fragments(wr, splits, ng) if bf16 else None
    first = None
    if bf16 and cin in FIRST_MMA_KPAD and cout <= FIRST_MMA_MAX_COUT:
        first = _first_mma_fragments(wr)
    return PackedConv(wr, packed, frags, dtype, ng, splits, first)


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


def conv3d_cf(x, w, bias=None, activation=None, post=None, head=None, accum=None):
    """SAME 3³ conv, channels-first (see the module docstring)."""
    srcs = _sources(x)
    dev = srcs[0].device
    if dev.type == "cpu":
        return conv3d_cf_reference(srcs, w, bias=bias, activation=activation,
                                   post=post, head=head, accum=accum)
    if dev.type != "cuda":
        raise ValueError(f"conv3d_cf runs on CPU (plain) or CUDA (kernels), not {dev}")
    return _launch(srcs, w, bias, activation, post, head, accum)


def _f32_on(t, dev, shape, name):
    t = torch.as_tensor(t).to(device=dev, dtype=torch.float32).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    return t


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def _launch(srcs, w, bias, activation, post, head, accum):
    dtype = srcs[0].dtype
    dev = srcs[0].device
    cins = [s.shape[0] for s in srcs]
    pc = w if isinstance(w, PackedConv) else pack_conv(w.to(dev), dtype, cins)
    if pc.dtype != dtype:
        raise ValueError(f"weights packed for {pc.dtype}, activations are {dtype}")
    if pc.w.device != dev:
        raise ValueError(f"weights on {pc.w.device}, activations on {dev}")
    cin, cout = sum(cins), pc.cout
    if pc.cin != cin:
        raise ValueError(f"kernel expects {pc.cin} input channels, got {cin}")
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
        if cout > 8 * pc.ng:
            raise ValueError(f"head folding needs cout <= {8 * pc.ng}, got {cout}")
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = (lambda t: None if t is None else t.data_ptr())
        act = _ACT_CODES[activation]
        first = len(srcs) == 1 and cin <= 2 and accum is None and head is None
        if first and dtype == torch.float32:
            out = torch.empty((cout, d, h, wd), dtype=dtype, device=dev)
            err = lib.conv3d_first_launch(
                ptr(srcs[0]), cin, d, h, wd, ptr(pc.packed), cout, pc.packed.shape[2],
                ptr(b), ptr(p), act, ptr(out), stream)
            _check(lib, err, "H-first")
            LAUNCHES["first"] += 1
            return out
        if first and pc.first_frags is not None:
            out = torch.empty((cout, d, h, wd), dtype=dtype, device=dev)
            vec = int(wd % 8 == 0 and _aligned(srcs[0], out))
            err = lib.conv3d_first_mma_launch(
                ptr(srcs[0]), cin, d, h, wd, ptr(pc.first_frags), cout, ptr(b), ptr(p), act,
                vec, ptr(out), stream)
            _check(lib, err, "H-first-mma")
            LAUNCHES["first_mma"] += 1
            return out
        if head is not None:
            out = torch.empty((1, d, h, wd), dtype=torch.float32, device=dev)
        else:
            out = torch.empty((cout, d, h, wd), dtype=dtype, device=dev)
        src1 = srcs[1] if len(srcs) == 2 else None
        c1 = cins[1] if src1 is not None else 0
        if dtype == torch.bfloat16:
            if _split_key(pc.splits) != _split_key(cins):
                raise ValueError(f"weights packed for sources {pc.splits}, got {tuple(cins)}")
            vec = int(wd % 8 == 0 and _aligned(*srcs, accum, out))
            err = lib.conv3d_fwd_mma_launch(
                ptr(srcs[0]), cins[0], ptr(src1), c1, d, h, wd, ptr(pc.frags), cout, pc.ng,
                ptr(b), ptr(accum), ptr(p), ptr(hd), act, vec, ptr(out), stream)
            _check(lib, err, "H-fwd-mma")
            LAUNCHES["fwd_mma"] += 1
            return out
        err = lib.conv3d_fwd_launch(
            ptr(srcs[0]), cins[0], ptr(src1), c1, d, h, wd, ptr(pc.packed), cout,
            pc.packed.shape[2], pc.ng, ptr(b), ptr(accum), ptr(p), ptr(hd), act, ptr(out), stream)
        _check(lib, err, "H-fwd")
        LAUNCHES["fwd"] += 1
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


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclass(frozen=True)
class WgradPlan:
    """A weight-gradient launch: tiles of ``th`` x ``tw`` voxels of one plane,
    ``co_tile`` output channels per block, the volume's (plane, tile) items
    split over ``n_split`` blocks per (8-channel group of x, co tile)."""
    th: int
    tw: int
    co_tile: int
    n_split: int


def wgrad_plan(ci: int, co: int, d: int, h: int, w: int, n_sm: int,
               dtype: torch.dtype) -> WgradPlan:
    """The launch shape of H-wgrad-mma (bf16) or H-wgrad (float32).

    H-wgrad-mma: items of 4 x 32 voxels (K = 128 per item), co tiles of 16·mt
    with mt = 3 where 48 divides C_out, else 2 (1 for C_out <= 16), and
    enough splits for WGRAD_MMA_BLOCKS_PER_SM blocks per SM, the number its
    registers and shared memory keep resident, so the card runs one even
    wave.  H-wgrad: tiles of th x tw <= WGRAD_MAX_TILE voxels, 8 <= tw <= 32;
    ``cout_groups`` groups of 8 output channels; about eight blocks per SM
    (registers and shared memory hold six 72-thread blocks per SM; two per
    SM left the card at 6 TFLOP/s)."""
    if dtype == torch.bfloat16:
        th, tw = WGRAD_MMA_TILE
        co_tile = 48 if co % 48 == 0 else (32 if co > 16 else 16)
        per_sm = WGRAD_MMA_BLOCKS_PER_SM
    else:
        tw = min(32, max(8, _pow2_ceil(w)))
        th = max(1, min(WGRAD_MAX_TILE // tw, _pow2_ceil(h)))
        co_tile = 8 * cout_groups(co)
        per_sm = 8
    items = d * -(-w // tw) * -(-h // th)
    pairs = -(-ci // WGRAD_CHUNK) * -(-co // co_tile)
    n_split = max(1, min(items, -(-per_sm * n_sm // pairs)))
    return WgradPlan(th, tw, co_tile, n_split)


def conv3d_cf_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, ci, co) float32 weight gradient (see the module docstring)."""
    dev = x.device
    if dev.type == "cpu":
        return conv3d_cf_wgrad_reference(x, g)
    if dev.type != "cuda":
        raise ValueError(f"conv3d_cf_wgrad runs on CPU (plain) or CUDA (kernel), not {dev}")
    g = _wgrad_operands(x, g).contiguous()
    x = x.contiguous()
    ci, d, h, wd = x.shape
    co = g.shape[0]
    plan = wgrad_plan(ci, co, d, h, wd,
                      torch.cuda.get_device_properties(dev).multi_processor_count, x.dtype)
    ci_pad = -(-ci // WGRAD_CHUNK) * WGRAD_CHUNK
    co_pad = -(-co // plan.co_tile) * plan.co_tile
    partial = torch.empty((plan.n_split, 27, ci_pad, co_pad), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if x.dtype == torch.bfloat16:
            vec = int(wd % 8 == 0 and _aligned(x, g))
            err = lib.conv3d_wgrad_mma_launch(x.data_ptr(), g.data_ptr(), ci, co, d, h, wd,
                                              plan.co_tile // 16, plan.n_split, vec,
                                              partial.data_ptr(), dw.data_ptr(), stream)
            _check(lib, err, "H-wgrad-mma")
            LAUNCHES["wgrad_mma"] += 1
            return dw
        err = lib.conv3d_wgrad_launch(x.data_ptr(), g.data_ptr(), ci, co, d, h, wd, plan.th,
                                      plan.tw, plan.co_tile // 8, plan.n_split,
                                      partial.data_ptr(), dw.data_ptr(), stream)
    _check(lib, err, "H-wgrad")
    LAUNCHES["wgrad"] += 1
    return dw
