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
- ``activation``: None, "elu" (``exp(x) - 1`` below zero, as on the TPU) or
  "relu";
- ``post``: an optional (2, C_out) per-channel (scale, shift) applied after
  the activation (inference BatchNorm folded in);
- ``head``: an optional (a (C_out,), b scalar): the 1x1x1 likelihood conv
  folded in after ``post``.

Dispatch, with no fallback: a CPU tensor goes to :func:`conv3d_cf_reference`
(plain PyTorch); a CUDA tensor launches **H-first** (one source, C_in <= 2, no
``accum``, no ``head``; replaces K1) or **H-fwd** (everything else; replaces
K2, K3 and K4) from ``csrc/conv3d_cf.cu``; any other device raises.

``conv3d_cf_wgrad(x, g)`` is the training backward's weight gradient,
``dw[dz, dy, dx, ci, co] = sum x[ci, z+dz-1, h+dy-1, w+dx-1] g[co, z, h, w]``
(zero padding), (3, 3, 3, ci, co) float32, with ``g`` rounded to ``x.dtype``
first as K6 does (conv_pallas.py:1230).  The same dispatch: the plain
:func:`conv3d_cf_wgrad_reference` on a CPU tensor, **H-wgrad** from
``csrc/conv3d_wgrad.cu`` (replaces K6 and K7) on a CUDA tensor.

``LAUNCHES`` counts kernel launches per kernel, and nothing else.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import cuda_build

LAUNCHES = {"first": 0, "fwd": 0, "wgrad": 0}

FWD_CHUNK = 8  # input channels per H-fwd chunk (FWD_CK in csrc/conv3d_cf.cu)
WGRAD_CHUNK = 8  # input channels per H-wgrad block (WG_CK in csrc/conv3d_wgrad.cu)
WGRAD_MAX_TILE = 128  # voxels per H-wgrad tile (WG_MAXVOX)
_ACT_CODES = {None: 0, "elu": 1, "relu": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def build_kernels() -> float:
    """Build (if needed) and load the kernels; returns the compile seconds
    (0.0 when an earlier build of the same sources was reused)."""
    global _lib
    path, seconds = cuda_build.build()
    lib = cuda_build.load(path)
    if lib.conv3d_fwd_chunk() != FWD_CHUNK:
        raise RuntimeError("csrc/conv3d_cf.cu and conv_cf.FWD_CHUNK disagree")
    if (lib.conv3d_wgrad_chunk(), lib.conv3d_wgrad_max_tile()) != (WGRAD_CHUNK, WGRAD_MAX_TILE):
        raise RuntimeError("csrc/conv3d_wgrad.cu and conv_cf.WGRAD_* disagree")
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


@dataclass(frozen=True)
class PackedConv:
    """A conv weight made ready once for both paths.

    ``w``: DHWIO float32, values rounded to ``dtype`` (the plain version's
    operand).  ``packed``: (cin_pad, 27, cout_pad) float32, zero-padded to the
    kernels' channel chunk and cout tile (the kernels' operand)."""
    w: torch.Tensor
    packed: torch.Tensor
    dtype: torch.dtype
    ng: int

    @property
    def cin(self) -> int:
        return self.w.shape[3]

    @property
    def cout(self) -> int:
        return self.w.shape[4]


def pack_conv(w: torch.Tensor, dtype: torch.dtype) -> PackedConv:
    """Round a DHWIO 3³ kernel to ``dtype`` and arrange it for the kernels,
    on the weight's own device."""
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"expected a (3, 3, 3, cin, cout) kernel, got {tuple(w.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype}")
    cin, cout = w.shape[3], w.shape[4]
    wr = w.detach().to(dtype).to(torch.float32).contiguous()
    ng = cout_groups(cout)
    cin_pad = -(-cin // FWD_CHUNK) * FWD_CHUNK
    cout_pad = -(-cout // (8 * ng)) * (8 * ng)
    packed = torch.zeros((cin_pad, 27, cout_pad), dtype=torch.float32, device=w.device)
    packed[:cin, :, :cout] = wr.reshape(27, cin, cout).permute(1, 0, 2)
    return PackedConv(wr, packed, dtype, ng)


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


def _launch(srcs, w, bias, activation, post, head, accum):
    dtype = srcs[0].dtype
    dev = srcs[0].device
    pc = w if isinstance(w, PackedConv) else pack_conv(w.to(dev), dtype)
    if pc.dtype != dtype:
        raise ValueError(f"weights packed for {pc.dtype}, activations are {dtype}")
    if pc.packed.device != dev:
        raise ValueError(f"weights on {pc.packed.device}, activations on {dev}")
    cins = [s.shape[0] for s in srcs]
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
        bf16 = int(dtype == torch.bfloat16)
        act = _ACT_CODES[activation]
        cout_pad = pc.packed.shape[2]
        if len(srcs) == 1 and cin <= 2 and accum is None and head is None:
            out = torch.empty((cout, d, h, wd), dtype=dtype, device=dev)
            err = lib.conv3d_first_launch(
                ptr(srcs[0]), cin, d, h, wd, ptr(pc.packed), cout, cout_pad,
                ptr(b), ptr(p), act, bf16, ptr(out), stream)
            _check(lib, err, "H-first")
            LAUNCHES["first"] += 1
            return out
        if head is not None:
            out = torch.empty((1, d, h, wd), dtype=torch.float32, device=dev)
        else:
            out = torch.empty((cout, d, h, wd), dtype=dtype, device=dev)
        src1 = srcs[1] if len(srcs) == 2 else None
        err = lib.conv3d_fwd_launch(
            ptr(srcs[0]), cins[0], ptr(src1), cins[1] if src1 is not None else 0,
            d, h, wd, ptr(pc.packed), cout, cout_pad, pc.ng, ptr(b), ptr(accum),
            ptr(p), ptr(hd), act, bf16, ptr(out), stream)
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


def wgrad_plan(ci: int, co: int, d: int, h: int, w: int, n_sm: int):
    """H-wgrad's launch shape: (th, tw, ng, n_split).

    Tiles of th x tw <= WGRAD_MAX_TILE voxels, 8 <= tw <= 32; ``ng`` groups of
    8 output channels per block (:func:`cout_groups`); the volume's
    (z-plane, tile) items are split over ``n_split`` blocks per (ci chunk,
    co tile) so that about eight blocks per SM are launched (registers and
    shared memory hold six 72-thread blocks per SM; two per SM left the card
    at 6 TFLOP/s)."""
    tw = min(32, max(8, _pow2_ceil(w)))
    th = max(1, min(WGRAD_MAX_TILE // tw, _pow2_ceil(h)))
    ng = cout_groups(co)
    items = d * -(-w // tw) * -(-h // th)
    pairs = -(-ci // WGRAD_CHUNK) * -(-co // (8 * ng))
    n_split = max(1, min(items, -(-8 * n_sm // pairs)))
    return th, tw, ng, n_split


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
    th, tw, ng, n_split = wgrad_plan(ci, co, d, h, wd,
                                     torch.cuda.get_device_properties(dev).multi_processor_count)
    ci_pad = -(-ci // WGRAD_CHUNK) * WGRAD_CHUNK
    co_pad = -(-co // (8 * ng)) * (8 * ng)
    partial = torch.empty((n_split, 27, ci_pad, co_pad), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.conv3d_wgrad_launch(x.data_ptr(), g.data_ptr(), ci, co, d, h, wd, th, tw, ng,
                                      n_split, partial.data_ptr(), dw.data_ptr(),
                                      int(x.dtype == torch.bfloat16), stream)
    _check(lib, err, "H-wgrad")
    LAUNCHES["wgrad"] += 1
    return dw
