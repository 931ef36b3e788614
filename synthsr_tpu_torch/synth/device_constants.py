"""The generator's host constants, built once on their device.

The synthesis ops take a few small host arrays on every call: blur sigmas,
the deformation's centre, the flip and GMM label LUTs, the reliability mask
of a downsampled channel, the bounds of a hyperparameter draw.  On a CUDA
device ``torch.as_tensor`` of a host array is a pageable copy followed by a
wait on the stream, and a CUDA graph cannot capture it.  :func:`constant` and
:func:`cached` build each such tensor once and keep it, keyed by what
determines it: its values, or the shapes a mask is built from.

The cache is shared by the process: an entry is a pure function of its key,
so every caller may read it, and none may write to it.  It keeps the
``MAX_ENTRIES`` most recently used entries.  A CUDA graph reads the entries
it was captured with by address, so it keeps them alive through
:func:`held`, whatever the cache drops.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

MAX_ENTRIES = 256

_cache: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_holders: list = []
_lock = threading.Lock()


def cached(key: tuple, build) -> torch.Tensor:
    """The tensor ``build()`` returned the first time ``key`` was asked for.
    ``key`` is hashable and names the device."""
    with _lock:
        t = _cache.get(key)
        if t is not None:
            _cache.move_to_end(key)
    if t is None:
        t = build()
        with _lock:
            _cache[key] = t
            while len(_cache) > MAX_ENTRIES:
                _cache.popitem(last=False)
    with _lock:
        for h in _holders:
            h.append(t)
    return t


def constant(value, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``: a tensor passes
    straight through, a host array or list is copied to ``device`` once per
    distinct value and dtype (as a numpy array: give ``dtype`` for a list of
    Python floats, which numpy reads as float64)."""
    if isinstance(value, torch.Tensor):
        return torch.as_tensor(value, dtype=dtype, device=device)
    arr = np.asarray(value)
    dev = torch.device("cpu" if device is None else device)
    key = ("constant", arr.dtype.str, arr.shape, arr.tobytes(), dtype, dev)
    return cached(key, lambda: torch.tensor(arr, dtype=dtype, device=dev))


@contextlib.contextmanager
def held():
    """Yields a list that keeps every entry handed out inside the block."""
    h: list = []
    with _lock:
        _holders.append(h)
    try:
        yield h
    finally:
        with _lock:
            _holders.remove(h)
