"""Shared three-stage directory-mode pipeline for the predict CLIs: the
port's own copy of ``synthsr_tpu/cli/_pipeline.py``.

The reference batch loops (``scripts/predict_command_line.py:109-138``,
``scripts/predict_command_line_hyperfine.py:95-135``) are fully serial:
gzip-inflate, predict, gzip-deflate, repeat — the accelerator idles through
both gzip passes.  Both CLIs here run the same pipeline instead: a loader
thread keeps ``prefetch`` volumes decoded ahead (``PrefetchIterator``) and a
writer thread compresses/saves behind, so the device-side predict stream
never waits on host NIfTI codec work.  Output files and values are identical
to the serial loop (same order, same writer).

Error semantics: a writer failure fails the batch FAST (the predict loop
stops before the next volume instead of predicting the whole directory
first), and is never masked by a concurrent predict/loader failure — if both
happen the predict error propagates with the save error chained as its
``__cause__``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence

from ..io.volume import save_volume
from ..utils.prefetch import PrefetchIterator


def run_pipelined(loads: Iterator, predict_fn: Callable, outs: Sequence[str],
                  prefetch: int = 2, verbose: bool = False,
                  describe: Callable[[int], str] | None = None):
    """Drive ``predict_fn`` over decoded inputs with threaded load/save.

    ``loads``: iterator yielding decoded inputs (one per output path) —
    consumed through a ``PrefetchIterator`` so decoding runs ahead.
    ``predict_fn(item) -> (pred, aff)``: the device-side predict.
    ``outs``: output paths, saved via ``io.volume.save_volume``.
    ``describe(idx)``: optional per-item label printed when ``verbose``.
    """
    loaded = PrefetchIterator(iter(loads), buffer_size=prefetch)
    save_q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    save_errors: list[Exception] = []

    def writer():
        while True:
            item = save_q.get()
            if item is None:
                return
            pred, aff, pout = item
            try:
                save_volume(pred, aff, None, pout)
            except Exception as e:  # surfaced in the predict loop / at exit
                save_errors.append(e)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for idx, (item, pout) in enumerate(zip(loaded, outs)):
            if save_errors:  # fail fast — don't predict the rest of the batch
                break
            if verbose:
                print(f"  Working on image {idx + 1}")
                if describe is not None:
                    print("  " + describe(idx))
            pred, aff = predict_fn(item)
            save_q.put((pred, aff, pout))
    except BaseException as e:
        if save_errors:
            raise e from save_errors[0]
        raise
    finally:
        save_q.put(None)
        t.join()
        loaded.close()
    if save_errors:
        raise save_errors[0]
