"""Background prefetching for host input pipelines: the port's own copy of
``synthsr_tpu/utils/prefetch.py``.

The reference's training loop is starved by design: a synchronous python
generator loads + reorients a NIfTI label map on the host before every step
(``SynthSR/model_inputs.py:77-139`` feeding fit_generator).  Here the host
pipeline runs in daemon threads ahead of the device, so generation/training
steps never wait on gzip decompression.
"""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Wrap an iterator; ``n_workers`` threads keep ``buffer_size`` items ready.

    With n_workers > 1 the upstream iterator is still consumed under a lock
    (safe for generators), only the per-item work overlaps.  Exceptions are
    re-raised in the consumer.
    """

    _SENTINEL = object()

    def __init__(self, iterator, buffer_size: int = 4, n_workers: int = 1):
        self._it = iterator
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(n_workers)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                with self._lock:
                    item = next(self._it)
            except StopIteration:
                self._q.put(self._SENTINEL)
                return
            except Exception as e:  # propagate to consumer
                self._q.put(e)
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
