"""Background-thread prefetch for host-side data iterators (counterpart of
``ldiffusion_tpu/data/prefetch.py``): one daemon thread and a small queue
overlap patch sampling and host spatial augmentation with the device's step.
An exception in the producer re-raises in the consumer instead of hanging."""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

DEPTH = 2  # batches held ready ahead of the consumer


class _Stop:
    pass


class Prefetcher:
    def __init__(self, iterator: Iterator):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._exc: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._done.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # handed to the consumer
            self._exc = e
        finally:
            self._q.put(_Stop())

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Stop):
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._done.set()
        try:  # drain so that the producer unblocks
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
