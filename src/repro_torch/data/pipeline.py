"""Host-side input pipeline (the port of ``repro/data/pipeline.py``):
background prefetch with a bounded queue.

The paper preloads datasets before measuring ("the generation of on-the-fly
randomized data proved exceptionally slow"): ``Preloader`` does that.
``Prefetcher`` is the training driver's path: a daemon thread keeps up to
``depth`` batches ready, so the host does not starve the device stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class Prefetcher:
    """Wrap an iterator with a daemon thread and a bounded queue; an error
    raised by the iterator is raised again by ``next`` once the items
    before it are consumed."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class Preloader:
    """Materialise n batches up front (the paper's measurement protocol)."""

    def __init__(self, make: Callable[[int], object], n: int):
        self.batches = [make(i) for i in range(n)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)
