"""Background data prefetching (a copy of `metamorph_tpu/train/prefetch.py`):
overlap host-side packing/decoding with device compute on a thread with a
bounded queue."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional


class Prefetcher:
    """Wrap an iterator; pull items on a background thread into a bounded
    queue, optionally transforming them on the worker."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
