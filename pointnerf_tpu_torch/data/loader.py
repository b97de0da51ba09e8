"""Background-thread prefetching over dataset items (copy of
`pointnerf_tpu/data/loader.py`).

The host work per step is numpy slicing of images decoded at init, so one
thread that builds the next step's batch while the device runs the current
one is enough (reference: data/__init__.py:47-88 uses DataLoader worker
processes instead).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class Prefetcher:
    """Runs `producer()` in a background thread, `depth` results ahead."""

    def __init__(self, producer: Callable[[], object], depth: int = 2):
        self.producer = producer
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                item = self.producer()
                while not self._stop.is_set():
                    try:
                        self.q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the next get()
            self._exc = e

    def get(self):
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self.q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._exc is None:
                    raise RuntimeError("prefetcher thread died")

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
