"""Background batch prefetching: overlap host data work with device compute.

Own copy of ``k8s_distributed_deeplearning_tpu/train/prefetch.py``. The
reference's input path is synchronous: ``feed_dict`` copies the next numpy
batch to the device inside the step loop (``tensorflow_mnist.py:165-171``),
serializing host batch assembly with device execution. Here a daemon
thread runs the host-side batch iterator and the device placement
(``parallel.data_parallel.to_device``) ``depth`` steps ahead, so when the
train loop asks for batch N+1 its copy was issued while the card computed
step N.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

PyTree = Any

_SENTINEL = object()


class Prefetcher:
    """Iterator wrapper: pulls from *source*, applies *place_fn* (e.g.
    ``to_device``), and keeps up to *depth* placed batches queued.

    Exceptions in the worker propagate to the consumer on the next
    ``__next__``. Always ``close()`` (or exhaust) to stop the thread; usable
    as a context manager.
    """

    def __init__(self, source: Iterator[PyTree],
                 place_fn: Callable[[PyTree], PyTree] | None = None,
                 depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._source = source
        self._place = place_fn or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                placed = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(placed, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:          # noqa: BLE001 — must surface
            self._error = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> PyTree:
        item = self._q.get()
        if item is _SENTINEL:
            # Re-queue the sentinel so the terminal state stays observable:
            # a second next() after exhaustion/error/close must raise again,
            # not block forever on an empty queue with a dead worker.
            try:
                self._q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        # Idempotent: close() is called from both normal teardown and
        # finally-block cleanup (close_all), so a second call must be a
        # no-op — re-draining would steal the sentinel a concurrent
        # consumer is about to observe, and there is no worker left to
        # wake or join.
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # Drain so a blocked put wakes up and the thread can exit.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        # Drain AGAIN after the join: a worker blocked mid-put may have
        # landed one more item in the freed slot before observing stop —
        # without this second drain the sentinel put below can hit Full and
        # a post-close next() would return a stale batch then hang.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        try:
            self._q.put_nowait(_SENTINEL)   # post-close next() raises, no hang
        except queue.Full:
            pass

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def maybe(source: Iterator[PyTree],
          place_fn: Callable[[PyTree], PyTree],
          depth: int,
          registry: list | None = None) -> Iterator[PyTree]:
    """Shared CLI wiring: threaded prefetch when ``depth > 0``, else a plain
    mapping generator. Threaded instances are appended to *registry* so the
    caller can ``close_all(registry)`` in a finally block (a leaked worker
    keeps device batches pinned)."""
    if depth > 0:
        p = Prefetcher(source, place_fn=place_fn, depth=depth)
        if registry is not None:
            registry.append(p)
        return p
    return (place_fn(b) for b in source)


def close_all(registry: list) -> None:
    for p in registry:
        p.close()
    registry.clear()
