"""Bounded background-thread prefetch for host-side iterators.

The ctypes parsing core releases the GIL while C code runs, so a producer
thread genuinely overlaps data.json parsing/packing with device compute and
CSV writing.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def threaded_iter(source: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Iterate ``source`` on a daemon thread, buffering up to ``depth`` items.

    Exceptions from the producer are re-raised at the consumer.  If the
    consumer abandons iteration (exception, early ``break``, generator
    close), the producer is cancelled instead of blocking forever on the
    full queue holding multi-MB batches.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    error = []
    cancelled = threading.Event()

    def produce():
        try:
            for item in source:
                while not cancelled.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
        except BaseException as exc:  # re-raised on the consumer side
            error.append(exc)
        finally:
            while not cancelled.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        cancelled.set()
