"""Background-prefetch input pipeline.

The port's copy of ``dualdiff_tpu/data/prefetch.py`` (standard library
only).  It covers the role of the reference's DataLoader worker processes
(``num_workers`` + ``prefetch_factor``): sample fetch, rasterisation and
collate run on a thread pool while the device runs the current step, and
finished batches come back in input order.  Threads, not processes: the
numpy and OpenCV work releases the GIL, and a batch built on a worker
thread can be copied to the card there.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")

__all__ = ["prefetch_map"]


def prefetch_map(fn: Callable[[T], R], items: Iterable[T],
                 num_workers: int = 1, depth: int = 2) -> Iterator[R]:
    """Ordered parallel ``map`` with bounded lookahead.

    Up to ``depth`` results are in flight or buffered beyond the one being
    consumed; results arrive in input order (deterministic batch order).
    ``num_workers <= 0`` degrades to the serial path.
    """
    if num_workers <= 0:
        for item in items:
            yield fn(item)
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        q: collections.deque = collections.deque()
        it = iter(items)
        exhausted = False
        for _ in range(max(1, depth)):
            try:
                q.append(ex.submit(fn, next(it)))
            except StopIteration:
                exhausted = True
                break
        while q:
            fut = q.popleft()
            if not exhausted:
                try:
                    q.append(ex.submit(fn, next(it)))
                except StopIteration:
                    exhausted = True
            yield fut.result()
