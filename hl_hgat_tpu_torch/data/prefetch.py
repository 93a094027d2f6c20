"""Background batch prefetch (``hl_hgat_tpu/data/prefetch.py``).

PyG's ``DataLoader(num_workers=N)`` (reference main_zinc...py:223-225)
overlaps collate with the training step through worker processes.  One
daemon thread does it here: the native packed collate releases the
interpreter lock inside its C calls, so batch k+1 is collated while the
interpreter dispatches step k, and the card runs asynchronously under both.

    for batch in prefetch(loader, depth=2):
        trainer.train_step(batch)

``depth`` bounds the queue: at most ``depth`` collated batches wait ahead
of the consumer.  An exception in the producer is raised again at the
consumer's next ``__next__``.  When the consumer stops early (it raised,
or closed the generator), the producer stops at its next item and the
queued batches are dropped.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()


def prefetch(batches: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``batches`` on a daemon thread, ``depth`` items ahead;
    ``depth <= 0`` passes them through on the caller's thread."""
    if depth <= 0:
        yield from batches
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has stopped; False once it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for item in batches:
                if not put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 - relayed to the consumer
            put((_END, exc))
            return
        put((_END, None))

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # free the queued batches
            q.get_nowait()
