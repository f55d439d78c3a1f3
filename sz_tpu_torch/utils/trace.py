"""Per-stage wall-clock spans and counters (the port's copy of
``sz_tpu.utils.trace``, with counters added).

    with trace("quantize"):
        ...
    count("fsm_scans", 1)
    print(last_spans(), last_counts())

Device spans in the port end with a synchronize inside the ``with``, so
they time the device work, not its enqueue.  The record is one for the
process: spans of slabs compressed in several threads at once interleave
in it (the sharded codec records its own ``slabs`` span around them).
"""

from __future__ import annotations

import contextlib
import threading
import time

_spans: list = []
_counts: dict = {}
_lock = threading.Lock()


def reset() -> None:
    _spans.clear()
    _counts.clear()


def last_spans() -> list:
    """[(name, seconds), ...] since the last reset()."""
    return list(_spans)


def last_counts() -> dict:
    """{name: total} of the counts since the last reset()."""
    return dict(_counts)


def count(name: str, n: int) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def trace(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _lock:
            _spans.append((name, time.perf_counter() - t0))
            if len(_spans) > 4096:
                del _spans[:2048]
