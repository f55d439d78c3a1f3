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
SZ_TPU_TRACE set to anything but "" or "0" also prints each span to
stderr as it closes, as ``sz_tpu`` does; :func:`enable` overrides it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

_enabled = None   # None: follow SZ_TPU_TRACE
_spans: list = []
_counts: dict = {}
_lock = threading.Lock()


def enable(on: bool | None = True) -> None:
    """Print spans (True), or not (False), whatever SZ_TPU_TRACE says;
    None follows it again."""
    global _enabled
    _enabled = on


def printing() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get("SZ_TPU_TRACE", "") not in ("", "0")


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
        dt = time.perf_counter() - t0
        with _lock:
            _spans.append((name, dt))
            if len(_spans) > 4096:
                del _spans[:2048]
        if printing():
            print(f"[sz_tpu_torch {name}: {dt * 1e3:.1f} ms]",
                  file=sys.stderr, flush=True)
