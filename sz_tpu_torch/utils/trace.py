"""Per-stage wall-clock spans and counters (the port's copy of
``sz_tpu.utils.trace``, with counters added).

    with trace("quantize"):
        ...
    count("fsm_steps", 20)
    print(last_spans(), last_counts())

Device spans in the port end with a synchronize inside the ``with``, so
they time the device work, not its enqueue.
"""

from __future__ import annotations

import contextlib
import time

_spans: list = []
_counts: dict = {}


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
    _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def trace(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _spans.append((name, time.perf_counter() - t0))
        if len(_spans) > 4096:
            del _spans[:2048]
