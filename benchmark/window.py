"""The window's arithmetic: every end-to-end rate is all the work of the
window over all of its time, every tail is over all of its samples. And
the window's quiet: no garbage collection inside it."""

from __future__ import annotations

import contextlib
import gc
import math
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value with at
    least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def intervals_ms(event_ms: Sequence[float]) -> list:
    """Gaps between consecutive event times (ms): one per step, the first
    event being the window's start."""
    return [b - a for a, b in zip(event_ms, event_ms[1:])]


@contextlib.contextmanager
def no_gc():
    """Set-up's objects collected and frozen before the window, the
    collector off inside it and back on after."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
