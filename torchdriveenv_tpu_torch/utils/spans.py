"""Spans and counters of the program's phases, recorded only while someone
looks: inside a ``torch.profiler`` session, or inside ``recording()``.

    with spans.span("env.core"):
        ...
    spans.count("envs_reset", done)

Off (the default) ``span`` returns one shared null context and ``count``
does nothing. On, a span
  - opens ``torch.profiler.record_function(name)`` under a profiler, so the
    trace shows it as a ``user_annotation`` on the device's clock;
  - appends a record to the log: its name, its parent's and its root's
    index, its host start and end (``time.perf_counter_ns``);
  - where CUDA is in use, records a timing event on the current stream at
    entry and at exit (none while the stream is being captured into a
    graph). An event record is no kernel, copy or memset.
A count keeps a reference to a tensor the program already computed (or a
number): it launches nothing and is summed when read. ``records()`` and ``counters()``
read the log, ``clear()`` empties it. The log holds ``MAX_RECORDS`` spans
and as many counts, and counts what it drops past that (``dropped()``).

Operators read a run's phases so::

    with spans.recording():
        ...                       # or any torch.profiler session
    for r in spans.records():
        print(r["name"], r["stream_ms"], r["self_stream_ms"])
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 65536

_NULL = contextlib.nullcontext()


class _Log:
    def __init__(self):
        self.recording = 0        # depth of open ``recording()`` blocks
        # [name, parent, root, host start ns, host end ns, stream, event
        # at entry, event at exit on that stream]
        self.spans: List[list] = []
        self.counts: List[tuple] = []
        self.open: List[int] = []   # the open spans' indices, outermost first
        self.dropped = 0
        # timing events that no record holds, by device
        self.free: Dict[int, list] = {}


_LOG = _Log()


def _event(stream):
    pool = _LOG.free.setdefault(stream.device_index, [])
    ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "rec", "fn")

    def __init__(self, name: str):
        self.name, self.rec, self.fn = name, None, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        log = _LOG
        if len(log.spans) >= MAX_RECORDS:
            log.dropped += 1
            return self
        i = len(log.spans)
        stream = None
        if (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            stream = torch.cuda.current_stream()
        self.rec = [self.name, log.open[-1] if log.open else -1,
                    log.open[0] if log.open else i, time.perf_counter_ns(),
                    None, stream, None if stream is None else _event(stream),
                    None]
        log.spans.append(self.rec)
        log.open.append(i)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if (rec[5] is not None
                    and not torch.cuda.is_current_stream_capturing()):
                rec[7] = _event(rec[5])
            rec[4] = time.perf_counter_ns()
            if _LOG.open:
                _LOG.open.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)


def span(name: str):
    """A context manager around one phase: the shared null context when
    off."""
    if not (_LOG.recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def count(name: str, tensor) -> None:
    """When on, add ``tensor``'s sum (read later; a number as it is) to the
    counter ``name``."""
    if not (_LOG.recording or _profiler._is_profiler_enabled):
        return
    if len(_LOG.counts) >= MAX_RECORDS:
        _LOG.dropped += 1
        return
    _LOG.counts.append((name, tensor))


def enabled() -> bool:
    """Whether spans and counts are recorded now."""
    return bool(_LOG.recording or _profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Spans and counts on inside the block, with or without a profiler."""
    _LOG.recording += 1
    try:
        yield
    finally:
        _LOG.recording -= 1


def _union_ms(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total, end = total + b - a, b
    return total


def records() -> List[dict]:
    """The log, oldest first, without clearing it. Each span's ``name``,
    ``parent`` and ``root`` (indices into the list; ``parent`` -1 for a
    root, a root is its own root), and on each clock (``host``,
    ``stream``): ``<clock>_start_ms`` and ``<clock>_end_ms`` from the log's
    first span, ``<clock>_ms`` (its duration) and ``self_<clock>_ms`` (the
    duration less the union of its children's). The stream clock is the
    device's timeline between the span's two events, idle included; its
    fields are None where the span recorded none, as are an open span's
    ends."""
    spans = _LOG.spans
    devs = {rec[5].device_index for rec in spans if rec[5] is not None}
    for dev in devs:
        torch.cuda.synchronize(dev)
    first_ev: Dict[int, object] = {}
    t0 = spans[0][3] if spans else 0
    out = []
    for name, parent, root, h0, h1, stream, e0, e1 in spans:
        r = {"name": name, "parent": parent, "root": root,
             "host_start_ms": (h0 - t0) * 1e-6,
             "host_end_ms": None if h1 is None else (h1 - t0) * 1e-6,
             "stream_start_ms": None, "stream_end_ms": None}
        if stream is not None:
            ref = first_ev.setdefault(stream.device_index, e0)
            r["stream_start_ms"] = ref.elapsed_time(e0)
            if e1 is not None:
                r["stream_end_ms"] = ref.elapsed_time(e1)
        out.append(r)
    children: Dict[int, List[int]] = {}
    for i, r in enumerate(out):
        children.setdefault(r["parent"], []).append(i)
    for i, r in enumerate(out):
        for c in ("host", "stream"):
            lo, hi = r[f"{c}_start_ms"], r[f"{c}_end_ms"]
            if lo is None or hi is None:
                r[f"{c}_ms"] = r[f"self_{c}_ms"] = None
                continue
            kids = [(out[k][f"{c}_start_ms"], out[k][f"{c}_end_ms"])
                    for k in children.get(i, ())]
            kids = [k for k in kids if None not in k]
            r[f"{c}_ms"] = hi - lo
            r[f"self_{c}_ms"] = hi - lo - _union_ms(kids, lo, hi)
    return out


def counters() -> Dict[str, float]:
    """Each counter's total over the log (a host read of every tensor)."""
    out: Dict[str, float] = {}
    for name, t in _LOG.counts:
        n = t.sum().item() if isinstance(t, torch.Tensor) else t
        out[name] = out.get(name, 0) + n
    return out


def dropped() -> int:
    """Spans and counts the full log left out."""
    return _LOG.dropped


def clear() -> None:
    """Empty the log (outside any span); its events go back to the pool."""
    for rec in _LOG.spans:
        for ev in rec[6:]:
            if ev is not None:
                _LOG.free[rec[5].device_index].append(ev)
    _LOG.spans, _LOG.counts, _LOG.open = [], [], []
    _LOG.dropped = 0
