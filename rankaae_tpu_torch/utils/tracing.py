"""Spans and counters inside the program, on the clock the device trace is
stamped with.

A span marks one piece of work at a layer boundary where it happens: the
epoch, a batch, an optimizer's step, its backward and its update, a random
draw, the validation (``PERF.md`` §3 names each one and the metric that
reads it).  :func:`span` is a context manager and :func:`spanned` the same
around a whole function.  Tracing is on while a ``torch.profiler`` session
is active in the process, or between :func:`enable` and :func:`disable`.
When it is off, :func:`span` returns one shared object that does nothing:
the cost is a flag check, with no allocation, no clock read and no device
call.  When it is on, a span records its name, its parent (the index in
the buffer of the span open around it, -1 for none), its host start and
end on ``time.time_ns()`` (the clock the profiler stamps its events with:
an event's offset from :func:`trace_start_ns` puts both on one clock) and,
where CUDA is in use, a pair of timing events recorded on the current
stream at entry and at exit.  The events are resolved only when the spans
are read (:func:`spans`, which syncs the device first) into each span's
device-stream milliseconds: the stream's time from the span's first
operation to its last, any idle time between them included.  Spans are
kept in memory until :func:`reset`.

Counters (:func:`count`) are always on: one add each, process totals.

Nothing here emits a ``record_function`` or an NVTX range: either may put
annotation events on the device row of a profile, where they would count
as launches and as busy time.  One thread opens spans (the trainer's); the
buffer is not shared across threads.
"""
from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    parent: int                     # index of the enclosing span in spans(), -1 for a root
    start_ns: int                   # host clock, time.time_ns()
    end_ns: Optional[int]           # None while the span is open
    device_ms: Optional[float]      # the current stream's ms, None without CUDA


_enabled = False
#: one list per span: name, parent, start ns, end ns, start event, end event, device ms
_buffer: List[list] = []
#: indices of the open spans, innermost last
_open: List[int] = []
_counters: Dict[str, float] = {}


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def active() -> bool:
    """Whether spans record: :func:`enable` is in force or a profiler runs."""
    return _enabled or _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rec", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self.rec = [self.name, _open[-1] if _open else -1, 0, None, None, None, None]
        if torch.cuda.is_initialized():
            rec[4] = torch.cuda.Event(enable_timing=True)
            rec[4].record()
        rec[2] = time.time_ns()
        self.index = len(_buffer)
        _buffer.append(rec)
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[3] = time.time_ns()
        if rec[4] is not None:
            rec[5] = torch.cuda.Event(enable_timing=True)
            rec[5].record()
        if _open and _open[-1] == self.index:
            _open.pop()
        return False


def span(name: str, sub: Optional[str] = None):
    """A span named ``name`` (``name.sub`` where ``sub`` is given, joined
    only when tracing is on), or the shared no-op when it is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _On(name if sub is None else f"{name}.{sub}")


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not (_enabled or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def timed(name: str):
    """Decorate a function so that each call adds its seconds to the
    counter ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                count(name, time.perf_counter() - t0)
        return counted
    return wrap


def spans() -> List[Span]:
    """Every span recorded since :func:`reset`, in the order they opened;
    CUDA events are resolved first (one device sync)."""
    pending = [rec for rec in _buffer if rec[5] is not None]
    if pending:
        torch.cuda.synchronize()
        for rec in pending:
            rec[6] = rec[4].elapsed_time(rec[5])
            rec[4] = rec[5] = None
    return [Span(*rec[:4], rec[6]) for rec in _buffer]


def reset() -> None:
    """Empty the span buffer (the counters stay)."""
    _buffer.clear()
    _open.clear()


def count(name: str, n: float = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, float]:
    """Every counter's process total."""
    return dict(_counters)


def counter(name: str) -> float:
    """One counter's process total (0 where it never counted)."""
    return _counters.get(name, 0)


def reset_counters(*names: str) -> None:
    """Zero the counters ``names`` (every counter where none is given)."""
    for name in names or list(_counters):
        _counters.pop(name, None)


def newest(all_spans: List[Span], name: str) -> List[Span]:
    """The newest closed span called ``name`` and every span inside it (a
    span's descendants follow it in the buffer), their parents indexed
    within that list; empty where there is none."""
    for root in range(len(all_spans) - 1, -1, -1):
        if all_spans[root].name == name and all_spans[root].end_ns is not None:
            at = {root: 0}
            for i in range(root + 1, len(all_spans)):
                if all_spans[i].parent not in at:
                    break
                at[i] = len(at)
            return [all_spans[i]._replace(parent=at.get(all_spans[i].parent, -1)) for i in at]
    return []


def self_ns(all_spans: List[Span]) -> List[int]:
    """Each closed span's self time in ns: its host duration less the part
    of it that its children cover (children run one after another)."""
    out = [0 if s.end_ns is None else s.end_ns - s.start_ns for s in all_spans]
    for s in all_spans:
        if s.parent >= 0 and s.end_ns is not None:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def totals(all_spans: List[Span]) -> Dict[str, dict]:
    """Per span name: count, host ms, self ms and device-stream ms (None
    without CUDA events), over the closed spans."""
    out = defaultdict(lambda: {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None})
    for s, own in zip(all_spans, self_ns(all_spans)):
        if s.end_ns is None:
            continue
        t = out[s.name]
        t["count"] += 1
        t["host_ms"] += (s.end_ns - s.start_ns) / 1e6
        t["self_ms"] += own / 1e6
        if s.device_ms is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + s.device_ms
    return dict(out)


def trace_start_ns(prof) -> int:
    """The ``time.time_ns()`` at which a ``torch.profiler.profile``'s trace
    starts: its events' times are microseconds after it."""
    return prof.profiler.kineto_results.trace_start_ns()


def report(start_ns: Optional[int] = None) -> dict:
    """Every span (name, parent, host start and end ns, device ms), every
    counter and the totals per span name, as one JSON-ready dict;
    ``start_ns`` (:func:`trace_start_ns` of the profile the spans ran
    under) is written beside them."""
    all_spans = spans()
    return {"clock": "time.time_ns", "trace_start_ns": start_ns,
            "spans": [s._asdict() for s in all_spans], "counters": counters(),
            "totals": totals(all_spans)}
