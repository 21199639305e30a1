"""One profiled epoch: device activity from ``torch.profiler`` (CUDA only),
host spans from the benchmark's own wrappers around the trainer's calls,
and what the per-layer readers and the breakdown take from them.

:func:`kernel_summary`'s arithmetic is a frozen copy of
``rankaae_tpu_torch/tools/profile_epoch.py::kernel_summary``: busy time is
the union of the device operations' intervals, idle share is 1 - busy /
wall, and every device operation counts as a launch.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

#: the trainer's calls the spans wrap, innermost last
SPANNED = ("_train_batch", "_adversarial_step", "_correlation_step", "_reconstruction_step",
           "_mutual_info_step", "_smoothness_step", "_validate")


class Spans:
    """Host spans (name, start ns, end ns, depth) on the clock the profiler
    stamps its events with (``time.time_ns``), around the trainer's calls
    of :data:`SPANNED`, installed on one trainer object and removed by
    :meth:`remove`."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.spans: List[Tuple[str, int, int, int]] = []
        self.depth = 0
        self.batch = 0
        for name in SPANNED:
            setattr(trainer, name, self._wrap(name, getattr(trainer, name)))

    def _wrap(self, name, call):
        label = name.strip("_").replace("_step", "")

        def wrapped(*args, **kw):
            if name == "_train_batch":
                self.batch += 1
            tag = f"batch{self.batch}" if name == "_train_batch" else label
            self.depth += 1
            t0 = time.time_ns()
            try:
                return call(*args, **kw)
            finally:
                self.spans.append((tag, t0, time.time_ns(), self.depth))
                self.depth -= 1
        return wrapped

    def remove(self):
        for name in SPANNED:
            self.trainer.__dict__.pop(name, None)

    def label(self, t_ns: int) -> str:
        """The path of the spans open at ``t_ns``, outermost first."""
        open_ = sorted((d, n) for n, a, b, d in self.spans if a <= t_ns < b)
        return "/".join(n for _, n in open_) or "epoch"


def profile_epoch(run_epoch, trainer):
    """Run ``run_epoch()`` (one epoch ending in a device sync) under the
    profiler with the spans installed; returns the profile's device events,
    the spans and the epoch's wall seconds."""
    spans = Spans(trainer)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0_ns = time.time_ns()
            run_epoch()
            t1_ns = time.time_ns()
    finally:
        spans.remove()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            events.append((evt.name, evt.time_range.start, evt.time_range.end))
    return Profile(events, spans, start_ns, t0_ns, t1_ns)


class Profile:
    """A profiled epoch: device events (name, start us, end us) relative to
    the trace's start, the host spans, and the epoch's host interval."""

    def __init__(self, events, spans: Spans, start_ns, t0_ns, t1_ns):
        self.events, self.spans = events, spans
        self.start_ns, self.t0_ns, self.t1_ns = start_ns, t0_ns, t1_ns
        self.wall_ms = (t1_ns - t0_ns) / 1e6
        self.summary = kernel_summary(events, self.wall_ms)

    def idle_by_span(self, top: int = 10):
        """The device's idle time inside the epoch summed by the host span
        its middle falls in, longest first: [[span, seconds], ...]."""
        lo = (self.t0_ns - self.start_ns) / 1e3
        hi = (self.t1_ns - self.start_ns) / 1e3
        idle = defaultdict(float)
        end = lo
        for a, b in self.summary["intervals"] + [(hi, hi)]:
            if a > end:
                mid_ns = self.start_ns + int((end + a) / 2 * 1e3)
                idle[self.spans.label(mid_ns)] += (min(a, hi) - end) / 1e6
            end = max(end, b)
        return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]

    def device_ops(self, top: int = 10):
        """The device operations that took most time: [[name, seconds], ...],
        each name cut to its first 160 characters."""
        ranked = sorted(self.summary["per_kernel"].items(), key=lambda kv: -kv[1][1])
        return [[name[:160], ms / 1e3] for name, (_, ms) in ranked[:top]]


def kernel_summary(events, wall_ms: float) -> Dict:
    """Per operation name its count and summed device ms, the merged busy
    intervals, the busy ms, the idle share and the launches of a window of
    ``wall_ms``."""
    per_kernel = defaultdict(lambda: [0, 0.0])
    spans = []
    for name, a, b in events:
        per_kernel[name][0] += 1
        per_kernel[name][1] += (b - a) / 1e3
        spans.append((a, b))
    busy_us, end = 0.0, float("-inf")
    merged = []
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
            end = b
    return {
        "per_kernel": dict(per_kernel),
        "intervals": merged,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms if wall_ms else None,
        "kernel_launches": sum(n for n, _ in per_kernel.values()),
    }
