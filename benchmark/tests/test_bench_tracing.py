"""The readers of the program's spans and counters: nothing to read gives
None, and a synthetic span list and profile give the sums by hand; on a
CUDA device (marked ``chip``) a traced run reports each of them."""
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import Profile
from rankaae_tpu_torch.utils import tracing
from rankaae_tpu_torch.utils.tracing import Span

READERS = ("optimizer_ms_per_epoch", "sampler_ms_per_epoch", "host_loop_idle_ms_per_epoch",
           "trainer_setup_s", "kernel_load_s")
START = 1_700_000_000_000_000_000      # the trace's start, ns on the host clock


def us(t):
    """``t`` us after the trace's start, in host ns."""
    return START + int(t * 1000)


def synthetic():
    """An older epoch, then the newest: its updates at 120-200 and 500-650
    us (0.5 and 1.0 device ms), a draw at 380-450 us (0.25 ms) inside a
    batch, a backward at 90-140 us; the device busy at 0-100, 150-400
    (two touching events) and 600-900 us of the 0-1000 us window."""
    spans = [Span("epoch", -1, us(-900), us(-100), 50.0),
             Span("update", 0, us(-800), us(-200), 40.0),
             Span("epoch", -1, us(0), us(1000), 9.0),
             Span("batch", 2, us(10), us(700), 6.0),
             Span("backward", 3, us(90), us(140), 0.75),
             Span("update", 3, us(120), us(200), 0.5),
             Span("draw.z_real", 3, us(380), us(450), 0.25),
             Span("update", 3, us(500), us(650), 1.0)]
    events = [("k", 0.0, 100.0), ("k", 150.0, 300.0), ("k", 300.0, 400.0), ("k", 600.0, 900.0)]
    return spans, Profile(events, None, START, us(0), us(1000))


def test_readers_read_nothing_without_spans_or_counters(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: {})
    _, profile = synthetic()
    for run in (SimpleNamespace(profile=None), SimpleNamespace(profile=profile)):
        for name in READERS:
            assert harness.reader(name)(run) is None, name


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """As on a parent commit without ``utils/tracing.py``: no reader raises."""
    import rankaae_tpu_torch.utils

    monkeypatch.delattr(rankaae_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "rankaae_tpu_torch.utils.tracing", None)
    _, profile = synthetic()
    for name in READERS:
        assert harness.reader(name)(SimpleNamespace(profile=profile)) is None, name


def test_readers_sum_a_synthetic_epoch(monkeypatch):
    spans, profile = synthetic()
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"setup.trainer_s": 1.5, "setup.kernel_load_s": 0.25})
    run = SimpleNamespace(profile=profile)
    assert harness.reader("optimizer_ms_per_epoch")(run) == 1.5
    assert harness.reader("sampler_ms_per_epoch")(run) == 0.25
    # idle 100-150, 400-600 and 900-1000 us; under the updates and the
    # draw: 120-150, 400-450 and 500-600 us
    assert harness.reader("host_loop_idle_ms_per_epoch")(run) == pytest.approx(0.18)
    assert harness.reader("trainer_setup_s")(run) == 1.5
    assert harness.reader("kernel_load_s")(run) == 0.25


def test_device_times_missing_read_nothing(monkeypatch):
    spans, profile = synthetic()
    spans = [s._replace(device_ms=None) for s in spans]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    run = SimpleNamespace(profile=profile)
    assert harness.reader("optimizer_ms_per_epoch")(run) is None
    assert harness.reader("sampler_ms_per_epoch")(run) is None
    assert harness.reader("host_loop_idle_ms_per_epoch")(run) == pytest.approx(0.18)


@pytest.mark.chip
def test_traced_run_reports_the_program_metrics(cuda):
    r = harness.run("compact-train-t256", 2**31 + 77, 1.0, True, time.perf_counter())
    for name in READERS:
        assert isinstance(r["metrics"][name]["value"], float), name
    ms = r["metrics"]
    assert ms["optimizer_ms_per_epoch"]["value"] + ms["sampler_ms_per_epoch"]["value"] <= \
        r["device"]["window_s"] * 1e3
    assert r["correct"]
