"""The port's tracer (``rankaae_tpu_torch/utils/tracing.py``) on the CPU.

* Off, :func:`span` is one shared no-op and records nothing; counters count.
* On, nested spans record their parents, and a span's self time is its
  duration less its children's.
* Under ``torch.profiler`` tracing is on by itself, and a span's host
  interval holds the profiler's event for an ``aten::mm`` run inside it,
  once both are on one clock through the trace's start (the clock the
  benchmark's ``host_loop_idle_ms_per_epoch`` relies on).
* A tiny faithful epoch (FC form, 2 trials, 3 batches, dropout and the
  discriminator's noise on, so every draw site runs) gives the span tree
  the benchmark's readers and ``PERF.md`` rely on, and the same log and
  weights, bit for bit, with tracing on and off.
* ``train_sc --profile-dir`` writes ``spans.json`` beside its trace.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes, make_synthetic_xanes_csv
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
from rankaae_tpu_torch.utils import tracing
from rankaae_tpu_torch.utils.config import TrainConfig
from tests import torch_parity  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, N_TRAIN, N_VAL = 2, 32, 70, 20
CFG = {
    "max_epoch": 10, "batch_size": B, "gradient_reversal": True,
    "alpha_flat_step": 739, "alpha_limit": 0.7172, "decoder_activation": "Softplus",
    "dis_beta": 1.1, "dis_dropout_rate": 0.1, "dis_noise": 0.1, "gen_beta": 1.1,
    "n_aux": 5, "nstyle": 6, "ae_form": "FC", "dim_in": 256, "dim_out": 256,
    "n_layers": 3, "FC_discriminator_layers": 3, "use_cnn_discriminator": False,
    "dropout_rate": 0.1, "sch_factor": 0.1, "sch_patience": 100, "lr_base": 0.001,
    "lr_ratio_Corr": 10, "lr_ratio_Mutual": 1, "lr_ratio_Reconn": 10,
    "lr_ratio_Smooth": 1, "lr_ratio_dis": 1, "lr_ratio_gen": 10,
    "optimizer_name": "AdamW", "spec_noise": 0.02, "use_flex_spec_target": True,
    "weight_decay": 0.01, "kendall_activation": True, "epoch_stop_smooth": 5,
}
STEPS = ("step.adversarial", "step.correlation", "step.reconstruction", "step.mutual_info",
         "step.smoothness")


@pytest.fixture(autouse=True)
def _clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def test_off_is_one_shared_noop_and_counters_count():
    assert not tracing.active()
    a, b = tracing.span("epoch"), tracing.span("draw", "z_real")
    assert a is b
    with a:
        pass

    @tracing.spanned("f")
    def f(x):
        return x + 1

    assert f(2) == 3
    assert tracing.spans() == []
    before = tracing.counter("test.n")
    tracing.count("test.n")
    tracing.count("test.n", 2)
    assert tracing.counter("test.n") == before + 3
    assert tracing.counters()["test.n"] == before + 3
    tracing.reset_counters("test.n")
    assert tracing.counter("test.n") == 0 and "test.n" not in tracing.counters()


def test_nested_spans_record_parents_and_self_time():
    @tracing.spanned("leaf")
    def leaf():
        time.sleep(0.002)

    tracing.enable()
    with tracing.span("root"):
        time.sleep(0.003)
        with tracing.span("mid"):
            leaf()
            leaf()
        with tracing.span("draw", "x"):
            pass
    with tracing.span("second"):
        pass
    tracing.disable()
    sp = tracing.spans()
    assert [(s.name, s.parent) for s in sp] == [
        ("root", -1), ("mid", 0), ("leaf", 1), ("leaf", 1), ("draw.x", 0), ("second", -1)]
    assert all(s.end_ns >= s.start_ns and s.device_ms is None for s in sp)
    dur = [s.end_ns - s.start_ns for s in sp]
    own = tracing.self_ns(sp)
    assert own == [dur[0] - dur[1] - dur[4], dur[1] - dur[2] - dur[3], dur[2], dur[3], dur[4],
                   dur[5]]
    assert own[0] >= 3e6 and dur[1] >= 4e6
    totals = tracing.totals(sp)
    assert totals["leaf"]["count"] == 2
    assert totals["leaf"]["host_ms"] == pytest.approx((dur[2] + dur[3]) / 1e6)
    assert totals["mid"]["self_ms"] == pytest.approx(own[1] / 1e6)
    assert totals["root"]["device_ms"] is None
    assert [(s.name, s.parent) for s in tracing.newest(sp, "root")] == [
        ("root", -1), ("mid", 0), ("leaf", 1), ("leaf", 1), ("draw.x", 0)]
    assert tracing.newest(sp, "none") == []
    tracing.reset()
    assert tracing.spans() == []


def test_profiler_turns_tracing_on_and_shares_its_clock():
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.active()
        with tracing.span("matmul"):
            x @ x
    assert not tracing.active()
    with tracing.span("after"):
        pass
    (s,) = tracing.spans()
    assert s.name == "matmul"
    start = tracing.trace_start_ns(prof)
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns <= start + e.time_range.start * 1e3 <= \
            start + e.time_range.end * 1e3 <= s.end_ns


def _trainer_and_data():
    aux, spec, _ = make_synthetic_xanes(n_rows=N_TRAIN + N_VAL, dim=256, seed=3)
    spec, aux = spec.astype(np.float32), aux.astype(np.float32)
    data = TrialData(*(torch.tensor(a) for a in (spec[:N_TRAIN], aux[:N_TRAIN],
                                                   spec[N_TRAIN:], aux[N_TRAIN:])))
    tr = RankAAETrainer(TrainConfig(**CFG), n_train=N_TRAIN, n_val=N_VAL, trials=T,
                        device="cpu")
    return tr, tr.init_state(5), data


def _children(sp, i):
    return [j for j, s in enumerate(sp) if s.parent == i]


def test_faithful_epoch_span_tree_and_bitwise_equal_on_and_off():
    before = tracing.counter("setup.trainer_s")
    tr_off, st_off, data = _trainer_and_data()
    tr_on, st_on, _ = _trainer_and_data()
    assert tracing.counter("setup.trainer_s") > before
    st_off, log_off = tr_off.epoch_step(st_off, 0, data)
    assert tracing.spans() == []
    tracing.enable()
    st_on, log_on = tr_on.epoch_step(st_on, 0, data)
    tracing.disable()

    sp = tracing.spans()
    names = [s.name for s in sp]
    assert sp[0].name == "epoch" and sp[0].parent == -1 and names.count("epoch") == 1
    assert all(s.parent >= 0 for s in sp[1:]) and all(s.end_ns is not None for s in sp)
    top = [names[j] for j in _children(sp, 0)]
    assert top == ["draw.permutation"] + ["batch"] * tr_on.n_batch + ["validate"]
    batches = [j for j in _children(sp, 0) if names[j] == "batch"]
    for b in batches:
        kids = [names[j] for j in _children(sp, b)]
        assert [k for k in kids if k.startswith("step.")] == list(STEPS)
        assert kids[:2] == ["draw.spec_noise", "draw.z_real"]
        # the dead re-encode between the reconstruction and MI steps draws
        # its dropout masks in the batch itself
        assert set(kids) - set(STEPS) == {"draw.spec_noise", "draw.z_real", "draw.keep_mask"}
        for step in (j for j in _children(sp, b) if names[j].startswith("step.")):
            inner = [names[j] for j in _children(sp, step)]
            assert inner.count("backward") == 1 and inner.count("update") == 1, inner
            assert inner[-2:] == ["backward", "update"]
            assert all(k.startswith("draw.") for k in inner[:-2]), inner
            assert "draw.keep_mask" in inner
            if names[step] == "step.mutual_info":
                assert inner[0] == "draw.z_sample"
            if names[step] == "step.adversarial":
                assert "draw.dis_noise" in inner
            for j in _children(sp, step):
                assert _children(sp, j) == []
    (val,) = [j for j in _children(sp, 0) if names[j] == "validate"]
    assert {names[j] for j in _children(sp, val)} == {"draw.z_val", "draw.z_real_val"}
    assert names.count("update") == 5 * tr_on.n_batch == names.count("backward")

    assert log_on.keys() == log_off.keys()
    for k, v in log_off.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, log_on[k]), k
        else:
            assert v == log_on[k], k
    for role, module in tr_off.models.items():
        for name, t in module.state_dict().items():
            assert torch.equal(t, tr_on.models[role].state_dict()[name]), (role, name)
    for name, o in st_off.opt.items():
        for a, b in zip(o.mu + o.nu, st_on.opt[name].mu + st_on.opt[name].nu):
            assert torch.equal(a, b), name


def test_train_sc_profile_dir_writes_spans(tmp_path):
    work = tmp_path / "work"
    work.mkdir()
    make_synthetic_xanes_csv(str(work / "data.csv"), n_rows=150, dim=256, seed=7)
    with open(os.path.join(REPO, "example", "fix_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({"trials": 1, "max_epoch": 1, "n_layers": 3, "batch_size": 64,
                "data_file": "data.csv"})
    (work / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    prof_dir = tmp_path / "prof"
    res = subprocess.run(
        [sys.executable, "-m", "rankaae_tpu_torch.cli.train_sc", "-c", "cfg.yaml", "-w",
         str(work), "--device", "cpu", "--profile-dir", str(prof_dir)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert (prof_dir / "train_sc.trace.json").exists()
    out = json.loads((prof_dir / "spans.json").read_text())
    assert out["clock"] == "time.time_ns" and out["trace_start_ns"] > 0
    names = [s["name"] for s in out["spans"]]
    assert names.count("epoch") == 1 and names.count("validate") == 1
    assert set(out["spans"][0]) == {"name", "parent", "start_ns", "end_ns", "device_ms"}
    assert all(s["start_ns"] >= out["trace_start_ns"] for s in out["spans"])
    assert out["totals"]["update"]["count"] == 5 * names.count("batch") > 0
    assert set(out["totals"]["epoch"]) == {"count", "host_ms", "self_ms", "device_ms"}
    assert out["counters"]["setup.trainer_s"] > 0
