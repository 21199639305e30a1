"""One run of one cell: set-up, the measured window, the traced epoch, the
check, and the result line.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration in ``benchmark/configs/<config>.json``,
the configuration's model module (the plain reference's encoder, decoder,
discriminator, weights' layout and multiply-adds) at the path its
``reference`` key gives, its traffic in
``benchmark/workloads/<traffic>.json``, and each metric it reports in
``benchmark/metrics/<metric>.py`` (a module with
``read(run) -> float | None``).  The system under test is
``rankaae_tpu_torch``'s trainer: T stacked trials, driven one epoch at a
time through ``RankAAETrainer.epoch_step``, each epoch ending in a device
sync.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "rankaae_tpu")


class NoDevice(RuntimeError):
    """No CUDA device, or fewer than the cell asks for."""


class BadModel(ValueError):
    """A configuration's ``reference`` names no model module, or one that
    lacks a name of the interface."""


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(name: str, spec: dict, here: str = HERE):
    """The cell ``name``'s entry, its configuration file and its traffic
    file."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    with open(os.path.join(here, "configs", f"{cell['config']}.json")) as f:
        config = json.load(f)
    with open(os.path.join(here, "workloads", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(spec: dict, cell: dict, trace: bool):
    """The metric entries a run of ``cell`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones (those that list it, or, without a
    ``workloads`` key, those whose ``moves`` the cell reports)."""
    def reports(m):
        return "workloads" not in m or cell["name"] in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def _load(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: str = HERE):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    return _load(os.path.join(here, "metrics", f"{name}.py"), f"benchmark_metric_{name}").read


def load_model(config: dict, root: str = ROOT):
    """The model module that the configuration file ``config`` names under
    ``reference``: a ``.py`` file under ``<root>/benchmark/``, its path
    relative to ``root``, loaded by path.  Raises :class:`BadModel`, naming
    the file and what is missing, where there is no such file or it lacks a
    function of ``benchmark.reference.MODEL_INTERFACE``."""
    from benchmark.reference import MODEL_INTERFACE

    rel = config.get("reference")
    here = os.path.realpath(os.path.join(root, "benchmark"))
    path = os.path.realpath(os.path.join(root, rel)) if isinstance(rel, str) else ""
    if not (path.startswith(here + os.sep) and path.endswith(".py") and os.path.isfile(path)):
        raise BadModel(f"configuration {config.get('name')!r}: its reference {rel!r} is no "
                       f"model module: no .py file of that path under {here}")
    mod = _load(path, "benchmark_model_" + os.path.basename(path)[:-3])
    missing = [n for n in MODEL_INTERFACE if not callable(getattr(mod, n, None))]
    if missing:
        raise BadModel(f"configuration {config.get('name')!r}: its model module {rel} lacks "
                       f"{', '.join(missing)} (a model module gives "
                       f"{', '.join(MODEL_INTERFACE)})")
    return mod


def program_params(config: dict, traffic: dict) -> dict:
    """The configuration's keys as the program is run: the file's
    ``config`` with the traffic's ``program`` options over it."""
    params = dict(config["config"])
    params.update(traffic.get("program", {}))
    return params


def checked_trials(seed: int, trials: int, k: int):
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    return sorted(int(t) for t in rng.choice(trials, size=min(k, trials), replace=False))


def weight_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0])


def loaded_forbidden():
    names = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(names & set(FORBIDDEN))


class Cell:
    """The program set up for one cell from one seed: the trainer, its
    state and data on ``device``, the benchmark's initial weights of the
    model module ``model`` loaded."""

    def __init__(self, params: dict, traffic: dict, seed: int, device: str, model):
        import torch

        from benchmark import data as bench_data
        from benchmark import reference as ref
        from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
        from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

        self.traffic, self.seed, self.device = traffic, seed, device
        self.trials = params["trials"]
        cfg = TrainConfig.from_parameters(Parameters(params))
        self.host = bench_data.make_splits(seed, traffic, params["dim_in"], params["n_aux"])
        self.data = TrialData(*(torch.from_numpy(a).to(device) for a in self.host))
        self.n_train, self.n_val = len(self.host[0]), len(self.host[2])
        self.trainer = RankAAETrainer(cfg, self.n_train, self.n_val, trials=self.trials,
                                      device=device)
        self.state = self.trainer.init_state(seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(weight_seed(seed))
        self.weights0 = ref.make_weights(model.layout(params), self.trials, gen, device)
        for role, module in self.trainer.models.items():
            module.load_state_dict(self.weights0[role])
        self.epoch = 0

    def epoch_step(self):
        """One epoch of every trial, ending in a device sync; returns its log."""
        import torch

        self.state, log = self.trainer.epoch_step(self.state, self.epoch, self.data)
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.epoch += 1
        return log

    def recorded_epoch(self):
        """The first epoch, recorded for the check (``benchmark/check.py``)."""
        from benchmark import check

        trials = checked_trials(self.seed, self.trials, self.traffic["check_trials"])
        rec = check.Recorder(self.trainer, self.state, trials)
        try:
            log = self.epoch_step()
        finally:
            rec.remove()
        return rec.finish(log, self.weights0)

    def free(self):
        for name in ("trainer", "state", "data", "weights0"):
            setattr(self, name, None)
        gc.collect()


class PermTap:
    """The program's sampler, unchanged, keeping each epoch's permutation."""

    def __init__(self, inner):
        self._inner, self.perms = inner, []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def permutation(self, n):
        p = self._inner.permutation(n)
        self.perms.append(p.cpu().numpy())
        return p


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        stderr=None, device: str = "cuda", resize=None, root: str = ROOT) -> dict:
    """One run (see ``benchmark/run.py``); returns the result line's object.
    ``device`` "cpu", ``resize`` (a function that returns the cell's params
    and traffic made small) and ``root`` (a tree with its own
    ``BENCHMARK.json`` and ``benchmark/`` files) serve the CPU tests."""
    import torch

    from benchmark import check
    from benchmark import reference as ref

    stderr = sys.stderr if stderr is None else stderr
    from benchmark import trace as bench_trace

    here = os.path.join(root, "benchmark")
    spec = load_spec(root)
    cell, config, traffic = load_cell(workload, spec, here)
    model = load_model(config, root)
    on_gpu = device != "cpu"
    if on_gpu and (not torch.cuda.is_available()
                   or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"{workload} needs {cell['chips']} CUDA device(s); "
                       f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    params = program_params(config, traffic)
    if resize is not None:
        params, traffic = resize(params, traffic)
    metrics = cell_metrics(spec, cell, trace)

    c = Cell(params, traffic, seed, device, model)
    t0 = time.perf_counter()
    record = c.recorded_epoch()
    warmup_epoch_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start

    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    epochs = failed = 0
    w0 = time.perf_counter()
    while True:
        log = c.epoch_step()
        failed += int((~torch.isfinite(log["combined"])).sum())
        epochs += 1
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    rate = c.trials * c.n_train * epochs / window_s

    profile, perms = None, []
    if trace:
        tap = PermTap(c.state.sampler)
        c.state.sampler = tap
        try:
            profile = bench_trace.profile_epoch(c.epoch_step, c.trainer)
        finally:
            c.state.sampler = tap._inner
        perms = tap.perms

    ctx = SimpleNamespace(
        params=params, model=model, trials=c.trials, n_train=c.n_train, n_val=c.n_val,
        train_aux=c.host[1], val_aux=c.host[3], perms=perms, profile=profile,
        setup_s=setup_s, warmup_epoch_s=warmup_epoch_s, rate=rate, window_s=window_s,
        epochs=epochs, peak_bytes=peak)
    values = {}
    for m in metrics:
        v = reader(m["name"], here)(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    host = c.host
    c.free()
    if on_gpu:
        torch.cuda.empty_cache()
    where = {}
    r0 = time.perf_counter()
    try:
        numbers = check.run_reference(params, record, host, 0, device, where, model=model)
    except ref.DrawMismatch as e:
        # the program drew what the reference cannot follow: no number holds
        print(f"check: the reference cannot follow the program's draws: {e}", file=stderr)
        numbers = {k: None for k in check.NUMBERS + check.READINGS}
    reference_s = time.perf_counter() - r0
    correct, checks = check.judge(numbers, config["limits"])
    correct = correct and failed == 0

    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu", "count": cell["chips"],
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": epochs * c.trials, "failed": failed,
              "metrics": values, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile.summary["device_busy_ms"] / 1e3
        dev["window_s"] = profile.wall_ms / 1e3
        result["breakdown"] = {"device_ops": profile.device_ops(),
                               "idle_gaps": profile.idle_by_span()}
    result["checks"] = checks
    print(f"timing: set-up {setup_s:.3f} s (warm-up epoch {warmup_epoch_s:.3f} s), window "
          f"{window_s:.3f} s of {epochs} epochs, reference {reference_s:.3f} s", file=stderr)
    for name in check.READINGS:
        print(f"reading {name}: {numbers[name]!r} at {where.get(name)}", file=stderr)
    for name in check.NUMBERS:
        print(f"worst {name} at {where.get(name)}", file=stderr)
    for name, chk in checks.items():
        ok = "ok" if chk["value"] is not None and chk["value"] <= chk["limit"] else "FAILED"
        print(f"check {name}: {chk['value']!r} limit {chk['limit']!r} {ok}", file=stderr)
    return result

