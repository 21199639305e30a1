"""The plain reference as a protocol (``benchmark/reference.py``) and model
modules (``benchmark/models/``), on the CPU at ``readings.small``'s size.

``pinned.json`` holds values that the harness gave while the conv forms
still lived in ``benchmark/reference.py`` itself: the initial weights'
digest, ``flops.epoch_flops``, the reference's own losses, gradients and
validation from seeded draws, and the numbers ``check.run_reference``
returns for the program's recorded first epoch.  The harness reproduces
each exactly.  The last depend on the program's first epoch too, whose
digest is pinned beside them: where that one differs, the program moved,
not the harness.

Also: a configuration that names no model module, or one that lacks a name
of the interface, stops before set-up; and nothing the reference runs
imports the program, JAX or the JAX package.
"""
import ast
import glob
import hashlib
import json
import os
import shutil
import time

import pytest
import torch

from benchmark import check, flops, harness, readings
from benchmark import data as bench_data
from benchmark import reference as ref

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "pinned.json")) as f:
    PINNED = json.load(f)
CELLS = ("normal-train-t256", "compact-train-t256")
SEED = 2**31 + 101


def small_cell(workload):
    """The cell's configuration file, its params and traffic at the small
    size, its full params, and its model module."""
    spec = harness.load_spec()
    cell, config, traffic = harness.load_cell(workload, spec)
    full = harness.program_params(config, traffic)
    params, traffic = readings.small(full, traffic)
    return config, params, traffic, full, harness.load_model(config)


def digest_tree(obj, h):
    """Feeds ``obj`` (tensors in dicts, lists and tuples) to the hash ``h``
    in its own order: names, dtypes, shapes and bytes."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.numpy().tobytes())
    elif isinstance(obj, dict):
        for k in obj:
            h.update(repr(k).encode())
            digest_tree(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        h.update(f"[{len(obj)}".encode())
        for x in obj:
            digest_tree(x, h)
    else:
        h.update(repr(obj).encode())


def digest(obj):
    h = hashlib.sha256()
    digest_tree(obj, h)
    return h.hexdigest()


def digest_by_name(tree):
    h = hashlib.sha256()
    for n in sorted(tree):
        h.update(n.encode())
        h.update(tree[n].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


class SeededDraws(ref.Draws):
    """Draws made on demand from one generator, in the order asked for."""

    def __init__(self, seed):
        super().__init__([])
        self.g = torch.Generator().manual_seed(seed)

    def normal(self, name, shape):
        return torch.randn(shape, generator=self.g)

    def mask(self, shape):
        return torch.rand(shape, generator=self.g) < 0.95


@pytest.mark.parametrize("workload", CELLS)
def test_weights_and_epoch_flops_are_as_pinned(workload):
    config, params, traffic, full, model = small_cell(workload)
    gen = torch.Generator().manual_seed(harness.weight_seed(SEED))
    weights = ref.make_weights(model.layout(params), params["trials"], gen, "cpu")
    assert digest(weights) == PINNED[workload]["weights"]
    assert flops.epoch_flops(model, params, 489, 105) == PINNED[workload]["epoch_flops"]["small"]
    assert flops.epoch_flops(model, full, 4900, 1050) == PINNED[workload]["epoch_flops"]["full"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_from_seeded_draws_is_as_pinned(workload):
    """One trial of the reference alone, no program: the five steps of a
    batch from the benchmark's weights and the validation."""
    config, params, traffic, full, model = small_cell(workload)
    host = bench_data.make_splits(7, traffic, params["dim_in"], params["n_aux"])
    b = params["batch_size"]
    spec, aux = (torch.as_tensor(a[:b]) for a in host[:2])
    w = ref.make_weights(model.layout(params), 1, torch.Generator().manual_seed(11), "cpu")
    trial = ref.Trial(params, {r: {n: t[0] for n, t in sd.items()} for r, sd in w.items()},
                      "cpu", model=model)
    draws = SeededDraws(13)
    trial.begin(spec, draws)
    steps = {}
    for step, _, _ in ref.STEPS:
        loss, grads = trial.step(step, aux, 0, draws)
        steps[step] = [float(loss).hex(), digest_by_name(grads)]
    val = trial.validate(torch.as_tensor(host[2]), torch.as_tensor(host[3]), 0, draws, 0.5)
    pinned = PINNED[workload]
    assert steps == pinned["reference_steps"]
    assert digest_by_name({f"{r}.{n}": t for r, sd in trial.w.items() for n, t in sd.items()}) \
        == pinned["reference_weights"]
    assert {k: [float(x).hex() for x in v] if isinstance(v, list) else float(v).hex()
            for k, v in val.items()} == pinned["reference_val"]


@pytest.mark.parametrize("workload", CELLS)
def test_check_numbers_are_as_pinned(workload):
    config, params, traffic, full, model = small_cell(workload)
    c = harness.Cell(params, traffic, SEED, "cpu", model)
    record = c.recorded_epoch()
    host = c.host
    c.free()
    kept = {k: record[k] for k in ("head", "val", "batches", "batch_mi", "log", "weights0")}
    assert digest(kept) == PINNED[workload]["record"], \
        "the program's recorded first epoch is not the one the numbers were pinned on"
    numbers = check.run_reference(params, record, host, 0, "cpu", model=model)
    assert {k: float(v).hex() for k, v in numbers.items()} == PINNED[workload]["check_numbers"]


# --------------------------------------------------------------------------- #
# the loader
# --------------------------------------------------------------------------- #

def broken_tree(tmp_path, reference):
    """A tree whose one extra cell ``broken-train`` has a configuration
    naming ``reference``."""
    here = tmp_path / "benchmark"
    for sub in ("configs", "workloads", "metrics", "models"):
        shutil.copytree(os.path.join(harness.HERE, sub), here / sub)
    spec = harness.load_spec()
    config = json.loads((here / "configs" / "fix-compact.json").read_text())
    config.update(name="fix-broken", reference=reference)
    (here / "configs" / "fix-broken.json").write_text(json.dumps(config))
    spec["workloads"].append({"name": "broken-train", "config": "fix-broken",
                              "traffic": "t256-faithful", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return here


@pytest.mark.parametrize("case", ("missing", "outside", "no_macs"))
def test_a_bad_model_module_stops_before_set_up(tmp_path, monkeypatch, case):
    conv = open(os.path.join(harness.HERE, "models", "conv.py")).read()
    if case == "missing":
        reference, named = "benchmark/models/absent.py", ["benchmark/models/absent.py"]
    elif case == "outside":
        (tmp_path / "outside.py").write_text(conv)
        reference, named = "outside.py", ["outside.py"]
    else:
        reference, named = "benchmark/models/no_macs.py", ["benchmark/models/no_macs.py", "macs"]
    here = broken_tree(tmp_path, reference)
    if case == "no_macs":
        assert "\ndef macs(cfg):" in conv
        (here / "models" / "no_macs.py").write_text(conv.replace("\ndef macs(cfg):",
                                                                 "\ndef _macs(cfg):"))

    def no_set_up(*args, **kw):
        raise AssertionError("set-up began")

    monkeypatch.setattr(harness, "Cell", no_set_up)
    with pytest.raises(harness.BadModel) as err:
        harness.run("broken-train", 1, 0.0, False, time.perf_counter(), device="cpu",
                    resize=readings.small, root=str(tmp_path))
    for name in named:
        assert name in str(err.value)


def test_every_configuration_names_a_model_module():
    spec = harness.load_spec()
    for entry in spec["configs"]:
        with open(os.path.join(harness.ROOT, entry["file"])) as f:
            config = json.load(f)
        model = harness.load_model(config)
        for name in ref.MODEL_INTERFACE:
            assert callable(getattr(model, name)), (entry["name"], name)


# --------------------------------------------------------------------------- #
# imports
# --------------------------------------------------------------------------- #

FORBIDDEN = ("rankaae_tpu_torch", "rankaae_tpu", "jax", "jaxlib", "flax")


def imports(path):
    """The modules ``path`` imports, by full dotted name (``from a import
    b`` gives ``a`` and ``a.b``)."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_reference_and_model_modules_import_nothing_of_the_program():
    """The protocol, the comparison, the counts and every model module, and
    the benchmark modules they import in turn: no top-level name of the
    program, JAX or the JAX package."""
    todo = [os.path.join(harness.HERE, f) for f in ("reference.py", "check.py", "flops.py")]
    todo += sorted(glob.glob(os.path.join(harness.HERE, "models", "*.py")))
    assert len(todo) > 3
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imports(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)
            if name.split(".", 1)[0] == "benchmark":
                target = os.path.join(harness.ROOT, *name.split(".")) + ".py"
                if os.path.isfile(target):
                    todo.append(target)
    assert os.path.join(harness.HERE, "reference.py") in seen
