"""The harness is driven by data: a cell, a configuration with its own
model module, a traffic mix and a metric added as files are found and run
with no edit; and nothing the harness loads is JAX or the JAX package."""
import json
import os
import shutil
import subprocess
import sys
import time

from benchmark import harness, readings

ROOT = harness.ROOT


def test_new_cell_config_traffic_and_metric_are_found(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark", "configs"), here / "configs")
    shutil.copytree(os.path.join(ROOT, "benchmark", "workloads"), here / "workloads")
    shutil.copytree(os.path.join(ROOT, "benchmark", "metrics"), here / "metrics")
    (here / "models").mkdir()
    shutil.copy(os.path.join(ROOT, "benchmark", "models", "conv.py"),
                here / "models" / "conv_renamed.py")
    spec = harness.load_spec()
    config = json.loads((here / "configs" / "fix-compact.json").read_text())
    config["name"] = "fix-compact-b512"
    config["reference"] = "benchmark/models/conv_renamed.py"
    config["config"]["batch_size"] = 512
    (here / "configs" / "fix-compact-b512.json").write_text(json.dumps(config))
    traffic = json.loads((here / "workloads" / "t256-faithful.json").read_text())
    traffic["program"]["trials"] = 8
    (here / "workloads" / "t8-faithful.json").write_text(json.dumps(traffic))
    (here / "metrics" / "epochs_in_window.py").write_text(
        "def read(run):\n    return run.epochs\n")
    spec["workloads"].append({"name": "compact-b512", "config": "fix-compact-b512",
                              "traffic": "t8-faithful", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "epochs_in_window", "unit": "epochs", "better": "higher",
                              "source": "host_clock", "layer": "whole step",
                              "moves": "train_spectra_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = harness.load_spec(str(tmp_path))
    cell, config, traffic = harness.load_cell("compact-b512", spec, str(here))
    params = harness.program_params(config, traffic)
    assert params["batch_size"] == 512 and params["trials"] == 8
    names = [m["name"] for m in harness.cell_metrics(spec, cell, trace=True)]
    assert "epochs_in_window" in names and "kendall_roofline" not in names
    assert [m["name"] for m in harness.cell_metrics(spec, cell, trace=False)] == \
        ["train_spectra_per_s", "peak_mem_gib", "setup_s"]
    run = type("Run", (), {"epochs": 3})()
    assert harness.reader("epochs_in_window", str(here))(run) == 3

    # the new cell runs on its own model module, at the small size (which
    # sets the batch and the trials) the same as the cell it was copied from
    loaded = []

    def load_model(*args, **kw):
        loaded.append(real_load_model(*args, **kw))
        return loaded[-1]

    real_load_model = harness.load_model
    monkeypatch.setattr(harness, "load_model", load_model)
    seed = 2**31 + 31
    new = harness.run("compact-b512", seed, 0.0, False, time.perf_counter(), device="cpu",
                      resize=readings.small, root=str(tmp_path))
    old = harness.run("compact-train-t256", seed, 0.0, False, time.perf_counter(), device="cpu",
                      resize=readings.small)
    assert loaded[0].__file__ == str(here / "models" / "conv_renamed.py")
    assert new["correct"], new["checks"]
    assert new["checks"] == old["checks"]


def test_every_metric_has_a_reader():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for cell in spec["workloads"]:
        harness.load_cell(cell["name"], spec)


def test_nothing_loaded_is_jax():
    """A small run on the CPU in a fresh process, every reader loaded: no
    module whose top-level name is jax, jaxlib, flax or rankaae_tpu."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness, readings, faults, trace, flops\n"
        "spec = harness.load_spec()\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "r = harness.run('compact-train-t256', 7, 0.0, False, time.perf_counter(), device='cpu',\n"
        "                resize=readings.small)\n"
        "print(harness.loaded_forbidden(), sorted(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == \
        "[] ['attempted', 'checks', 'correct', 'device', 'failed', 'metrics']"


def test_no_device_exits_without_a_result():
    """Without CUDA the benchmark prints no result and exits non-zero."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "compact-train-t256", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
