"""The port's training-quality harness (``rankaae_tpu_torch/tools/
parity_experiment.py`` ``--mode ours``/``aggregate`` and
``tools/parity_gate.py``) against the JAX package's
(``scripts/parity_experiment.py``, ``scripts/fused_gate.py``), on the CPU.

* The experiment config (every form, with and without ``--set``) and
  ``_final_stats`` equal the script's: the script is loaded by path, and its
  module top imports only numpy.
* The scores of the JAX package's initial weights, carried across by the
  weight bridge into the port's ``InferenceModel``, within 1e-5 of the JAX
  ``InferenceModel``'s (FC and normal).
* ``--mode ours`` at FC, 2 seeds x 2 epochs, 300 rows: the JAX record's keys,
  traces 2 epochs long, and a ``--segment-epochs 1`` run equal to the uncut
  one; ``--mode aggregate``'s tables equal the script's ``_aggregate`` on the
  same records; the refused flags.
* ``parity_gate`` on the committed ``fc300_faithful``/``fc300_fused`` records
  reproduces ``PARITY_FUSED.md``'s floor CIs and ratio and
  ``fused_gate.py``'s rows; on an old record it holds the final MSE; and
  ``fused_gate.py`` itself, run unchanged, reads a port record.
"""
import argparse
import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rankaae_tpu.models.inference import InferenceModel as JaxInferenceModel
from rankaae_tpu.models.registry import build_autoencoder
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.models.inference import InferenceModel
from rankaae_tpu_torch.tools import parity_experiment as pe
from rankaae_tpu_torch.tools import parity_gate
from rankaae_tpu_torch.utils.config import TrainConfig
from tests.test_torch_trainer import CFG
from tests.torch_parity import make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts")
FAITHFUL = os.path.join(ART, "parity_fused", "fc300_faithful", "ours.json")
FUSED = os.path.join(ART, "parity_fused", "fc300_fused", "ours.json")
EPOCHS, SEEDS, ROWS = 2, 2, 300
PORT_KEYS = {"stack", "device", "seed_scheme", "command"}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _load_script("parity_experiment")


@pytest.fixture(scope="module")
def ours(tmp_path_factory):
    """Two ``--mode ours`` runs on the CPU: uncut, and in segments of one
    epoch."""
    root = tmp_path_factory.mktemp("parity")
    base = ["--mode", "ours", "--epochs", str(EPOCHS), "--rows", str(ROWS), "--seeds",
            str(SEEDS), "--device", "cpu"]
    runs = {name: pe.main(base + ["--json-dir", str(root / name)] + extra)
            for name, extra in (("uncut", []), ("segmented", ["--segment-epochs", "1"]))}
    return root, runs


OVERRIDES = ["protocol=fused", "batch_size=1400", "spec_noise=0.0", "flex_scale_weight=0.3",
             "optimizer_name=RAdam"]


@pytest.mark.parametrize("sets", [[], OVERRIDES], ids=["plain", "set"])
@pytest.mark.parametrize("ae_form", ["FC", "normal", "compact", "qved"])
def test_experiment_config_matches_the_script(script, ae_form, sets):
    kw = {"ae_form": ae_form, "precision": "default", "act_dtype": "bfloat16",
          "sch_recon_metric": "val_recon"}
    for args in ({"ae_form": ae_form}, kw):
        want = script._experiment_config(300, **args)
        for kv in sets:             # the script's --set (scripts/parity_experiment.py:778-789)
            key, _, raw = kv.partition("=")
            assert key in want or key in JaxTrainConfig.__dataclass_fields__
            try:
                want[key] = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                want[key] = raw
        got = pe._apply_overrides(pe._experiment_config(300, **args), sets)
        assert got == want and list(got) == list(want)


def test_unknown_override_is_refused():
    with pytest.raises(SystemExit, match="unknown config key"):
        pe._apply_overrides(pe._experiment_config(300), ["no_such_key=1"])


@pytest.mark.parametrize("train", [False, True], ids=["val", "val+train"])
def test_final_stats_match_the_script(script, train):
    rng = np.random.default_rng(5)
    spec = np.abs(rng.normal(1.0, 0.3, size=(240, 32))).astype(np.float32)
    aux = rng.normal(size=(240, 5)).astype(np.float32)
    w = rng.normal(size=(32, 6)).astype(np.float32)
    v = rng.normal(size=(6, 32)).astype(np.float32) / 4
    encode = lambda x: x @ w                                    # noqa: E731
    decode = lambda z: np.logaddexp(0.0, z @ v).astype(np.float32)  # noqa: E731
    t = spec[:160] if train else None
    got = pe._final_stats(encode, decode, spec[160:], aux[160:], train_spec=t)
    want = script._final_stats(encode, decode, spec[160:], aux[160:], train_spec=t)
    assert got == want and list(got) == list(want)
    assert pe._train_eval_recon(encode, decode, spec) == \
        float(np.mean((decode(encode(spec)) - spec) ** 2))


def _jax_weights(cfg, seed):
    """The JAX package's initial encoder and decoder weights and running
    statistics (its modules' ``init``, as ``RankAAETrainer.init_state``
    calls it), as numpy trees."""
    jcfg = JaxTrainConfig(**cfg)
    enc, dec = build_autoencoder(jcfg)

    @jax.jit
    def init(key):
        k_enc, k_dec = jax.random.split(key)
        ev = enc.init({"params": k_enc, "dropout": k_enc}, jnp.zeros((2, jcfg.dim_in)),
                      train=True)
        dv = dec.init({"params": k_dec, "dropout": k_dec}, jnp.zeros((2, jcfg.nstyle)),
                      train=True)
        return ({"enc": ev["params"], "dec": dv["params"]},
                {"enc": ev.get("batch_stats", {}), "dec": dv.get("batch_stats", {})})

    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("ae_form", ["FC", "normal"])
def test_inference_stats_match_jax(ae_form):
    cfg = {**CFG, "ae_form": ae_form}
    params, stats = _jax_weights(cfg, seed=3)
    spec, aux = make_data(7, 160)
    jm = JaxInferenceModel(params, stats, JaxTrainConfig(**cfg))
    tm = InferenceModel(params, stats, TrainConfig(**cfg), device="cpu")   # via from_jax
    want = pe._final_stats(jm.encode, jm.decode, spec[:80], aux[:80], train_spec=spec[80:])
    got = pe._final_stats(tm.encode, tm.decode, spec[:80], aux[:80], train_spec=spec[80:])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_mode_ours_writes_the_jax_schema(ours):
    root, runs = ours
    with open(root / "uncut" / "ours.json") as f:
        rec = json.load(f)
    with open(FAITHFUL) as f:
        jax_rec = json.load(f)
    assert set(rec) == set(jax_rec) | PORT_KEYS
    assert rec["stack"] == "rankaae_tpu_torch" and rec["device"] == "cpu"
    assert rec["epochs"] == EPOCHS and rec["rows"] == ROWS and len(rec["seeds"]) == SEEDS
    js = jax_rec["seeds"][0]
    for s in rec["seeds"]:
        assert list(s) == list(js)
        for k, v in js.items():
            if isinstance(v, dict):
                assert list(s[k]) == list(v), k
        for k in ("val_recon_trace", "lr_recon_trace", "gain_trace", "metrics_trace"):
            assert len(s[k]) == EPOCHS, k
        assert all(len(row) == 5 for row in s["metrics_trace"])
        assert all(len(v) == EPOCHS for v in s["component_traces"].values())
        assert s["val_recon_min"] == min(s["val_recon_trace"]) or \
            abs(s["val_recon_min"] - min(s["val_recon_trace"])) <= 5e-7
        assert np.isfinite(s["final"]["recon_mse"]) and len(s["final"]["style_desc_rho"]) == 5
    # 1,400 / 300 of 2,000 rows: the train split holds 70%
    assert runs["uncut"].train_spec.shape[0] == int(0.7 * ROWS)
    assert runs["uncut"].results.logs["val_recon"].shape == (SEEDS, EPOCHS)


def test_segmented_run_equals_the_uncut_one(ours):
    root, runs = ours
    assert runs["segmented"].record["seeds"] == runs["uncut"].record["seeds"]
    assert os.path.exists(root / "segmented" / "train_state" / "progress.json")


@pytest.mark.parametrize("argv,match", [
    (["--rng", "threefry"], "rng"),
    (["--mode", "ref"], "reference"),
    (["--mode", "full"], "reference"),
    (["--set", "no_such_key=1"], "unknown config key"),
], ids=["rng", "ref", "full", "unknown-set"])
def test_refused_flags(tmp_path, capsys, argv, match):
    with pytest.raises(SystemExit) as exc:
        pe.main(argv + ["--device", "cpu", "--json-dir", str(tmp_path)])
    assert match in f"{exc.value.code} {capsys.readouterr().err}"
    assert not os.path.exists(tmp_path / "ours.json")


def test_aggregate_matches_the_script(ours, script, tmp_path):
    root, _ = ours
    ref_dir = os.path.join(ART, "parity_fc300")
    both = tmp_path / "both"
    both.mkdir()
    for fn in os.listdir(ref_dir):
        shutil.copy(os.path.join(ref_dir, fn), both / fn)
    shutil.copy(root / "uncut" / "ours.json", both / "ours.json")
    script._aggregate(argparse.Namespace(json_dir=str(both), ae_form="FC",
                                         out=str(tmp_path / "jax.md")), json)
    pe.main(["--mode", "aggregate", "--json-dir", str(root / "uncut"), "--ref-json-dir",
             ref_dir, "--out", str(tmp_path / "port.md")])
    rows = lambda fn: [line.replace("rankaae_tpu_torch", "rankaae_tpu")    # noqa: E731
                       for line in open(fn).read().splitlines() if line.startswith("|")]
    got, want = rows(tmp_path / "port.md"), rows(tmp_path / "jax.md")
    assert len(want) >= 24 and got == want


def test_parity_gate_reproduces_parity_fused(tmp_path):
    out = tmp_path / "gate.md"
    parity_gate.main(["--pair", "FC-300-fused", FAITHFUL, FUSED, "--columns", "faithful",
                      "fused", "--out", str(out)])
    text = out.read_text()
    assert "faithful [0.00157, 0.00201], fused [0.00187, 0.00288] — **OVERLAP**" in text
    assert "fused/faithful floor ratio 1.49x" in text
    # every row fused_gate.py prints, cell for cell
    fg_lines, overlap, ratio = _load_script("fused_gate").pair_section("FC-300-fused",
                                                                       FAITHFUL, FUSED)
    assert overlap and round(ratio, 2) == 1.49
    gate_rows = {line.split(" | ")[0]: line for line in text.splitlines()
                 if line.startswith("| ")}
    fg_rows = [line for line in fg_lines if line.startswith("| ") and "wall" not in line
               and "Quantity" not in line]
    assert len(fg_rows) == 11
    for line in fg_rows:
        assert gate_rows[line.split(" | ")[0]] == line


def test_parity_gate_on_an_old_record(tmp_path):
    out = tmp_path / "gate.md"
    parity_gate.main(["--pair", "bf16", os.path.join(ART, "parity_1500", "ours.json"),
                      os.path.join(ART, "knob_quality", "bf16act_threefry", "ours.json"),
                      "--out", str(out)])
    text = out.read_text()
    assert "predates the reconstruction floor" in text
    assert "| reconstruction floor (min val recon) | n/a | n/a |" in text
    assert "Final val recon MSE median 95% bootstrap CIs" in text
    assert "not compared" in text


def test_fused_gate_reads_a_port_record(ours, tmp_path):
    root, _ = ours
    out = tmp_path / "fused_gate.md"
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "fused_gate.py"),
                          "--pair", "port", FAITHFUL, str(root / "uncut" / "ours.json"),
                          "--out", str(out)], capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr
    text = out.read_text()
    assert "## port (faithful n=16, fused n=2, 300 epochs)" in text
    assert "OVERLAP" in text or "NO overlap" in text
