"""The port's report stage against the JAX package's on qved bundles (the
JAX CLI reports a qved tree, so the port does too).  The pattern of
``tests/test_torch_report_normal.py``: the port's ``train_sc`` trains 2
trials of ``tests/test_torch_report.py``'s config as the qved form (2
epochs, at ``lr_base`` 1e-6 so that the bundles are the same on every
host) on a seeded 12-dim dataset in the reference CSV's schema (the
q-vectors of ``tests/test_torch_qved.py``); then the JAX package's
``generate`` and the port's each report a copy: the same files, JSON keys
and ranks, values within 1e-4 (``assert_reports_match``).
"""
import os

import numpy as np
import pandas as pd
import yaml

from rankaae_tpu.report.generate_report import generate as jax_generate
from rankaae_tpu.utils.config import Parameters as JaxParameters

from rankaae_tpu_torch.cli import train_sc
from rankaae_tpu_torch.data.synthetic import DESCRIPTOR_NAMES
from rankaae_tpu_torch.report.generate_report import generate
from rankaae_tpu_torch.utils.config import Parameters
from tests.test_torch_qved import qvec_data
from tests.test_torch_report import (CFG, OUTPUTS, assert_reports_match, copy_work_dir,
                                     report_files)

N_ROWS = 600


def test_qved_report_matches_jax(tmp_path):
    trained = tmp_path / "trained"
    trained.mkdir()
    q, aux = qvec_data(5, N_ROWS)
    cols = [f"AUX_{n}" for n in DESCRIPTOR_NAMES] + [f"ENE_{i}.00" for i in range(q.shape[1])]
    idx = pd.MultiIndex.from_arrays([[f"mp-{i // 10}" for i in range(N_ROWS)],
                                     list(range(N_ROWS))], names=["material", "site"])
    pd.DataFrame(np.concatenate([aux, q], axis=1), columns=cols, index=idx).to_csv(
        trained / "data.csv")
    with open(trained / "cfg.yaml", "w") as f:
        yaml.safe_dump({**CFG, "ae_form": "qved", "dim_in": q.shape[1], "dim_out": q.shape[1],
                        "max_epoch": 2, "lr_base": 1e-6}, f)
    train_sc.main(["-c", "cfg.yaml", "-w", str(trained), "--device", "cpu"])
    works = {side: copy_work_dir(trained, tmp_path / side) for side in ("port", "jax")}
    jax_generate(works["jax"], JaxParameters.from_yaml(os.path.join(works["jax"], "cfg.yaml")))
    generate(works["port"], Parameters.from_yaml(os.path.join(works["port"], "cfg.yaml")),
             device="cpu")
    assert report_files(works["port"]) == report_files(works["jax"]) == sorted(OUTPUTS)
    got = assert_reports_match(works["port"], works["jax"])
    assert sorted(got) == ["job_1", "job_2"]
