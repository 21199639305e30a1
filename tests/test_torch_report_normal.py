"""The port's report stage against the JAX package's on normal-form
bundles: the conv decoder's eval-mode blocks (K3's plain version on the
CPU) in every decode of the report.  The pattern of
``tests/test_torch_report.py`` (its config with ``ae_form: normal``, 2
epochs, 2 trials), in a file of its own for time: the JAX package's
compilations of the deep normal form take most of it.
"""
import os

from rankaae_tpu.report.generate_report import generate as jax_generate
from rankaae_tpu.utils.config import Parameters as JaxParameters

from rankaae_tpu_torch.report.generate_report import generate
from rankaae_tpu_torch.utils.config import Parameters
from tests.test_torch_report import (OUTPUTS, assert_reports_match, copy_work_dir,
                                     report_files, train_work_dir)


def test_normal_form_report_matches_jax(tmp_path):
    trained = train_work_dir(tmp_path / "trained", ae_form="normal", max_epoch=2)
    works = {side: copy_work_dir(trained, tmp_path / side) for side in ("port", "jax")}
    jax_generate(works["jax"], JaxParameters.from_yaml(os.path.join(works["jax"], "cfg.yaml")))
    generate(works["port"], Parameters.from_yaml(os.path.join(works["port"], "cfg.yaml")),
             device="cpu")
    assert report_files(works["port"]) == report_files(works["jax"]) == sorted(OUTPUTS)
    assert_reports_match(works["port"], works["jax"])
