"""The report stage: score and rank the trials, draw the best one's report."""
from rankaae_tpu_torch.report import analysis  # noqa: F401
from rankaae_tpu_torch.report.analysis import (  # noqa: F401
    evaluate_all_models,
    evaluate_model,
    plot_spectra_variation,
    sort_all_models,
)
from rankaae_tpu_torch.report.curves import LossCurvePlotter, Reconstruct  # noqa: F401
from rankaae_tpu_torch.report.generate_report import plot_report, sorting_algorithm  # noqa: F401
