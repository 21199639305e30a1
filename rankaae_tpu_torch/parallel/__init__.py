"""Several trials of one configuration at once: stacked on one card, in
waves, and over processes and cards (``run_trials``)."""
from rankaae_tpu_torch.parallel.trials import TrialResults, run_trials  # noqa: F401
