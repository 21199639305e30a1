"""The training core (every form, the faithful, fused and joint protocols,
T stacked trials; ``RankAAETrainer.run``) and its reference-compatible
``Trainer`` facade (``train/facade.py``)."""
from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrainState, TrialData  # noqa: F401
