"""The four optimizers (Adam, AdamW, RAdam, AdaBound) with per-trial runtime
learning rates, and ReduceLROnPlateau as device state."""
from rankaae_tpu_torch.optim.optimizers import OPTIMIZERS, Optimizer, make_optimizer  # noqa: F401
from rankaae_tpu_torch.optim.plateau import PlateauState, plateau_init, plateau_update  # noqa: F401
