"""Seconds the program spent building the trainer and its state
(``RankAAETrainer.__init__`` and ``init_state``, T trials): its counter
``setup.trainer_s`` (``rankaae_tpu_torch/utils/tracing.py``).  Nothing to
read where the program has no such counter."""


def read(run):
    try:
        from rankaae_tpu_torch.utils import tracing
    except ImportError:
        return None
    value = tracing.counters().get("setup.trainer_s")
    return None if value is None else float(value)
