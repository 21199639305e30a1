"""Device-stream ms of the optimizers' updates in the profiled epoch: the
sum over the program's ``update`` spans (one around each optimizer update;
``rankaae_tpu_torch/utils/tracing.py``) inside its newest ``epoch`` span.
Nothing to read where the program records no such spans or no device
times."""


def read(run):
    try:
        from rankaae_tpu_torch.utils import tracing
    except ImportError:
        return None
    ms = [s.device_ms for s in tracing.newest(tracing.spans(), "epoch") if s.name == "update"]
    if not ms or None in ms:
        return None
    return float(sum(ms))
