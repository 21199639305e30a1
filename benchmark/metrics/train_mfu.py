"""The whole training step's share of the card's float32 peak, in %: the
floating-point operations of an epoch of one trial from the layer shapes
of the cell's model module (``benchmark/flops.py::epoch_flops`` with the
module's ``macs``: the faithful batch's forwards and backwards, the
validation's forwards, nothing recomputed) times the window's epochs per
second of every trial, over 67 TFLOP/s (float32, TF32 off)."""
from benchmark.flops import PEAK_F32_OPS_PER_S, epoch_flops


def read(run):
    flops = epoch_flops(run.model, run.params, run.n_train, run.n_val)
    flops_per_s = flops * run.rate / run.n_train
    return 100.0 * flops_per_s / PEAK_F32_OPS_PER_S
