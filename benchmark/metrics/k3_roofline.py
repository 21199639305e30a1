"""The fused-block kernel K3's share of its roofline in the profiled epoch,
in %: ``benchmark/flops.py::k3_bound`` of each launch (one a trial and
fused block in each of the validation's two eval-mode decodes, B = n_val;
C read from the kernel's template argument) summed, over their device
time.  Nothing to read where K3 did not run."""
import re

from benchmark.flops import k3_bound

NAME = re.compile(r"fused_block_kernel<(\d+)>")


def read(run):
    if run.profile is None:
        return None
    least = device_ms = 0.0
    for name, (count, ms) in run.profile.summary["per_kernel"].items():
        m = NAME.search(name)
        if m:
            least += count * k3_bound(run.n_val, int(m.group(1)))[0]
            device_ms += ms
    return float(100.0 * least / device_ms) if device_ms > 0 else None
