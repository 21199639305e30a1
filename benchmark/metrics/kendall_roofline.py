"""The Kendall kernels' share of their roofline in the profiled epoch, in %:
the least time of each K1 and K2 call (``benchmark/flops.py::bound`` at the
call's T, B and K, with the untied pairs of each trial's batch counted from
its descriptors) summed, over the device time of their launches.  K1 runs
once a batch with the row sums and once in the validation without; K2 once
a batch.  Nothing to read where the launches are not those."""
from benchmark.flops import bound, untied_pairs


def read(run):
    if run.profile is None or len(run.perms) != 1:
        return None
    per_kernel = run.profile.summary["per_kernel"]
    k1 = [v for n, v in per_kernel.items() if "pair_sums" in n]
    k2 = [v for n, v in per_kernel.items() if "grad_rows" in n]
    b, k, t = run.params["batch_size"], run.params["n_aux"], run.trials
    starts = list(range(0, run.n_train, b))
    if sum(c for c, _ in k1) != len(starts) + 1 or sum(c for c, _ in k2) != len(starts):
        return None
    perm = run.perms[0]
    least = 0.0
    for s in starts:
        rows = perm[:, s:s + b]
        untied = sum(untied_pairs(run.train_aux[r]) for r in rows)
        least += bound("kendall_pair_sums", t, rows.shape[1], k, untied)[0]
        least += bound("grad_rows", t, rows.shape[1], k, 0)[0]
    least += bound("kendall_pair_sums", t, run.n_val, k, t * untied_pairs(run.val_aux),
                   rows=False)[0]
    device_ms = sum(ms for _, ms in k1 + k2)
    return float(100.0 * least / device_ms) if device_ms > 0 else None

