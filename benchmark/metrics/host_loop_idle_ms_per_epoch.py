"""The device's idle ms in the profiled epoch that fall while the host is
inside one of the program's ``update`` or ``draw.*`` spans
(``rankaae_tpu_torch/utils/tracing.py``): the gaps between the merged
device intervals inside the epoch's host window, placed on the host clock
through the trace's start, summed where they overlap those spans' host
intervals.  Nothing to read without the profile or the spans."""


def read(run):
    if run.profile is None:
        return None
    try:
        from rankaae_tpu_torch.utils import tracing
    except ImportError:
        return None
    p = run.profile
    # the spans' host intervals in us after the trace's start, merged
    loops = []
    for a, b in sorted(((s.start_ns - p.start_ns) / 1e3, (s.end_ns - p.start_ns) / 1e3)
                       for s in tracing.newest(tracing.spans(), "epoch")
                       if s.name == "update" or s.name.startswith("draw.")):
        if loops and a <= loops[-1][1]:
            loops[-1][1] = max(loops[-1][1], b)
        else:
            loops.append([a, b])
    if not loops:
        return None
    lo = (p.t0_ns - p.start_ns) / 1e3
    hi = (p.t1_ns - p.start_ns) / 1e3
    gaps, end = [], lo
    for a, b in p.summary["intervals"] + [(hi, hi)]:
        if min(a, hi) > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    idle_us, i = 0.0, 0
    for a, b in gaps:
        while i < len(loops) and loops[i][1] <= a:
            i += 1
        k = i
        while k < len(loops) and loops[k][0] < b:
            idle_us += min(b, loops[k][1]) - max(a, loops[k][0])
            k += 1
    return idle_us / 1e3
