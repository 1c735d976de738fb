"""device_idle_pct: the share of the profiled stretch in which no device
operation ran (torch.profiler device events). Layer: device; moves
requests_per_s."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
