"""latency_p95_ms: the 95th percentile of the latency of every request
answered in the window, from its submit to the moment the harness sees its
flush's event complete (host clock)."""
from benchlib.stats import percentile


def read(run):
    w = run.window
    if w is None:
        return None
    p = percentile(w.latencies_s, 95)
    return None if p is None else p * 1e3
