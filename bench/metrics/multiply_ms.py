"""multiply_ms: mean per flush of the program's ``batcher/multiply`` span,
read with a registry of the program's obs installed (the span synchronises
the device). Layer: operator; moves requests_per_s."""


def read(run):
    s = run.spans.get("batcher/multiply")
    return None if s is None else s[1] * 1e3
