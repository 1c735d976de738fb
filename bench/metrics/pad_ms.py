"""pad_ms: mean per flush of the program's ``batcher/pad`` span, read with
a registry of the program's obs installed (the span synchronises the
device). Layer: batcher; moves requests_per_s."""


def read(run):
    s = run.spans.get("batcher/pad")
    return None if s is None else s[1] * 1e3
