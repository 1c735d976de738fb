"""requests_per_s: requests answered in the window over the window's
seconds (host clock). Moves with every layer on the request path."""


def read(run):
    w = run.window
    if w is None or w.window_s <= 0 or not w.answered:
        return None
    return w.answered / w.window_s
