"""Device: the share of the profiled sub-window in which no operation
(kernel, copy or memset) ran on the card. Moves ``offline_tok_s``."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
