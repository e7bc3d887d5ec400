"""Paged runner: mean wall milliseconds of a ``decode`` call that started
in the window, on the benchmark's clock (synchronous, as ``prefill_ms``).
Moves ``offline_tok_s``: every step's decode call, offline rows among
its online ones, holds the card from the next offline chunk."""


def read(run):
    ts = [c.t1 - c.t0 for c in run.calls if c.kind == "decode" and run.in_window(c.t0)]
    return 1e3 * sum(ts) / len(ts) if ts else None
