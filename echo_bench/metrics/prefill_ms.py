"""Paged runner: mean wall milliseconds of a ``prefill_chunk`` call that
started in the window, on the benchmark's clock (the call ends in the
logits' copy to the host, so it is synchronous). Moves ``offline_tok_s``."""


def read(run):
    ts = [c.t1 - c.t0 for c in run.calls if c.kind == "prefill" and run.in_window(c.t0)]
    return 1e3 * sum(ts) / len(ts) if ts else None
