"""Paged runner: the offline tokens the runner computed in the window, over
the window's seconds: the live rows of every offline ``prefill_chunk`` call
and the offline rows of every ``decode`` call that started in the window.
Prefix hits are not computed and do not count: this is the part of
``offline_tok_s`` that the card works for, apart from the prefix-hit
credits that come a document at a time. Moves ``offline_tok_s``."""


def read(run):
    off = run.offline_rids
    n = 0
    for c in run.calls:
        if not run.in_window(c.t0):
            continue
        if c.kind == "prefill" and c.rid in off:
            n += c.chunk
        elif c.kind == "decode":
            n += sum(1 for r in c.rids if r in off)
    span = run.window[1] - run.window[0]
    return n / span if span > 0 else None
