"""Engine + scheduler: mean host milliseconds of an engine step that began
in the window, outside its ``schedule``, ``runner.prefill`` and
``runner.decode`` spans: the engine's own bookkeeping (swaps, commit,
clock, emit, kv_threshold, record), read from the port's host track
(``run.spans``; ``hostspans.attach``). Moves ``offline_tok_s``: the card
waits while the host does it."""
from echo_bench.hostspans import children

OUTSIDE = ("schedule", "runner.prefill", "runner.decode")


def read(run):
    spans = getattr(run, "spans", None)
    steps = [s for s in spans or () if s.name == "step"]
    if not steps:
        return None
    kids = children(spans)
    own = [(s.t1 - s.t0) - sum(c.t1 - c.t0 for c in kids.get(s.id, ()) if c.name in OUTSIDE)
           for s in steps]
    return sum(own) / len(own) / 1e6
