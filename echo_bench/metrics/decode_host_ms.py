"""Paged runner: mean host milliseconds of a window ``runner.decode`` span
outside its ``logits`` child (the copy to the host, which waits for the
card): the batch's host arrays, the H2D copies and the Python dispatch of
the stack, from the port's host track (``run.spans``). Moves
``offline_tok_s``."""
from echo_bench.hostspans import children


def read(run):
    spans = getattr(run, "spans", None) or ()
    kids = children(spans)
    own = [(s.t1 - s.t0) - sum(c.t1 - c.t0 for c in kids.get(s.id, ()) if c.name == "logits")
           for s in spans if s.name == "runner.decode"]
    return sum(own) / len(own) / 1e6 if own else None
