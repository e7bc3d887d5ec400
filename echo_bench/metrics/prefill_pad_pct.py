"""Paged runner: the share of the rows computed by the window's
``prefill_chunk`` calls that no token filled: 100 x (rows computed - live
rows) / rows computed. Computed from the harness's own record of the
calls, not counted by the runner: live rows are each call's chunk, rows
computed what the runner pads it to by its rule
(``repro_torch.models.paged.padded_rows``). A 16-64-token question tail
costs a whole chunk. Moves ``offline_tok_s``."""


def read(run):
    try:
        from repro_torch.models.paged import padded_rows
    except ImportError:
        return None
    calls = [c for c in run.calls if c.kind == "prefill" and run.in_window(c.t0)]
    rows = sum(padded_rows("prefill", c.chunk, run.engine["chunk_size"]) for c in calls)
    live = sum(c.chunk for c in calls)
    return 100.0 * (rows - live) / rows if rows else None
