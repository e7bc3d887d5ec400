#!/usr/bin/env python3
"""One run of a cell with the port's host track attached, and what its
spans show.

    python3 echo_bench/tools/host_spans.py --workload yi-9b.docqa --seed 7 --seconds 51 --trace 1

Runs ``run.py``'s ``main`` with the same arguments and ``hostspans.attach``
as its patch, so ``run.py`` prints its own lines first. Then, with
``--trace 1``, one JSON line more: each span reader's value
(``metrics/<name>.py``), the signed median of the estimate's error, and,
where the card was profiled, both clock anchors' offsets, the longest
idle stretches labelled by the innermost program span open as each began,
and the idle time split by the spans it lasted through. With ``--trace 0`` it is
an untraced run whose engine records its spans all the same: the host
track's cost, end to end.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SPAN_METRICS = ("step_host_ms", "est_err_pct", "clock_lag_pct", "kv_scan_blocks",
                "kv_hash_blocks", "prefill_pad_pct", "decode_host_ms")
ANCHOR_SPREAD_NS = 100_000


def main(argv=None) -> int:
    from echo_bench import hostspans, stats
    from echo_bench.run import ROOT, _parse, main as run_main
    from echo_bench.spec import metric_reader
    sessions = []

    def patch(sess):
        hostspans.attach(sess)
        sessions.append(sess)
    rc = run_main(argv, patch=patch)
    if rc != 0 or not sessions or not _parse(argv).trace:
        return rc
    sess = sessions[0]
    rec = sess.rec
    out = {"metrics": {n: metric_reader(n, ROOT)(rec) for n in SPAN_METRICS}}
    errs = hostspans.estimate_errors(rec.spans)
    out["est_err_signed_pct"] = 100.0 * stats.quantile(errs, 0.5) if errs else None
    out["window_spans"] = len(rec.spans)
    out["dropped_events"] = sess.host_tracer.dropped_events
    if rec.trace is not None and sess.anchored is not None:
        clock = hostspans.Clock(sess.anchored.anchors, rec.trace.ranges)
        offs = clock.offsets_ns
        out["anchor_offsets_ns"] = offs
        if abs(offs[-1] - offs[0]) > ANCHOR_SPREAD_NS:
            print(f"host_spans: the anchors' offsets differ by {abs(offs[-1] - offs[0])} ns, "
                  f"more than {ANCHOR_SPREAD_NS}", file=sys.stderr)
        gaps = hostspans.idle_gaps(rec.trace, rec.spans, clock)
        out["idle_gaps"] = [[n, s] for n, s in gaps[:10]]
        out["idle_by_span"] = [[n, s] for n, s in
                               hostspans.idle_by_span(rec.trace, rec.spans, clock)]
        out["idle_s"] = sum(s for _, s in gaps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[2] / "src"),
                    str(Path(__file__).resolve().parents[2])]
    sys.exit(main())
