#!/usr/bin/env python3
"""What one span site of the port's host track costs on this host's CPU,
with the track off (``host_track is None``: one test) and on (a
``HostTrack.switch``: close the open span into the ring and open the next
one, one clock read), each less an empty loop's time per pass.

    PYTHONPATH=src python3 tools/host_track_cost.py [--n 1000000]

Prints one JSON line of nanoseconds per site, the median of 7 repeats.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import types


def per_pass(fn, n: int) -> float:
    t0 = time.perf_counter_ns()
    fn(n)
    return (time.perf_counter_ns() - t0) / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    from repro_torch.obs import Tracer

    def empty(n, ht=None):
        for _ in range(n):
            pass

    def site(n, ht=None):
        for _ in range(n):
            if ht is not None:
                ht.switch("commit")

    def on(n):
        tracer = Tracer(cap=n + 16)
        engine = types.SimpleNamespace(scheduler=types.SimpleNamespace(), runner=None)
        ht = tracer.attach_host(engine)
        ht.open("schedule", t=ht.open("step"))
        site(n, ht)

    rows = {"empty": [], "off": [], "on": []}
    for _ in range(7):
        rows["empty"].append(per_pass(empty, args.n))
        rows["off"].append(per_pass(site, args.n))
        rows["on"].append(per_pass(on, args.n))
    base = statistics.median(rows["empty"])
    print(json.dumps({"n": args.n, "empty_loop_ns": base,
                      "off_ns": statistics.median(rows["off"]) - base,
                      "on_ns": statistics.median(rows["on"]) - base}))


if __name__ == "__main__":
    main()
