"""Artifact smoke checks: is this a loadable Chrome trace / parseable
Prometheus exposition?  Used by CI after the benchmark jobs and by the
tests; importable (``check_trace`` / ``check_prometheus``) or runnable:

    python -m repro_torch.obs.check trace.json metrics.prom
"""
from __future__ import annotations

import json
import sys
from typing import List

from repro_torch.obs.metrics import parse_prometheus


def check_trace(path: str) -> dict:
    """Validate a Chrome-trace JSON file; returns summary counts. Raises
    ``ValueError`` on anything Perfetto would refuse to load."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError(f"{path}: no traceEvents array")
    events = data["traceEvents"]
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    n_spans = n_instants = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: event {i} is not an object")
        for key in ("ph", "name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"{path}: event {i} missing {key!r}")
        ph = ev["ph"]
        if ph != "M" and "ts" not in ev:
            raise ValueError(f"{path}: event {i} ({ph!r}) missing ts")
        if ph == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"{path}: span {i} has no valid dur")
            n_spans += 1
        elif ph == "i":
            n_instants += 1
    if n_spans == 0:
        raise ValueError(f"{path}: no complete ('X') spans recorded")
    return {"events": len(events), "spans": n_spans, "instants": n_instants}


def check_prometheus(path: str) -> dict:
    """Validate a Prometheus text file; returns summary counts."""
    with open(path) as f:
        series = parse_prometheus(f.read())
    n = sum(len(v) for v in series.values())
    return {"metrics": len(series), "samples": n}


def main(argv: List[str]) -> int:
    if not argv:
        print("usage: python -m repro_torch.obs.check <artifact>...", file=sys.stderr)
        return 2
    for path in argv:
        try:
            # dispatch on content, not filename: traces are JSON objects
            # with a traceEvents array, anything else is exposition text
            with open(path) as f:
                head = f.read(512)
            if head.lstrip().startswith("{"):
                summary = check_trace(path)
            else:
                summary = check_prometheus(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            return 1
        print(f"ok {path}: " + ", ".join(f"{k}={v}"
                                         for k, v in summary.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
