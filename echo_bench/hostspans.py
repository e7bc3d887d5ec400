"""The port's own host track in a run: its spans, and their place on the
device trace's clock.

``attach(session)`` turns on ``repro_torch``'s host track
(``Tracer.attach_host``) for the session's engine before its run: the
engine, its scheduler and the paged runner then record their own spans
(``step`` and its children, the scheduler's phases, each runner call's
``prep``, ``forward`` and ``logits``) on ``time.perf_counter_ns``, the
benchmark's clock. When the run ends, ``session.rec.spans`` holds the
spans of the steps that began in the window, children and all.

Where the session profiles a sub-window, the profiler's start and stop
each take an anchor: ``perf_counter_ns`` read on each side of a
``record_function`` enter, paired with that range's ``start_ns`` on the
profiler's clock (``c10::getTime``, the realtime clock). ``Clock`` maps a
host stamp onto the trace's clock between the two anchors, and
``idle_gaps`` names each idle stretch of the device by the innermost
program span open as it began.

``tools/host_spans.py`` runs a cell this way and prints what the span
readers (``metrics/step_host_ms.py`` and the others) read.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

ANCHOR = "eb.anchor"
ANCHOR_TRIES = 8          # the anchor taken is the try with the tightest bracket
CAP = 2_000_000           # ring events: a whole run's spans


@dataclass
class Anchor:
    """One pairing of the two clocks: the host's stamps ``a`` and ``b``
    around the enter of the range ``name``, whose start the trace holds."""
    name: str
    a: int
    b: int

    @property
    def host_ns(self) -> int:
        return (self.a + self.b) // 2


def take_anchor(name: str) -> Anchor:
    """The tightest of ``ANCHOR_TRIES`` brackets around a range's enter;
    each try is its own range (``name.i``)."""
    from torch.profiler import record_function
    best = None
    for i in range(ANCHOR_TRIES):
        rf = record_function(f"{name}.{i}")
        a = time.perf_counter_ns()
        rf.__enter__()
        b = time.perf_counter_ns()
        rf.__exit__(None, None, None)
        if best is None or b - a < best.b - best.a:
            best = Anchor(f"{name}.{i}", a, b)
    return best


class Clock:
    """Host stamps onto the trace's clock: the offset of each anchor,
    interpolated between them."""

    def __init__(self, anchors: Sequence[Anchor], ranges):
        starts = {n: s for n, s, _ in ranges}
        self.points = [(an.host_ns, starts[an.name] - an.host_ns) for an in anchors]

    @property
    def offsets_ns(self) -> List[int]:
        return [off for _, off in self.points]

    def __call__(self, t: int) -> float:
        (h0, o0), (h1, o1) = self.points[0], self.points[-1]
        if h1 == h0:
            return t + o0
        return t + o0 + (o1 - o0) * (t - h0) / (h1 - h0)


class _Anchored:
    """The session's profiler with an anchor taken as it starts and as it
    stops (inside the ``eb.window`` range)."""

    def __init__(self, prof):
        self.anchors: List[Anchor] = []
        start, stop = prof.start, prof.stop

        def start_():
            start()
            self.anchors.append(take_anchor(f"{ANCHOR}.start"))

        def stop_():
            self.anchors.append(take_anchor(f"{ANCHOR}.stop"))
            stop()
        prof.start, prof.stop = start_, stop_


def attach(session, cap: int = CAP):
    """Turn on the engine's host track for ``session`` (an
    ``echo_bench.serve.Session``, before its run). Returns the tracer; the
    profiler's anchors, if it profiles, are ``session.anchored.anchors``."""
    from repro_torch.obs import Tracer
    tracer = Tracer(cap=cap)
    tracer.attach_host(session.engine)
    session.host_tracer = tracer
    session.anchored = _Anchored(session.profiler) if session.profiler else None
    run = session.run

    def run_(*a, **k):
        out = run(*a, **k)
        session.rec.spans = window_spans(tracer.host_spans(), session.rec.window)
        return out
    session.run = run_
    return tracer


def window_spans(spans, window: Tuple[float, float]) -> list:
    """The ``step`` spans that began in ``window`` (seconds on
    ``perf_counter``), with every span under them."""
    w0, w1 = window
    parent = {s.id: s.parent for s in spans}
    roots = {s.id for s in spans if s.name == "step" and w0 <= s.t0 / 1e9 < w1}

    def root(i):
        while parent.get(i):
            i = parent[i]
        return i
    return [s for s in spans if root(s.id) in roots]


def children(spans) -> Dict[int, list]:
    """Span id -> its children."""
    out: Dict[int, list] = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def estimate_errors(spans) -> List[float]:
    """(``predicted_us`` - runner time) / runner time of each ``step`` that
    called the runner; its runner time is the sum of its ``runner.prefill``
    and ``runner.decode`` spans."""
    kids = children(spans)
    out = []
    for s in spans:
        if s.name != "step":
            continue
        ran = sum(c.t1 - c.t0 for c in kids.get(s.id, ())
                  if c.name in ("runner.prefill", "runner.decode")) / 1e3
        if ran > 0:
            out.append((s.args["predicted_us"] - ran) / ran)
    return out


def _paths(spans, clock) -> Tuple[List[float], List[Optional[str]]]:
    """(time, label) at every span edge, on the trace's clock: the label
    is the innermost open span's path below ``step`` (``commit``,
    ``runner.decode/logits``), ``step`` itself, or None with none open."""
    by_id = {s.id: s for s in spans}

    def path(s) -> str:
        names = []
        while s is not None and s.name != "step":
            names.append(s.name)
            s = by_id.get(s.parent)
        return "/".join(reversed(names)) or "step"
    # at one instant: closes before opens, an inner span closes first and
    # an outer one opens first
    edges = sorted([(clock(s.t0), 1, -s.t1, s.id) for s in spans]
                   + [(clock(s.t1), 0, -s.t0, s.id) for s in spans])
    stack: List[int] = []
    times, labels = [], []
    for t, opens, _, sid in edges:
        if opens:
            stack.append(sid)
        elif sid in stack:
            stack.remove(sid)
        times.append(t)
        labels.append(path(by_id[stack[-1]]) if stack else None)
    return times, labels


def _label_at(t, times, labels, eb, eb_times) -> str:
    """The innermost program span's path at ``t``, or the benchmark's own
    range label (``Trace.idle_gaps``' names) where none is open."""
    from echo_bench.devtrace import LABELS
    i = bisect.bisect_right(times, t) - 1
    label = labels[i] if i >= 0 else None
    if label is None:
        name = eb[bisect.bisect_right(eb_times, t) - 1][1]
        if name is not None and name.startswith(ANCHOR):
            name = None                  # the harness, between steps
        label = LABELS.get(name, name)
    return label


def idle_gaps(trace, spans, clock) -> List[Tuple[str, float]]:
    """Every stretch of the profiled sub-window with no device operation,
    longest first, labelled as it began: by the innermost program span
    open, or by the benchmark's own range where no program span is open."""
    times, labels = _paths(spans, clock)
    eb = trace._labels()
    eb_times = [p[0] for p in eb]
    gaps, t = [], trace.start
    for s, e in trace.busy() + [(trace.end, trace.end)]:
        if s > t:
            gaps.append((_label_at(t, times, labels, eb, eb_times), (s - t) / 1e9))
        t = max(t, e)
    return sorted(gaps, key=lambda g: -g[1])


def idle_by_span(trace, spans, clock) -> List[Tuple[str, float]]:
    """The sub-window's idle seconds split by what the host was doing
    through them: each idle stretch cut at every span edge and every
    benchmark range edge, each piece given to the innermost span then
    open (labels as ``idle_gaps``'), summed by label, most first. A gap
    that began in ``logits`` and lasted through the step's bookkeeping is
    charged to each span it spans."""
    times, labels = _paths(spans, clock)
    eb = trace._labels()
    eb_times = [p[0] for p in eb]
    cuts = sorted(set(times) | set(eb_times))
    out: Dict[str, float] = {}
    t = trace.start
    for s, e in trace.busy() + [(trace.end, trace.end)]:
        if s > t:
            edges = [t] + cuts[bisect.bisect_right(cuts, t):bisect.bisect_left(cuts, s)] + [s]
            for a, b in zip(edges, edges[1:]):
                label = _label_at(a, times, labels, eb, eb_times)
                out[label] = out.get(label, 0.0) + (b - a) / 1e9
        t = max(t, e)
    return sorted(out.items(), key=lambda x: -x[1])
