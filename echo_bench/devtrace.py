"""The profiled sub-window of a ``--trace 1`` run, and what it shows.

``torch.profiler`` (CPU and CUDA activity) is started between engine steps
near the end of the measured window and stopped at the first step
boundary after it closes. Each trace opens with ``PRIMER_LAUNCHES`` small
launches (the profiler at times drops the first device records of a trace;
the primer takes those losses, as in ``chip_smoke._trace``), then a range
``eb.window`` that holds whole engine steps. Inside it the benchmark's own
ranges name what the host was doing: ``eb.step`` (one ``engine.step``),
``eb.schedule`` (``scheduler.schedule``), ``eb.prefill#i`` and
``eb.decode#i`` (the i-th runner call of the run, whose arguments the
harness kept). A range also leaves a device-side annotation, which is not
an operation and is skipped.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PRIMER_LAUNCHES = 1024
DEVICE_CALLS = ("LaunchKernel", "MemcpyAsync", "MemsetAsync")
WINDOW = "eb.window"
LABELS = {"eb.prefill": "prefill call", "eb.decode": "decode call",
          "eb.schedule": "schedule", "eb.step": "engine step, other",
          None: "generator and harness"}


@dataclass
class Trace:
    """One profiled sub-window: times in ns on the profiler's clock."""
    start: int
    end: int
    ranges: List[Tuple[str, int, int]]              # (name, start, end)
    ops: List[Tuple[str, int, int, int]]            # (name, start, end, correlation id)
    launch_at: Dict[int, int]                       # correlation id -> host call start
    lacking: int                                    # launches with no device record
    calls: Dict[str, List[Tuple[int, int, int]]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """Merged intervals in which some device operation ran, clipped to
        the window."""
        iv = sorted((max(s, self.start), min(e, self.end)) for _, s, e, _ in self.ops
                    if e > self.start and s < self.end)
        out: List[List[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def _labels(self) -> List[Tuple[int, Optional[str]]]:
        """(time, innermost benchmark range from then on) at every range
        edge; the ranges nest."""
        # at one instant: closes before opens, an inner range closes first
        # and an outer one opens first
        edges = sorted([(s, 1, -e, n) for n, s, e in self.ranges if n != WINDOW]
                       + [(e, 0, -s, n) for n, s, e in self.ranges if n != WINDOW])
        stack: List[str] = []
        points = [(self.start, None)]
        for t, opens, _, name in edges:
            if opens:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            points.append((t, stack[-1].split("#")[0] if stack else None))
        return points

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Every stretch of the window with no device operation, longest
        first, labelled by what the host was doing as it began."""
        points = self._labels()
        times = [p[0] for p in points]
        gaps, t = [], self.start
        for s, e in self.busy() + [(self.end, self.end)]:
            if s > t:
                label = points[bisect.bisect_right(times, t) - 1][1]
                gaps.append((LABELS.get(label, label), (s - t) / 1e9))
            t = max(t, e)
        return sorted(gaps, key=lambda g: -g[1])

    def device_ops(self) -> List[Tuple[str, float, int]]:
        """(name, seconds, count) of the device operations, most time first."""
        by: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for name, s, e, _ in self.ops:
            by[name][0] += (e - s) / 1e9
            by[name][1] += 1
        return sorted(((n, t, c) for n, (t, c) in by.items()), key=lambda x: -x[1])

    def call_of(self, corr: int) -> Optional[Tuple[str, int]]:
        """The runner call (kind, index) whose range holds the host call
        that launched the operation ``corr``."""
        t = self.launch_at.get(corr)
        if t is None:
            return None
        for kind, spans in self.calls.items():
            i = bisect.bisect_right(spans, (t, float("inf"), 0)) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                return kind, spans[i][2]
        return None

    def kernel_calls(self, name_part: str) -> List[Tuple[float, Tuple[str, int]]]:
        """(seconds, runner call) of each launch of a kernel whose name holds
        ``name_part``, for the launches a runner call made."""
        out = []
        for name, s, e, corr in self.ops:
            if name_part in name:
                call = self.call_of(corr)
                if call is not None:
                    out.append(((e - s) / 1e9, call))
        return out


class Profiler:
    """Starts and stops one sub-window; ``mark(name)`` wraps host work in a
    named range while the profiler runs and costs nothing otherwise."""

    def __init__(self):
        self.prof = None
        self._window = None
        self._stopped = None
        self._trace: Optional[Trace] = None

    @property
    def done(self) -> bool:
        return self._stopped is not None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def prime(self) -> None:
        """One empty trace at set-up: the profiler's first start loads and
        initialises CUPTI, seconds that would otherwise stall the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        buf = torch.zeros(1, device="cuda")
        for _ in range(PRIMER_LAUNCHES):
            buf.add_(1)
        torch.cuda.synchronize()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def mark(self, name: str):
        from torch.profiler import record_function
        return record_function(name)

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self._stopped, self.prof = self.prof, None

    def trace(self) -> Optional[Trace]:
        """The sub-window, read once the run is over (reading its events
        takes seconds)."""
        if self._trace is None and self._stopped is not None:
            self._trace = parse(self._stopped.profiler.kineto_results.events())
        return self._trace


def parse(events) -> Trace:
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges, host_calls, ops = [], [], []
    for e in events:
        dt = e.device_type()
        if dt == cpu:
            name = e.name()
            if name.startswith("eb."):
                ranges.append((name, e.start_ns(), e.end_ns()))
            elif any(c in name for c in DEVICE_CALLS):
                host_calls.append((e.correlation_id(), e.start_ns()))
        elif dt == cuda and not e.is_user_annotation():
            ops.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    window = next(r for r in ranges if r[0] == WINDOW)
    start, end = window[1], window[2]
    inside = {c: t for c, t in host_calls if start <= t <= end}
    on_device = {corr for _, _, _, corr in ops}
    ops = [o for o in ops if o[3] in inside]
    calls: Dict[str, List[Tuple[int, int, int]]] = defaultdict(list)
    for name, s, e in ranges:
        kind, _, idx = name.partition("#")
        if idx:
            calls[kind].append((s, e, int(idx)))
    for spans in calls.values():
        spans.sort()
    return Trace(start=start, end=end, ranges=ranges, ops=ops, launch_at=inside,
                 lacking=len(set(inside) - on_device), calls=dict(calls))
