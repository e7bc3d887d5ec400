"""Labeled counters, gauges, and fixed-bucket histograms with JSON and
Prometheus text exposition.

Design constraints (ISSUE 6): bounded overhead when enabled, zero when not.
Hot paths resolve a labeled child ONCE (``metric.labels(...)`` returns a
cached handle) and then do plain attribute arithmetic per event — no dict
construction, no label hashing, no allocation on the event path. Histograms
are pre-bucketed: ``observe`` is one ``bisect`` into a fixed bound tuple
plus two adds. Percentile queries interpolate inside the bucket, which is
exact enough for p50/p90/p99 reporting and costs O(buckets) only at query
time, never at record time.

The module is import-clean (stdlib only) so anything — serving, engine,
benchmarks — can embed a ``Histogram`` without dragging in the rest of the
observability layer.
"""
from __future__ import annotations

import json
import re
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Shared bucket families (seconds unless noted). Chosen to straddle the
# virtual-clock magnitudes of the A100/H100 presets: iteration times land in
# the 1-100 ms decades, TTFT/queue delay in 10 ms - 10 s, and relative
# errors (unitless) in 0.5% - 500%.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
ITER_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0)
REL_ERR_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0)
FRACTION_BUCKETS = (0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7,
                    0.8, 0.9, 0.95, 0.99, 1.0)
# Per-iteration PCIe swap payloads (bytes): state-family snapshots sit in
# the 10 KB - 1 MB decades, paged KV restores in 1 MB - 1 GB.
BYTES_BUCKETS = (1e4, 1e5, 1e6, 4e6, 1.6e7, 6.4e7, 2.56e8, 1e9)


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> Optional[float]:
        """Linear interpolation inside the target bucket; the overflow
        bucket reports its lower bound (there is no upper edge to reach)."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0.0
        lo = 0.0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                hi = self.bounds[i] if i < len(self.bounds) else lo
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
            if i < len(self.bounds):
                lo = self.bounds[i]
        return self.bounds[-1]


class _Metric:
    """Shared labeled-children machinery. ``labels()`` returns the cached
    child for a label-value tuple — resolve once, hold the handle."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.label_names:                 # unlabeled: one child
            self._default = self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        if kv:
            values = tuple(str(kv[k]) for k in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        child = self._children.get(values)
        if child is None:
            if len(values) != len(self.label_names):
                raise ValueError(f"{self.name}: expected labels "
                                 f"{self.label_names}, got {values}")
            child = self._children[values] = self._new_child()
        return child

    # unlabeled sugar --------------------------------------------------
    def inc(self, v: float = 1.0) -> None:
        self._default.inc(v)

    def set(self, v: float) -> None:
        self._default.set(v)

    def observe(self, v: float) -> None:
        self._default.observe(v)

    def percentile(self, q: float):
        return self._default.percentile(q)


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (), *,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        super().__init__(name, help, labels)

    def _new_child(self):
        return _HistogramChild(self.buckets)


class MetricsRegistry:
    """Flat registry of named metrics with dual exposition.

    ``to_prometheus()`` emits the text format (``<ns>_<name>`` full names,
    histogram ``_bucket``/``_sum``/``_count`` series with cumulative
    ``le`` labels); ``to_json()`` a structured snapshot for artifacts."""

    def __init__(self, namespace: str = "echo"):
        self.namespace = namespace
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, metric: _Metric) -> _Metric:
        existing = self._metrics.get(metric.name)
        if existing is not None:
            if type(existing) is not type(metric) or \
                    existing.label_names != metric.label_names:
                raise ValueError(f"metric {metric.name!r} re-registered "
                                 "with a different shape")
            return existing
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labels))

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labels))

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), *,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help, labels, buckets=buckets))

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def __iter__(self) -> Iterable[_Metric]:
        return iter(self._metrics.values())

    # ------------------------------------------------------------ exposition
    @staticmethod
    def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                    extra: str = "") -> str:
        parts = [f'{k}="{_escape(v)}"' for k, v in zip(names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in self._metrics.values():
            full = f"{self.namespace}_{m.name}"
            lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind}")
            for values, child in sorted(m._children.items()):
                if m.kind == "histogram":
                    cum = 0
                    for bound, c in zip(m.buckets, child.counts):
                        cum += c
                        lab = self._fmt_labels(m.label_names, values,
                                               f'le="{_fmt(bound)}"')
                        lines.append(f"{full}_bucket{lab} {cum}")
                    cum += child.counts[-1]
                    lab = self._fmt_labels(m.label_names, values, 'le="+Inf"')
                    lines.append(f"{full}_bucket{lab} {cum}")
                    lab = self._fmt_labels(m.label_names, values)
                    lines.append(f"{full}_sum{lab} {_fmt(child.sum)}")
                    lines.append(f"{full}_count{lab} {child.count}")
                else:
                    lab = self._fmt_labels(m.label_names, values)
                    lines.append(f"{full}{lab} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        out: Dict[str, dict] = {}
        for m in self._metrics.values():
            entry: dict = {"type": m.kind, "help": m.help,
                           "labels": list(m.label_names)}
            series = []
            for values, child in sorted(m._children.items()):
                if m.kind == "histogram":
                    series.append({"labels": list(values),
                                   "buckets": list(m.buckets),
                                   "counts": list(child.counts),
                                   "sum": child.sum, "count": child.count})
                else:
                    series.append({"labels": list(values),
                                   "value": child.value})
            entry["series"] = series
            out[f"{self.namespace}_{m.name}"] = entry
        return out

    def write(self, path: str) -> None:
        """JSON for ``.json`` paths, Prometheus text otherwise."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.to_json(), f, indent=2)
        else:
            with open(path, "w") as f:
                f.write(self.to_prometheus())


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"           # metric name
    r"(\{[^}]*\})?"                           # optional label set
    r"\s+(-?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\+?Inf|NaN))\s*$")


def parse_prometheus(text: str) -> Dict[str, List[Tuple[str, float]]]:
    """Minimal exposition-format parser used by the CI smoke check and the
    tests: returns ``{metric_name: [(label_block, value), ...]}`` and raises
    ``ValueError`` on any malformed line."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i + 1}: not a valid sample: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        v = float("inf") if value.lstrip("+") == "Inf" else float(value)
        out.setdefault(name, []).append((labels, v))
    if not out:
        raise ValueError("no samples found")
    return out
