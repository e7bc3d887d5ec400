"""Observability layer: lifecycle tracing (Chrome-trace/Perfetto export),
a labeled metrics registry with Prometheus/JSON exposition, and
estimator-drift probes over the engine's calibration loop.

Import discipline: nothing here may import ``repro_torch.serving`` at module
level — ``repro_torch.serving.events`` imports ``repro_torch.obs.metrics``, which
executes this package init. Probes take the bus duck-typed instead.
"""
from repro_torch.obs.metrics import (Counter, FRACTION_BUCKETS, Gauge, Histogram,
                               ITER_BUCKETS, LATENCY_BUCKETS,
                               MetricsRegistry, REL_ERR_BUCKETS,
                               parse_prometheus)
from repro_torch.obs.probes import (EngineProbe, ServiceMetrics, instrument,
                              instrument_engine)
from repro_torch.obs.trace import Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "EngineProbe", "ServiceMetrics", "instrument", "instrument_engine",
    "parse_prometheus", "LATENCY_BUCKETS", "ITER_BUCKETS",
    "REL_ERR_BUCKETS", "FRACTION_BUCKETS",
]
