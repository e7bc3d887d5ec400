"""``sched_ms`` in a cell whose end-to-end metric is ``itl_p95_ms``: every step
schedules before it runs. The same reading as ``metrics/sched_ms.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("sched_ms")
