"""``kv_used_pct`` in a cell whose end-to-end metric is ``itl_p95_ms``: the
offline work it reads is what runs beside each decode call. The same
reading as ``metrics/kv_used_pct.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("kv_used_pct")
