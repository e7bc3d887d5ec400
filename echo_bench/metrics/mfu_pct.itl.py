"""``mfu_pct`` in a cell whose end-to-end metric is ``itl_p95_ms``: the whole
step's share of the peak bounds what a kernel's gain can give the gap. The
same reading as ``metrics/mfu_pct.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("mfu_pct")
