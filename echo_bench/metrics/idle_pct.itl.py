"""``idle_pct`` in a cell whose end-to-end metric is ``itl_p95_ms``: the card
waits on the host in every online token's step. The same reading as
``metrics/idle_pct.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("idle_pct")
