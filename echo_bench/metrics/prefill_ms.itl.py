"""``prefill_ms`` in a cell whose end-to-end metric is ``itl_p95_ms``: the
offline chunks run beside each decode call lengthen an online token's gap.
The same reading as ``metrics/prefill_ms.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("prefill_ms")
