"""``offline_computed_tok_s`` in a cell whose end-to-end metric is ``itl_p95_ms``: the
offline work it reads is what runs beside each decode call. The same
reading as ``metrics/offline_computed_tok_s.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("offline_computed_tok_s")
