"""``prefill_pad_pct`` in a cell whose end-to-end metric is ``itl_p95_ms``:
a decode waits for the prefill chunks of its step, padded rows and all.
The same reading as ``metrics/prefill_pad_pct.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("prefill_pad_pct")
