"""``decode_ms`` in a cell whose end-to-end metric is ``itl_p95_ms``: the
decode call is most of an online token's gap. The same reading as
``metrics/decode_ms.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("decode_ms")
