"""``prefill_attn_roofline`` in a cell whose end-to-end metric is
``itl_p95_ms``: the prefill kernel runs inside the chunks beside each decode
call. The same reading as ``metrics/prefill_attn_roofline.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("prefill_attn_roofline")
