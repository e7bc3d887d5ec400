"""``decode_attn_roofline`` in a cell whose end-to-end metric is
``itl_p95_ms``: the decode kernel runs in every online token's step. The
same reading as ``metrics/decode_attn_roofline.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("decode_attn_roofline")
