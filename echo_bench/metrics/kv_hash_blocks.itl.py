"""``kv_hash_blocks`` in a cell whose end-to-end metric is ``itl_p95_ms``: the host
work it reads delays every decode call. The same reading as
``metrics/kv_hash_blocks.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("kv_hash_blocks")
