"""``ttft_p95_ms.host_bound`` in a cell whose end-to-end metric is
``itl_p95_ms``: a new request's first chunk waits for the same steps that
set an online token's gap. The same reading as
``metrics/ttft_p95_ms.host_bound.py``."""
from echo_bench.spec import metric_reader

read = metric_reader("ttft_p95_ms.host_bound")
