"""Echo's co-serving benchmark for the PyTorch/CUDA port (``repro_torch``).

One command, ``python3 echo_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, serves a cell (a configuration under a traffic
mix, both named in ``BENCHMARK.json``) through ``repro_torch``'s
``EchoEngine`` and prints one JSON line. See ``echo_bench/README.md``.
"""
