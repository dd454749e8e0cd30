"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``
once (``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``). See ``benchmark/README.md``."""
