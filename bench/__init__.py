"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell is ``python3 bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  What a cell is made of is named in ``BENCHMARK.json``
and found here by name (:mod:`bench.spec`)."""
