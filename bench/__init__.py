"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` serves one cell of ``BENCHMARK.json`` on the card and prints one
JSON line of metrics. Everything that belongs to one configuration, cell,
traffic kind, model family (its model, weights, work counts and
reference) or metric is a file of its own, found by its name
(``bench/lib/spec.py``), so a new cell, configuration, architecture,
traffic kind or metric is new files plus a ``BENCHMARK.json`` entry.
"""
