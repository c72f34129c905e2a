"""The benchmark of the PyTorch and CUDA package ``repro_torch``.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell needs is
found by name: ``configs/<config>.json``, ``mixes/<traffic>.json``,
``cells/<workload>.json`` (its output limits), ``drivers/<kind>.py`` (one
per entry kind of the program), ``metrics/<metric>.py`` (one reader per
metric), ``reference/<family>.py`` (the plain model the outputs are held
to) and ``roofline/<kernel>.py`` (a kernel's operations and bytes).
"""
