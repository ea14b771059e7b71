"""The benchmark of graph_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell uses is found by name under this folder:
``configs/<config>.json`` (a graph and its limits), ``traffic/<mix>.json``
(the requests), ``ops/<op>.py`` (one kind of request through the port's
public entries), ``generators/<name>.py`` (a graph made on the device
from the seed), ``metrics/<metric>.py`` (one reader per metric).
``reference/`` is the plain reference that decides ``correct``; it
imports nothing of the port.
"""
