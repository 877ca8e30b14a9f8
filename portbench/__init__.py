"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything the benchmark measures with lives here: the traffic
drivers, the plain references, the work counts and the table of peaks,
the metric readers and the comparison that decides ``correct``.  It
imports neither JAX nor the JAX package; of the port it takes only the
entry points it times (``solve``, the service and its client).

Each configuration (``configs/<name>.json``), cell
(``workloads/<name>.json``), traffic driver (``traffic/<name>.py``),
metric reader (``metrics/<name>.py``) and work count
(``work/<config>.py``) is a file of its own, found by name.
"""
