"""The benchmark of cutadapt_tpu_torch (the PyTorch and CUDA port).

``python benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (read by ``generate.py``, whose model makes
the reads unless the traffic names a generator of its own under
``generators/``; the traffic also gives how many files a run calls in
turn and whether they are gzip-compressed) and ``metrics/<metric>.py``.
The plain reference that decides ``correct`` is
``reference/<reference>.py``, named by the configuration; it imports
nothing of the port.
"""
