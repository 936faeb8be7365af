"""The benchmark of ``repro_torch``, the PyTorch + CUDA port of Pipelined CG.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on one H100:

    python3 -m bench.run --workload poisson125.solve --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``, and the operator generators and program forms the
configurations name (``operators/<name>.py``, ``forms/<name>.py``). The
yardstick lives here too: the traffic generator (``loadgen``), the byte
counts and peaks (``roofline``), the trace reduction (``trace``) and the
plain float64 reference that decides ``correct`` (``reference``), which
imports nothing of the program.
"""
