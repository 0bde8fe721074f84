"""The benchmark of ``ursabench_tpu_torch`` on an NVIDIA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` (``run.py``). A cell's files are found
by name (``core.Registry``): ``workloads/<cell>.json`` (its configuration,
traffic mix, cards and the limits of its checked numbers),
``configs/<config>.json``, ``traffic/<mix>.json`` (the parameters of one
``drivers/<kind>.py``) and ``metrics/<metric>.py`` (one reader each). The
yardstick lives here too: the plain reference (``reference/``), the peaks
(``peaks.py``), the FLOP counts (``flops.py``) and the reduction of a
profiler trace (``trace.py``). ``calibrate.py`` gives the readings a cell's
limits are set from. Nothing here imports JAX or the JAX package.
"""
