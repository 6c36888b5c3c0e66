"""cellbench: the benchmark of ``arcle_tpu_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 cellbench/run.py --workload o2arc_mlp.ppo --seed 7 --seconds 40 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the driver it
names, ``drivers/<driver>.py``), ``kinds/<kind>.py`` (how a configuration's
kind is built in the port and in the reference), ``metrics/<metric>.py``
and ``limits/<workload>.json``.  ``reference/`` holds the plain reference
that decides ``correct``; ``cost/`` the frozen yardsticks (model FLOPs,
the step kernel's bytes, the card's peaks).
"""
