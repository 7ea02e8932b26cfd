"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

Run one cell from the checkout's root::

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: a cell names a
configuration (``configs/<config>.json``, a deployment's sizes) and a
traffic mix (``traffic/<mix>.json``, parameters that :mod:`graphbench.drive`
reads: how work arrives, and which kinds of work, each a module
``work/<name>.py`` that runs it on the port and judges it); its correctness
limits are ``limits/<cell>.json``; a per-layer metric is read by
``metrics/<metric>.py``.  A configuration's ``container`` names the port's
state and entries it runs on: ``graph`` and ``ratings`` are
:mod:`graphbench.port`'s, any other is ``containers/<container>.py``'s
``Container(config, data, device)``.  Those modules are the only ones that
import the system under test; :mod:`graphbench.reference` is the plain
reference, which imports nothing of it.

So a new configuration is new files alone: its config file, a generator
(``gen/<generator>.py``) where none fits, its container, its kinds of work
(``work/<name>.py``), its reference (``reference/``), its limits, its
readers, and its entries in ``BENCHMARK.json``.
"""
