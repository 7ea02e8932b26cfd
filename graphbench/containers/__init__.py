"""The port's containers that ``graphbench.port`` does not hold, one module
each, found by a configuration's ``container``:
``graphbench/containers/<container>.py`` defines ``Container(config, data,
device)``, which builds the port's state from the benchmark's inputs as a
user would and gives the work kinds the calls that the timed window makes.
These modules, with ``port.py``, are the only ones of the benchmark that
import the port (``repro_torch``); none imports JAX or the JAX package.
"""
