"""GraphMat on PyTorch and CUDA: the port of the JAX package :mod:`repro`.

The layout mirrors :mod:`repro` (``graphs``, ``core``, ``kernels``,
``algos``, ``service``).  The package imports ``torch`` and ``numpy`` and
nothing of JAX or of :mod:`repro`.  Entry points take a ``device`` (default
``"cuda"``) and raise when no card is present unless the caller passes
``device="cpu"``; functions on an existing graph run on the graph's device.
"""
