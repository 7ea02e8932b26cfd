"""Cost counting of one step (the port of :mod:`repro.analysis`):
:func:`repro_torch.analysis.cost.analyze` counts the flops, bytes,
transcendentals and collectives each rank dispatches."""

from repro_torch.analysis.cost import CostMode, analyze, collective_bytes

__all__ = ["CostMode", "analyze", "collective_bytes"]
