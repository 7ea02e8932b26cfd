"""Launchers: the training driver (the port of :mod:`repro.launch`; the
production mesh and the multi-pod dry run are not ported yet)."""
