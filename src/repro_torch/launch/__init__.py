"""Launchers (the port of :mod:`repro.launch`): the training driver
(``train``), the production meshes (``mesh``), the input specs and
shardings of every (arch × shape) cell (``specs``) and the multi-pod dry
run (``dryrun``)."""
