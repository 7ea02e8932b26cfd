"""The plain reference: each algorithm the cells run, in plain PyTorch over
the benchmark's own edge list, with no kernel, container or plan of the
system under test.  It imports nothing of the port and nothing of the JAX
package; it works out again whatever the port derives (degrees, step
sizes, frontiers).  ``dtype`` selects the precision: the configuration's,
or the control's one step below it."""
