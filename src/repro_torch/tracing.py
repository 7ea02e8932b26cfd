"""Spans at the port's layer boundaries, on the profiler's own clock.

``with tracing.span(tracing.SPILL): ...`` opens a ``torch.profiler`` range
while a profiler session records, and otherwise the one shared
:data:`NULL` context, so an untraced call pays for one check of a flag.
The ranges are kineto host events of the session that also holds the
card's activity, so they share its clock; nothing is kept or exported
here, the session collects them (an operator's ``torch.profiler.profile``,
or a benchmark's traced window).  Nesting on a thread gives each span its
parent.

A range is a ``torch._C._profiler._RecordFunctionFast``: the RecordFunction
that ``torch.profiler.record_function`` opens, entered from C++, at about an
eighth of ``record_function``'s cost while a session records (that one
goes through Python and two operator calls).  It is recorded as a host
operation (``cpu_op``), not a user annotation, so it draws no range on the
card's track; the kernels it launched link to it through their launches.

The flag is ``torch.autograd.profiler._is_profiler_enabled``, which torch
sets at every profiler start and clears at its stop, for the whole
process.  ``torch._C._autograd._profiler_enabled()`` is the calling
thread's own state: it reads False on a server's driver thread, and on
every thread of a session started with ``profile_all_threads``, while
that session records them.  A session without that option records only
the thread that started it (and the threads it hands its state to); a
span on another thread then costs its enter and exit and records nothing.

Names are ``graphmat.<layer>.<what>``, constants here, so nothing is
formatted per call.  The counters stay where they are:
``service.metrics.Counters`` and ``kernels.ell_spmv.launches``.
"""

from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# service: GraphQueryServer.step_round and its parts.
ROUND = "graphmat.service.round"
ADMIT = "graphmat.service.admit"
ROUND_READ = "graphmat.service.round_read"
RETIRE = "graphmat.service.retire"
# engine: one superstep (single-query or batched), the host's read of it,
# one level of a level sweep (run_level_sweep).
SUPERSTEP = "graphmat.engine.superstep"
HOST_READ = "graphmat.engine.host_read"
LEVEL = "graphmat.engine.level"
# algos: betweenness centrality's two passes (algos/bc.py).
BC_FORWARD = "graphmat.algos.bc.forward"
BC_BACKWARD = "graphmat.algos.bc.backward"
# spmv: the backend that executes a call (SPMV + its registered name, as
# Backend.span), the spill merge.
SPMV = "graphmat.spmv."
SPILL = "graphmat.spmv.merge_spill"
# kernels: the ELL wrapper's checks, table choice and launch.
ELL_SPMV = "graphmat.kernels.ell_spmv"

NULL = contextlib.nullcontext()


def span(name: str):
  """A profiler range named ``name`` while a profiler records, else
  :data:`NULL`."""
  if _profiler._is_profiler_enabled:
    return _RecordFunctionFast(name)
  return NULL
