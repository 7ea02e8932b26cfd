"""Hand-written "native" baselines (the paper's Table-3 foil), port of
:mod:`repro.algos.native`.

Direct torch versions of each algorithm with no framework machinery: no
GraphProgram dispatch, no property pytrees, no frontier bookkeeping beyond
what the algorithm itself needs.  ``chip_smoke.py`` times GraphMat against
them on the card.
"""

from repro_torch.algos.native.baselines import (  # noqa: F401
    native_bfs, native_cf, native_pagerank, native_sssp, native_tc)
