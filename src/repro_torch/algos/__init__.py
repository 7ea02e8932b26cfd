"""The paper's traversal and ranking algorithms as vertex programs (port of
:mod:`repro.algos`; triangle counting and collaborative filtering are not
ported yet)."""

from repro_torch.algos.pagerank import pagerank, pagerank_program  # noqa: F401
from repro_torch.algos.bfs import bfs, bfs_program  # noqa: F401
from repro_torch.algos.sssp import sssp, sssp_program  # noqa: F401
from repro_torch.algos.multi import (multi_bfs, multi_sssp,  # noqa: F401
                                     personalized_pagerank)
