"""The paper's five algorithms (Section 3) as GraphMat vertex programs (port
of :mod:`repro.algos`), their multi-query forms, and GAP's betweenness
centrality on the multi-query engine (``bc.py``)."""

from repro_torch.algos.pagerank import pagerank, pagerank_program  # noqa: F401
from repro_torch.algos.bfs import bfs, bfs_program  # noqa: F401
from repro_torch.algos.sssp import sssp, sssp_program  # noqa: F401
from repro_torch.algos.triangle_count import triangle_count  # noqa: F401
from repro_torch.algos.collab_filter import (  # noqa: F401
    collaborative_filtering)
from repro_torch.algos.multi import (multi_bfs, multi_sssp,  # noqa: F401
                                     personalized_pagerank)
from repro_torch.algos.bc import betweenness  # noqa: F401
