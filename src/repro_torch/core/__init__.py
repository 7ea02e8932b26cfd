"""GraphMat core on PyTorch: vertex programs mapped to generalized SpMV."""

from repro_torch.core.semiring import (  # noqa: F401
    MAX_TIMES, MIN_FIRST, MIN_PLUS, OR_AND, PLUS_TIMES, Semiring)
from repro_torch.core.vertex_program import (  # noqa: F401
    GraphProgram, lanewise_activate, program_from_semiring)
from repro_torch.core.graph import (  # noqa: F401
    CooGraph, DenseGraph, EllGraph, build_coo, build_dense, build_ell,
    dense_adjacency, from_arrays)
from repro_torch.core.spmv import spmv as generalized_spmv  # noqa: F401
from repro_torch.core.spmv import (  # noqa: F401
    spmv_coo, spmv_coo_tiled, spmv_dense, spmv_ell)
from repro_torch.core.backends import (  # noqa: F401
    AUTO_PLAN, Backend, GraphStats, Plan, PlanCache, PlanLike, Planner,
    as_plan, compute_stats, get_backend, register, registered_backends)
from repro_torch.core.engine import (  # noqa: F401
    EngineState, run_fixed_iters, run_graph_program)
from repro_torch.core.distributed import (  # noqa: F401
    DistGraph, Grid, launch, partition_2d, run_graph_program_2d, spmv_2d)
