"""Graph data substrate (copies of :mod:`repro.graphs`' numpy code)."""

from repro_torch.graphs.rmat import rmat_edges, bipartite_ratings  # noqa: F401
from repro_torch.graphs.preprocess import (  # noqa: F401
    dag_orient, dedupe_edges, remove_self_loops, shuffle_vertices, symmetrize)
