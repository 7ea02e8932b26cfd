"""Collaborative filtering by gradient descent (port of
:mod:`repro.algos.collab_filter`; the paper's Section 3-III, eqs 3-6).

Incomplete matrix factorization G ≈ P_Uᵀ P_V on the bipartite rating graph.
Each sweep is two generalized-SpMV phases:

  phase U: user u receives (G_uv - p_uᵀp_v)·p_v from each rated item v,
           REDUCE = Σ, APPLY: p_u += γ(Σ - λ p_u)
  phase V: symmetric, items gather from users.

PROCESS_MESSAGE reads the destination's latent vector (GraphMat's
extension).  Its error is a dot product over the K lanes, so it is not the
CUDA ELL kernel's per-lane form ``edge_minus_msg_dst_times_msg``
(``(e - m·d)·m`` lane by lane; the two agree only at K = 1).  The
destination property has two leaves (``{"p", "side"}``), as in the
reference, where that keeps CF off the Pallas kernel; here it runs on the
torch ``coo`` / ``ell`` backends.  The same process over the latent matrix
as the one leaf mixes the lanes on the kernel's lane-vector grid
(``chip_smoke.py`` phase 5 runs it at the Netflix Prize's size).

The reference draws the initial factors from ``jax.random.PRNGKey``, which
torch cannot reproduce: the port takes them as ``p0``, or draws them from
an explicit ``torch.Generator`` on the graph's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.core import graph as graphlib
from repro_torch.core.backends.plan import PlanLike
from repro_torch.core.engine import run_fixed_iters
from repro_torch.core.vertex_program import GraphProgram


def cf_program(gamma: float, lam: float) -> GraphProgram:
  def process(m, e, d):
    # m: sender latent [*edges, K]; e: rating [*edges, 1];
    # d: receiver {"p": [*edges, K], "side": [*edges]}.
    err = e - (m * d["p"]).sum(dim=-1, keepdim=True)
    return err * m

  def apply(red, old):
    newp = old["p"] + gamma * (red - lam * old["p"])
    return {"p": newp, "side": old["side"]}

  return GraphProgram(
      process_message=process,
      reduce_kind="add",
      send_message=lambda prop: prop["p"],
      apply=apply,
      process_reads_dst=True,
      name="collaborative_filtering")


def build_bipartite(users: np.ndarray, items: np.ndarray,
                    ratings: np.ndarray, num_users: int, num_items: int,
                    fmt: str = "coo", device: DeviceLike = "cuda"):
  """Vertices [0, U) are users, [U, U+I) items.  Returns (item->user graph,
  user->item graph, n)."""
  n = num_users + num_items
  item_ids = items + num_users
  build = graphlib.build_coo if fmt == "coo" else graphlib.build_ell
  g_to_users = build(item_ids, users, ratings, n=n, device=device)
  g_to_items = build(users, item_ids, ratings, n=n, device=device)
  return g_to_users, g_to_items, n


def collaborative_filtering(g_to_users, g_to_items, n: int, k: int, *,
                            num_iters: int = 10, gamma: float = 5e-4,
                            lam: float = 0.05, p0=None,
                            generator: Optional[torch.Generator] = None,
                            backend: PlanLike = "auto") -> torch.Tensor:
  """Run ``num_iters`` GD sweeps; returns the latent factors [n, K] (users
  then items) on the graphs' device.

  ``p0`` ([n, K] float32, a tensor or numpy array) gives the initial
  factors; without it they are drawn uniform in [0, 0.1), as the reference
  draws them, from ``generator``, which must then be given.
  """
  dev = g_to_users.device
  if p0 is None:
    if generator is None:
      raise ValueError("give the initial factors p0 or a torch.Generator")
    p0 = torch.rand((n, k), generator=generator, device=dev) * 0.1
  if not isinstance(p0, torch.Tensor):
    p0 = torch.from_numpy(np.array(p0, np.float32))
  p0 = p0.to(device=dev, dtype=torch.float32)
  if tuple(p0.shape) != (n, k):
    raise ValueError(f"p0 has shape {tuple(p0.shape)}, not {(n, k)}")
  prop = {"p": p0, "side": torch.zeros((n,), dtype=torch.int8, device=dev)}
  prog = cf_program(gamma, lam)
  active = torch.ones((n,), dtype=torch.bool, device=dev)
  for _ in range(num_iters):
    # Phase U: users gather from items; phase V: items gather from users.
    prop = run_fixed_iters(g_to_users, prog, prop, active, 1,
                           backend=backend).prop
    prop = run_fixed_iters(g_to_items, prog, prop, active, 1,
                           backend=backend).prop
  return prop["p"]
