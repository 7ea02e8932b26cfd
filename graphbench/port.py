"""The system under test: ``repro_torch``, through its public entry points.

The only module of the benchmark that imports the port.  It hands the
port the benchmark's inputs as the port's users would (host edge arrays
into ``core.graph``'s builders) and gives the drivers the calls that the
timed window makes.  It never imports the JAX package.
"""

from __future__ import annotations

import inspect
import pathlib
import sys
from typing import Dict

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
  sys.path.insert(0, str(SRC))

from repro_torch.algos.pagerank import pagerank  # noqa: E402
from repro_torch.algos.sssp import sssp  # noqa: E402
from repro_torch.core import graph as graphlib  # noqa: E402
from repro_torch.core.backends import Plan, Planner  # noqa: E402
from repro_torch.core.engine import run_fixed_iters  # noqa: E402
from repro_torch.core.vertex_program import GraphProgram  # noqa: E402
from repro_torch.kernels import ell_spmv  # noqa: E402
from repro_torch.service import (GraphQueryServer, QueryFamily,  # noqa: E402
                                 QuerySpec, ServerDriver)
from repro_torch.algos.bfs import bfs  # noqa: E402


def _host(t: torch.Tensor, dtype) -> np.ndarray:
  return t.cpu().numpy().astype(dtype, copy=False)


def ell_calls() -> int:
  """The ELL wrapper's launches so far (the port's own counter): one a
  superstep on a single-query grid."""
  return ell_spmv.launches.total


def ell_kernels() -> int:
  """The ELL kernels those launches put on the card: two for a call on the
  lane-vector grid (its all-active pass, then the grid), else one, as
  ``ell_spmv.kernels_per_call`` says."""
  return sum(count * (2 if key.startswith("lanes/") else 1)
             for key, count in ell_spmv.launches.by_config.items())


def families() -> Dict[str, type]:
  """The port's query families by their ``name``."""
  found, todo = {}, list(QueryFamily.__subclasses__())
  while todo:
    cls = todo.pop()
    found.setdefault(cls.name, cls)
    todo += cls.__subclasses__()
  return found


class GraphPort:
  """One undirected graph as the port's ELL container, and its entries."""

  def __init__(self, config: dict, data: dict, device):
    e = data["edges"]
    self.n = int(data["n"])
    self.device = torch.device(device)
    self.graph = graphlib.build_ell(
        _host(e["src"], np.int32), _host(e["dst"], np.int32),
        _host(e["w"], np.float32), n=self.n, device=self.device)
    self.plan = Plan(config["plan"])
    self.out_deg = torch.bincount(e["src"], minlength=self.n).to(
        torch.int32)

  def _plan(self, plan):
    return self.plan if plan is None else Plan(plan)

  def sssp(self, root: int, plan=None) -> torch.Tensor:
    return sssp(self.graph, root, self.n, backend=self._plan(plan))

  def bfs(self, root: int, plan=None) -> torch.Tensor:
    return bfs(self.graph, root, self.n, backend=self._plan(plan))

  def pagerank(self, iters: int, plan=None) -> torch.Tensor:
    return pagerank(self.graph, self.out_deg, num_iters=iters,
                    backend=self._plan(plan))

  def family(self, name: str):
    """The port's query family ``name``, given what its constructor asks
    for (``n``, or the out-degrees)."""
    cls = families()[name]
    args = inspect.signature(cls.__init__).parameters
    given = {"n": self.n, "out_deg": self.out_deg}
    return cls(**{k: given[k] for k in args if k in given})

  def serve(self, names, num_slots: int, steps_per_round: int, plan=None):
    """One server a family of ``names``, and a started
    :class:`ServerDriver` over them all."""
    servers = [GraphQueryServer(self.graph, self.family(name),
                                num_slots=num_slots,
                                steps_per_round=steps_per_round,
                                backend=self._plan(plan))
               for name in names]
    return servers, ServerDriver(*servers).start()

  @staticmethod
  def query(family: str, source: int) -> QuerySpec:
    return QuerySpec(family, int(source))


class RatingsPort:
  """Collaborative filtering with the configuration's one-leaf program:
  phase U over the item-to-user graph as ELL on ``config["plan_u"]``,
  phase V over the user-to-item graph as COO on the planner's plan."""

  def __init__(self, config: dict, data: dict, device):
    users = int(data["users"])
    self.n = users + int(data["items"])
    self.device = torch.device(device)
    user = _host(data["user"], np.int32)
    vid = _host(data["item"] + users, np.int32)
    rating = _host(data["rating"], np.float32)
    self.g_u = graphlib.build_ell(vid, user, rating, n=self.n,
                                  device=self.device)
    self.g_v = graphlib.build_coo(user, vid, rating, n=self.n,
                                  device=self.device)
    gamma = step_size(user, vid, rating, self.n)
    del user, vid, rating
    prog = config["program"]
    lam = float(config["lam"])
    process = eval("lambda m, e, d: " + prog["process_message"])  # noqa: S307
    apply = eval(f"lambda red, old: {prog['apply']}",  # noqa: S307
                 {"gamma": gamma, "lam": lam})
    self.program = GraphProgram(process_message=process, reduce_kind="add",
                                apply=apply, process_reads_dst=True,
                                name=prog["name"])
    self.plan_u = Plan(config["plan_u"])
    self.plan_v = Planner().plan(self.g_v, self.program)
    self.every = torch.ones((self.n,), dtype=torch.bool, device=self.device)

  def sweep(self, p: torch.Tensor) -> torch.Tensor:
    p = run_fixed_iters(self.g_u, self.program, p, self.every, 1,
                        backend=self.plan_u).prop
    return run_fixed_iters(self.g_v, self.program, p, self.every, 1,
                           backend=self.plan_v).prop


def step_size(user: np.ndarray, vid: np.ndarray, rating: np.ndarray,
              n: int) -> float:
  """The program's gamma, as its user works it out: 1 / (the largest
  degree x the mean rating)."""
  deg = np.bincount(user, minlength=n) + np.bincount(vid, minlength=n)
  return 1.0 / (float(deg.max()) * float(rating.astype(np.float64).mean()))


# The port's container for each configuration's ``container``.
CONTAINERS: Dict[str, type] = {"graph": GraphPort, "ratings": RatingsPort}
