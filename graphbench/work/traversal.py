"""What BFS and SSSP share: a traversal from a root, run alone back to back
from Graph500's search keys or served as a query, and checked root by root
against the reference's distances."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from graphbench import check, roofline
from graphbench.reference import components
from graphbench.reference import sssp as ref_sssp
from graphbench.work import Work, rng

REF_LANES = 8


class Traversal(Work):
  """A subclass names the port's entry and family (``family``), whether the
  process reads the edge's value (``value_bytes``), and gives
  :meth:`edges` (what the reference traverses), :meth:`answer` (the
  port's answer as the reference's float distances) and :meth:`control`."""

  value_bytes = 4

  def __init__(self, *args):
    super().__init__(*args)
    t = self.traffic
    self.n = int(self.data["n"])
    if "search_keys" in t:
      # Graph500's search keys, the same vertices under every seed, in the
      # seed's order.
      keys = self.data["keys"][:int(t["search_keys"])].cpu().numpy()
      self.roots = keys[rng(self.seed).permutation(keys.size)]
      self.warm_roots = self.roots[:int(t.get("warmup_runs", 1))]
    self.frontiers: List = []
    self.picked: List[dict] = []

  # -- the reference's side ---------------------------------------------------

  def edges(self) -> Dict[str, torch.Tensor]:
    return self.data["edges"]

  def answer(self, got) -> torch.Tensor:
    return torch.as_tensor(got).to(self.data["edges"]["src"].device,
                                   torch.float32).flatten()

  def reference(self, roots: Sequence[int], dtype=torch.float32,
                frontiers: Optional[List] = None) -> List[torch.Tensor]:
    dev = self.data["edges"]["src"].device
    out = []
    for lo in range(0, len(roots), REF_LANES):
      block = torch.as_tensor(list(roots[lo:lo + REF_LANES]), device=dev)
      d = ref_sssp.sssp(self.edges(), self.n, block, dtype=dtype,
                        frontiers=frontiers)
      out += [d[:, j] for j in range(d.shape[1])]
    return out

  def control(self, roots: Sequence[int]) -> List[torch.Tensor]:
    raise NotImplementedError

  def check_answers(self, roots: Sequence[int], got: List, limits: Dict,
                    control: bool = False, frontiers=None) -> Dict:
    """Vertices reached on one side only, and the largest gap between the
    distances of vertices both reach."""
    if control:
      got = self.control(roots)
    reach, gap = (0, 0.0) if len(roots) else (check.NAN, check.NAN)
    want = self.reference(roots, frontiers=frontiers)
    for g, w in zip(got, want):
      g = self.answer(g)
      if g.numel() != w.numel():
        reach += w.numel()
        continue
      g_inf, w_inf = torch.isinf(g), torch.isinf(w)
      reach += int((g_inf != w_inf).sum()) + int(torch.isnan(g).sum())
      both = ~g_inf & ~w_inf
      if bool(both.any()):
        gap = max(gap, float((g[both] - w[both]).abs().max()))
    return {"reach_mismatch": check.number(reach, limits["reach_mismatch"]),
            "dist_gap": check.number(gap, limits["dist_gap"])}

  # -- back to back -------------------------------------------------------------

  def run(self, root: int):
    return getattr(self.port, self.family)(int(root), plan=self.plan)

  def root(self, job: int) -> int:
    """Job ``job``'s root: the search keys, round and round."""
    return int(self.roots[job % len(self.roots)])

  def warm_up(self) -> None:
    for r in self.warm_roots:
      self.run(int(r))

  def start(self, job: int):
    return self.root(job)

  def step(self, root: int):
    return self.run(root)

  def output(self, state):
    return state

  def metrics(self, rec: Dict) -> Dict[str, float]:
    """Graph500's TEPS: for each traversal finished, the input edge tuples
    in its root's component, over the window's seconds."""
    label = components.labels(self.data["edges"], self.n)
    roots = torch.as_tensor([self.root(j["job"]) for j in rec["jobs"]],
                            dtype=torch.int64, device=label.device)
    edges = int(components.tuples_in_component(
        self.data["tuples"], label, roots).sum())
    return {"gteps": edges / rec["seconds"] / 1e9}

  def check(self, picked: List[dict], limits: Dict, control: bool) -> Dict:
    self.picked, self.frontiers = picked, []
    return self.check_answers([self.root(j["job"]) for j in picked],
                              [j["out"] for j in picked], limits,
                              control=control, frontiers=self.frontiers)

  def layer_inputs(self, rec: Dict) -> Dict:
    """A superstep is one ELL launch on the single-query grid; the bytes
    and wall time are the checked traversals'."""
    nbytes = roofline.frontier_bytes(self.frontiers,
                                     value_bytes=self.value_bytes,
                                     message_bytes=4)
    wall = sum(j["t1"] - j["t0"] for j in self.picked)
    return {"units": rec["launches"], "bytes": nbytes, "spmv_wall_s": wall}
