"""PageRank by the paper's fixed sweeps: the port's ``algos.pagerank`` with
``iters`` sweeps a run, runs back to back.  Every sampled run is held to
the reference's ranks (sums in float64); the control is the reference with
ranks and messages in bfloat16."""

from __future__ import annotations

from typing import Dict, List

import torch

from graphbench import check, roofline
from graphbench.reference import pagerank as ref_pagerank
from graphbench.work import Work as Base
from graphbench.work import sync


class Work(Base):

  def __init__(self, *args):
    super().__init__(*args)
    self.iters = int(self.traffic["iters"])
    self.n = int(self.data["n"])

  def warm_up(self) -> None:
    self.step(None)
    sync(self.device)

  def start(self, job: int):
    return None

  def step(self, state):
    return self.port.pagerank(self.iters, plan=self.plan)

  def output(self, state):
    return state

  def metrics(self, rec: Dict) -> Dict[str, float]:
    return {"sweep_ms": 1e3 * rec["seconds"] / (rec["steps"] * self.iters)}

  def check(self, picked: List[dict], limits: Dict, control: bool) -> Dict:
    """The largest relative gap of a rank, over every run sampled."""
    got = [j["out"] for j in picked]
    if control:
      got = [ref_pagerank.pagerank(self.data["edges"], self.n, self.iters,
                                   dtype=torch.bfloat16)]
    want = ref_pagerank.pagerank(self.data["edges"], self.n, self.iters)
    gaps = []
    for g in got:
      g = torch.as_tensor(g).to(want.device, torch.float32).flatten()
      gaps.append(float(((g - want).abs() / want).max())
                  if g.numel() == want.numel() else check.NAN)
    return {"rank_rel_gap": check.number(check.worst(gaps),
                                         limits["rank_rel_gap"])}

  def layer_inputs(self, rec: Dict) -> Dict:
    sweeps = rec["steps"] * self.iters
    per = roofline.pagerank_sweep_bytes(self.data["edges"], self.n)
    return {"units": sweeps, "bytes": per * sweeps,
            "spmv_wall_s": rec["seconds"]}
