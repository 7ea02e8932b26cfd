"""Collaborative filtering: jobs of ``sweeps`` sweeps (phase U, then phase
V) of the configuration's one-leaf program from each job's own seeded
start, back to back.  A sampled job's factors are held to the reference's
from the same start (sums in float64); the control is the reference with
its factors in bfloat16 (sums in float32)."""

from __future__ import annotations

from typing import Dict, List

import torch

from graphbench import check, roofline
from graphbench.gen import generator
from graphbench.reference import cf as ref_cf
from graphbench.work import Work as Base
from graphbench.work import sync


class Work(Base):

  def __init__(self, *args):
    super().__init__(*args)
    self.steps_per_job = int(self.traffic["sweeps"])
    self.k = int(self.config["k"])
    self.n = int(self.data["users"]) + int(self.data["items"])
    self.mean = float(self.data["rating"].to(torch.float64).mean())

  def p0(self, job: int) -> torch.Tensor:
    """Job ``job``'s starting factors: every prediction near the mean
    rating, with a seeded spread."""
    spread = float(self.config["init_spread"])
    gen = generator(self.seed * 1_000_003 + job + 1, self.device)
    u = torch.rand((self.n, self.k), generator=gen, device=self.device)
    return (self.mean / self.k) ** 0.5 * (1.0 + spread * (u - 0.5))

  def warm_up(self) -> None:
    self.step(self.p0(-1))
    sync(self.device)

  def start(self, job: int) -> torch.Tensor:
    return self.p0(job)

  def step(self, p: torch.Tensor) -> torch.Tensor:
    return self.port.sweep(p)

  def output(self, p: torch.Tensor) -> torch.Tensor:
    return p

  def metrics(self, rec: Dict) -> Dict[str, float]:
    return {"cf_sweep_ms": 1e3 * rec["seconds"] / rec["steps"]}

  def check(self, picked: List[dict], limits: Dict, control: bool) -> Dict:
    """The largest gap of an entry, over the largest change the sweeps made
    to an entry."""
    d = self.data
    gamma = ref_cf.step_size(d["user"], d["item"], d["rating"], d["users"],
                             d["items"])
    lam, sweeps = float(self.config["lam"]), self.steps_per_job
    gaps = []
    for j in picked:
      p0 = self.p0(j["job"])
      want = ref_cf.cf(d["user"], d["item"], d["rating"], d["users"], p0,
                       sweeps, gamma, lam)
      got = j["out"]
      if control:
        got = ref_cf.cf(d["user"], d["item"], d["rating"], d["users"], p0,
                        sweeps, gamma, lam, dtype=torch.bfloat16)
      change = float((want - p0).abs().max())
      got = torch.as_tensor(got).to(want.device, torch.float32)
      gaps.append(float((got - want).abs().max()) / change
                  if got.shape == want.shape else check.NAN)
    return {"factor_gap": check.number(check.worst(gaps),
                                       limits["factor_gap"])}

  def layer_inputs(self, rec: Dict) -> Dict:
    per = roofline.cf_sweep_bytes(self.data, self.k)
    return {"units": rec["steps"], "bytes": per * rec["steps"],
            "spmv_wall_s": rec["seconds"]}
