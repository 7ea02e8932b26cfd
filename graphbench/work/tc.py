"""Triangle counting, one whole count a job (the bitmap build, then the
intersect) on the same graph, back to back, as GAP times its trials.  Every
count sampled is held to the reference's exactly; the control is the
reference with its per-vertex counts in float16 (exact only to 2,048)
summed in float32."""

from __future__ import annotations

from typing import Dict, List

import torch

from graphbench import check, roofline
from graphbench.reference import tc as ref_tc
from graphbench.work import Work as Base
from graphbench.work import sync


class Work(Base):

  def __init__(self, *args):
    super().__init__(*args)
    self.n = int(self.data["n"])
    self.warmup_runs = int(self.traffic["warmup_runs"])

  def warm_up(self) -> None:
    for _ in range(self.warmup_runs):
      self.step(None)
    sync(self.device)

  def start(self, job: int):
    return None

  def step(self, state):
    return self.port.count()

  def output(self, state):
    return state

  def metrics(self, rec: Dict) -> Dict[str, float]:
    return {"tc_ms": 1e3 * rec["seconds"] / rec["steps"]}

  def check(self, picked: List[dict], limits: Dict, control: bool) -> Dict:
    """The largest gap, in triangles, of a sampled count."""
    want = ref_tc.triangles(self.data["dag"], self.n)
    if control:
      got = [ref_tc.triangles(self.data["dag"], self.n, dtype=torch.float16)]
    else:
      got = [float(j["out"]) for j in picked]
    gaps = [abs(g - want) for g in got]
    return {"count_gap": check.number(check.worst(gaps), limits["count_gap"])}

  def layer_inputs(self, rec: Dict) -> Dict:
    per = roofline.tc_bytes(self.data["dag"], self.n)
    return {"units": rec["steps"], "bytes": per * rec["steps"],
            "spmv_wall_s": rec["seconds"]}
