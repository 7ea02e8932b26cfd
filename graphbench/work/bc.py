"""GAP's betweenness centrality (the BC kernel of arXiv:1508.03619), one
trial a job, back to back: the configuration's ``lanes`` sources as the
lanes of one batched sweep, taken from Graph500's first ``search_keys``
search keys in the seed's order, ``lanes`` a trial, round and round.

Each sampled trial is held to the plain reference (``reference/bc.py``):
every vertex's depth from every source and its path count exactly
(``depth_mismatch``, ``count_gap``: float64 counts are whole numbers), its
path counts kept in float64 (``count_dtype``, the trials that kept them in
another dtype: no path count of this graph reaches 2**24, so float32 counts
would match the reference's to the last bit), and the normalized scores
within ``score_gap``.  The control is the reference with its path counts in
float32 and its dependencies in bfloat16.
``gteps`` is Graph500's count: for each source of each finished trial,
the input edge tuples in its component, over the window's seconds."""

from __future__ import annotations

from typing import Dict, List

import torch

from graphbench import check, roofline
from graphbench.reference import bc as ref_bc
from graphbench.reference import components
from graphbench.work import Work as Base
from graphbench.work import rng, sync

# Bytes of one message a lane: the forward pass's float64 path counts, the
# backward pass's float32 shares.
MESSAGE_BYTES = {"forward": 8, "backward": 4}


def level_bytes(kind: str, sizes: torch.Tensor, lanes: int) -> int:
  """What one superstep of Brandes needs, whatever runs it: each out-edge
  of a vertex active in any lane read once (its index), each active lane's
  message once, each receiving row's result (``lanes`` wide) written once;
  ``sizes`` is the reference's (:func:`graphbench.reference.bc._sizes`)."""
  _, out_edges, pairs, rows = (int(x) for x in sizes)
  size = MESSAGE_BYTES[kind]
  return (out_edges * roofline.INDEX + pairs * size + rows * lanes * size)


class Work(Base):

  def __init__(self, *args):
    super().__init__(*args)
    t = self.traffic
    self.n = int(self.data["n"])
    self.lanes = int(self.config["lanes"])
    keys = self.data["keys"][:int(t["search_keys"])].cpu().numpy()
    self.sources = keys[rng(self.seed).permutation(keys.size)]
    self.trials = len(self.sources) // self.lanes
    self.warmup_runs = int(t["warmup_runs"])
    self.first = self.last = 0
    self.picked: List[dict] = []
    self.levels: List = []

  def trial_sources(self, job: int) -> List[int]:
    k = job % self.trials
    return [int(s) for s in self.sources[k * self.lanes:(k + 1) * self.lanes]]

  def warm_up(self) -> None:
    for job in range(self.warmup_runs):
      self.port.trial(self.trial_sources(job))
    sync(self.device)

  def start(self, job: int):
    if job == 0:
      self.first = self.last = self.port.supersteps()
    return job

  def step(self, job: int):
    out = self.port.trial(self.trial_sources(job))
    self.last = self.port.supersteps()
    return out

  def output(self, state):
    return state

  def metrics(self, rec: Dict) -> Dict[str, float]:
    label = components.labels(self.data["edges"], self.n)
    roots = torch.as_tensor([s for j in rec["jobs"]
                             for s in self.trial_sources(j["job"])],
                            dtype=torch.int64, device=label.device)
    edges = int(components.tuples_in_component(
        self.data["tuples"], label, roots).sum())
    return {"gteps": edges / rec["seconds"] / 1e9}

  def check(self, picked: List[dict], limits: Dict, control: bool) -> Dict:
    """Vertex-and-source pairs whose depth differs, the largest gap of a
    path count, the trials whose path counts are not float64, the largest
    gap of a normalized score."""
    self.picked, self.levels = picked, []
    edges = self.data["edges"]
    mismatch, counts, dtypes, scores = [], [], [], []
    for j in picked:
      src = torch.as_tensor(self.trial_sources(j["job"]),
                            device=edges["src"].device)
      depth, sigma, delta = ref_bc.brandes(edges, self.n, src,
                                           levels=self.levels)
      want = ref_bc.scores(delta)
      if control:
        d, s, dl = ref_bc.brandes(edges, self.n, src, control=True)
        got = {"depth": d, "sigma": s, "scores": ref_bc.scores(dl, True)}
      else:
        got = j["out"]
      mismatch.append(float((got["depth"].long() != depth).sum()))
      counts.append(float((got["sigma"].double() - sigma).abs().max()))
      dtypes.append(float(got["sigma"].dtype != torch.float64))
      scores.append(float((got["scores"].double() - want).abs().max()))
    return {"depth_mismatch": check.number(
                sum(mismatch) if picked else check.NAN,
                limits["depth_mismatch"]),
            "count_gap": check.number(check.worst(counts),
                                      limits["count_gap"]),
            "count_dtype": check.number(
                sum(dtypes) if picked else check.NAN, limits["count_dtype"]),
            "score_gap": check.number(check.worst(scores),
                                      limits["score_gap"])}

  def layer_inputs(self, rec: Dict) -> Dict:
    """A unit is a BC superstep (the port's count, forward and backward);
    the bytes and wall time are the checked trials'."""
    nbytes = sum(level_bytes(kind, sizes, self.lanes)
                 for kind, sizes in self.levels)
    wall = sum(j["t1"] - j["t0"] for j in self.picked)
    return {"units": self.last - self.first, "trials": rec["steps"],
            "bytes": nbytes, "spmv_wall_s": wall}
