"""The general traffic generator: when work arrives and how long it runs,
read from a traffic mix's parameters (``traffic/<mix>.json``).  What the
work is, and how it is judged, is the named kind of work's
(``graphbench/work/<name>.py``), so a mix of known kinds is data alone.

Every driver has the same life: ``warm_up`` (set-up: the cell's own shapes
and no others), ``drop_inputs`` (the benchmark's inputs leave the card, so
that the memory peak is the port's), ``window`` (the measured seconds, the
traced window around exactly them), ``free`` (drop the port's state),
``rebind`` (the inputs made again from the seed), then ``metrics`` and
``check`` (the reference on a sample drawn from the seed).

* ``back_to_back`` (``"work": <name>``): one caller runs jobs of the work's
  steps one after another; the window ends at the first step boundary
  after ``--seconds``.
* ``closed_loop`` (``"clients"``): each client submits a query and waits
  for its answer before the next.
* ``open_loop`` (``"rate_per_s"``): queries arrive at Poisson times drawn
  from the seed, whatever the answers do; each is waited for on its own.

A served mix lists its query kinds and their shares (``"serve": [{"work":
"sssp", "share": 1}]``), one server each on one ``ServerDriver``, with
``num_slots`` and ``steps_per_round``; its ``sources`` are ``"distinct"``
(non-isolated vertices in the seed's order, none twice, so no answer comes
from the result cache) or ``{"zipf": s, "pool": k}`` (repeats from the
first ``k``, by Zipf's law).  A mix may name a ``plan`` in place of the
configuration's.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from graphbench import check, work
from graphbench.work import rng, sync


def now() -> float:
  return time.perf_counter()


def sample(gen: np.random.Generator, count: int, k: int) -> List[int]:
  """``k`` of ``range(count)`` drawn from ``gen``, in order."""
  return sorted(gen.choice(count, size=min(k, count), replace=False).tolist())


class Reservoir:
  """A uniform sample of ``k`` of the jobs a window finishes, drawn from
  the seed as they finish (Algorithm R), so that only the answers to be
  checked stay on the card."""

  def __init__(self, k: int, gen: np.random.Generator):
    self.k, self.gen, self.seen = k, gen, 0
    self.kept: List[dict] = []

  def offer(self, unit: dict) -> None:
    if len(self.kept) < self.k:
      self.kept.append(unit)
    else:
      j = int(self.gen.integers(0, self.seen + 1))
      if j < self.k:
        self.kept[j] = unit
    self.seen += 1


class Driver:
  """What the drivers share: the cell, the port, the seed, the works."""

  def __init__(self, cell: dict, data: dict, port, seed: int, device):
    self.cell = cell
    self.traffic = cell["traffic"]
    self.data = data
    self.port = port
    self.seed = int(seed)
    self.device = torch.device(device)
    self.works: List[work.Work] = []

  def _work(self, name: str) -> work.Work:
    w = work.load(name, self.cell, self.data, self.port, self.seed,
                  self.device)
    self.works.append(w)
    return w

  def drop_inputs(self) -> None:
    self.rebind(None)

  def rebind(self, data) -> None:
    self.data = data
    for w in self.works:
      w.data = data

  def free(self) -> None:
    self.port = None
    for w in self.works:
      w.port = None


class BackToBack(Driver):
  """One caller running whole jobs back to back."""

  def __init__(self, *args):
    super().__init__(*args)
    self.work = self._work(self.traffic["work"])
    self.reservoir = Reservoir(int(self.traffic["check_runs"]),
                               rng(self.seed))
    self.jobs: List[dict] = []

  def warm_up(self) -> None:
    self.work.warm_up()
    sync(self.device)

  def window(self, seconds: float, tracer) -> Dict:
    from graphbench import port as port_mod
    w, per_job = self.work, self.work.steps_per_job
    with tracer:
      calls0, kernels0 = port_mod.ell_calls(), port_mod.ell_kernels()
      t_start = now()
      t_end = t_start + seconds
      steps, job, done = 0, 0, 0
      while now() < t_end:
        if done == 0:
          state, t0 = w.start(job), now()
        state = w.step(state)
        sync(self.device)
        done += 1
        steps += 1
        if done == per_job:
          unit = {"job": job, "t0": t0, "t1": now()}
          self.jobs.append(unit)
          self.reservoir.offer({**unit, "out": w.output(state)})
          state, job, done = None, job + 1, 0
      t_stop = now()
      calls = port_mod.ell_calls() - calls0
      kernels = port_mod.ell_kernels() - kernels0
    return {"t_start": t_start, "t_end": t_stop, "seconds": t_stop - t_start,
            "steps": steps, "jobs": self.jobs, "launches": calls,
            "ell_kernels": kernels}

  def work_done(self, rec: Dict):
    return rec["steps"], 0

  def metrics(self, rec: Dict) -> Dict[str, float]:
    return self.work.metrics(rec)

  def check(self, rec: Dict, limits: Dict, control: bool = False) -> Dict:
    picked = sorted(self.reservoir.kept, key=lambda r: r["t0"])
    return self.work.check(picked, limits, control)

  def layer_inputs(self, rec: Dict) -> Dict:
    return self.work.layer_inputs(rec)


class Served(Driver):
  """Queries of the mix's kinds, one server each on one driver thread."""

  def __init__(self, *args):
    super().__init__(*args)
    t = self.traffic
    mix = t["serve"]
    kinds = [self._work(m["work"]) for m in mix]
    self.servers, self.driver = self.port.serve(
        [w.family for w in kinds], int(t["num_slots"]),
        int(t["steps_per_round"]), plan=t.get("plan"))
    roots = self.data["roots"].cpu().numpy()
    warm = int(t["warmup_queries"])
    self.warm_roots, pool = roots[-warm:], roots[:-warm]
    share = np.asarray([float(m["share"]) for m in mix])
    self.kind_of = rng(self.seed, 1).choice(len(mix), size=pool.size,
                                            p=share / share.sum())
    sources = t.get("sources", "distinct")
    if sources == "distinct":
      self.sources = pool
    else:
      k, s = int(sources["pool"]), float(sources["zipf"])
      weight = np.arange(1, k + 1, dtype=np.float64) ** -s
      pick = rng(self.seed, 2).choice(k, size=pool.size, p=weight / weight.sum())
      self.sources = pool[:k][pick]

  def query(self, i: int) -> dict:
    """Query ``i``: its kind (the index of its server) and source."""
    return {"i": i, "kind": int(self.kind_of[i]),
            "source": int(self.sources[i])}

  def submit(self, q: dict) -> int:
    server = self.servers[q["kind"]]
    return server.submit(self.port.query(self.works[q["kind"]].family,
                                         q["source"]))

  def wait(self, q: dict, qid: int) -> None:
    try:
      q["value"] = self.servers[q["kind"]].result(qid, timeout=None)
    except Exception as e:  # noqa: BLE001 — a failed answer is counted
      q["error"] = repr(e)
    q["t1"] = now()

  def warm_up(self) -> None:
    for k, server in enumerate(self.servers):
      qids = [server.submit(self.port.query(self.works[k].family, int(s)))
              for s in self.warm_roots]
      for qid in qids:
        server.result(qid, timeout=None)

  def counters(self) -> Dict[str, float]:
    out = {"supersteps": 0.0, "rounds": 0.0, "slot_util_sum": 0.0,
           "slot_util_count": 0.0}
    from graphbench import port as port_mod
    for server in self.servers:
      snap = server.counters.snapshot()
      util = snap["histograms"].get("round.slot_utilization",
                                    {"sum": 0.0, "count": 0})
      out["supersteps"] += snap["counters"].get("supersteps", 0.0)
      out["rounds"] += snap["counters"].get("rounds", 0.0)
      out["slot_util_sum"] += util["sum"]
      out["slot_util_count"] += util["count"]
    out["launches"] = port_mod.ell_calls()
    out["ell_kernels"] = port_mod.ell_kernels()
    return out

  def finish(self, threads: List[threading.Thread], t_end: float) -> None:
    """Wait for the answers still due, ``answer_wait_s`` past the window at
    most, then close the servers (drained, or aborted if some are still
    owed)."""
    limit = t_end + float(self.traffic["answer_wait_s"])
    for th in threads:
      th.join(max(0.0, limit - now()))
    if any(th.is_alive() for th in threads):
      self.driver.close("abort")
      for th in threads:
        th.join(10.0)
    else:
      self.driver.close("drain")

  def record(self, t_start, t_end, queries, before, after) -> Dict:
    diff = {k: after[k] - before[k] for k in after}
    return {"t_start": t_start, "t_end": t_end, "seconds": t_end - t_start,
            "queries": queries, "counters": diff,
            "launches": diff["launches"], "ell_kernels": diff["ell_kernels"]}

  def free(self) -> None:
    self.servers = self.driver = None
    super().free()

  def metrics(self, rec: Dict) -> Dict[str, float]:
    """Queries answered inside the window over its seconds; the tail of
    every query submitted in it, those answered after it too."""
    q = rec["queries"]
    done_in = [r for r in q if "value" in r and r["t1"] <= rec["t_end"]]
    lat = [1e3 * (r["t1"] - r["t0"]) for r in q if "value" in r]
    out = {"queries_per_s": len(done_in) / rec["seconds"]}
    if lat:
      out["query_p95_ms"] = float(np.percentile(lat, 95))
    return out

  def work_done(self, rec: Dict):
    q = rec["queries"]
    return len(q), sum(1 for r in q if "value" not in r)

  def check(self, rec: Dict, limits: Dict, control: bool = False) -> Dict:
    """A sample of the answers drawn from the seed, and the slowest, each
    against the reference; with more than one kind, each kind's numbers
    under ``<work>.<number>``.  ``missing``: queries never answered."""
    answered = [r for r in rec["queries"] if "value" in r]
    picked = [answered[k] for k in sample(
        rng(self.seed), len(answered), int(self.traffic["check_queries"]))]
    if answered:
      slowest = max(answered, key=lambda r: r["t1"] - r["t0"])
      if slowest not in picked:
        picked.append(slowest)
    out = {}
    for k, w in enumerate(self.works):
      mine = [r for r in picked if r["kind"] == k]
      prefix = f"{self.traffic['serve'][k]['work']}." if len(
          self.works) > 1 else ""
      lim = {n[len(prefix):]: v for n, v in limits.items()
             if n.startswith(prefix)}
      got = w.check_answers([r["source"] for r in mine],
                            [r["value"] for r in mine], lim, control=control)
      out.update({prefix + n: v for n, v in got.items()})
    out["missing"] = check.number(len(rec["queries"]) - len(answered),
                                  limits["missing"])
    return out

  def layer_inputs(self, rec: Dict) -> Dict:
    c = rec["counters"]
    return {"units": c["supersteps"], "counters": c}


class ClosedLoop(Served):
  """Clients that each wait for their answer before the next query."""

  def window(self, seconds: float, tracer) -> Dict:
    clients = int(self.traffic["clients"])
    lock = threading.Lock()
    go = threading.Event()
    queries: List[dict] = []
    state = {"next": 0}

    def client():
      go.wait()
      while True:
        with lock:
          i = state["next"]
          if now() >= t_end or i >= len(self.sources):
            return
          state["next"] = i + 1
          q = self.query(i)
          queries.append(q)
        q["t0"] = now()
        try:
          qid = self.submit(q)
        except Exception as e:  # noqa: BLE001 — a refused query is counted
          q["error"], q["t1"] = repr(e), now()
          continue
        self.wait(q, qid)

    threads = [threading.Thread(target=client, daemon=True,
                                name=f"graphbench-client-{k}")
               for k in range(clients)]
    for th in threads:
      th.start()
    with tracer:
      before = self.counters()
      t_start = now()
      t_end = t_start + seconds
      go.set()
      time.sleep(max(0.0, t_end - now()))
      after = self.counters()
    self.finish(threads, t_end)
    return self.record(t_start, t_end, queries, before, after)


class OpenLoop(Served):
  """Queries at Poisson arrival times, at ``rate_per_s``, each waited for
  by a thread of its own; a query's time runs from its arrival."""

  def window(self, seconds: float, tracer) -> Dict:
    rate = float(self.traffic["rate_per_s"])
    gaps = rng(self.seed, 3).exponential(1.0 / rate,
                                         size=int(rate * seconds * 2) + 16)
    queries: List[dict] = []
    threads: List[threading.Thread] = []
    with tracer:
      before = self.counters()
      t_start = now()
      t_end = t_start + seconds
      at = t_start
      for i, gap in enumerate(gaps):
        at += float(gap)
        if at >= t_end or i >= len(self.sources):
          break
        time.sleep(max(0.0, at - now()))
        q = {**self.query(i), "t0": at}
        queries.append(q)
        try:
          qid = self.submit(q)
        except Exception as e:  # noqa: BLE001 — a refused query is counted
          q["error"], q["t1"] = repr(e), now()
          continue
        th = threading.Thread(target=self.wait, args=(q, qid), daemon=True,
                              name=f"graphbench-query-{i}")
        th.start()
        threads.append(th)
      time.sleep(max(0.0, t_end - now()))
      after = self.counters()
    self.finish(threads, t_end)
    return self.record(t_start, t_end, queries, before, after)


DRIVERS = {"closed_loop": ClosedLoop, "open_loop": OpenLoop,
           "back_to_back": BackToBack}


def make(cell: dict, data: dict, port, seed: int, device) -> Driver:
  return DRIVERS[cell["traffic"]["kind"]](cell, data, port, seed, device)
