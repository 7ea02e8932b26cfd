#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py            # all phases, RMAT scale 20

Phases, in order; any failure exits non-zero before the result line:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   ELL kernel from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. hold the kernel against its plain PyTorch version on the card over a
   sweep of shapes, semirings, dtypes and query widths;
3. build an RMAT graph (Graph500 parameters, scale 20, edge factor 16,
   self-loops removed, symmetrized) as an ELL graph on the card, serve 32
   BFS queries through ``GraphQueryServer`` with ``Plan("cuda_ell")`` (by
   ``drain()`` and through a ``ServerDriver``), hold them against the plain
   torch ``Plan("ell")`` path, run single-query BFS, SSSP and PageRank
   through the kernel, and check that the kernel's launch counter rose;
4. time the kernel, its plain version and ``torch.sparse.mm`` with CUDA
   events at the phase-3 shapes and print the ``{"kernels": [...]}`` line;

and last, ``{"ok": true, "device": {...}}``.  Detail that is too long for
the end of the output goes to ``chiprun_out/chip_smoke.json``.

Tolerances: min/max reductions and int32 results must match bitwise (the
same values are reduced, in any order).  Float add reductions match with
``rtol`` 1e-5 in float32 and 1e-2 in float16, ``atol`` = rtol times the
largest magnitude of the plain result, because the kernel sums in another
order than the plain version.  PageRank after 20 sweeps: rtol 1e-4.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def log(msg: str) -> None:
  print(msg, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
  """Mean milliseconds of ``fn`` over ``iters`` launches, CUDA events."""
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 2: kernel against plain
# ---------------------------------------------------------------------------

SEMIRINGS = {  # name -> (process_op, reduce)
    "min_plus": ("msg_plus_edge", "min"),
    "plus_times": ("msg_times_edge", "add"),
    "max_times": ("msg_times_edge", "max"),
    "bfs": ("msg_plus_one", "min"),
    "pagerank": ("msg", "add"),
}


def compare(y, yr, r, rr, reduce_kind: str, what: str) -> float:
  """Raise unless kernel (y, r) agrees with plain (yr, rr); returns the max
  absolute difference of y."""
  import torch
  if not torch.equal(r, rr):
    raise AssertionError(f"{what}: recv differs")
  yf, yrf = y.double(), yr.double()
  finite, nan = torch.isfinite(yrf), torch.isnan(yrf)
  inf = ~finite & ~nan
  if not (torch.equal(torch.isnan(yf), nan)
          and torch.equal(torch.isfinite(yf), finite)
          and torch.equal(yf[inf], yrf[inf])):
    raise AssertionError(f"{what}: non-finite entries differ")
  err = float((yf[finite] - yrf[finite]).abs().max()) if finite.any() else 0.0
  if reduce_kind != "add" or y.dtype == torch.int32:
    if not torch.equal(y[~nan], yr[~nan]):
      raise AssertionError(f"{what}: not bitwise equal (max err {err})")
    return err
  rtol = 1e-2 if y.dtype == torch.float16 else 1e-5
  scale = float(yrf[finite].abs().max()) if finite.any() else 0.0
  torch.testing.assert_close(yf, yrf, rtol=rtol, atol=rtol * scale,
                             equal_nan=True, msg=lambda m: f"{what}: {m}")
  return err


def random_ell(gen, n_pad, width, n_src, q, dtype, p_mask=0.7, p_act=0.8):
  import torch
  dev = "cuda"
  cols = torch.randint(0, n_src, (n_pad, width), generator=gen,
                       device=dev, dtype=torch.int32)
  vals = (torch.rand((n_pad, width), generator=gen, device=dev) * 1.9 + 0.1)
  mask = torch.rand((n_pad, width), generator=gen, device=dev) < p_mask
  act = torch.rand((n_src,), generator=gen, device=dev) < p_act
  if dtype == torch.int32:
    msg = torch.randint(0, 1000, (n_src, q), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = vals.to(torch.int32)
  else:
    msg = torch.randn((n_src, q), generator=gen, device=dev).to(dtype)
    vals = vals.to(dtype)
  return cols, vals, mask, msg, act


def phase_kernel_sweep(ell_mod, ref_mod) -> dict:
  import torch
  gen = torch.Generator(device="cuda").manual_seed(0)
  cases = []
  for shape in [(8, 8, 8, 1), (64, 16, 100, 1), (128, 24, 50, 4),
                (256, 8, 256, 8)]:
    for sem in ("min_plus", "plus_times", "max_times"):
      cases.append((shape, sem, torch.float32, {}))
  for q in (1, 8):
    cases += [((512, 40, 700, q), "min_plus", torch.float16, {}),
              ((512, 40, 700, q), "bfs", torch.int32, {}),
              ((512, 40, 700, q), "pagerank", torch.float32, {})]
  # Query tiles that do not divide Q, and other block shapes.
  cases += [((300, 33, 310, 6), "min_plus", torch.float32,
             {"block_queries": 4}),
            ((300, 33, 310, 12), "plus_times", torch.float32,
             {"block_queries": 8, "block_rows": 32}),
            ((300, 33, 310, 3), "max_times", torch.float32,
             {"block_queries": 1, "block_rows": 1})]
  # NaN in about 1% of the messages and edge values: a min or max over a
  # NaN is NaN, as torch.amin/amax give it.
  nan_cases = [((256, 24, 300, q), sem, dtype, {"nan": True})
               for q in (1, 8)
               for sem, dtype in (("min_plus", torch.float32),
                                  ("max_times", torch.float32),
                                  ("plus_times", torch.float32),
                                  ("min_plus", torch.float16))]
  cases += nan_cases
  max_err = 0.0
  for shape, sem, dtype, kw in cases:
    n_pad, width, n_src, q = shape
    op, red = SEMIRINGS[sem]
    cols, vals, mask, msg, act = random_ell(gen, n_pad, width, n_src, q,
                                            dtype)
    kw = dict(kw)
    if kw.pop("nan", False):
      msg[torch.rand(msg.shape, generator=gen, device="cuda") < 0.01] = (
          float("nan"))
      vals[torch.rand(vals.shape, generator=gen, device="cuda") < 0.01] = (
          float("nan"))
    y, r = ell_mod.ell_spmv(cols, vals, mask, msg, act, process_op=op,
                            reduce_kind=red, **kw)
    dprop = torch.zeros((n_pad, 1), dtype=dtype, device="cuda")
    yr, rr = ref_mod.ell_spmv_ref(cols, vals, mask, msg, act, dprop,
                                  process=ell_mod.plain_process(op),
                                  reduce_kind=red)
    torch.cuda.synchronize()
    what = f"{shape} {sem} {dtype} {kw}"
    if msg.is_floating_point() and torch.isnan(msg).any():
      what += " with NaN"
      if not torch.isnan(yr).any():
        raise AssertionError(f"{what}: no NaN reached the output")
    max_err = max(max_err, compare(y, yr, r, rr, red, what))
  # All sources inactive: identity everywhere, recv all zero.
  cols, vals, mask, msg, act = random_ell(gen, 64, 16, 64, 1, torch.float32)
  y, r = ell_mod.ell_spmv(cols, vals, mask, msg, torch.zeros_like(act),
                          process_op="msg_plus_edge", reduce_kind="min")
  torch.cuda.synchronize()
  if r.any() or not torch.isinf(y).all():
    raise AssertionError("all-inactive case: expected identity rows")
  log(f"phase 2: kernel == plain on {len(cases) + 1} cases "
      f"(max abs err {max_err:.3g})")
  return {"cases": len(cases) + 1, "max_abs_err": max_err}


# ---------------------------------------------------------------------------
# Phase 3: the slice at full size
# ---------------------------------------------------------------------------


def build_graph(scale: int, seed: int = 0):
  import numpy as np
  from repro_torch.core import graph as G
  from repro_torch.graphs import remove_self_loops, rmat_edges, symmetrize
  t0 = time.perf_counter()
  src, dst = rmat_edges(scale, 16, abc=(0.57, 0.19, 0.19), seed=seed)
  t1 = time.perf_counter()
  src, dst = remove_self_loops(src, dst)
  src, dst = symmetrize(src, dst)
  t2 = time.perf_counter()
  w = np.random.default_rng(seed + 1).uniform(0.1, 2.0, src.shape[0]
                                              ).astype(np.float32)
  n = 1 << scale
  g = G.build_ell(src, dst, w, n=n, device="cuda")
  import torch
  torch.cuda.synchronize()
  t3 = time.perf_counter()
  stats = {"n": n, "edges": int(src.shape[0]), "width": g.width,
           "n_pad": g.n_pad,
           "packed_edges": int(g.mask.sum()),
           "spill_edges": 0 if g.spill is None else int(g.spill.emask.sum()),
           "rmat_s": t1 - t0, "symmetrize_s": t2 - t1,
           "build_ell_s": t3 - t2}
  return g, src, dst, w, stats


def bfs_numpy(src, dst, n, root):
  """Independent level-synchronous BFS on host arrays (the check of phase
  3's small input)."""
  import numpy as np
  dist = np.full(n, -1, np.int64)
  dist[root] = 0
  frontier = np.array([root])
  order = np.argsort(src, kind="stable")
  s_sorted, d_sorted = src[order], dst[order]
  starts = np.searchsorted(s_sorted, np.arange(n + 1))
  level = 0
  while frontier.size:
    level += 1
    nbrs = np.unique(np.concatenate([d_sorted[starts[u]:starts[u + 1]]
                                     for u in frontier]))
    nbrs = nbrs[dist[nbrs] < 0]
    dist[nbrs] = level
    frontier = nbrs
  return dist


def phase_slice(scale: int, num_queries: int, ell_mod):
  import numpy as np
  import torch
  from repro_torch.algos import bfs, pagerank, sssp
  from repro_torch.algos.bfs import UNREACHED
  from repro_torch.core.backends import Plan
  from repro_torch.service import (BfsFamily, GraphQueryServer, QuerySpec,
                                   ServerDriver)

  kernel, plain = Plan(backend="cuda_ell"), Plan(backend="ell")

  # Small input first: the kernel path against an independent host BFS.
  gs, s_src, s_dst, _, _ = build_graph(10, seed=5)
  n_s = 1 << 10
  root = int(s_dst[0])
  got = bfs(gs, root, n_s, backend=kernel).cpu().numpy()
  want = bfs_numpy(s_src, s_dst, n_s, root)
  got = np.where(got == UNREACHED, -1, got)
  if not np.array_equal(got, want):
    raise AssertionError("BFS on the scale-10 graph disagrees with host BFS")
  log("phase 3: scale-10 BFS through cuda_ell == independent host BFS")

  g, src, dst, w, gstats = build_graph(scale)
  n = gstats["n"]
  log("phase 3: graph " + json.dumps(gstats))
  deg = np.bincount(dst, minlength=n)
  sources = np.random.default_rng(2).choice(np.flatnonzero(deg > 0),
                                            num_queries, replace=False)
  specs = [QuerySpec("bfs", int(s)) for s in sources]
  half = num_queries // 2

  ell_mod.launches.reset()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  server = GraphQueryServer(g, BfsFamily(n), num_slots=8, backend=kernel)
  t_setup = time.perf_counter() - t0
  t0 = time.perf_counter()
  qids = server.submit_many(specs[:half])
  drained = server.drain()
  results = {s.source: drained[q] for s, q in zip(specs[:half], qids)}
  with ServerDriver(server) as driver:
    qids = server.submit_many(specs[half:])
    for s, q in zip(specs[half:], qids):
      results[s.source] = server.result(q, timeout=600.0)
  torch.cuda.synchronize()
  t_serve = time.perf_counter() - t0
  if driver.error is not None:
    raise driver.error
  if len(results) != num_queries or any(r is None for r in results.values()):
    raise AssertionError("not every query was answered")
  stats = server.stats()
  supersteps = stats["counters"].get("supersteps", 0.0)
  launches_serve = dict(ell_mod.launches.by_config)
  if ell_mod.launches.multi == 0:
    raise AssertionError("the server's rounds never launched the kernel")
  log(f"phase 3: served {num_queries} BFS queries in {t_serve:.3f} s "
      f"({num_queries / t_serve:.3f} queries/s, {supersteps:.0f} supersteps, "
      f"server set-up {t_setup:.3f} s, kernel launches {launches_serve})")

  # Every served query (both halves: drain() and the driver's thread) again
  # through the plain torch ELL path, bitwise.
  check = specs
  ref_server = GraphQueryServer(g, BfsFamily(n), num_slots=8, backend=plain)
  ref_qids = ref_server.submit_many(check)
  ref = ref_server.drain()
  ref_server.close()
  for s, q in zip(check, ref_qids):
    if not np.array_equal(results[s.source], ref[q]):
      raise AssertionError(f"BFS query {s.source}: cuda_ell != ell")
    reached = int((ref[q] != UNREACHED).sum())
    if reached < 2:
      raise AssertionError(f"BFS query {s.source} reached {reached} vertex")
  server.close()
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  log(f"phase 3: {len(check)} served queries == Plan('ell') bitwise "
      f"(peak device memory {peak_gib:.2f} GiB)")

  before = ell_mod.launches.single
  root = int(sources[0])
  t0 = time.perf_counter()
  d_k = bfs(g, root, n, backend=kernel)
  torch.cuda.synchronize()
  t_bfs = time.perf_counter() - t0
  if not torch.equal(d_k, bfs(g, root, n, backend=plain)):
    raise AssertionError("single-query BFS: cuda_ell != ell")
  s_k = sssp(g, root, n, backend=kernel)
  if not torch.equal(s_k, sssp(g, root, n, backend=plain)):
    raise AssertionError("single-query SSSP: cuda_ell != ell")
  out_deg = torch.from_numpy(np.bincount(src, minlength=n).astype(
      np.float32)).cuda()
  pr_k = pagerank(g, out_deg, num_iters=20, backend=kernel)
  pr_p = pagerank(g, out_deg, num_iters=20, backend=plain)
  torch.testing.assert_close(pr_k, pr_p, rtol=1e-4, atol=0.0)
  if not (torch.isfinite(pr_k).all() and torch.isfinite(s_k[d_k != UNREACHED]
                                                          ).all()):
    raise AssertionError("non-finite ranks or reachable distances")
  if ell_mod.launches.single <= before:
    raise AssertionError("single-query entry points never launched the kernel")
  log(f"phase 3: single-query BFS ({t_bfs:.3f} s), SSSP, PageRank(20) "
      "through cuda_ell == Plan('ell')")
  return {"graph": gstats, "queries": num_queries, "serve_s": t_serve,
          "queries_per_s": num_queries / t_serve, "supersteps": supersteps,
          "server_setup_s": t_setup, "peak_device_gib": peak_gib,
          "launches": dict(ell_mod.launches.by_config),
          "launches_single": ell_mod.launches.single,
          "launches_multi": ell_mod.launches.multi,
          "launches_serve": launches_serve,
          "single_bfs_s": t_bfs}, g


# ---------------------------------------------------------------------------
# Phase 4: timings and the kernels line
# ---------------------------------------------------------------------------


def phase_timing(g, ell_mod, ref_mod, launches: dict):
  import torch
  from repro_torch.core.spmv import merge_spill
  from repro_torch.kernels.ops import spmv_ell_cuda
  from repro_torch.algos.multi import multi_bfs_program

  gen = torch.Generator(device="cuda").manual_seed(7)
  n, n_pad, width = g.n, g.n_pad, g.width
  active = torch.ones((n,), dtype=torch.bool, device="cuda")
  valid_slots = int(g.mask.sum())
  entries = []
  array_bounds = {}  # bytes of every ELL slot / HBM rate, for the record
  configs = [  # name, op, reduce, dtype, Q, replaces
      ("ell_spmv[bfs,int32,min,Q=1]", "msg_plus_one", "min", torch.int32, 1,
       "src/repro/kernels/ell_spmv.py:192"),
      ("ell_spmv[bfs,int32,min,Q=8]", "msg_plus_one", "min", torch.int32, 8,
       "src/repro/kernels/ell_spmv.py:165"),
      ("ell_spmv[sssp,f32,min,Q=1]", "msg_plus_edge", "min", torch.float32,
       1, "src/repro/kernels/ell_spmv.py:192"),
      ("ell_spmv[pagerank,f32,add,Q=1]", "msg", "add", torch.float32, 1,
       "src/repro/kernels/ell_spmv.py:192"),
  ]
  csr = None
  for name, op, red, dtype, q, replaces in configs:
    if dtype == torch.int32:
      msg = torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                          dtype=torch.int32)
    else:
      msg = torch.rand((n, q), generator=gen, device="cuda")
    args = (g.cols, g.vals, g.mask, msg, active)
    y, r = ell_mod.ell_spmv(*args, process_op=op, reduce_kind=red)
    dprop = torch.zeros((n_pad, 1), dtype=dtype, device="cuda")
    plain = lambda: ref_mod.ell_spmv_ref(  # noqa: E731
        *args, dprop, process=ell_mod.plain_process(op), reduce_kind=red)
    yr, rr = plain()
    err = compare(y, yr, r, rr, red, name)
    del yr, rr
    kernel_ms = cuda_ms(lambda: ell_mod.ell_spmv(
        *args, process_op=op, reduce_kind=red))
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    size = msg.element_size()
    edge = op in ("msg_plus_edge", "msg_times_edge")
    # Bytes this run's data needs: every mask byte, cols (and vals for the
    # edge forms) of the marked slots, msg and active once, y and recv once.
    need = (n_pad * width + valid_slots * (4 + (4 if edge else 0))
            + n * q * size + n + n_pad * q * size + n_pad)
    full = (n_pad * width * (9 if edge else 5) + n * q * size + n
            + n_pad * q * size + n_pad)
    library_ms = None
    if red == "add":
      # torch.sparse.mm on the same matrix as CSR: plus_times over the
      # 0/1 pattern (PageRank's process passes the message through).
      if csr is None:
        # The packed ELL matrix as CSR, columns sorted within each row.
        rows, slots = g.mask.nonzero(as_tuple=True)
        src_ids = g.cols[rows, slots].long()
        order = torch.argsort(rows * n + src_ids)
        rows, slots, src_ids = rows[order], slots[order], src_ids[order]
        crow = torch.zeros(n_pad + 1, dtype=torch.int64, device="cuda")
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n_pad), 0)
        ones = torch.ones(src_ids.shape, dtype=torch.float32, device="cuda")
        csr = torch.sparse_csr_tensor(crow, src_ids, ones, size=(n_pad, n))
        del rows, slots, src_ids, order
      x = torch.where(active[:, None], msg, 0.0)
      y_lib = torch.sparse.mm(csr, x)
      torch.testing.assert_close(y_lib, y, rtol=1e-4, atol=1e-4 * float(
          y.abs().max()))
      library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x))
    key = ell_mod.config_key(q, dtype, red, op)
    entries.append({
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "replaces": replaces, "launches": int(launches.get(key, 0)),
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": need / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": library_ms})
    array_bounds[name] = full / H100_BYTES_PER_S * 1e3
    log(f"phase 4: {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} "
        f"ms, bound {entries[-1]['bound_ms']:.4f} ms, ELL-array bound "
        f"{array_bounds[name]:.4f} ms, library {library_ms}")
    torch.cuda.empty_cache()

  # One superstep of the kernel backend on this graph, split into the
  # kernel and the COO spill merge (BFS program, int32 messages).
  prog = multi_bfs_program()
  split = {}
  for q in (1, 8):
    msg = torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                        dtype=torch.int32)
    m = msg[:, 0] if q == 1 else msg
    y = m.clone()
    recv = torch.zeros((n,), dtype=torch.bool, device="cuda")
    split[f"Q={q}"] = {
        "superstep_spmv_ms": cuda_ms(lambda: spmv_ell_cuda(
            g, m, active, m, prog), iters=10),
        "kernel_ms": cuda_ms(lambda: ell_mod.ell_spmv(
            g.cols, g.vals, g.mask, msg, active, process_op=prog.process_op,
            reduce_kind="min"), iters=10),
        "spill_merge_ms": cuda_ms(lambda: merge_spill(
            g, y, recv, m, active, m, prog), iters=10)}
  log("phase 4: superstep split " + json.dumps(split))
  return entries, array_bounds, split


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--scale", type=int, default=20,
                  help="RMAT scale of the phase-3 graph (a smaller one "
                  "rehearses the run quickly)")
  args = ap.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
    print("chip_smoke: run from a checkout of the repository "
          "(src/repro_torch is missing)", file=sys.stderr)
    return 2
  sys.path.insert(0, str(ROOT / "src"))
  from repro_torch.kernels import ell_spmv as ell_mod
  from repro_torch.kernels import ref as ref_mod

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  log(card)
  log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
      f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
  ell_mod.build()
  info = ell_mod.build_info
  log(f"phase 1: built {info['path']} in {info['seconds']:.2f} s")
  log("\n".join(line for line in info["log"].splitlines()
                if "registers" in line or "error" in line.lower())[:4000])

  sweep = phase_kernel_sweep(ell_mod, ref_mod)
  slice_stats, g = phase_slice(args.scale, 32, ell_mod)
  entries, array_bounds, split = phase_timing(g, ell_mod, ref_mod,
                                              slice_stats["launches"])

  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
      "card": card, "build": {k: info[k] for k in ("seconds", "log")},
      "sweep": sweep, "slice": slice_stats, "kernels": entries,
      "ell_array_bound_ms": array_bounds, "superstep_split": split},
      indent=1))
  log(card)
  print(json.dumps({"kernels": entries}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
