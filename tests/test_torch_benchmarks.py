"""The port's benchmark harness (``benchmarks/*_torch.py``) against the
reference's (``benchmarks/*.py``).

Each section runs once on each side at RMAT scale 10 on the CPU (the
multi-query sweep, 73 BFS runs a backend, at 8), with
``bench`` replaced in both harnesses' module namespaces by one untimed call
that reports 1.0 µs, and every field that does not depend on a clock is
compared; no time is.  Row names are compared under the mapping of
``benchmarks/run_torch.py``'s docstring: ``pallas`` → ``cuda_ell``, and
the planner's kernel-tile candidates (``_r<rows>``) are each planner's
own.  With every call at 1.0 µs a ``multi_query`` row's ``agg_meps`` is
the edges it processed, ``e_sym`` × the summed supersteps of its Q
queries, so equal ``agg_meps`` are equal summed ``iters``.
"""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_algorithms as ref_alg  # noqa: E402
from benchmarks import bench_native_gap as ref_gap  # noqa: E402
from benchmarks import bench_optimizations as ref_opt  # noqa: E402
from benchmarks import bench_algorithms_torch as alg  # noqa: E402
from benchmarks import bench_native_gap_torch as gap  # noqa: E402
from benchmarks import bench_optimizations_torch as opt  # noqa: E402
from benchmarks import run_torch  # noqa: E402

SCALE = 10
MULTI_SCALE = 8
# Derived fields that do not depend on a clock.
COUNTED = ("n", "e", "e_sym", "width", "triangles", "ratings", "k",
           "active_edge_frac", "max/mean", "nnz", "hub_ratio")


def _one_call(fn, *args, warmup=2, iters=5, **kwargs):
  return 1.0, fn(*args, **kwargs)


@pytest.fixture(scope="module")
def untimed():
  mp = pytest.MonkeyPatch()
  for mod in (ref_alg, ref_opt, alg, opt):
    mp.setattr(mod, "bench", _one_call)
  yield
  mp.undo()


def _mapped(name: str) -> str:
  """A row name in the port's terms (run_torch's mapping), with a planner
  kernel-tile suffix made generic."""
  name = name.replace("pallas", "cuda_ell")
  return re.sub(r"(planner/ell_cuda_ell)_r\d+$", r"\1_r*", name)


def _names(rows):
  return [_mapped(r.split(",", 1)[0]) for r in rows if not r.startswith("#")]


def _fields(rows) -> dict:
  out = {}
  for r in rows:
    if r.startswith("#"):
      continue
    name, _, derived = r.split(",", 2)
    for key, val in re.findall(r"([\w/]+)=(\S+)", derived):
      out[(_mapped(name), key)] = val
  return out


def _report(rows, tag: str) -> dict:
  (line,) = [r for r in rows if r.startswith(f"# {tag} ")]
  return json.loads(line[len(f"# {tag} "):])


@pytest.fixture(scope="module")
def algorithms(untimed):
  return ref_alg.main(SCALE), alg.main(SCALE, "cpu")


@pytest.fixture(scope="module")
def multi(untimed):
  return (ref_alg.multi_query(MULTI_SCALE),
          alg.multi_query(MULTI_SCALE, "cpu"))


@pytest.fixture(scope="module")
def ladder(untimed):
  return ref_opt.main(SCALE), opt.main(SCALE, device="cpu")


def test_make_graphs_matches_reference():
  for got, want in zip(alg.make_graphs(SCALE), ref_alg.make_graphs(SCALE)):
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("section", ["algorithms", "multi", "ladder"])
def test_row_names_match_reference(section, request):
  ref_rows, port_rows = request.getfixturevalue(section)
  assert _names(port_rows) == _names(ref_rows)


@pytest.mark.parametrize("section", ["algorithms", "ladder"])
def test_counted_fields_match_reference(section, request):
  ref_rows, port_rows = request.getfixturevalue(section)
  want = {k: v for k, v in _fields(ref_rows).items() if k[1] in COUNTED}
  got = {k: v for k, v in _fields(port_rows).items() if k[1] in COUNTED}
  assert want and got == want


def test_algorithm_rows_carry_the_reference_sizes(algorithms):
  _, port_rows = algorithms
  f = _fields(port_rows)
  assert f[("pagerank/graphmat_coo", "n")] == str(1 << SCALE)
  assert f[("collab_filter/graphmat", "k")] == "16"
  assert "pagerank/graphmat_cuda_ell,0.1,CUDA kernel" in port_rows  # per sweep


def test_multi_query_summed_iters_match_reference(multi):
  ref_rows, port_rows = multi
  want = {k: v for k, v in _fields(ref_rows).items() if k[1] == "agg_meps"}
  got = {k: v for k, v in _fields(port_rows).items() if k[1] == "agg_meps"}
  assert len(want) == 12 and got == want
  # batched and sequential run the same supersteps
  for be in ("coo", "ell"):
    for q in (1, 8, 64):
      assert got[(f"multi_query/bfs_{be}_q{q}_batched", "agg_meps")] == \
          got[(f"multi_query/bfs_{be}_q{q}_sequential", "agg_meps")]


def test_native_gap_rows_match_reference(algorithms, monkeypatch):
  ref_rows, port_rows = algorithms
  monkeypatch.setattr(ref_gap.bench_algorithms, "main", lambda scale: ref_rows)
  want = ref_gap.main(SCALE)
  got = gap.gap_rows(port_rows)
  assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
  # every time is 1.0 µs, so each row's text is the reference's
  assert got == want


def test_native_gap_main_is_gap_rows_of_the_algorithms(monkeypatch):
  rows = ["pagerank/graphmat_ell,2.0,", "pagerank/native,1.0,x",
          "bfs/graphmat_ell,3.0,", "bfs/native,1.0,",
          "sssp/graphmat_ell,1.0,", "sssp/native,1.0,",
          "tri_count/graphmat,4.0,", "tri_count/native,2.0,",
          "collab_filter/graphmat,1.0,", "collab_filter/native,2.0,"]
  monkeypatch.setattr(gap.bench_algorithms_torch, "main",
                      lambda scale, device: rows)
  out = gap.main(SCALE, "cpu")
  assert out == gap.gap_rows(rows)
  assert out[-1] == "native_gap/geomean,0.0,slowdown=1.43x paper=1.20"


def test_frontier_work_ratio_matches_reference():
  n, src, dst, w = alg.make_graphs(9)
  assert opt.frontier_work_ratio(src, dst, w, n, "cpu") == \
      ref_opt.frontier_work_ratio(src, dst, w, n)


@pytest.mark.parametrize("shuffled", [False, True])
def test_block_balance_matches_reference(shuffled):
  """max/mean of the 4×4 block populations, numpy over both packages'
  ``partition_2d``."""
  from repro.core.distributed import partition_2d as ref_part
  from repro.graphs import shuffle_vertices as ref_shuffle
  from repro_torch.core.distributed import partition_2d
  from repro_torch.graphs import shuffle_vertices
  n, src, dst, w = alg.make_graphs(SCALE)
  if shuffled:
    s2, d2 = shuffle_vertices(src, dst, n, 1)[:2]
    r2, rd2 = ref_shuffle(src, dst, n, 1)[:2]
    np.testing.assert_array_equal(s2, r2)
    np.testing.assert_array_equal(d2, rd2)
  else:
    s2, d2 = src, dst
  ww = None if shuffled else w
  pop = np.sum(partition_2d(s2, d2, ww, n=n, R=4, C=4).emask, axis=-1)
  want = np.asarray(ref_part(s2, d2, ww, n=n, R=4, C=4).emask).sum(-1)
  np.testing.assert_array_equal(pop, want)
  assert pop.max() / max(pop.mean(), 1) == want.max() / max(want.mean(), 1)


def test_heuristic_plans_match_reference(ladder):
  ref_rows, port_rows = ladder
  want, got = _report(ref_rows, "plan_report"), _report(port_rows,
                                                          "plan_report")
  assert set(got) == set(want) == {"coo", "ell"}
  for g in want:
    assert got[g]["heuristic"] == want[g]["heuristic"].replace(
        "pallas", "cuda_ell")


def test_planner_timed_every_candidate(ladder):
  """No candidate of the port's planner was skipped: each has a row and a
  time in the plan report."""
  from repro_torch.core.backends import Planner
  _, port_rows = ladder
  cands = {r.split(",")[0] for r in port_rows if r.startswith("planner/")}
  rep = _report(port_rows, "plan_report")
  for g in ("coo", "ell"):
    assert {f"planner/{g}_{t}" for t in rep[g]["candidate_us"]} == \
        {c for c in cands if c.startswith(f"planner/{g}_")}
  ell = [c for c in Planner().candidates(
      alg.G.build_ell(np.array([0]), np.array([1]), n=2, device="cpu"),
      opt.pagerank_program())]
  assert set(rep["ell"]["candidate_us"]) == {opt._plan_tag(c) for c in ell}


def test_admission_split_matches_reference(ladder):
  ref_rows, port_rows = ladder
  want, got = _report(ref_rows, "admission_report"), _report(
      port_rows, "admission_report")
  assert set(got) == set(want) == {"fifo", "fair"}
  for policy in want:
    assert got[policy]["weights"] == want[policy]["weights"]
    for t in ("gold", "free"):
      assert got[policy]["tenants"][t]["completed_at_saturation"] == \
          want[policy]["tenants"][t]["completed_at_saturation"]


def test_all_active_sssp_program_matches_reference():
  """The lambda program of the ladder's second row, on both packages'
  COO engines: 20 all-active supersteps give the same distances."""
  import jax.numpy as jnp
  from repro.core import graph as RG
  from repro.core.engine import run_fixed_iters as ref_run
  from repro_torch.core import graph as G
  from repro_torch.core.engine import run_fixed_iters
  n, src, dst, w = alg.make_graphs(8)
  got = run_fixed_iters(G.build_coo(src, dst, w, n=n, device="cpu"),
                        opt.sssp_prog_all_active(), opt.sssp_init(n, "cpu"),
                        torch.ones((n,), dtype=torch.bool), 20,
                        backend=opt.COO)
  want = ref_run(RG.build_coo(src, dst, w, n=n),
                 ref_opt.sssp_prog_all_active(), ref_opt.sssp_init(n),
                 jnp.ones((n,), bool), 20, backend="coo")
  np.testing.assert_array_equal(got.prop.numpy(), np.asarray(want.prop))
  assert bool(got.active.all())


def test_run_torch_quick_on_cpu(algorithms, multi, ladder, capsys,
                                monkeypatch):
  """The CSV runner's wiring: ``--quick`` runs the sections at scale 10
  on the asked device, in the reference's order, each printing its rows;
  the sections give the rows the fixtures above computed."""
  calls = []

  def cached(name, rows):
    def section(scale, device):
      calls.append((name, scale, str(device)))
      return rows
    return section

  monkeypatch.setattr(alg, "main", cached("algorithms", algorithms[1]))
  monkeypatch.setattr(alg, "multi_query", cached("multi", multi[1]))
  monkeypatch.setattr(opt, "main", lambda scale, device: cached(
      "ladder", ladder[1])(scale, device))
  assert run_torch.main(["--device", "cpu", "--quick", "--skip-scaling"]) == 0
  out = capsys.readouterr().out.splitlines()
  assert calls == [(name, 10, "cpu") for name in (
      "algorithms", "multi", "algorithms", "ladder")]
  assert out == (["name,us_per_call,derived",
                  "# --- fig4_table2_algorithms ---"] + algorithms[1]
                 + ["# --- multi_query_serving ---"] + multi[1]
                 + ["# --- table3_native_gap ---"]
                 + gap.gap_rows(algorithms[1])
                 + ["# --- fig7_optimizations ---"] + ladder[1])
  assert not [r for r in out if "ERROR" in r]


def test_chip_smoke_holds_the_cli_to_the_references_rows(algorithms, multi,
                                                         ladder, monkeypatch):
  """``chip_smoke.py`` phase 15 holds the CLI on the card (scale 12, Fig. 5
  included) to ``BENCH_CLI_ROWS``: the reference's section lines and row
  names in order, under the mapping.  The scale-10 sections give the names
  that do not depend on the scale; the planner's COO tile counts do, so
  those rows are the reference planner's candidates on the scale-12 graph;
  Fig. 5's are the reference's meshes."""
  import importlib.util
  import pathlib
  from benchmarks import bench_scaling as ref_scaling
  from repro.algos.pagerank import pagerank_program
  from repro.core import graph as RG
  from repro.core.backends import Planner as RefPlanner

  root = pathlib.Path(__file__).resolve().parents[1]
  spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                root / "chip_smoke.py")
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)

  ref_alg_rows, _ = algorithms
  ref_mq_rows, _ = multi
  ref_opt_rows, _ = ladder
  n, src, dst, _ = ref_alg.make_graphs(12, seed=5)
  planner = [f"planner/{g}_{ref_opt._plan_tag(c)}" for g, build in (
      ("coo", RG.build_coo), ("ell", RG.build_ell))
      for c in RefPlanner().candidates(build(src, dst, n=n),
                                       pagerank_program())]
  ladder_names = cs.cli_row_names(ref_opt_rows)
  first = ladder_names.index("planner/coo_coo")
  last = ladder_names.index("# plan_report")
  ladder_names[first:last] = planner
  monkeypatch.setattr(ref_gap.bench_algorithms, "main",
                      lambda scale: ref_alg_rows)
  gap_names = cs.cli_row_names(ref_gap.main(SCALE))
  want = (["# --- fig4_table2_algorithms ---"] + cs.cli_row_names(ref_alg_rows)
          + ["# --- multi_query_serving ---"] + cs.cli_row_names(ref_mq_rows)
          + ["# --- table3_native_gap ---"] + gap_names
          + ["# --- fig7_optimizations ---"] + ladder_names
          + ["# --- fig5_scaling ---"]
          + [f"scaling/pagerank_{t}" for t, _, _ in re.findall(
              r'\("(\w+)", \((\d+), (\d+)\)\)', ref_scaling._CHILD)])
  assert [_mapped(x) for x in cs.BENCH_CLI_ROWS] == [_mapped(x) for x in want]
  assert "planner/coo_coo_tiled_t32" in cs.BENCH_CLI_ROWS
