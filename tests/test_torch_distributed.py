"""The port's 2-D distributed runner against the JAX package's.

One module-scoped subprocess runs the reference's ``run_graph_program_2d``
and ``run_graph_program_2d_batched`` on 8 fake CPU devices (the device
count must be fixed before JAX starts, as in ``tests/test_distributed.py``)
over meshes of 1×1, 2×2 and 4×2, and writes their inputs and outputs to an
``.npz``.  The port runs the same programs on the same inputs in spawned
gloo ranks on the CPU, one rank per block, on the RMAT-8 graph of
``tests/conftest.py``: one program for each reduce kind (add: PageRank;
min: SSSP in float32 and BFS in int32; max: label propagation; any:
reachability over heavy edges; a generic monoid: bitwise-or source sets
over heavy edges),
and the batched runner for multi-BFS and multi-SSSP.

Tolerances: min, max, any, generic and every integer output bitwise, with
equal superstep counts; add (PageRank) at rtol 1e-5, atol 1e-6, because
the block scatter-adds may sum in another order than XLA's.

The spawned ranks import this module, so it imports JAX only inside the
tests that call it.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import _tree  # noqa: E402
from repro_torch.algos.bfs import bfs_program  # noqa: E402
from repro_torch.algos.multi import (multi_bfs_program,  # noqa: E402
                                     multi_sssp_program)
from repro_torch.algos.pagerank import pagerank_program  # noqa: E402
from repro_torch.algos.sssp import sssp_program  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core.vertex_program import GraphProgram  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRIDS = ((1, 1), (2, 2), (4, 2))
PROGRAMS = ("pagerank", "sssp", "bfs", "max", "any", "generic")
BATCHED = ("multi_bfs", "multi_sssp")
UNWEIGHTED = ("bfs", "multi_bfs")   # run on the partition with w = None
PAGERANK_ITERS = 8
ADD_TOL = dict(rtol=1e-5, atol=1e-6)

# The reference side: the same programs, written for JAX.  The inputs are
# made here, padded per grid, and saved beside the outputs.
_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.algos.bfs import UNREACHED, bfs_program
from repro.algos.multi import multi_bfs_program, multi_sssp_program
from repro.algos.pagerank import pagerank_program
from repro.algos.sssp import sssp_program
from repro.core.distributed import (partition_2d, run_graph_program_2d,
                                    run_graph_program_2d_batched)
from repro.core.vertex_program import GraphProgram
from repro.graphs import dedupe_edges, remove_self_loops, rmat_edges

src, dst = rmat_edges(8, 8, seed=3)
src, dst = remove_self_loops(src, dst)
src, dst = dedupe_edges(src, dst)
n = 256
w = np.random.default_rng(0).uniform(0.1, 2.0, len(src)).astype(np.float32)
sources = np.array([3, 77, 130, 200], np.int32)

programs = {
    "pagerank": pagerank_program(),
    "sssp": sssp_program(),
    "bfs": bfs_program(),
    "max": GraphProgram(process_message=lambda m, e, d: m, reduce_kind="max",
                        apply=jnp.maximum, process_reads_dst=False),
    "any": GraphProgram(process_message=lambda m, e, d: m & (e > 1.0),
                        reduce_kind="any", apply=jnp.logical_or,
                        process_reads_dst=False),
    "generic": GraphProgram(process_message=lambda m, e, d: jnp.where(
                                e > 1.7, m, 0), reduce_kind="generic",
                            reduce=jnp.bitwise_or, reduce_identity=0,
                            apply=jnp.bitwise_or, process_reads_dst=False),
    "multi_bfs": multi_bfs_program(),
    "multi_sssp": multi_sssp_program(),
}


def inputs(name, n_pad):
  one = np.zeros(n_pad, bool); one[sources[0]] = True
  if name == "pagerank":
    deg = np.bincount(src, minlength=n_pad).astype(np.float32)
    return ({"rank": np.ones(n_pad, np.float32), "deg": deg},
            np.ones(n_pad, bool))
  if name == "sssp":
    d = np.full(n_pad, np.inf, np.float32); d[sources[0]] = 0
    return d, one
  if name == "bfs":
    d = np.full(n_pad, UNREACHED, np.int32); d[sources[0]] = 0
    return d, one
  if name == "max":
    return np.arange(n_pad, dtype=np.int32) % 97, np.ones(n_pad, bool)
  if name == "any":
    return one.copy(), one
  if name == "generic":
    bits = np.zeros(n_pad, np.int32); act = np.zeros(n_pad, bool)
    for k, s in enumerate(sources):
      bits[s] |= 1 << k; act[s] = True
    return bits, act
  q = len(sources); lanes = np.arange(q)
  fill, dt = (UNREACHED, np.int32) if name == "multi_bfs" else (np.inf,
                                                                np.float32)
  d = np.full((n_pad, q), fill, dt); d[sources, lanes] = 0
  a = np.zeros((n_pad, q), bool); a[sources, lanes] = True
  return d, a


def leaves(prefix, tree):
  if isinstance(tree, dict):
    return {f"{prefix}.{k}": np.asarray(v) for k, v in tree.items()}
  return {prefix: np.asarray(tree)}


out = {}
for R, C in ((1, 1), (2, 2), (4, 2)):
  mesh = jax.sharding.Mesh(
      np.array(jax.devices()[:R * C]).reshape(R, C), ("data", "model"),
      axis_types=(jax.sharding.AxisType.Auto,) * 2)
  graphs = {True: partition_2d(src, dst, w, n=n, R=R, C=C),
            False: partition_2d(src, dst, n=n, R=R, C=C)}
  for name, prog in programs.items():
    g = graphs[name not in ("bfs", "multi_bfs")]
    prop, act = inputs(name, g.n_pad)
    key = f"{R}x{C}/{name}"
    out.update(leaves(key + "/init_prop", prop))
    out[key + "/init_active"] = act
    prop = jax.tree_util.tree_map(jnp.asarray, prop)
    with jax.set_mesh(mesh):
      if name.startswith("multi"):
        fin = run_graph_program_2d_batched(g, prog, prop, jnp.asarray(act),
                                           mesh, max_iters=300)
        for f in ("done", "iters", "num_active", "iteration"):
          out[f"{key}/{f}"] = np.asarray(getattr(fin, f))
      else:
        fin = run_graph_program_2d(
            g, prog, prop, jnp.asarray(act), mesh,
            max_iters=8 if name == "pagerank" else 300)
        out[key + "/iteration"] = np.asarray(fin.iteration)
        out[key + "/num_active"] = np.asarray(fin.num_active)
    out.update(leaves(key + "/prop", fin.prop))
    out[key + "/active"] = np.asarray(fin.active)
np.savez(sys.argv[1], **out)
"""


def _rmat8():
  from repro_torch.graphs import dedupe_edges, remove_self_loops, rmat_edges
  src, dst = rmat_edges(8, 8, seed=3)
  src, dst = remove_self_loops(src, dst)
  src, dst = dedupe_edges(src, dst)
  w = np.random.default_rng(0).uniform(0.1, 2.0, len(src)).astype(np.float32)
  return 256, src, dst, w


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
  path = tmp_path_factory.mktemp("jax2d") / "ref.npz"
  env = dict(os.environ)
  env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                       env.get("PYTHONPATH", "")])
  res = subprocess.run([sys.executable, "-c", _CHILD, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
  assert res.returncode == 0, res.stderr[-3000:]
  with np.load(path) as z:
    return dict(z)


def _torch_programs():
  return {
      "pagerank": pagerank_program(),
      "sssp": sssp_program(),
      "bfs": bfs_program(),
      "max": GraphProgram(process_message=lambda m, e, d: m,
                          reduce_kind="max", apply=torch.maximum,
                          process_reads_dst=False),
      "any": GraphProgram(process_message=lambda m, e, d: m & (e > 1.0),
                          reduce_kind="any", apply=torch.logical_or,
                          process_reads_dst=False),
      "generic": GraphProgram(process_message=lambda m, e, d: torch.where(
                                  e > 1.7, m, 0), reduce_kind="generic",
                              reduce=torch.bitwise_or, reduce_identity=0,
                              apply=torch.bitwise_or, process_reads_dst=False),
      "multi_bfs": multi_bfs_program(),
      "multi_sssp": multi_sssp_program(),
  }


def _unflatten(arrays: dict, key: str):
  """``key`` or its ``key.<leaf>`` entries as a tensor or a dict of them."""
  if key in arrays:
    return torch.from_numpy(arrays[key])
  pre = key + "."
  return {k[len(pre):]: torch.from_numpy(v) for k, v in arrays.items()
          if k.startswith(pre)}


def _rank_run(grid, graph_dirs: dict, inputs_path: str) -> dict:
  """One rank: every program on its block, on the CPU."""
  with np.load(inputs_path) as z:
    arrays = dict(z)
  blocks = {k: TD.DistGraph.load(d).block(grid.i, grid.j, device="cpu")
            for k, d in graph_dirs.items()}
  out = {}
  for name, prog in _torch_programs().items():
    block = blocks[name not in UNWEIGHTED]
    prop = _unflatten(arrays, f"{name}/init_prop")
    act = _unflatten(arrays, f"{name}/init_active")
    if name in BATCHED:
      fin = TD.run_graph_program_2d_batched(block, prog, prop, act, grid,
                                            max_iters=300)
      res = {f: getattr(fin, f) for f in
             ("done", "iters", "num_active", "iteration")}
    else:
      fin = TD.run_graph_program_2d(
          block, prog, prop, act, grid,
          max_iters=PAGERANK_ITERS if name == "pagerank" else 300)
      res = {"iteration": fin.iteration, "num_active": fin.num_active}
    res["prop"], res["active"] = fin.prop, fin.active
    out[name] = res
  return out


_PORT_RUNS = {}


def _port(grid, jax_out, tmp_path_factory):
  """The port's outputs on every rank of ``grid``, once per grid."""
  if grid not in _PORT_RUNS:
    R, C = grid
    tmp = tmp_path_factory.mktemp(f"port{R}x{C}")
    n, src, dst, w = _rmat8()
    dirs = {True: str(tmp / "w"), False: str(tmp / "u")}
    TD.partition_2d(src, dst, w, n=n, R=R, C=C).save(dirs[True])
    TD.partition_2d(src, dst, n=n, R=R, C=C).save(dirs[False])
    pre = f"{R}x{C}/"
    np.savez(tmp / "inputs.npz", **{k[len(pre):]: v for k, v in jax_out.items()
                                    if k.startswith(pre) and "/init_" in k})
    _PORT_RUNS[grid] = TD.launch(_rank_run, R, C, dirs,
                                 str(tmp / "inputs.npz"))
  return _PORT_RUNS[grid]


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("weighted", [True, False], ids=["w", "unweighted"])
def test_partition_2d_matches_jax(grid, weighted):
  from repro.core import distributed as JD
  n, src, dst, w = _rmat8()
  R, C = grid
  w = w if weighted else None
  want = JD.partition_2d(src, dst, w, n=n, R=R, C=C)
  got = TD.partition_2d(src, dst, w, n=n, R=R, C=C)
  assert (got.n, got.n_pad, got.R, got.C) == (want.n, want.n_pad, R, C)
  for f in ("src", "dst", "w", "emask"):
    a, b = getattr(got, f), np.asarray(getattr(want, f))
    assert a.dtype == b.dtype and a.shape == b.shape, f
    np.testing.assert_array_equal(a, b, err_msg=f)


def test_block_is_the_reference_local_slice(tmp_path):
  n, src, dst, w = _rmat8()
  dg = TD.partition_2d(src, dst, w, n=n, R=4, C=2)
  dg.save(tmp_path)
  loaded = TD.DistGraph.load(tmp_path)
  b = loaded.block(3, 1, device="cpu")
  assert b.n == dg.rows_per_block == 64 and dg.cols_per_block == 128
  assert b.src.dtype == torch.int64 and b.dst.dtype == torch.int64
  np.testing.assert_array_equal(b.src.numpy(), dg.src[3, 1])
  np.testing.assert_array_equal(b.dst.numpy(), dg.dst[3, 1])
  np.testing.assert_array_equal(b.w.numpy(), dg.w[3, 1])
  np.testing.assert_array_equal(b.emask.numpy(), dg.emask[3, 1])
  # The blocks' real edges are the graph's, each once.
  assert int(dg.emask.sum()) == len(src)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", PROGRAMS + BATCHED)
def test_2d_runner_matches_jax(grid, name, jax_out, tmp_path_factory):
  ranks = _port(grid, jax_out, tmp_path_factory)
  key = f"{grid[0]}x{grid[1]}/{name}"
  fields = (("done", "iters", "num_active", "iteration") if name in BATCHED
            else ("iteration", "num_active"))
  for r, out in enumerate(ranks):
    got = out[name]
    for f in fields + ("active",):
      np.testing.assert_array_equal(_np(got[f]), jax_out[f"{key}/{f}"],
                                    err_msg=f"rank {r} {f}")
    prop = got["prop"]
    leaves = (prop.items() if isinstance(prop, dict) else [(None, prop)])
    for leaf, val in leaves:
      want = jax_out[f"{key}/prop" + (f".{leaf}" if leaf else "")]
      assert _np(val).dtype == want.dtype
      if name == "pagerank":
        np.testing.assert_allclose(_np(val), want, **ADD_TOL)
      else:
        np.testing.assert_array_equal(_np(val), want, err_msg=f"rank {r}")


def test_every_rank_returns_the_same_global_state(jax_out, tmp_path_factory):
  ranks = _port((4, 2), jax_out, tmp_path_factory)
  for out in ranks[1:]:
    for name in PROGRAMS + BATCHED:
      for a, b in zip(_tree.tree_leaves(out[name]),
                      _tree.tree_leaves(ranks[0][name])):
        assert torch.equal(a, b), name


def _raise_on_rank_one(grid):
  if grid.rank == 1:
    raise RuntimeError("rank one fails")
  return grid.rank


def _grid_layout(grid):
  return [grid.i, grid.j, torch.distributed.get_world_size(grid.reduce_group),
          torch.distributed.get_world_size(grid.gather_group)]


def test_launch_fails_when_a_rank_fails():
  with pytest.raises(Exception, match="rank one fails"):
    TD.launch(_raise_on_rank_one, 1, 2)


def test_grid_groups():
  got = TD.launch(_grid_layout, 2, 3)
  assert got == [[r // 3, r % 3, 3, 2] for r in range(6)]


def test_pad_vertex_tree_matches_jax():
  from repro.core import distributed as JD
  tree = {"d": np.arange(6, dtype=np.int32).reshape(3, 2),
          "a": np.array([True, False, True])}
  want = JD.pad_vertex_tree(tree, 3, 8, fill=7)
  got = TD.pad_vertex_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                           3, 8, fill=7)
  for k in tree:
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
  assert TD.pad_vertex_tree(got, 8, 8) is got


def _rank_spmv(grid, graph_dir: str, msg, active):
  """``spmv_2d`` on this rank's block: column block j of the message in,
  row block i of (y, recv) out."""
  block = TD.DistGraph.load(graph_dir).block(grid.i, grid.j, device="cpu")
  nc = msg.shape[0] // grid.C
  cols = slice(grid.j * nc, (grid.j + 1) * nc)
  y, recv = TD.spmv_2d(block, msg[cols], active[cols], grid.rows(msg),
                       sssp_program(), grid)
  return [y, recv]


def test_spmv_2d_equals_one_device(tmp_path):
  from repro_torch.core import graph as TG
  from repro_torch.core.spmv import spmv_coo
  n, src, dst, w = _rmat8()
  TD.partition_2d(src, dst, w, n=n, R=2, C=2).save(tmp_path)
  r = np.random.default_rng(5)
  msg = torch.from_numpy(r.uniform(0, 4, n).astype(np.float32))
  active = torch.from_numpy(r.random(n) < 0.5)
  ranks = TD.launch(_rank_spmv, 2, 2, str(tmp_path), msg, active)
  want_y, want_recv = spmv_coo(TG.build_coo(src, dst, w, n=n, device="cpu"),
                               msg, active, msg, sssp_program())
  got_y = torch.cat([ranks[0][0], ranks[2][0]])      # row blocks 0 and 1
  got_recv = torch.cat([ranks[0][1], ranks[2][1]])
  assert torch.equal(got_y, want_y) and torch.equal(got_recv, want_recv)
  assert torch.equal(ranks[1][0], ranks[0][0])       # replicated over (i, ·)
