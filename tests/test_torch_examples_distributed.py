"""``examples/distributed_pagerank_torch.py`` against
``examples/distributed_pagerank.py``.

The reference example raises before it runs anything: it asks for
``pagerank_program(tol=1e-6)``, which takes no ``tol`` (``ROADMAP.md``,
Queue 3 item 17).  The port runs PageRank at that tolerance as both
packages' ``pagerank(..., tol=...)`` does (delta-PageRank, rank₀ = Δ₀ = r),
so the reference side here is the reference's ``run_graph_program_2d``
with ``delta_pagerank_program(tol=1e-6)`` on the example's shuffled
RMAT-12 graph, 8 fake CPU devices as a 4×2 mesh, ``max_iters=50``, in a
subprocess (the device count must be fixed before JAX starts).  The port
runs the example's ``pagerank_2d`` in 8 spawned gloo ranks on the CPU.

Tolerances: supersteps, the final frontier size and the top-5 ids
exactly; the ranks at rtol 1e-5 (the block scatter-adds sum in another
order than XLA's).  Both print the top-5 as shuffled ids under the label
"original ids" (Queue 3 item 15).

The spawned ranks import the example by name, so ``examples/`` goes on
``sys.path``.
"""

import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.algos.pagerank import delta_pagerank_program
from repro.core import distributed as D
from repro.graphs import (dedupe_edges, remove_self_loops, rmat_edges,
                          shuffle_vertices)

src, dst = rmat_edges(12, 8, seed=21)
src, dst = remove_self_loops(src, dst)
src, dst = dedupe_edges(src, dst)
n = 1 << 12
src, dst, perm = shuffle_vertices(src, dst, n, seed=3)
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
dg = D.partition_2d(src, dst, None, n=n, R=4, C=2)
out_deg = np.bincount(src, minlength=dg.n_pad).astype(np.float32)
prop = {"rank": jnp.full((dg.n_pad,), 0.15, jnp.float32),
        "delta": jnp.full((dg.n_pad,), 0.15, jnp.float32),
        "deg": jnp.asarray(out_deg)}
with jax.set_mesh(mesh):
  final = D.run_graph_program_2d(dg, delta_pagerank_program(tol=1e-6), prop,
                                 jnp.ones((dg.n_pad,), bool), mesh,
                                 max_iters=50)
np.savez(sys.argv[1], ranks=np.asarray(final.prop["rank"])[:n], perm=perm,
         iteration=np.asarray(final.iteration),
         num_active=np.asarray(final.num_active), n_pad=dg.n_pad,
         capacity=dg.src.shape[-1])
"""


def _env():
  env = dict(os.environ)
  env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                       env.get("PYTHONPATH", "")])
  return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
  path = tmp_path_factory.mktemp("dpr") / "ref.npz"
  res = subprocess.run([sys.executable, "-c", _CHILD, str(path)], env=_env(),
                       capture_output=True, text=True, timeout=600)
  assert res.returncode == 0, res.stderr[-3000:]
  with np.load(path) as z:
    return dict(z)


@pytest.fixture(scope="module")
def example():
  sys.path.insert(0, str(ROOT / "examples"))
  try:
    return importlib.import_module("distributed_pagerank_torch")
  finally:
    sys.path.remove(str(ROOT / "examples"))


@pytest.fixture(scope="module")
def port(example):
  # The ranks import the example by name; eight ranks share the host's
  # cores, one thread each.
  sys.path.insert(0, str(ROOT / "examples"))
  threads = os.environ.get("OMP_NUM_THREADS")
  os.environ["OMP_NUM_THREADS"] = "1"
  try:
    return example.pagerank_2d(12, device="cpu")
  finally:
    sys.path.remove(str(ROOT / "examples"))
    if threads is None:
      del os.environ["OMP_NUM_THREADS"]
    else:
      os.environ["OMP_NUM_THREADS"] = threads


def test_reference_example_raises_on_tol():
  res = subprocess.run([sys.executable,
                        str(ROOT / "examples" / "distributed_pagerank.py")],
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
  assert res.returncode != 0
  assert "pagerank_program() got an unexpected keyword argument 'tol'" in \
      res.stderr


def test_supersteps_and_top5_match_reference(port, reference):
  assert (port["n"], port["n_pad"], port["capacity"]) == (
      4096, int(reference["n_pad"]), int(reference["capacity"]))
  assert port["supersteps"] == int(reference["iteration"]) == 50
  assert port["num_active"] == int(reference["num_active"])
  np.testing.assert_array_equal(port["perm"], reference["perm"])
  assert port["top"] == np.argsort(-reference["ranks"])[:5].tolist()


def test_ranks_match_reference(port, reference):
  assert port["ranks"].dtype == np.float32
  np.testing.assert_allclose(port["ranks"], reference["ranks"], rtol=1e-5)
  assert port["every_rank_equal"]


def test_printed_ids_are_the_shuffled_ids_as_in_the_reference(
    example, port, reference, monkeypatch, capsys):
  monkeypatch.setattr(example, "pagerank_2d", lambda *a, **k: port)
  example.main(["--device", "cpu"])
  lines = capsys.readouterr().out.splitlines()
  assert lines[0] == (f"mesh 4×2, n=4096 padded to {port['n_pad']}, "
                      f"block capacity {port['capacity']} edges")
  assert lines[1] == "converged in 50 supersteps (tolerance frontier emptied)"
  shuffled = np.argsort(-reference["ranks"])[:5]
  original = np.argsort(reference["perm"])[shuffled]
  assert lines[2] == f"top-5 (original ids): {shuffled.tolist()}"
  assert shuffled.tolist() != original.tolist()
