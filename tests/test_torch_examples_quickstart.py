"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``.

The same RMAT-12 graph and weights (numpy, seeded) go through the
reference's SSSP program (its lambda, on the JAX engine) and the port's, in
both of the port's forms: PROCESS_MESSAGE declared as
``process_op="msg_plus_edge"`` (eligible for the CUDA ELL kernel, whose
plain version runs on CPU tensors) and as the reference's lambda (the torch
ELL path).  Tolerance: bitwise (min over the same float32 candidates), with
equal superstep counts.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.core import backends  # noqa: E402
from repro_torch.kernels import process_expr  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
  spec = importlib.util.spec_from_file_location(
      f"_example_{name}", ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope="module")
def port():
  return _load("quickstart_torch")


@pytest.fixture(scope="module")
def reference():
  """The reference's run (its ``main`` body), as arrays."""
  ref = _load("quickstart")
  scale = 12
  src, dst = ref.rmat_edges(scale, edge_factor=8, seed=42)
  src, dst = ref.remove_self_loops(src, dst)
  src, dst = ref.dedupe_edges(src, dst)
  n = 1 << scale
  w = np.random.default_rng(0).uniform(0.1, 2.0, len(src)).astype(np.float32)
  graph = ref.build_ell(src, dst, w, n=n)
  sssp = ref.GraphProgram(
      process_message=lambda msg, edge, dst_prop: msg + edge,
      reduce_kind="min", apply=lambda reduced, old: jnp.minimum(reduced, old),
      process_reads_dst=False, name="sssp")
  dist0 = jnp.full((n,), jnp.inf, jnp.float32).at[6].set(0.0)
  active0 = jnp.zeros((n,), bool).at[6].set(True)
  final = ref.run_graph_program(graph, sssp, dist0, active0)
  return np.asarray(final.prop), int(final.iteration)


@pytest.fixture(scope="module")
def port_graph(port):
  return port.build_graph(12, "cpu")


@pytest.mark.parametrize("declared", [True, False], ids=["process_op",
                                                         "lambda"])
def test_sssp_matches_reference_bitwise(port, port_graph, reference,
                                        declared):
  want, steps = reference
  graph, n = port_graph
  out = port.run_sssp(graph, n, 6, declared=declared)
  assert out["dist"].dtype == torch.float32
  np.testing.assert_array_equal(out["dist"].numpy(), want)
  assert out["supersteps"] == steps == 8
  assert out["reached"] == int(np.isfinite(want).sum()) == 2579


def test_declared_form_is_kernel_eligible_and_the_lambda_is_not(
    port, port_graph):
  """Both forms are kernel-eligible now: the reference's lambda is traced
  into the kernel and equals the declared form ``msg_plus_edge`` node for
  node, so it runs that form's shipped instance (the name is from the
  slice before the lambda was traced)."""
  graph, n = port_graph
  kernel = backends.get_backend("cuda_ell")
  msg = torch.zeros((n,), dtype=torch.float32)
  declared, lam = port.sssp_program(True), port.sssp_program(False)
  assert declared.process_op == "msg_plus_edge"
  assert not declared.process_reads_dst
  assert kernel.eligible(graph, msg, msg, declared)
  assert lam.process_op is None and kernel.eligible(graph, msg, msg, lam)
  traced = process_expr.for_program(lam, msg, graph.vals, None)
  assert traced.shipped == "msg_plus_edge"
  # Structural auto (the engine's default) puts both on the kernel.
  auto = backends.AUTO_PLAN
  assert backends.base.resolve(auto, graph, msg, msg, declared).name == \
      "cuda_ell"
  assert backends.base.resolve(auto, graph, msg, msg, lam).name == \
      "cuda_ell"


def test_main_prints_the_reference_lines(port, capsys):
  _load("quickstart").main()
  want = capsys.readouterr().out
  port.main(["--device", "cpu"])
  got = capsys.readouterr().out
  assert got == want
  assert got.startswith("SSSP from vertex 6: converged in 8 supersteps, "
                        "reached 2579/4096 vertices")
