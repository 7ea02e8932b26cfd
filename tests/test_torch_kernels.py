"""The CUDA ELL kernel's plain version, wrapper and backend against the JAX
package.

* ``ell_spmv_ref`` against the JAX ``ell_spmv_pallas`` in interpret mode,
  as ``tests/test_kernels.py`` runs it, over a subset of its sweep.
* The ``ell_spmv`` wrapper on CPU tensors (its plain version) for the four
  ``process_op`` forms, against the JAX kernel at Q = 1 and with
  ``block_queries``.
* The ``cuda_ell`` backend on CPU, spill and un-permute included, against
  the JAX ``pallas`` backend.
* On a card only: the kernel against its plain version.

Tolerances: min/max and int32 bitwise; float add rtol 1e-5 (atol 1e-5 as
in ``tests/test_kernels.py``), since the sums run in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algos.bfs import bfs_program as j_bfs_program  # noqa: E402
from repro.algos.pagerank import (  # noqa: E402
    pagerank_program as j_pagerank_program)
from repro.algos.sssp import sssp_program as j_sssp_program  # noqa: E402
from repro.core import backends as jbe  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import spmv as jspmv  # noqa: E402
from repro.kernels.ell_spmv import ell_spmv_pallas  # noqa: E402
from repro_torch.algos.bfs import bfs_program  # noqa: E402
from repro_torch.algos.pagerank import pagerank_program  # noqa: E402
from repro_torch.algos.sssp import sssp_program  # noqa: E402
from repro_torch.core import backends as tbe  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.vertex_program import (  # noqa: E402
    PROCESS_FORMS, GraphProgram)
from repro_torch.kernels import ell_spmv as kmod  # noqa: E402
from repro_torch.kernels.ref import ell_spmv_ref  # noqa: E402

# The reference sweep's semirings; the callables work on both frameworks.
PROCS = {
    "min_plus": (lambda m, e, d: m + e[..., None], "min"),
    "plus_times": (lambda m, e, d: m * e[..., None], "add"),
    "max_times": (lambda m, e, d: m * e[..., None], "max"),
    "plus_dst": (lambda m, e, d: (e[..., None] - m * d) * m, "add"),
}


def make_ell(rng, n_pad, width, n_src, dtype):
  cols = rng.integers(0, n_src, (n_pad, width)).astype(np.int32)
  vals = rng.uniform(0.1, 2.0, (n_pad, width)).astype(dtype)
  mask = rng.uniform(size=(n_pad, width)) > 0.3
  return cols, vals, mask


def _assert(got, want, kind):
  got = got.cpu().numpy()
  want = np.asarray(want)
  if kind == "add" and want.dtype.kind == "f":
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  else:
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 8, 8, 1), (64, 16, 100, 1),
                                   (128, 24, 50, 4)])
@pytest.mark.parametrize("sem", sorted(PROCS))
def test_ref_matches_jax_kernel(shape, sem):
  n_pad, width, n_src, k = shape
  rng = np.random.default_rng(sum(shape) + len(sem))
  cols, vals, mask = make_ell(rng, n_pad, width, n_src, np.float32)
  msg = rng.standard_normal((n_src, k)).astype(np.float32)
  act = rng.uniform(size=n_src) > 0.2
  dprop = rng.standard_normal((n_pad, k)).astype(np.float32)
  proc, kind = PROCS[sem]
  yj, rj = ell_spmv_pallas(*map(jnp.asarray, (cols, vals, mask, msg, act,
                                              dprop)),
                           process=proc, reduce_kind=kind)
  yt, rt = ell_spmv_ref(*map(torch.from_numpy, (cols, vals, mask, msg, act,
                                                dprop)),
                        process=proc, reduce_kind=kind)
  np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
  _assert(yt, yj, kind)


FORMS = [  # process_op, reduce, dtype, JAX callable
    ("msg", "add", np.float32, lambda m, e, d: m),
    ("msg_plus_one", "min", np.int32, lambda m, e, d: m + 1),
    ("msg_plus_edge", "min", np.float32, lambda m, e, d: m + e[..., None]),
    ("msg_times_edge", "max", np.float32, lambda m, e, d: m * e[..., None]),
]


@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("q", [1, 4])
def test_wrapper_forms_match_jax_kernel(form, q):
  op, kind, dtype, jproc = form
  rng = np.random.default_rng(q)
  cols, vals, mask = make_ell(rng, 32, 16, 40, np.float32)
  vals = vals.astype(dtype)
  msg = (rng.integers(0, 50, (40, q)) if dtype == np.int32
         else rng.standard_normal((40, q))).astype(dtype)
  act = rng.uniform(size=40) > 0.3
  kw = {"block_queries": 2} if q > 1 else {}
  yj, rj = ell_spmv_pallas(
      *map(jnp.asarray, (cols, vals, mask, msg, act)),
      jnp.zeros((32, 1), dtype), process=jproc, reduce_kind=kind, **kw)
  before = kmod.launches.total
  yt, rt = kmod.ell_spmv(*map(torch.from_numpy, (cols, vals, mask, msg, act)),
                         process_op=op, reduce_kind=kind, **kw)
  assert kmod.launches.total == before  # the CPU path launches nothing
  assert yt.dtype == torch.from_numpy(msg).dtype
  np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
  _assert(yt, yj, kind)


PROGRAMS = {
    "bfs": (j_bfs_program, bfs_program, np.int32),
    "sssp": (j_sssp_program, sssp_program, np.float32),
    "pagerank": (j_pagerank_program, pagerank_program, np.float32),
}


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
@pytest.mark.parametrize("q", [0, 4])
def test_cuda_ell_backend_matches_jax_pallas(rmat_small, prog, q):
  """Spill (width 8) and un-permute included; q=0 is a scalar payload."""
  n, src, dst, w = rmat_small
  jmake, tmake, dtype = PROGRAMS[prog]
  jg = JG.build_ell(src, dst, w, n=n, width=8)
  tg = TG.build_ell(src, dst, w, n=n, width=8, device="cpu")
  rng = np.random.default_rng(7)
  shape = (n,) if q == 0 else (n, q)
  msg = (rng.integers(0, 30, shape) if dtype == np.int32
         else rng.uniform(0, 2, shape)).astype(dtype)
  act = rng.uniform(size=n) < 0.5
  jy, jr = jspmv.spmv(jg, jnp.asarray(msg), jnp.asarray(act),
                      jnp.asarray(msg), jmake(),
                      backend=jbe.Plan(backend="pallas"))
  prog_t = tmake()
  impl = tbe.resolve(tbe.AUTO_PLAN, tg, torch.from_numpy(msg),
                     torch.from_numpy(msg), prog_t)
  assert impl.name == "cuda_ell"
  ty, tr = tspmv.spmv(tg, torch.from_numpy(msg), torch.from_numpy(act),
                      torch.from_numpy(msg), prog_t,
                      backend=tbe.Plan(backend="cuda_ell"))
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
  _assert(ty, jy, prog_t.reduce_kind)


def test_cuda_ell_rejects_what_the_kernel_does_not_take(rmat_small):
  n, src, dst, w = rmat_small
  g = TG.build_ell(src, dst, w, n=n, device="cpu")
  msg = torch.rand(n)
  act = torch.ones(n, dtype=torch.bool)
  plan = tbe.Plan(backend="cuda_ell")
  no_op = GraphProgram(process_message=lambda m, e, d: m * e,
                       reduce_kind="add", process_reads_dst=False)
  with pytest.raises(ValueError, match="process_op"):
    tspmv.spmv(g, msg, act, msg, no_op, backend=plan)
  assert tbe.resolve(tbe.AUTO_PLAN, g, msg, msg, no_op).name == "ell"
  # A program that reads the destination property has no process_op form.
  reads_dst = GraphProgram(process_message=lambda m, e, d: m * d,
                           reduce_kind="add")
  with pytest.raises(ValueError, match="ROADMAP"):
    tspmv.spmv(g, msg, act, msg, reads_dst, backend=plan)
  with pytest.raises(ValueError, match="not both"):
    GraphProgram(process_message=lambda m, e, d: m * d, process_op="msg")
  with pytest.raises(ValueError, match="process_message or process_op"):
    GraphProgram(reduce_kind="add")
  with pytest.raises(ValueError, match="block_slots"):
    tspmv.spmv(g, msg, act, msg, pagerank_program(),
               backend=tbe.Plan(backend="cuda_ell", block_slots=8))
  with pytest.raises(ValueError):
    GraphProgram(process_message=lambda m, e, d: m, process_op="msg_squared")
  # Edge forms need vals in the message's dtype: int32 SSSP-style messages
  # on float edges stay on the torch ELL path.
  int_edge = GraphProgram(reduce_kind="min", process_op="msg_plus_edge")
  assert int_edge.process_message is PROCESS_FORMS["msg_plus_edge"]
  assert not int_edge.process_reads_dst
  assert tbe.resolve(tbe.AUTO_PLAN, g, msg.int(), msg.int(),
                     int_edge).name == "ell"


def test_wrapper_rejects_bad_launch_arguments():
  cols = torch.zeros((8, 8), dtype=torch.int32)
  mask = torch.ones((8, 8), dtype=torch.bool)
  with pytest.raises(ValueError, match="process_op"):
    kmod.ell_spmv(cols, cols.float(), mask, torch.ones(4, 1),
                  torch.ones(4, dtype=torch.bool), process_op="nope",
                  reduce_kind="min")
  with pytest.raises(ValueError, match="n_src"):
    kmod.ell_spmv(cols, cols.float(), mask, torch.ones(4, 1),
                  torch.ones(5, dtype=torch.bool), process_op="msg",
                  reduce_kind="min")


def test_kernel_matches_plain_on_card():
  """The CUDA kernel itself; runs only where a card is present."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
  gen = torch.Generator(device="cuda").manual_seed(0)
  for q, (op, kind, dtype, _) in [(q, f) for q in (1, 8) for f in FORMS]:
    tdt = torch.int32 if dtype == np.int32 else torch.float32
    cols = torch.randint(0, 300, (256, 40), generator=gen, device="cuda",
                         dtype=torch.int32)
    vals = (torch.rand((256, 40), generator=gen, device="cuda") + 0.5
            ).to(tdt)
    mask = torch.rand((256, 40), generator=gen, device="cuda") < 0.7
    msg = (torch.rand((300, q), generator=gen, device="cuda") * 50).to(tdt)
    act = torch.rand((300,), generator=gen, device="cuda") < 0.8
    y, r = kmod.ell_spmv(cols, vals, mask, msg, act, process_op=op,
                         reduce_kind=kind)
    yr, rr = ell_spmv_ref(cols, vals, mask, msg, act,
                          torch.zeros((256, 1), dtype=tdt, device="cuda"),
                          process=kmod.plain_process(op), reduce_kind=kind)
    assert torch.equal(r, rr)
    if kind == "add" and tdt.is_floating_point:
      torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
    else:
      assert torch.equal(y, yr)
    if tdt.is_floating_point and kind != "add":
      # A NaN message makes the row's min or max NaN, as torch.amin does.
      msg[::7] = float("nan")
      y, r = kmod.ell_spmv(cols, vals, mask, msg, act, process_op=op,
                           reduce_kind=kind)
      yr, rr = ell_spmv_ref(cols, vals, mask, msg, act,
                            torch.zeros((256, 1), dtype=tdt, device="cuda"),
                            process=kmod.plain_process(op), reduce_kind=kind)
      assert torch.isnan(yr).any()
      torch.testing.assert_close(y, yr, rtol=0, atol=0, equal_nan=True)
