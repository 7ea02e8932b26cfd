"""The CUDA COO kernel on the card against the PyTorch path on the same CUDA
inputs.  This file imports no JAX, so that it runs on a machine with a card
and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_coo_card.py

Every test is marked ``cuda`` and skips without a card.  The kernel path is
:func:`repro_torch.core.spmv.spmv_coo` (and ``spmv_coo_tiled``, and the ELL
spill merge through ``kernels/coo_spmv.py::merge``) on CUDA tensors, which
the routing sends to the kernel; the PyTorch path is the plain version,
``core/spmv.py::_spmv_coo_torch``.  Graphs are dst-sorted COO with a hub of
5,000 in-edges (a run over 4 of the kernel's 1,024-edge tiles), a run of
2,100, single-edge runs, destinations with no edge, padded edges (emask
false at the end) and masked edges in the middle, under frontiers of every
source active (the frontier pass then spares the active flags) and of a
part, and lanewise messages of 1 to 32 lanes (the kernel's query tiles
hold 8).  Tolerances: min and max
bitwise (no arithmetic is reordered); float32 add at rtol 1e-5 (the PyTorch
path adds with atomics in no fixed order, the kernel in its tile order);
float16 and bfloat16 sums against the float64 sum of the same terms at
their own rtol (1e-2, 2e-2: both paths sum in float and round once);
float64 sums of whole numbers below 2**40 (GAP's path counts, the float64
pass-through instance) bitwise, since they are exact in any order.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import graph as G
from repro_torch.core import spmv as S
from repro_torch.core.vertex_program import GraphProgram
from repro_torch.kernels import coo_spmv as K
from repro_torch.kernels import ell_spmv as E

pytestmark = pytest.mark.cuda

N = 400
F32_ADD_RTOL = 1e-5
HALF_RTOL = {torch.float16: 1e-2, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (run on the card: see the docstring)")
  return torch.device("cuda")


def runs_graph(device, pad=0, masked=0.0, seed=0, n=N):
  """A dst-sorted graph: a hub of 5,000 in-edges into vertex 3, 2,100 into
  9, one into 7, 0-5 into each of vertices 10..n-2, none into the rest."""
  rng = np.random.default_rng(seed)
  runs = [(3, 5000), (7, 1), (9, 2100)] + [
      (v, int(rng.integers(0, 6))) for v in range(10, n - 1)]
  dst = np.concatenate([np.full(k, v) for v, k in runs])
  src = rng.integers(0, n, dst.shape[0])
  w = rng.uniform(0.5, 1.5, dst.shape[0]).astype(np.float32)
  g = G.build_coo(src, dst, w, n=n, capacity=dst.shape[0] + pad,
                  device=device)
  if masked:
    keep = torch.from_numpy(rng.uniform(size=g.capacity) >= masked)
    g = G.CooGraph(g.n, g.src, g.dst, g.w, g.emask & keep.to(device),
                   g.out_deg, g.in_deg)
  return g


def inputs(device, shape, dtype=torch.float32, frac=1.0, seed=1):
  rng = np.random.default_rng(seed)
  msg = rng.uniform(0.0, 10.0, shape)
  active = rng.uniform(size=shape[0]) < frac
  return (torch.from_numpy(msg).to(dtype).to(device),
          torch.from_numpy(active).to(device))


def program(op=None, fn=None, reduce_kind="min", reads_dst=False):
  if op is not None:
    return GraphProgram(process_op=op, reduce_kind=reduce_kind)
  return GraphProgram(process_message=fn, reduce_kind=reduce_kind,
                      process_reads_dst=reads_dst)


def both(g, msg, active, dprop, prog, with_recv=True):
  """(kernel path, PyTorch path), checking that the first launched."""
  before = K.launches.total
  torch_before = sum(K.torch_path.values())
  ell_before = E.launches.total
  got = S.spmv_coo(g, msg, active, dprop, prog, with_recv=with_recv)
  assert K.launches.total == before + 1
  assert sum(K.torch_path.values()) == torch_before
  assert E.launches.total == ell_before
  want = S._spmv_coo_torch(g, msg, active, dprop, prog, with_recv=with_recv)
  torch.cuda.synchronize()
  return got, want


def assert_same(got, want, rtol=0.0):
  (y, recv), (y_w, recv_w) = got, want
  assert (recv is None) == (recv_w is None)
  if recv is not None:
    assert torch.equal(recv, recv_w)
  assert y.dtype == y_w.dtype and y.shape == y_w.shape
  if rtol:
    torch.testing.assert_close(y, y_w, rtol=rtol, atol=rtol)
  else:
    assert torch.equal(y, y_w)


@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("frac", [1.0, 0.1])
@pytest.mark.parametrize("layout", ["plain", "padded", "masked"])
def test_sssp_min_is_bitwise(card, q, frac, layout):
  """SSSP's msg_plus_edge, min, at Q = 1 and 8: every frontier and layout
  bitwise equal to the PyTorch path."""
  g = runs_graph(card, pad=700 if layout == "padded" else 0,
                 masked=0.2 if layout == "masked" else 0.0)
  msg, active = inputs(card, (N,) if q == 1 else (N, q), frac=frac)
  assert_same(*both(g, msg, active, msg, program("msg_plus_edge")))


QUERY_TILE_CASES = [(torch.float32, "msg_plus_edge"),
                    (torch.int32, "msg_plus_one")]


@pytest.mark.parametrize("q", [5, 12, 16, 32])
@pytest.mark.parametrize("dtype,op", QUERY_TILE_CASES)
@pytest.mark.parametrize("frac", [1.0, 0.3])
def test_query_tiles_are_bitwise(card, q, dtype, op, frac):
  """Lanewise messages wider than the kernel's query tile of 8 (a partial
  tile at Q = 5 and 12, two to four whole tiles at 16 and 32), SSSP's f32
  and BFS's int32 min, on the hub graph padded and holed: bitwise equal to
  the PyTorch path, recv too."""
  g = runs_graph(card, pad=500, masked=0.1)
  msg, active = inputs(card, (N, q), dtype=dtype, frac=frac)
  assert_same(*both(g, msg, active, msg, program(op)))


def test_frontier_pass_follows_each_call(card):
  """Calls on one stream alternate between every source active (the
  first pass reads no active flag) and one source inactive: each result
  is the PyTorch path's, bitwise (min)."""
  g = runs_graph(card, masked=0.1)
  msg, every = inputs(card, (N,))
  prog = program("msg_plus_edge")
  for hole in (None, 0, None, N - 1, None):
    active = every.clone()
    if hole is not None:
      active[g.src[g.emask][hole if hole == 0 else -1]] = False
    assert_same(*both(g, msg, active, msg, prog))


@pytest.mark.parametrize("with_recv", [True, False])
def test_pagerank_add(card, with_recv):
  """PageRank's msg, add: rtol 1e-5 (the PyTorch path's atomics add in no
  fixed order); recv bitwise."""
  g = runs_graph(card, pad=300)
  msg, active = inputs(card, (N,), frac=0.5)
  assert_same(*both(g, msg, active, msg, program("msg", reduce_kind="add"),
                    with_recv=with_recv), rtol=F32_ADD_RTOL)


@pytest.mark.parametrize("k", [16, 3])
def test_cf_one_leaf(card, k):
  """Collaborative filtering's one-leaf process at K = 16 (and K = 3) with
  a [n, K] property: the lane-mixing instance (a traced process)."""
  g = runs_graph(card, masked=0.1)
  msg, active = inputs(card, (N, k), frac=0.7)
  prop = msg * 0.1
  prog = program(fn=lambda m, e, d: (e - (m * d).sum(-1, keepdim=True)) * m,
                 reduce_kind="add", reads_dst=True)
  assert_same(*both(g, msg, active, prop, prog), rtol=1e-4)


def test_dot_score_max_squeezed(card):
  """A lane-mixing process with a [E] result, max: y is [n]; rtol 1e-5,
  since the kernel sums a dot product's lanes in another order than
  torch.sum does."""
  g = runs_graph(card)
  msg, active = inputs(card, (N, 16), frac=0.5)
  prog = program(fn=lambda m, e, d: (m * d).sum(-1), reduce_kind="max",
                 reads_dst=True)
  assert_same(*both(g, msg, active, msg, prog), rtol=F32_ADD_RTOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_hub_sums_in_float(card, dtype):
  """A hub of 4,999 half-precision in-edges (the hub of
  ``test_torch_process_mixed.py::test_bf16_hub_sum_holds``): the kernel
  sums in float and rounds once, within the dtype's rtol of the float64
  sum of the same terms."""
  n = 5000
  rng = np.random.default_rng(0)
  src = np.concatenate([np.arange(1, n), rng.integers(0, n, 2000)])
  dst = np.concatenate([np.zeros(n - 1, np.int64), rng.integers(1, n, 2000)])
  g = G.build_coo(src, dst, np.ones(src.shape, np.float32), n=n,
                  device=card)
  g = G.CooGraph(g.n, g.src, g.dst, g.w.to(dtype), g.emask, g.out_deg,
                 g.in_deg)
  msg = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(
      dtype).to(card)
  active = torch.ones(n, dtype=torch.bool, device=card)
  prog = program(fn=lambda m, e, d: 0.85 * m, reduce_kind="add")
  (y, _), _ = both(g, msg, active, msg, prog)
  terms = (0.85 * msg).double().cpu().numpy()
  want = np.bincount(dst, weights=terms[src], minlength=n)
  assert y.dtype == dtype
  np.testing.assert_allclose(y.double().cpu().numpy(), want,
                             rtol=HALF_RTOL[dtype], atol=0)


def test_shipped_half_msg_sums_in_float(card):
  """The shipped msg form over float16: 2,048 and then 3,999 ones into one
  vertex sum to 6,048 (a float16 sum stalls at 2,048)."""
  n = 4000
  src = np.arange(n)
  dst = np.zeros(n, np.int64)
  g = G.build_coo(src, dst, None, n=n, device=card)
  msg = torch.ones(n, dtype=torch.float16, device=card)
  msg[0] = 2048.0
  active = torch.ones(n, dtype=torch.bool, device=card)
  (y, _), _ = both(g, msg, active, msg, program("msg", reduce_kind="add"))
  assert float(y[0]) == 6048.0


@pytest.mark.parametrize("reduce_kind", ["add", "min"])
def test_coo_tiled_equals_coo_bitwise(card, reduce_kind):
  """On the kernel path ``num_tiles`` does not change the result: coo and
  coo_tiled are bitwise equal, add too, and two runs are bitwise equal."""
  g = runs_graph(card, pad=100, masked=0.05)
  msg, active = inputs(card, (N,), frac=0.8)
  prog = program(fn=lambda m, e, d: m * e, reduce_kind=reduce_kind)
  y0, r0 = S.spmv_coo(g, msg, active, msg, prog)
  for tiles in (1, 3, 64):
    y1, r1 = S.spmv_coo_tiled(g, msg, active, msg, prog, num_tiles=tiles)
    assert torch.equal(y0, y1) and torch.equal(r0, r1)
  y2, r2 = S.spmv_coo(g, msg, active, msg, prog)
  assert torch.equal(y0, y2) and torch.equal(r0, r2)


@pytest.mark.parametrize("op,reduce_kind,q,dtype", [
    ("msg_plus_edge", "min", 1, torch.float32),
    ("msg_plus_edge", "min", 8, torch.float32),
    ("msg", "add", 1, torch.float32),
    # Several query tiles (the kernel's hold 8): each folds into the prior
    # result, recv as it stood before the call, and recv is written once.
    *[(op, "min", q, dtype) for dtype, op in QUERY_TILE_CASES
      for q in (5, 12, 16, 32)]])
def test_merge_into_ell_result(card, op, reduce_kind, q, dtype):
  """The spill merge folds the runs into another result in place, as
  ``merge_spill``'s PyTorch path does: y = recv ? REDUCE(y, y_s) : y_s
  where the spill reaches, and recv |= recv_s."""
  g = runs_graph(card, masked=0.1)
  msg, active = inputs(card, (N,) if q == 1 else (N, q), dtype=dtype,
                       frac=0.5)
  prog = program(op, reduce_kind=reduce_kind)
  rng = np.random.default_rng(7)
  recv0 = torch.from_numpy(rng.uniform(size=N) < 0.5).to(card)
  ident = {"add": 0, "min": (torch.iinfo(dtype).max if dtype == torch.int32
                             else float("inf"))}[reduce_kind]
  mask = recv0.reshape((-1,) + (1,) * (msg.ndim - 1))
  y0 = torch.where(mask, torch.full_like(msg, 2.5), torch.full_like(msg,
                                                                    ident))
  call = K.route(g, msg, active, msg, prog)
  assert call is not None
  before = K.launches.total
  y, recv = K.merge(call, g, active, y0.clone(), recv0.clone())
  assert K.launches.total == before + 1
  y_s, recv_s = S._spmv_coo_torch(g, msg, active, msg, prog)
  want = S._tree_where(recv_s, S._tree_where(recv0, prog.reduce_fn()(y0, y_s),
                                             y_s), y0)
  assert torch.equal(recv, recv0 | recv_s)
  if reduce_kind == "add":
    torch.testing.assert_close(y, want, rtol=F32_ADD_RTOL, atol=0)
  else:
    assert torch.equal(y, want)


def test_cuda_ell_spill_runs_the_kernel(card):
  """``cuda_ell`` on a graph whose hub spills: the spill merge runs the COO
  kernel once a call (the ELL counter counts only the ELL kernel), and the
  result equals ``Plan("ell")``'s, whose merge takes the same kernel."""
  from repro_torch.core.backends import Plan
  rng = np.random.default_rng(3)
  n = 2000
  src = np.concatenate([np.arange(1, n), rng.integers(0, n, 6000)])
  dst = np.concatenate([np.zeros(n - 1, np.int64), rng.integers(1, n, 6000)])
  w = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32)
  g = G.build_ell(src, dst, w, n=n, width=8, device=card)
  assert g.spill is not None
  msg = torch.from_numpy(rng.uniform(0, 10, n).astype(np.float32)).to(card)
  active = torch.from_numpy(rng.uniform(size=n) < 0.3).to(card)
  prog = program("msg_plus_edge")
  coo0, ell0 = K.launches.total, E.launches.total
  y, recv = S.spmv(g, msg, active, msg, prog, backend=Plan("cuda_ell"))
  assert K.launches.total == coo0 + 1 and E.launches.total == ell0 + 1
  y_t, recv_t = S.spmv(g, msg, active, msg, prog, backend=Plan("ell"))
  assert torch.equal(y, y_t) and torch.equal(recv, recv_t)
  exact = S.spmv_dense(*_dense(src, dst, w, n, card), msg, active, msg, prog)
  assert torch.equal(y, exact[0]) and torch.equal(recv, exact[1])


def _dense(src, dst, w, n, device):
  vals = torch.zeros((n, n), dtype=torch.float32)
  struct = torch.zeros((n, n), dtype=torch.bool)
  best = {}
  for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()):
    best[(d, s)] = min(best.get((d, s), float("inf")), x)
  for (d, s), x in best.items():
    vals[d, s] = x
    struct[d, s] = True
  return vals.to(device), struct.to(device)


def test_unsorted_graph_keeps_the_torch_path(card):
  """A graph built with ``sort=False`` takes the PyTorch path, counted by
  its reason."""
  rng = np.random.default_rng(4)
  src, dst = rng.integers(0, N, 3000), rng.integers(0, N, 3000)
  g = G.build_coo(src, dst, None, n=N, sort=False, device=card)
  msg, active = inputs(card, (N,))
  before = K.torch_path["unsorted"]
  S.spmv_coo(g, msg, active, msg, program("msg_plus_edge"))
  assert K.torch_path["unsorted"] == before + 1


def counts(device, shape, seed=5):
  """float64 whole numbers below 2**40 (path counts): sums of a few
  thousand of them are exact in any order."""
  rng = np.random.default_rng(seed)
  return torch.from_numpy(rng.integers(0, 2**40, shape).astype(
      np.float64)).to(device)


def f64_key(q, call):
  return "coo/" + E.config_key(q, torch.float64, "add", call.process.name)


@pytest.mark.parametrize("q", [1, 4, 8])
@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_float64_sum_is_exact(card, q, frac):
  """The float64 pass-through by add on the hub graph, padded and holed:
  bitwise equal to the PyTorch path, under its own launch key."""
  g = runs_graph(card, pad=300, masked=0.1)
  msg = counts(card, (N,) if q == 1 else (N, q))
  _, active = inputs(card, (N,), frac=frac)
  prog = program("msg", reduce_kind="add")
  call = K.route(g, msg, active, msg, prog)
  assert call is not None and call.process.shipped is None
  before = K.launches.by_config.get(f64_key(q, call), 0)
  assert_same(*both(g, msg, active, msg, prog))
  assert K.launches.by_config[f64_key(q, call)] == before + 1


@pytest.mark.parametrize("q", [1, 4, 8])
def test_float64_merge_into_ell_result(card, q):
  """The spill merge folds float64 runs into another float64 result in
  place, exactly as ``merge_spill``'s PyTorch path does."""
  g = runs_graph(card, masked=0.1)
  msg = counts(card, (N,) if q == 1 else (N, q))
  _, active = inputs(card, (N,), frac=0.5)
  prog = program("msg", reduce_kind="add")
  recv0 = torch.from_numpy(np.random.default_rng(8).uniform(size=N) < 0.5
                           ).to(card)
  mask = recv0.reshape((-1,) + (1,) * (msg.ndim - 1))
  y0 = torch.where(mask, counts(card, msg.shape, seed=9),
                   torch.zeros_like(msg))
  call = K.route(g, msg, active, msg, prog)
  assert call is not None
  before = K.launches.by_config.get(f64_key(q, call), 0)
  y, recv = K.merge(call, g, active, y0.clone(), recv0.clone())
  assert K.launches.by_config[f64_key(q, call)] == before + 1
  y_s, recv_s = S._spmv_coo_torch(g, msg, active, msg, prog)
  assert torch.equal(recv, recv0 | recv_s)
  assert torch.equal(y, torch.where(recv_s.reshape(mask.shape), y0 + y_s,
                                    y0))


@pytest.mark.parametrize("q", [1, 4])
def test_cuda_ell_float64_spill_runs_both_kernels(card, q):
  """``cuda_ell`` over float64 path counts on a graph whose hub spills: the
  ELL kernel's and the COO kernel's float64 instances once each a call,
  and the result equal, exactly, to every edge's message summed with
  ``index_add_`` (repeated edges count each time, as the add reduce counts
  them)."""
  from repro_torch.core.backends import Plan
  rng = np.random.default_rng(3)
  n = 2000
  src = np.concatenate([np.arange(1, n), rng.integers(0, n, 6000)])
  dst = np.concatenate([np.zeros(n - 1, np.int64), rng.integers(1, n, 6000)])
  g = G.build_ell(src, dst, None, n=n, width=8, device=card)
  assert g.spill is not None
  msg = counts(card, (n,) if q == 1 else (n, q))
  active = torch.from_numpy(rng.uniform(size=n) < 0.3).to(card)
  prog = program("msg", reduce_kind="add")
  coo0, ell0 = dict(K.launches.by_config), dict(E.launches.by_config)
  y, recv = S.spmv(g, msg, active, msg, prog, backend=Plan("cuda_ell"))
  new_coo = {k: v - coo0.get(k, 0) for k, v in K.launches.by_config.items()
             if v != coo0.get(k, 0)}
  new_ell = {k: v - ell0.get(k, 0) for k, v in E.launches.by_config.items()
             if v != ell0.get(k, 0)}
  assert [k.split("/")[1:4] for k in new_coo] == [
      ["q1" if q == 1 else "qtiled", "float64", "add"]]
  assert [k.split("/")[:3] for k in new_ell] == [
      ["q1" if q == 1 else "qtiled", "float64", "add"]]
  assert list(new_coo.values()) == list(new_ell.values()) == [1]
  s_t, d_t = (torch.from_numpy(x).to(card) for x in (src, dst))
  live = active[s_t]
  m2 = msg if q > 1 else msg[:, None]
  want = torch.zeros_like(m2).index_add_(0, d_t[live], m2[s_t[live]])
  assert torch.equal(y, want if q > 1 else want[:, 0])
  assert torch.equal(recv, torch.bincount(d_t[live], minlength=n) > 0)
