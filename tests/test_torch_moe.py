"""The port's MoE family against the JAX package.

Routing (``_route_group_sort`` on random logits and on logits with exact
ties at the k-th place, with a capacity that drops and one that does not),
the combine, the one-hot dispatch, the aux loss and ``moe_forward`` (both
``moe_impl``s, with and without shared experts, a case that drops); the
GraphMat tie-in (the combine is a PLUS_TIMES ``spmv_coo`` on the bipartite
token→slot graph; sort and one-hot dispatch agree; capacity drops are
deterministic); and ``Model.forward`` (logits and aux), ``decode_step``,
greedy ``generate`` and the sliding-window ring cache at the smoke sizes of
``mixtral_8x7b`` and ``deepseek_v2_236b``, with the JAX weights carried
across by ``params_from_numpy``; and the parameter counts at full size.

Tolerances (those of ``tests/test_torch_dense.py``): float32 rtol and atol
2e-4 (sums in other orders); bfloat16 rtol and atol 3e-2.  Routing indices,
slots and ``keep`` compare exactly, ties at the k-th place included.
bfloat16 is compared on one MoE block's given inputs only: through a whole
model, attention rounded in another order moves a router logit by one
bfloat16 step now and then, and that can send a token to another expert.  The
gate values compare at rtol 1e-6 (a few float32 steps): XLA's and
PyTorch's float32 ``exp`` differ in the last bit on about 9% of inputs, so
no softmax of one equals the other's bit for bit.  The port routes all groups at once
(``[G, Tg, ...]``); the reference routes one group at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import spmv as tspmv  # noqa: E402
from repro_torch.core.vertex_program import GraphProgram  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serve import generate, make_decode_step, make_prefill  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
GATE = dict(rtol=1e-6, atol=0)
MOE = ("mixtral_8x7b", "deepseek_v2_236b")
FULL_PARAMS = {"mixtral_8x7b": 46_702_792_704,
               "deepseek_v2_236b": 239_375_569_920}


def _rng(seed):
  return np.random.default_rng(seed)


def _f32(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(x, np.float32)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _logits(kind, g, tg, e, seed):
  r = _rng(seed)
  if kind == "ties":
    # Few distinct values: equal probabilities at the k-th place are common.
    return (r.integers(0, 3, (g, tg, e)) * 0.5).astype(np.float32)
  return r.standard_normal((g, tg, e)).astype(np.float32)


# ---------------------------------------------------------------------------
# Routing, combine, aux loss
# ---------------------------------------------------------------------------


def test_top_k_puts_the_lower_index_first_on_ties():
  p = np.array([[0.5, 0.7, 0.7, 0.1, 0.7]], np.float32)
  jv, ji = jax.lax.top_k(jnp.asarray(p), 3)
  tv, ti = tmoe._top_k(_t(p), 3)
  np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
  np.testing.assert_array_equal(ti.numpy(), [[1, 2, 4]])
  np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("cap", [4, 32], ids=["drops", "no_drops"])
def test_route_group_sort_matches_jax(kind, cap):
  g, tg, e, k, d = 3, 32, 4, 2, 8
  logits = _logits(kind, g, tg, e, seed=cap)
  x = _rng(1).standard_normal((g, tg, d)).astype(np.float32)
  xe, aux = tmoe._route_group_sort(_t(logits), _t(x), k, e, cap)
  assert xe.shape == (g, e, cap, d)
  dropped = 0
  for i in range(g):
    jxe, jaux = jmoe._route_group_sort(jnp.asarray(logits[i]),
                                       jnp.asarray(x[i]), k, e, cap)
    for name, got, want in zip(("e_sorted", "slot_pos", "tok_sorted",
                                "gate_sorted", "keep"), aux, jaux):
      if name == "gate_sorted":
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   **GATE)
      else:
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want),
                                      err_msg=name)
    np.testing.assert_allclose(xe[i].numpy(), np.asarray(jxe), **F32)
    dropped += int((~np.asarray(jaux[4])).sum())
  assert (dropped > 0) == (cap == 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_group_sort_matches_jax(dtype):
  g, tg, e, k, cap, d = 2, 24, 4, 2, 6, 8
  logits = _logits("random", g, tg, e, seed=3)
  x = _rng(4).standard_normal((g, tg, d)).astype(np.float32)
  ye = _rng(5).standard_normal((g, e, cap, d)).astype(np.float32)
  _, aux = tmoe._route_group_sort(_t(logits), _t(x), k, e, cap)
  tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
  y = tmoe._combine_group_sort(_t(ye).to(tdt), aux, tg)
  assert y.dtype == tdt and y.shape == (g, tg, d)
  tol = F32 if dtype == "float32" else BF16
  for i in range(g):
    _, jaux = jmoe._route_group_sort(jnp.asarray(logits[i]),
                                     jnp.asarray(x[i]), k, e, cap)
    want = jmoe._combine_group_sort(jnp.asarray(ye[i]).astype(jdt), jaux, tg)
    np.testing.assert_allclose(_f32(y[i]), _f32(want), **tol)


@pytest.mark.parametrize("cap", [3, 16], ids=["drops", "no_drops"])
def test_route_group_onehot_matches_jax(cap):
  g, tg, e, k, d = 2, 16, 4, 2, 8
  logits = _logits("ties", g, tg, e, seed=6)
  x = _rng(7).standard_normal((g, tg, d)).astype(np.float32)
  xe, comb = tmoe._route_group_onehot(_t(logits), _t(x), k, e, cap)
  for i in range(g):
    jxe, jcomb = jmoe._route_group_onehot(jnp.asarray(logits[i]),
                                          jnp.asarray(x[i]), k, e, cap)
    np.testing.assert_allclose(xe[i].numpy(), np.asarray(jxe), **F32)
    np.testing.assert_allclose(comb[i].numpy(), np.asarray(jcomb), **F32)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_moe_aux_loss_matches_jax(kind):
  logits = _logits(kind, 2, 9, 6, seed=8)
  want = jmoe.moe_aux_loss(jnp.asarray(logits), 2, 6)
  got = tmoe.moe_aux_loss(_t(logits), 2, 6)
  assert got.dtype == torch.float32 and got.dim() == 0
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_moe_defs_match_jax():
  for arch in MOE:
    for cfg_over in ({}, {"num_shared_experts": 0}):
      jcfg = JC.get_smoke_config(arch).scaled(**cfg_over)
      tcfg = TC.get_smoke_config(arch).scaled(**cfg_over)
      want = jax.tree_util.tree_map(lambda d: d.shape, jmoe.moe_defs(jcfg),
                                    is_leaf=jcommon.is_param_def)
      got = jax.tree_util.tree_map(
          lambda d: d.shape, tmoe.moe_defs(tcfg),
          is_leaf=lambda d: isinstance(d, tcommon.ParamDef))
      assert got == want
      assert ("shared" in got) == bool(tcfg.num_shared_experts)


def _moe_params(jcfg, seed=0):
  params = jcommon.init_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(seed))
  return params, tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("impl", ["sort", "onehot"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0],
                         ids=["drops", "no_drops"])
def test_moe_forward_matches_jax(impl, shared, capacity_factor):
  over = dict(num_shared_experts=shared, capacity_factor=capacity_factor)
  jcfg = JC.get_smoke_config("deepseek_v2_236b").scaled(**over)
  tcfg = TC.get_smoke_config("deepseek_v2_236b").scaled(**over)
  params, tparams = _moe_params(jcfg)
  # 2 x 32 tokens in groups of Tg = 16: four groups, capacity 10 at 1.25.
  x = _rng(9).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
  want = jmoe.moe_forward(params, jnp.asarray(x), jcfg, group_size=16,
                          moe_impl=impl)
  got = tmoe.moe_forward(tparams, _t(x), tcfg, group_size=16, moe_impl=impl)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
  if capacity_factor == 1.25:  # the case drops edges
    logits = torch.einsum("gtd,de->gte", _t(x).reshape(4, 16, -1),
                          tparams["router"])
    _, aux = tmoe._route_group_sort(logits, _t(x).reshape(4, 16, -1),
                                    tcfg.top_k, tcfg.num_experts,
                                    tmoe._group_capacity(tcfg, 16))
    assert not aux[4].all()


def test_moe_forward_bf16_matches_jax():
  jcfg = JC.get_smoke_config("mixtral_8x7b").scaled(dtype="bfloat16")
  tcfg = TC.get_smoke_config("mixtral_8x7b").scaled(dtype="bfloat16")
  params, tparams = _moe_params(jcfg, seed=2)
  x = _rng(10).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
  want = jmoe.moe_forward(params, jnp.asarray(x).astype(jnp.bfloat16), jcfg,
                          group_size=16)
  got = tmoe.moe_forward(tparams, _t(x).to(torch.bfloat16), tcfg,
                         group_size=16)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


# ---------------------------------------------------------------------------
# The GraphMat tie-in (tests/test_moe_graphmat.py, on the port)
# ---------------------------------------------------------------------------


def test_sort_and_onehot_dispatch_agree():
  cfg = TC.get_smoke_config("mixtral_8x7b").scaled(capacity_factor=8.0)
  params = tcommon.init_params(tmoe.moe_defs(cfg),
                               torch.Generator().manual_seed(0), device="cpu")
  x = torch.randn((2, 16, cfg.d_model),
                  generator=torch.Generator().manual_seed(1)) * 0.3
  y_sort = tmoe.moe_forward(params, x, cfg, group_size=16, moe_impl="sort")
  y_oh = tmoe.moe_forward(params, x, cfg, group_size=16, moe_impl="onehot")
  torch.testing.assert_close(y_sort, y_oh, **F32)


@pytest.mark.parametrize("cap", [4, 32], ids=["drops", "no_drops"])
def test_moe_combine_is_generalized_spmv(cap):
  """combine  y[t] = Σ_edges gate(t,e)·Y_e[slot(t,e)]  ==  PLUS_TIMES SpMV
  on the bipartite route graph with edge value = gate."""
  rng = _rng(0)
  tg, e_num, k, d = 32, 4, 2, 8
  logits = rng.standard_normal((1, tg, e_num)).astype(np.float32)
  x = rng.standard_normal((1, tg, d)).astype(np.float32)
  xe, aux = tmoe._route_group_sort(_t(logits), _t(x), k, e_num, cap)
  e_sorted, slot_pos, tok_sorted, gate_sorted, keep = (a[0] for a in aux)
  ye = _t(rng.standard_normal(xe.shape).astype(np.float32))
  y_moe = tmoe._combine_group_sort(ye, aux, tg)[0]

  # Bipartite graph: vertex ids = [0..tg) tokens, [tg..tg+e*cap) slots.
  kept = keep.numpy()
  slot_vid = tg + e_sorted.numpy() * cap + slot_pos.numpy()
  n = tg + e_num * cap
  g = TG.build_coo(slot_vid[kept], tok_sorted.numpy()[kept],
                   gate_sorted.numpy()[kept], n=n, device="cpu")
  # message = expert output per slot vertex; PROCESS = gate·msg; REDUCE = +.
  msg = torch.cat([torch.zeros((tg, d)), ye[0].reshape(e_num * cap, d)])
  prog = GraphProgram(process_message=lambda m, ev, dp: m * ev,
                      reduce_kind="add", process_reads_dst=False)
  y_spmv, _ = tspmv.spmv_coo(g, msg, torch.ones(n, dtype=torch.bool), msg,
                             prog)
  torch.testing.assert_close(y_spmv[:tg], y_moe, rtol=1e-4, atol=1e-5)
  # The reference's own tie-in on the same numbers.
  jaux = jmoe._route_group_sort(jnp.asarray(logits[0]), jnp.asarray(x[0]),
                                k, e_num, cap)[1]
  want = jmoe._combine_group_sort(jnp.asarray(ye[0].numpy()), jaux, tg)
  np.testing.assert_allclose(y_moe.numpy(), np.asarray(want), **F32)


def test_moe_capacity_drops_are_deterministic():
  rng = _rng(1)
  tg, e_num, k, cap = 64, 4, 2, 4  # cap forces drops
  logits = _t(rng.standard_normal((2, tg, e_num)).astype(np.float32))
  x = _t(rng.standard_normal((2, tg, 8)).astype(np.float32))
  first = tmoe._route_group_sort(logits, x, k, e_num, cap)
  again = tmoe._route_group_sort(logits, x, k, e_num, cap)
  assert torch.equal(first[0], again[0])
  assert all(torch.equal(a, b) for a, b in zip(first[1], again[1]))
  e_sorted, slot_pos, _, _, keep = first[1]
  for i in range(2):
    kept = keep[i].numpy()
    assert 0 < kept.sum() < tg * k
    pos = slot_pos[i].numpy()[kept]
    assert pos.max(initial=0) < cap
    # each (expert, slot) pair is unique among kept edges
    pairs = set(zip(e_sorted[i].numpy()[kept].tolist(), pos.tolist()))
    assert len(pairs) == kept.sum()
    assert (slot_pos[i].numpy()[~kept] == cap).all()


# ---------------------------------------------------------------------------
# The model and the serving entry points
# ---------------------------------------------------------------------------


def _models(arch, **over):
  jcfg = JC.get_smoke_config(arch).scaled(**over)
  tcfg = TC.get_smoke_config(arch).scaled(**over)
  jm, tm = j_build_model(jcfg, tp=1), build_model(tcfg)
  params = jax.tree_util.tree_map(
      np.asarray, jcommon.init_params(jm.defs(), jax.random.PRNGKey(1)))
  jparams = jax.tree_util.tree_map(jnp.asarray, params)
  return jm, tm, jparams, tcommon.params_from_numpy(params, device="cpu")


def _tokens(shape, seed=1):
  return _rng(seed).integers(0, 512, shape).astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_defs_match_jax(arch):
  jm, tm, params, tparams = _models(arch)
  shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), params)
  got = jax.tree_util.tree_map(
      lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tparams)
  assert got == shapes
  assert tcommon.num_params(tm.defs()) == jcommon.num_params(jm.defs())


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax(arch):
  jm, tm, params, tparams = _models(arch)
  toks = _tokens((2, 13))
  want, want_aux = jm.forward(params, {"tokens": jnp.asarray(toks)},
                              kv_chunk=4)
  got, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                        kv_chunk=4)
  assert got.shape == (2, 13, 512) and got.dtype == torch.float32
  np.testing.assert_allclose(_f32(got), _f32(want), **F32)
  assert aux.dim() == 0 and float(aux) > 0
  np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **F32)
  assert torch.equal(make_prefill(tm)(tparams,
                                      {"tokens": torch.from_numpy(toks)}),
                     tm.forward(tparams, {"tokens": torch.from_numpy(toks)})[0])


@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_jax(arch):
  jm, tm, params, tparams = _models(arch)
  toks = _tokens((2, 9), seed=2)
  jcache = jm.init_cache(2, 9)
  tcache = tm.init_cache(2, 9, device="cpu")
  assert sorted(tcache) == sorted(jcache)
  for name in jcache:
    assert tuple(tcache[name].shape) == jcache[name].shape
  jstep = jax.jit(jm.decode_step)
  step = make_decode_step(tm)
  for t in range(9):
    want, jcache = jstep(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                         jnp.int32(t))
    got, tcache = step(tparams, torch.from_numpy(toks[:, t:t + 1]), tcache,
                       torch.tensor(t, dtype=torch.int32))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
  for name in jcache:
    np.testing.assert_allclose(_f32(tcache[name]), _f32(jcache[name]), **F32)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_without_drops(arch):
  """Teacher-forced decode == full forward, within the port, where the
  prefill's groups drop no edge (a one-token decode group never drops)."""
  _, tm, _, tparams = _models(arch, capacity_factor=16.0)
  toks = torch.from_numpy(_tokens((2, 12), seed=3))
  logits, _ = tm.forward(tparams, {"tokens": toks}, kv_chunk=4)
  cache = tm.init_cache(2, 12, device="cpu")
  outs = []
  for t in range(12):
    lg, cache = tm.decode_step(tparams, toks[:, t:t + 1], cache, t)
    outs.append(lg)
  torch.testing.assert_close(torch.cat(outs, dim=1), logits, **F32)


def test_swa_ring_cache_consistency():
  """The port of ``tests/test_models_smoke.py::
  test_swa_ring_cache_consistency``: Mixtral's sliding_window=8 ring,
  decoded 20 steps (past the window) at a raised capacity_factor, against
  the reference's decode and the full forward."""
  jm, tm, params, tparams = _models("mixtral_8x7b", capacity_factor=16.0)
  toks = _tokens((1, 20), seed=4)
  jcache = jm.init_cache(1, 20)
  cache = tm.init_cache(1, 20, device="cpu")
  assert cache["k"].shape[2] == 8 == jcache["k"].shape[2]
  jstep = jax.jit(jm.decode_step)
  outs = []
  for t in range(20):
    want, jcache = jstep(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                         jnp.int32(t))
    got, cache = tm.decode_step(tparams, torch.from_numpy(toks[:, t:t + 1]),
                                cache, t)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    outs.append(got)
  logits, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                         kv_chunk=4)
  torch.testing.assert_close(torch.cat(outs, dim=1), logits, **F32)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_matches_jax(arch):
  jm, tm, params, tparams = _models(arch)
  prompt = _tokens((2, 5), seed=6)
  want = jengine.generate(jm, params, jnp.asarray(prompt), max_new=4)
  got = generate(tm, tparams, torch.from_numpy(prompt), max_new=4)
  assert got.dtype == torch.int32 and got.shape == (2, 9)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE)
def test_full_width_param_count(arch):
  defs = build_model(TC.get_config(arch)).defs()
  want = j_build_model(JC.get_config(arch), tp=1).defs()
  assert tcommon.num_params(defs) == jcommon.num_params(want) \
      == FULL_PARAMS[arch]
  shapes = jax.tree_util.tree_map(lambda d: tuple(d.shape), want,
                                  is_leaf=jcommon.is_param_def)
  assert jax.tree_util.tree_map(
      lambda d: tuple(d.shape), defs,
      is_leaf=lambda d: isinstance(d, tcommon.ParamDef)) == shapes
