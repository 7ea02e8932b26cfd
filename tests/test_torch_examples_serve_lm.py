"""``examples/serve_lm_torch.py`` against ``examples/serve_lm.py``.

The example's model (Mixtral's smoke config at the reference example's
widths) with the reference's weights (``init_params(PRNGKey(0))``, carried
across by ``params_from_numpy``) and prompts (``randint(PRNGKey(1))``):
greedy generation equals the reference's token for token.  Sampling draws
from a ``torch.Generator``, not ``jax.random``, so the sampled run is held
only to its shape, its prompt prefix and the vocabulary.
"""

import ast
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.serve import generate as j_generate  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
  spec = importlib.util.spec_from_file_location(
      f"_example_{name}", ROOT / "examples" / f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope="module")
def port():
  return _load("serve_lm_torch")


def _reference_config():
  # examples/serve_lm.py:19-21
  return JC.get_smoke_config("mixtral_8x7b").scaled(
      num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
      vocab_size=1024, num_experts=4, top_k=2, moe_d_ff=256)


def test_config_is_the_references(port):
  want, got = _reference_config(), port.example_config()
  for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
            "head_dim", "vocab_size", "num_experts", "top_k", "moe_d_ff",
            "d_ff", "dtype", "capacity_factor", "sliding_window"):
    assert getattr(got, f) == getattr(want, f), f


def test_greedy_matches_reference_token_for_token(port):
  cfg = _reference_config()
  model = j_build_model(cfg, tp=1)
  params = jcommon.init_params(model.defs(), jax.random.PRNGKey(0))
  prompt = jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                              cfg.vocab_size)
  want = np.asarray(j_generate(model, params, prompt, max_new=24,
                               greedy=True))
  tparams = tcommon.params_from_numpy(
      jax.tree_util.tree_map(np.asarray, params), device="cpu")
  out = port.serve(device="cpu", greedy=True, params=tparams,
                   prompt=torch.from_numpy(np.array(prompt, np.int32)))
  got = out["tokens"]
  assert got.dtype == torch.int32 and tuple(got.shape) == (4, 32)
  np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_run_keeps_the_prompt(port):
  out = port.serve(device="cpu")
  toks, prompt = out["tokens"], out["prompt"]
  assert toks.dtype == torch.int32 and tuple(toks.shape) == (4, 32)
  assert torch.equal(toks[:, :8], prompt)
  assert int(toks.min()) >= 0 and int(toks.max()) < 1024
  again = port.serve(device="cpu")["tokens"]
  assert torch.equal(again, toks)  # seeded: the same draws


def test_main_prints_four_continuations(port, capsys):
  port.main(["--device", "cpu"])
  lines = capsys.readouterr().out.splitlines()
  assert lines[0].startswith("served 4 requests × 24 new tokens in ")
  assert lines[1] == "continuations:"
  rows = [ast.literal_eval(l.strip()) for l in lines[2:]]
  assert len(rows) == 4 and all(len(r) == 32 for r in rows)


def test_first_greedy_token_is_the_argmax_of_a_prefill_that_drops_nothing(
    port):
  """A one-token decode group never drops a (token, expert) edge, so the
  first greedy token is the argmax of a prefill at a capacity factor under
  which the prompts drop none (at the configured 1.25 they may)."""
  from repro_torch.models.transformer import build_model
  from repro_torch.serve import make_prefill
  out = port.serve(device="cpu", greedy=True)
  cfg = out["model"].cfg.scaled(capacity_factor=16.0)
  logits = make_prefill(build_model(cfg))(out["params"],
                                          {"tokens": out["prompt"]})
  first = logits[:, -1, :cfg.vocab_size].argmax(dim=-1)
  assert torch.equal(out["tokens"][:, 8].long(), first)
