"""The port's dry run (``repro_torch.launch.dryrun``), in a child process: it
starts a fake process group of 256 or 512 ranks and traces as rank 0, with
no allocation.

The counterpart of ``tests/test_dryrun_cells.py``: the same two cells
(granite-3-2b × decode_32k on 16×16 in the "seq" cache layout, and
granite-3-2b × train_4k on 2×16×16), the same asserts and the skip of
long_500k.  Also: the per-rank ``argument_size_in_bytes`` of a reduced
granite-3-2b × prefill_32k cell (2 layers, smoke widths) equals the
reference's compiled ``argument_size_in_bytes`` for the same cell.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMOKE = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=512,
             dtype="float32", num_heads=4, num_kv_heads=2, head_dim=16)

_CHILD = r"""
import json
from repro_torch.launch.dryrun import run_cell, build_cell, SkipCell

out = {}
rec = run_cell("granite-3-2b", "decode_32k", False, cache_layout="seq")
out["decode"] = dict(flops=rec["flops"], coll=rec["collective_bytes"],
                     devices=rec["devices"])
rec2 = run_cell("granite-3-2b", "train_4k", True)  # multi-pod
out["train_mp"] = dict(flops=rec2["flops"], devices=rec2["devices"])
try:
    build_cell("granite-3-2b", "long_500k", False)
    out["skip"] = False
except SkipCell:
    out["skip"] = True
rec3 = run_cell("granite-3-2b", "prefill_32k", False, cfg_overrides=%s)
out["prefill_args"] = rec3["argument_size_in_bytes"]
print("RESULT:" + json.dumps(out))
"""

_REF_CHILD = r"""
import json
from repro.launch.dryrun import run_cell
rec = run_cell("granite-3-2b", "prefill_32k", False, cfg_overrides=%s)
print("RESULT:" + json.dumps(rec["argument_size_in_bytes"]))
"""


def _run(code: str, timeout: int):
  env = dict(os.environ)
  env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
  res = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=timeout)
  assert res.returncode == 0, res.stderr[-3000:]
  line = [l for l in res.stdout.splitlines() if l.startswith("RESULT:")][-1]
  return json.loads(line[len("RESULT:"):])


@pytest.fixture(scope="module")
def port_cells():
  return _run(_CHILD % repr(SMOKE), 900)


@pytest.mark.slow
def test_dryrun_cells_trace_and_record(port_cells):
  out = port_cells
  assert out["skip"] is True                      # full-attn long_500k
  assert out["decode"]["devices"] == 256
  assert out["train_mp"]["devices"] == 512        # multi-pod mesh
  assert out["decode"]["flops"] > 0
  # seq-layout decode must not move gigabytes per token.
  assert out["decode"]["coll"] < 1e9
  assert out["train_mp"]["flops"] > 1e13


@pytest.mark.slow
def test_argument_bytes_match_reference(port_cells):
  """Per rank: the placed parameters and batch take what the reference's
  compiled executable takes (DTensor's first shard and JAX's padded one
  agree here, as every leaf divides: tests/test_torch_sharding.py)."""
  pytest.importorskip("jax")
  want = _run(_REF_CHILD % repr(SMOKE), 600)
  assert port_cells["prefill_args"] == want
