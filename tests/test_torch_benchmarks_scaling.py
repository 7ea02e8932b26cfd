"""Fig. 5 (``benchmarks/bench_scaling_torch.py``) and the roofline
(``benchmarks/roofline_torch.py``) of the port's harness against the
reference's.

Scaling: the reference's analyzer runs in a child process on 8 fake host
devices (this file's own child: the reference's superstep at RMAT scale 10
on the 2×2 and 4×2 meshes, not its scale-14 ``_CHILD``); the port counts
rank 0's superstep under ``CostMode`` on fake process groups in its own
child.  Both reduce an f32 ``[nr]`` ``y`` and an int8 ``[nr]`` ``recv``
over the row's group, so the collective bytes per kind and group size are
equal.  The reference's analyzer reads no group size from the explicit
``replica_groups={{0,1},...}`` that XLA prints (it matches only the
``[a,b]`` iota form) and keys them ``|0``; this file's child reads the sizes
from the HLO text.  FLOPs are not compared with XLA's, which counts by
fusion: the port's are held to the analytic count stated in
:func:`test_flops_are_the_analytic_count`, and the reference's is printed
beside it.

Roofline: ``model_flops`` equals the reference's for every architecture ×
shape; ``analyze_record`` on one record of the port's dry run (traced in a
child process, which holds its own default process group) equals the
reference's with the reference module's constants set to the H100's.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_scaling as ref_scaling  # noqa: E402
from benchmarks import roofline as ref_roof  # noqa: E402
from benchmarks import bench_scaling_torch as scaling  # noqa: E402
from benchmarks import roofline_torch as roof  # noqa: E402
from benchmarks.common_torch import (H100_BF16_OPS_PER_S,  # noqa: E402
                                     H100_BYTES_PER_S,
                                     H100_NVLINK_BYTES_PER_S)
from repro import configs as RC  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE = 10
GRIDS = {"2d_4": (2, 2), "2d_8": (4, 2)}

_REF_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, re, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.distributed import partition_2d, spmv_2d
from repro.algos.pagerank import pagerank_program
from repro.graphs import (rmat_edges, remove_self_loops, dedupe_edges,
                          shuffle_vertices)
from repro.graphs.rmat import RMAT_PRBFS
from repro.analysis.hlo_cost import analyze

scale, grids = %d, %r
src, dst = rmat_edges(scale, 8, RMAT_PRBFS, seed=9)
src, dst = remove_self_loops(src, dst)
src, dst = dedupe_edges(src, dst)
n = 1 << scale
src, dst, _ = shuffle_vertices(src, dst, n, seed=2)
prog = pagerank_program()
out = {}
for tag, (r, c) in grids.items():
    mesh = jax.make_mesh((r, c), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    dg = partition_2d(src, dst, None, n=n, R=r, C=c)
    msg = jnp.ones((dg.n_pad,), jnp.float32)
    act = jnp.ones((dg.n_pad,), bool)
    prop = {"rank": msg, "deg": msg}
    def one(msg, act, prop):
        return spmv_2d(dg, msg, act, prop, prog, mesh)
    with jax.set_mesh(mesh):
        text = jax.jit(one).lower(msg, act, prop).compile().as_text()
    acc = analyze(text)
    sizes = {}
    for line in text.splitlines():
        m = re.search(r"= \S+ (all-reduce|all-gather|reduce-scatter|"
                      r"all-to-all|collective-permute)\(", line)
        if m:
            g = re.search(r"replica_groups=\{\{([\d,]*)\}", line)
            sizes.setdefault(m.group(1), set()).add(
                len(g.group(1).split(",")) if g else 0)
    pop = np.asarray(jnp.sum(dg.emask, axis=-1), np.float64)
    out[tag] = dict(collectives=acc["collectives"], flops=acc["flops"],
                    group_sizes={k: sorted(v) for k, v in sizes.items()},
                    balance=float(pop.max() / max(pop.mean(), 1.0)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
  env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
  res = subprocess.run([sys.executable, "-c", _REF_CHILD % (SCALE, GRIDS)],
                       env=env, capture_output=True, text=True, timeout=300)
  assert res.returncode == 0, res.stderr[-3000:]
  return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
  return {rec["tag"]: rec for rec in scaling.count(SCALE, "cpu")}


def _ref_meshes():
  return [(t, (int(r), int(c))) for t, r, c in re.findall(
      r'\("(\w+)", \((\d+), (\d+)\)\)', ref_scaling._CHILD)]


def test_meshes_are_the_references():
  assert list(scaling.MESHES) == _ref_meshes()
  assert scaling.SCALE == 14 and "scale, ef = 14, 8" in ref_scaling._CHILD


@pytest.mark.parametrize("tag", sorted(GRIDS))
def test_collective_bytes_match_reference(tag, reference, port):
  ref = reference[tag]
  want = {}
  for rec in ref["collectives"].values():
    (g,) = ref["group_sizes"][rec["kind"]]
    key = f"{rec['kind']}|{g}"
    b, c = want.get(key, (0.0, 0.0))
    want[key] = (b + rec["bytes"], c + rec["count"])
  got = {k: (v["bytes"], v["count"]) for k, v in
         port[tag]["collectives"].items()}
  r, c = GRIDS[tag]
  nr = -(-(1 << SCALE) // (r * c)) * (r * c) // r
  # an f32 [nr] y and an int8 [nr] recv over a group of C
  assert got == want == {f"all-reduce|{c}": (5.0 * nr, 2.0)}
  assert port[tag]["coll_bytes"] == 5.0 * nr


def test_reference_analyzer_reads_no_group_size(reference):
  """The reference's ``_GROUPS_RE`` matches only ``replica_groups=[a,b]``:
  the explicit groups give ``group_size`` 0, so its roofline's ring factor
  prices these collectives at 0 s.  The port's count reads the size from
  the process group."""
  for tag in GRIDS:
    assert {v["group_size"] for v in reference[tag]["collectives"].values()
            } == {0}
    assert reference[tag]["group_sizes"] == {"all-reduce": [GRIDS[tag][1]]}


@pytest.mark.parametrize("tag", sorted(GRIDS))
def test_flops_are_the_analytic_count(tag, reference, port):
  """Rank 0's PageRank superstep: 2 ops per padded block edge (the validity
  mask ``emask & active[src]`` and the select of message or identity;
  ``pagerank_program``'s ``process_op="msg"`` passes the message through)
  and 2 per row of its block (``recv > 0`` after the scatter and after the
  all-reduce).  XLA counts its fusions otherwise; its number is printed."""
  from repro_torch.core.distributed import partition_2d
  from repro_torch.graphs import (dedupe_edges, remove_self_loops,
                                  rmat_edges, shuffle_vertices)
  from repro_torch.graphs.rmat import RMAT_PRBFS
  r, c = GRIDS[tag]
  n = 1 << SCALE
  src, dst = rmat_edges(SCALE, 8, RMAT_PRBFS, seed=9)
  src, dst = dedupe_edges(*remove_self_loops(src, dst))
  src, dst, _ = shuffle_vertices(src, dst, n, seed=2)
  dg = partition_2d(src, dst, None, n=n, R=r, C=c)
  want = 2.0 * dg.src.shape[2] + 2.0 * dg.rows_per_block
  print(f"{tag}: port {port[tag]['flops']:.0f} FLOPs (analytic "
        f"{want:.0f}), reference's XLA count {reference[tag]['flops']:.0f}")
  assert port[tag]["flops"] == want


@pytest.mark.parametrize("tag", sorted(GRIDS))
def test_balance_matches_reference(tag, reference, port):
  assert port[tag]["balance"] == reference[tag]["balance"]


def test_rows_on_h100_constants(port, monkeypatch):
  recs = [port[t] for t, _ in scaling.MESHES]
  monkeypatch.setattr(scaling, "count", lambda scale, device: recs)
  rows = scaling.main("cpu")
  assert [r.split(",")[0] for r in rows] == [
      f"scaling/pagerank_{t}" for t, _ in _ref_meshes()]
  ts = [max(r["flops"] / H100_BF16_OPS_PER_S, r["bytes"] / H100_BYTES_PER_S,
            r["coll_bytes"] / H100_NVLINK_BYTES_PER_S) for r in recs]
  for row, t, rec in zip(rows, ts, recs):
    assert row.split(",")[1] == f"{t * 1e6:.2f}"
    assert f"projected_speedup={ts[0] / t:.2f}x" in row
    assert f"balance={rec['balance']:.2f}" in row
  assert not any(r["coll_bytes"] for r in recs if r["tag"].startswith("1d"))


def test_the_port_has_the_references_configs():
  from repro_torch import configs as C
  assert list(C.ARCHITECTURES) == list(RC.ARCHITECTURES)
  assert C.SHAPES == RC.SHAPES


@pytest.mark.parametrize("arch", RC.ARCHITECTURES)
def test_model_flops_match_reference(arch):
  for shape in RC.SHAPES:
    assert roof.model_flops(arch, shape) == ref_roof.model_flops(arch, shape)


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
  out = tmp_path_factory.mktemp("dryrun")
  env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
  res = subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
       "granite-3-2b", "--shape", "decode_32k", "--cache-layout", "seq",
       "--out", str(out)], env=env, capture_output=True, text=True,
      timeout=300)
  assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
  return out


def test_model_flops_at_a_cells_own_sizes():
  """A dry-run cell may override the shape's global batch and sequence
  (phase 13's 1×1 cells run 4 × 2,048): its model FLOPs are counted at
  those sizes."""
  full = roof.model_flops("granite-3-2b", "train_4k")
  shp = RC.SHAPES["train_4k"]
  cut = roof.model_flops("granite-3-2b", "train_4k", 4, 2048)
  assert cut * shp["global_batch"] * shp["seq_len"] == full * 4 * 2048
  assert roof.model_flops("granite-3-2b", "decode_32k", 4, 2048) * \
      RC.SHAPES["decode_32k"]["global_batch"] == \
      roof.model_flops("granite-3-2b", "decode_32k") * 4


def test_analyze_record_matches_reference(dryrun_dir, monkeypatch):
  (path,) = dryrun_dir.glob("*.json")
  rec = json.loads(path.read_text())
  assert rec["devices"] == 256 and rec["collectives"]
  monkeypatch.setattr(ref_roof, "PEAK_FLOPS", H100_BF16_OPS_PER_S)
  monkeypatch.setattr(ref_roof, "HBM_BW", H100_BYTES_PER_S)
  monkeypatch.setattr(ref_roof, "LINK_BW", H100_NVLINK_BYTES_PER_S)
  got = roof.analyze_record(rec)
  assert got == ref_roof.analyze_record(rec)
  assert got["t_collective"] > 0 and got["model_flops"] > 0


def test_roofline_prints_the_table(dryrun_dir, capsys):
  assert roof.main(["--dir", str(dryrun_dir)]) == 0
  lines = capsys.readouterr().out.splitlines()
  assert lines[0].split()[:2] == ["arch", "shape"]
  assert lines[2].split()[:2] == ["granite-3-2b", "decode_32k"]
  assert lines[2].split()[5] in ("compute", "memory", "collective")
