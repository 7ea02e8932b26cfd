"""Multi-pod dry run: trace every (arch × shape × mesh) cell, as one rank
sees it, with no allocation and no card (the port of
:mod:`repro.launch.dryrun`).

A cell's step — ``train_step``, ``prefill`` or ``decode_step`` — runs once
on fake DTensors placed by :mod:`repro_torch.launch.specs` on a production
mesh (:mod:`repro_torch.launch.mesh`) over a fake process group of 256 or
512 ranks, under ``FakeTensorMode``: every op computes shapes only, every
collective returns at once.  Around that one call:

  * :class:`repro_torch.analysis.cost.CostMode` counts the rank's flops,
    bytes, transcendentals and collectives (eager dispatch sees every
    layer, so ``--unroll`` changes nothing);
  * the same mode's peak of the bytes the step's ops hold gives
    ``temp_size_in_bytes`` (the rank's memory beyond its arguments).
    ``torch.distributed._tools.mem_tracker.MemTracker`` is not used: it
    counts a DTensor at its global size (343 GB for the decode_32k cache of
    granite-3-2b on one rank of 256).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k \\
      --cache-layout seq
  python -m repro_torch.launch.dryrun --all --multi-pod both --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch import configs as C
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.analysis.cost import CostMode, collective_bytes
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (data_axes, make_production_mesh,
                                     start_fake_group)
from repro_torch.models.common import P, ParamDef, named
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import make_decode_step, make_prefill
from repro_torch.train.steps import make_train_step

TP = 16  # fixed "model" axis extent of the production meshes


class SkipCell(Exception):
  pass


def _mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]]):
  """The production mesh on a fake group of its size, or, given
  ``mesh_shape`` (data, model), a mesh of that shape."""
  if mesh_shape is None:
    start_fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
  start_fake_group(int(np.prod(mesh_shape)))
  return init_device_mesh("cpu", tuple(mesh_shape),
                          mesh_dim_names=("data", "model"))


def _place(tree, shardings):
  """Meta stand-ins -> fake DTensors placed by ``shardings`` (call under
  ``FakeTensorMode``)."""
  return tree_map(lambda t, sh: sh.place(torch.empty(t.shape, dtype=t.dtype)),
                  tree, shardings)


def build_cell(arch: str, shape: str, multi_pod: bool, *,
               unroll: bool = False, cfg_overrides: Optional[dict] = None,
               cache_layout: str = "head", fsdp: bool = True,
               serve_dtype: Optional[str] = None,
               mesh_shape: Optional[Sequence[int]] = None,
               batch: Optional[int] = None, seq: Optional[int] = None):
  """Returns (fn, args, mesh, meta): ``fn(*args)`` is the cell's step on
  fake DTensors (make them under a ``FakeTensorMode``: ``args`` is a
  function of no arguments that builds them, so that they are made inside
  the caller's mode).

  ``unroll`` is accepted for the reference's signature and changes nothing
  (eager dispatch counts every layer).  ``mesh_shape`` (data, model),
  ``batch`` and ``seq`` replace the production mesh and the shape's global
  batch and sequence (the card's own check: a 1×1 mesh at the sizes it
  runs); ``tp`` is then the mesh's "model" extent.
  """
  del unroll
  cfg = C.get_config(arch)
  if cfg_overrides:
    cfg = dataclasses.replace(cfg, **cfg_overrides)
  shp = C.SHAPES[shape]
  if not C.shape_supported(cfg, shape):
    raise SkipCell(f"{arch}×{shape}: needs sub-quadratic attention "
                   f"(family={cfg.family}) — skipped")
  if cfg.family == "encdec" and shape == "long_500k":
    raise SkipCell(f"{arch}×{shape}: enc-dec full attention — skipped")
  mesh = _mesh(multi_pod, mesh_shape)
  dp_axes = data_axes(multi_pod) if mesh_shape is None else ("data",)
  dp_size = int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                         for a in dp_axes]))
  tp = TP if mesh_shape is None else int(mesh_shape[1])
  dp = S._dp(dp_axes)
  model = build_model(cfg, tp=tp, dp_spec=dp)
  defs = model.defs()
  kind = shp["kind"]
  if kind == "train" and fsdp:
    defs = S.fsdp_defs(defs, dp_axes, dp_size)
  if kind != "train" and serve_dtype:
    sdt = getattr(torch, serve_dtype)
    defs = tree_map(lambda d: ParamDef(d.shape, d.pspec, sdt, d.init,
                                       d.scale), defs)
  p_shapes = tree_map(lambda d: S.sds(d.shape, d.dtype), defs)
  p_specs = S.named(mesh, tree_map(lambda d: d.pspec, defs))
  B = batch or shp["global_batch"]
  L = seq or shp["seq_len"]

  if kind == "train":
    fn = make_train_step(model)
    b_shapes, b_pspecs = S.batch_specs(cfg, B, L, dp_axes, dp_size,
                                       with_labels=True)

    def args():
      return (_place(p_shapes, p_specs),
              _place(S.opt_state_shapes(defs),
                     S.named(mesh, S.opt_state_pspecs(defs))),
              _place(b_shapes, S.named(mesh, b_pspecs)))
  elif kind == "prefill":
    fn = make_prefill(model)
    b_shapes, b_pspecs = S.batch_specs(cfg, B, L, dp_axes, dp_size,
                                       with_labels=False)

    def args():
      return (_place(p_shapes, p_specs),
              _place(b_shapes, S.named(mesh, b_pspecs)))
  elif kind == "decode":
    fn = make_decode_step(model)
    cache_shapes = model.init_cache(B, L, abstract=True)
    cache_specs = S.named(mesh, S.cache_pspecs(cfg, B, dp_axes, dp_size, tp,
                                               layout=cache_layout))
    dp_or_none = dp if (B % dp_size == 0 and B >= dp_size) else None
    tok_spec = named(mesh, P(dp_or_none, None))

    def args():
      return (_place(p_shapes, p_specs),
              tok_spec.place(torch.empty((B, 1), dtype=torch.int32)),
              _place(cache_shapes, cache_specs),
              torch.empty((), dtype=torch.int32))
  else:
    raise ValueError(kind)
  meta = dict(arch=arch, shape=shape, kind=kind, batch=B, seq=L,
              multi_pod=multi_pod, devices=int(mesh.size()),
              family=cfg.family)
  return fn, args, mesh, meta


def _local_bytes(tree) -> int:
  total = 0
  for t in tree_leaves(tree):
    if isinstance(t, DTensor):
      t = t.to_local()
    if isinstance(t, torch.Tensor):
      total += t.numel() * t.element_size()
  return total


def trace(fn, make_args) -> Tuple[Dict[str, Any], Dict[str, int], Any]:
  """``fn(*make_args())`` once under ``FakeTensorMode``: (its counts,
  {argument, output, temp bytes}, the trace's seconds)."""
  t0 = time.time()
  with FakeTensorMode(allow_non_fake_inputs=True):
    args = make_args()
    with CostMode() as cost:
      out = fn(*args)
    res = cost.result()
    sizes = dict(argument_size_in_bytes=_local_bytes(args),
                 output_size_in_bytes=_local_bytes(out),
                 temp_size_in_bytes=int(res["peak_bytes"]))
  return res, sizes, time.time() - t0


def run_cell(arch: str, shape: str, multi_pod: bool,
             save_hlo: Optional[str] = None, *, unroll: bool = False,
             cfg_overrides: Optional[dict] = None,
             cache_layout: str = "head", fsdp: bool = True,
             serve_dtype: Optional[str] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             batch: Optional[int] = None,
             seq: Optional[int] = None) -> Dict[str, Any]:
  """One cell's record: the reference's keys where they mean the same
  (``trace_s`` for its ``lower_s``)."""
  if save_hlo:
    raise ValueError("save_hlo: the port has no HLO (eager dispatch)")
  fn, make_args, mesh, meta = build_cell(
      arch, shape, multi_pod, unroll=unroll, cfg_overrides=cfg_overrides,
      cache_layout=cache_layout, fsdp=fsdp, serve_dtype=serve_dtype,
      mesh_shape=mesh_shape, batch=batch, seq=seq)
  meta.update(fsdp=fsdp, serve_dtype=serve_dtype, unroll=unroll,
              cache_layout=cache_layout, cfg_overrides=cfg_overrides or {})
  acc, sizes, trace_s = trace(fn, make_args)
  rec = dict(meta)
  rec.update(
      trace_s=round(trace_s, 1),
      flops=float(acc["flops"]),
      product_flops=float(acc["product_flops"]),
      bytes_accessed=float(acc["bytes"]),
      transcendentals=float(acc["transcendentals"]),
      collectives=acc["collectives"],
      collective_bytes=collective_bytes(acc["collectives"]),
      **sizes)
  return rec


def _override(kv: str):
  k, v = kv.split("=", 1)
  if v in ("true", "false", "True", "False"):
    return k, v in ("true", "True")
  if v.isdigit():
    return k, int(v)
  try:
    return k, float(v)
  except ValueError:
    return k, v


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--arch", default=None)
  ap.add_argument("--shape", default=None, choices=list(C.SHAPES) + [None])
  ap.add_argument("--all", action="store_true")
  ap.add_argument("--multi-pod", default="single",
                  choices=["single", "multi", "both"])
  ap.add_argument("--out", default=None, help="directory for JSON records")
  ap.add_argument("--save-hlo", default=None,
                  help="no counterpart in the port: eager dispatch makes no "
                       "HLO; refused")
  ap.add_argument("--unroll", action="store_true",
                  help="accepted, changes nothing: eager dispatch counts "
                       "every layer")
  ap.add_argument("--cache-layout", default="head", choices=["head", "seq"])
  ap.add_argument("--no-fsdp", action="store_true",
                  help="disable ZeRO/FSDP param+optimizer sharding")
  ap.add_argument("--serve-dtype", default=None,
                  help="deployment weight dtype for prefill/decode cells")
  ap.add_argument("--override", action="append", default=[],
                  help="cfg override key=value (repeatable)")
  args = ap.parse_args(argv)
  if args.save_hlo:
    ap.error("--save-hlo has no counterpart in the port (no HLO)")
  overrides = dict(_override(kv) for kv in args.override)

  archs = C.ARCHITECTURES if (args.all or not args.arch) else [args.arch]
  shapes = list(C.SHAPES) if (args.all or not args.shape) else [args.shape]
  pods = {"single": [False], "multi": [True], "both": [False, True]}[
      args.multi_pod]
  failures = 0
  for arch in archs:
    for shape in shapes:
      for mp in pods:
        tag = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
        try:
          rec = run_cell(arch, shape, mp, unroll=args.unroll,
                         cache_layout=args.cache_layout,
                         cfg_overrides=overrides or None,
                         fsdp=not args.no_fsdp, serve_dtype=args.serve_dtype)
          print(f"[OK] {tag}: flops={rec['flops']:.3e} "
                f"coll={rec['collective_bytes']:.3e}B "
                f"args={rec['argument_size_in_bytes']:.3e}B "
                f"temp={rec['temp_size_in_bytes']:.3e}B "
                f"trace={rec['trace_s']}s", flush=True)
          if args.out:
            os.makedirs(args.out, exist_ok=True)
            fname = tag.replace("|", "__").replace(".", "_") + ".json"
            with open(os.path.join(args.out, fname), "w") as f:
              json.dump(rec, f, indent=1)
        except SkipCell as e:
          print(f"[SKIP] {tag}: {e}", flush=True)
        except Exception:
          failures += 1
          print(f"[FAIL] {tag}:\n{traceback.format_exc()}", flush=True)
  return 1 if failures else 0


if __name__ == "__main__":
  sys.exit(main())
