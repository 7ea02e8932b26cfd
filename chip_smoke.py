#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py            # all phases, RMAT scale 20
    python3 chip_smoke.py --scale 12 # a quicker rehearsal (smaller graphs)

Phases, in order; any failure exits non-zero before the result line:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``, one
   compiler per source, all at once: the shipped ELL and scan libraries
   and the ELL kernel's generated instances for the processes of
   ``traced_programs()`` (per-edge functions written only as lambdas, each
   traced by ``kernels/process_expr.py``; among them processes that
   mix the lanes of a [n, K] message, at K = 3, 16, 33, 128 and 256 over
   float32, float16 and bfloat16 messages, and processes over bfloat16 or
   mixed dtypes), each instance's seconds and a second load's cache hit;
2. hold the ELL kernel against its plain PyTorch version on the card over a
   sweep of shapes, semirings (the destination-reading form too, with a
   [n_pad, 1] and a [n_pad, Q] property), dtypes, query widths, masks
   (random, degree-sorted prefix rows, empty and last-slot-only rows) and
   frontiers (partial and every source active); then every generated
   instance against its plain version (the program's callable) over the
   same kinds of case, float16 included, the lane-mixing ones at their K
   with 80%, all and no sources active and on rows of 0, 1, 4, 5, 31, 32,
   33 and 152 slots; and the shipped float16 instances' sums (a row of
   4,000 terms of 1.0 gives 4,000 exactly; 2,048 and 3,999 ones give
   6,048, where a float16 sum would stall at 2,048; 500 terms within one
   float16 ulp of the float64 sum, at Q = 1 and 8);
3. build an RMAT graph (Graph500 parameters, scale 20, edge factor 16,
   self-loops removed, symmetrized) as an ELL graph on the card, serve 32
   BFS queries through ``GraphQueryServer`` with ``Plan("cuda_ell")`` (by
   ``drain()`` and through a ``ServerDriver``), hold them against the plain
   torch ``Plan("ell")`` path, run single-query BFS, SSSP, PageRank and
   a destination-reading gradient sweep (one lane and eight) through the
   kernel, and check that the kernel's launch counter rose; the
   lambda-only programs (widest path, its 8-source lane form, a damped
   PageRank of 20 sweeps, an int32 ``where``, SSSP as ``e + m``) through
   ``Plan("cuda_ell")`` against ``Plan("ell")``, each launching its
   generated instance, and so the mixed-dtype and lane-mixing programs
   (the damped PageRank in
   bfloat16, SSSP's ``m + e`` on the graph's edge values in float16, one
   superstep of a lane dot score over a K = 16 message and property),
   every spill merge among them on the COO kernel (``kernels/coo_spmv.py``,
   its launches and its CUDA calls left on the PyTorch path counted from
   the first query on); then run the BFS, the SSSP and the 32 queries
   again with the kernel's calls recorded;
4. time the ELL kernel and its plain version with CUDA events on the
   recorded calls of BFS and SSSP (their frontiers, superstep by superstep)
   and with every source active for PageRank (in turns with
   ``torch.sparse.mm``) and the gradient sweeps, the generated instances
   on their own programs' recorded calls, the ``e + m`` instance against
   the shipped ``msg_plus_edge`` on the SSSP's recorded calls (the card's
   time, in turns), the mixed-dtype and lane-mixing instances' rows, and
   the kernel at four frontiers (all, 10% and all but one source active);
   then the COO kernel on the graph's spill (SSSP at Q = 1 with every and
   10% of sources active and at Q = 8, PageRank's add in turns with
   ``torch.sparse.mm``), each held against ``_spmv_coo_torch`` on the same
   tensors (min bitwise, add within ``COO_ADD_TOL``) beside its byte bound
   and its message gathers' floor (``tools/gather_floor.cu``);
5. the paper's five algorithms and its Table 3: PageRank (20 sweeps), BFS
   and SSSP through ``Plan("cuda_ell")`` on the phase-3 graph against the
   native baselines on its edges (BFS and SSSP bitwise, PageRank at rtol
   1e-4), ``Planner.autotune`` for PageRank (Q = 1) and BFS (Q = 8) on it;
   then, with the graph freed, triangle counting (RMAT scale 16 with the
   paper's TC parameters, DAG-oriented, ``Plan("coo")``; equal to the native
   count and to a scipy count) and collaborative filtering at the Netflix
   Prize's size (K = 16, 3 sweeps; its RMSE below the mean rating's, equal
   to the native CF within ``CF_TOL``); each timed against its native
   baseline in turns, and the five ratios beside the paper's; then CF with
   its process over the latent matrix as the one leaf, phase U through
   ``Plan("cuda_ell")`` on the item-to-user graph built as ELL (the
   lane-vector grid), phase V on the COO kernel (its launches counted), 2
   sweeps held to the port's ``coo`` CF within ``CF_TOL``, and the rows of
   both kernels on the sweep's calls;
6. hold the selective-scan kernel against its plain version
   over the shapes of the reference's kernel test, shapes that run each
   choice of lanes per channel, and edge cases at the lanes of the prefill
   shape (ragged S and C, dt = 0, dt large enough that exp(dt·a) is 0, NaN
   in u, each at N = 4, 8 and 16; N = 5), and at the Falcon-Mamba-7B
   prefill shape [4, 2048, 8192, 16] and at [1, 2048, 8192, 16]; time it at
   both;
7. serve Falcon-Mamba-7B (``ssm_impl="fused"``, bf16 compute, random
   float32 weights from a seeded generator on the card): 4 prompts of 2,048
   tokens through ``make_prefill`` (one kernel launch per layer), the same
   prompts cut to 32 tokens through the decode step and ``generate`` (16
   greedy tokens), the device-busy share of one prefill and one decode
   step (``torch.profiler``), prefill against decode logits (in bf16 and
   again in float32 compute), and ``forward`` fused against ``assoc`` on 2
   layers;
8. the 2-D distributed runner (``core/distributed.py``) on the card: the
   phase-3 edges relabelled by ``shuffle_vertices`` and partitioned by
   ``partition_2d`` in the parent (before phase 5 frees the graph), then
   four spawned ranks on the one card over a gloo group (R = C = 2; NCCL
   refuses two ranks on one device) and one rank over an NCCL group (R = C
   = 1), each running BFS, SSSP, PageRank (20 sweeps, every vertex active)
   and 8 batched BFS queries on its block through ``Plan("coo")``, held
   against the single-device engine on the same edges; the block
   populations, and each run's superstep split into reshard, block SpMV,
   reduce and count.  Four ranks sharing one card measure the runner's
   overhead, not scale-out;
9. serve Granite-8B at its published widths and depth (the dense family:
   random float32 weights from a seeded generator on the card, bf16
   compute): 4 prompts of 2,048 tokens through ``make_prefill``
   (``kv_chunk`` 1024), one decode step at B = 4 against a 4,096-slot
   cache at position 2,048, the prompts cut to 32 tokens through the decode
   step and ``generate`` (16 greedy tokens), prefill against decode logits
   (bf16 and float32 compute), ``torch.profiler`` passes of a prefill and a
   decode step, one layer's attention and SwiGLU blocks, and chunked
   against dense attention on that layer's tensors, with
   ``scaled_dot_product_attention`` timed beside it as a yardstick (not on
   the path); neither kernel is launched (none is owed there);
10. serve the moe family at published widths with cut depth (random
   float32 weights, bf16 compute): Mixtral-8x7B (8 of 32 layers) and then
   DeepSeek-V2 (MLA, 2 of 60 layers), each as phase 9 serves Granite (a
   4 × 2,048 prefill, a decode step at position 2,048, 16 greedy tokens,
   profiler passes); the (token, expert) edges each layer's routing groups
   drop in the prefill at the config's capacity factor (the layers stepped
   one by one through the port's ``_route_group_sort``); prefill against
   decode on the 32-token prompts at that factor (the gap beside the drops,
   no bound) and at one under which nothing drops, in bf16 and float32,
   with each path's routing recorded; one layer's attention, routing and
   dispatch, expert GEMMs and combine at the prefill shape; on that layer's
   tensors, in float32, sort against onehot dispatch and the combine
   against ``spmv_coo`` on the token→expert bipartite ``CooGraph``; no
   kernel is launched (none is owed there);
11. serve the hybrid, encdec and vlm families at published widths (random
   float32 weights, bf16 compute), one model after another, each freed
   before the next: Zamba2-7B (all 81 layers: 13 segments of the shared
   attention block and 6 Mamba-2 blocks, then 3), SeamlessM4T-medium (12
   encoder + 12 decoder layers; a memory of 4 × 4,096 stub frames) and
   InternVL2-26B (24 of 48 layers; 256 stub vision embeddings + 1,792
   tokens a sequence), each as phase 9 serves Granite (a 4 × 2,048
   prefill, a decode step at position 2,048, 16 greedy tokens, profiler
   passes, peak memory); prefill against decode on the 32-token prompts
   (Zamba2 in bf16 and float32; SeamlessM4T as configured, reported beside
   the zero cross cache, and with every ``xattn.wo`` zeroed; InternVL2 with
   the image prefix, reported, and with none); one layer's blocks at the
   prefill shape (Zamba2: the Mamba-2 block and its three parts, the
   shared block; SeamlessM4T: an encoder layer, a decoder layer's self
   and cross attention and SwiGLU; InternVL2: attention and SwiGLU); no
   kernel is launched (none is owed there);
12. train Granite-3-2B at its published widths and depth (40 layers, remat
   full; random float32 weights, bf16 compute) through ``make_train_step``
   (AdamW, cosine schedule) on ``synthetic_batch`` at 4 × 2,048 tokens: 8
   steps on two alternating batches (the loss must be finite and fall), 6
   of them timed with CUDA events and one under ``torch.profiler`` (device
   busy share, device time by kernel class), peak memory, the optimizer
   update timed alone; at 4 layers, the gradients and peaks of remat full
   against none; at 2 layers in float32, the card's loss and gradients
   against the host's from the same weights; at 2 layers, the driver
   ``launch/train.py`` for 3 steps with a checkpoint every step, a restart
   to 6 that resumes at step 3, against 6 steps in one run; no kernel is
   launched on the train path (neither has a backward).  Then the eval
   step of Falcon-Mamba-7B (8 of 64 layers) with the fused scan (8
   launches) against ``assoc``, and a fused train step, which must raise;
13. the sharded LM (``build_model(cfg, tp=1, dp_spec="data")``, parameters
   and AdamW state as DTensors placed by ``param_shardings`` /
   ``opt_state_pspecs`` on a 1×1 ("data", "model") ``DeviceMesh`` over
   NCCL, world size 1; NCCL refuses two ranks on one card, so a real
   multi-rank mesh runs only in the CPU tests): Granite-3-2B at its
   published widths and depth, a 4 × 2,048 prefill and the loss and every
   gradient of a train step held against the unsharded port on the same
   weights and batch, two sharded train steps, each timed beside the
   unsharded one; the dry run's per-rank FLOPs and argument bytes for the
   same two steps (traced on a fake 1×1 group) against ``analysis``' count
   of the card's run and the placed tensors' storage bytes, and each
   step's FLOPs share of the data-sheet bf16 rate; Falcon-Mamba-7B (8 of
   64 layers, ``ssm_impl="fused"``) prefilled on the mesh, the CUDA scan
   through ``local_map`` (8 launches), against the unsharded fused
   prefill; and the reference test's dry-run cells (granite-3-2b ×
   decode_32k in the "seq" layout on 16×16, × train_4k on 2×16×16, the
   skip of long_500k), traced in a child process on fake process groups
   beside phases 12 and 13 (its failure fails the run), each cell's record
   written under ``chiprun_out/dryrun/``;
14. the five torch examples (``examples/*_torch.py``), imported with
   ``examples/`` on ``sys.path``, their section functions called on the
   card: the suite's road grid (``grid_road_graph``, 1,024 × 1,024: n =
   1,048,576, 4,190,208 edges) through its COO SSSP section, then through
   ``build_ell`` and ``Planner.plan`` with no forced plan (it must pick
   ``cuda_ell`` and launch the kernel) for BFS, SSSP and PageRank (20
   sweeps), each against ``Plan("ell")``, ``Planner.autotune`` for BFS and
   PageRank at Q = 1, and the kernel's road-grid rows of the kernels line;
   the lambda-only programs of phase 3 there (the lane widest path cut to
   ``TRACED_ROAD_LANE_ITERS`` supersteps), their generated instances' rows
   and ``e + m`` against ``msg_plus_edge``;
   at RMAT-18 (cut from 20: each example builds its own graph on the host)
   the quickstart's SSSP declared (``process_op``) and as the reference's
   lambda (traced: it equals the declared form), both through structural
   ``auto`` onto ``cuda_ell``, the suite's PageRank and BFS against
   ``algos/native``, the multi-query service's four sections (the
   fair-share split also at the example's RMAT-10, held to the
   reference's), the 4×2 distributed PageRank in eight gloo ranks sharing
   the card against one device; the suite's TC and CF at its own sizes;
   ``serve_lm``'s model sampled and greedy, then Mixtral-8x7B at published
   widths (2 of 32 layers) greedy;
15. the port's benchmark harness (``benchmarks/*_torch.py``): ``python -m
   benchmarks.run_torch --device cuda`` in a child process at the
   reference's own scale 12 with its Fig. 5 section (counted in a child of
   its own on fake process groups), whose rows must be the reference's
   under the ``pallas`` → ``cuda_ell`` mapping (``BENCH_CLI_ROWS``) with no
   ``ERROR`` row; then at RMAT-18 (cut from 20: the harness's TC runs two
   scales below, and TC above 16 does not fit the card) Fig. 4 / Table 2,
   the multi-query sweep, Table 3 on the same rows and the Fig. 7 ladder
   with its planner and admission sweeps, each once in this process, with
   the ELL kernel's launches counted by plan (the ``cuda_ell`` rows and
   every ``cuda_ell`` planner candidate must launch it, no other plan may);
   the roofline over phase 13's dry-run records;

then a summary line of phase 15, the card line, the ``{"kernels": [...]}``
line and last ``{"ok": true, "device": {...}}``.  Detail that is too long for the end of the output goes
to ``chiprun_out/chip_smoke.json``.

Tolerances: ELL min/max reductions and int32 results must match bitwise
(the same values are reduced, in any order; float forms round op by op, as
the plain version does; a generated instance computes a float16 process
in float32 and rounds after each op, as eager CUDA does).  The
lambda-only programs: widest path (both forms), the int32 ``where`` and
``e + m`` bitwise ``Plan("ell")``'s, the damped PageRank at rtol 1e-4;
SSSP on float16 edges bitwise, the bfloat16 PageRank within
``MIXED_PR_RTOL`` (2e-2), the dot score (a float lane sum) at rtol 1e-5.
Generated instances of a float16 or bfloat16 result sum in float and round
once, as the plain version does.  Float add reductions, and processes with
a float lane sum whatever their reduce, match
with ``rtol`` 1e-5 in float32, 1e-2 in float16 and 2e-2 in bfloat16
(``RTOL``), ``atol`` = rtol times the
largest magnitude of the plain result, because the kernel sums in another
order than the plain version.  PageRank after 20 sweeps: rtol 1e-4; the
gradient sweeps' change to the property: rtol 1e-5, atol
``GRADIENT_ATOL``.  The
selective scan: rtol 2e-4 / atol 2e-5 in the sweep (the reference's own);
at full width atol 2e-5 times max|y_plain|, because the two sum the N
products in another order.  Logits: prefill against decode within
``PREFILL_DECODE_TOL`` times max|logit| in bf16 and
``PREFILL_DECODE_F32_TOL`` in float32 compute, fused against assoc within
``FUSED_ASSOC_TOL`` times max|logit| (see their comments).  The 2-D
runner: BFS and SSSP bitwise with equal superstep counts (min over the same
float32 candidates is exact in any order), the batched BFS bitwise with
equal per-query counts, PageRank at rtol 1e-4.  Granite-8B: prefill against
decode within ``GQA_PREFILL_DECODE_TOL`` (bf16) and
``GQA_PREFILL_DECODE_F32_TOL`` (float32) times max|logit|, chunked against
dense attention within ``CHUNKED_DENSE_TOL`` times max|out|.  The moe
family: with no capacity drops, prefill against decode within
``MOE_PREFILL_DECODE_TOL`` (bf16) and ``MOE_PREFILL_DECODE_F32_TOL``
(float32) times max|logit| (see their comment); sort against onehot and the combine against ``spmv_coo``
within ``MOE_CROSS_TOL`` times max|y|.  Phase 11: Zamba2's prefill against
decode within ``HYBRID_PREFILL_DECODE_TOL`` (bf16) and
``HYBRID_PREFILL_DECODE_F32_TOL`` (float32) times max|logit|; SeamlessM4T
with ``xattn.wo`` zeroed and InternVL2 with no image within
``FRONTEND_FREE_PREFILL_DECODE_TOL`` (see their comments).  Phase 12:
gradients of remat full against none within ``REMAT_GRAD_TOL``, the card
against the host within ``HOST_LOSS_RTOL`` and ``HOST_GRAD_TOL``, the
resumed run's parameters within ``RESUME_PARAM_ATOL`` of the uninterrupted
run's (the restored state bit for bit), the fused eval loss within
``FUSED_ASSOC_TOL`` of the assoc one, relative to it.  Phase 13: the
sharded logits, loss and gradients equal the unsharded ones bit for bit
(the bound stated before its first run: on a 1×1 mesh the same local
kernels run on the same tensors); the dry run's FLOPs and argument bytes
equal the card's exactly; the dry-run cells within the reference test's
own bounds (devices 256 and 512, decode FLOPs > 0 and collective bytes
< 1e9, train FLOPs > 1e13, long_500k skipped).  Phase 14: the road grid's
BFS and SSSP through the kernel equal ``Plan("ell")``'s bitwise (and the
suite's COO SSSP), its PageRank within ``EXAMPLE_PR_RTOL``; the
quickstart's two forms bitwise; the suite's PageRank at rtol 1e-4 and BFS
bitwise against the native baselines, TC and CF (RMSE nan, diverged at
the example's step size) as the reference; the 2-D PageRank within
``DIST_PR_RTOL`` of one device; ``serve_lm``'s first greedy token is the
argmax of ``make_prefill``'s last logits at ``NO_DROP_CAPACITY``.  Phase
15: the ``cuda_ell`` PageRank (the harness's and the planner sweep's)
within ``BENCH_PR_RTOL`` of ``ell``'s; TC equal to native's (the harness's
own assert).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import typing

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, data sheet
# Base-2 exponentials per clock per SM on compute capability 9.0 (the CUDA
# C++ Programming Guide's table of arithmetic instruction throughput).
SFU_PER_CLOCK_PER_SM = 16
H100_SMS = 132
# bf16 logits of 64 layers: prefill (fused scan, [4, 32]-row matmuls) and
# decode ([4, 1]-row matmuls) round to bf16 after other sums in every layer,
# and the differences compound with depth (one bf16 step is 2^-8 = 0.39% of
# a value; on an H100, 1.0% of max|logit| at 4 layers and 6.2% at 64).
# The limit sits just above the 64-layer reading; the float32 check below is
# the one that binds the arithmetic.
PREFILL_DECODE_TOL = 0.08
# The same comparison in float32 compute, where no bf16 rounding differs:
# the two paths are the same arithmetic up to float32 rounding (1.1e-5 of
# max|logit| on an H100 at 64 layers).
PREFILL_DECODE_F32_TOL = 1e-3
# 2 layers, where only the scan differs (f32 either way, other orders):
# the differences appear only where a bf16 rounding of y flips.
FUSED_ASSOC_TOL = 0.02


def log(msg: str) -> None:
  print(msg, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
      capture_output=True, text=True, check=True, timeout=60)
  return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_ms(fn, iters: int = 20, warmup: int = 3, repeats: int = 1) -> float:
  """Milliseconds of ``fn`` per call, CUDA events: the mean over ``iters``
  calls, and with ``repeats`` the median of that many such means."""
  import statistics
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  means = []
  for _ in range(repeats):
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    end.synchronize()
    means.append(start.elapsed_time(end) / iters)
  return statistics.median(means)


def paired_ms(fn_a, fn_b, iters: int = 20, repeats: int = 5,
              warmup: int = 3):
  """:func:`cuda_ms` of two functions timed in turns (a, b, a, b, ...):
  the median over ``repeats`` turns of each."""
  import statistics
  a, b = [], []
  for _ in range(repeats):
    a.append(cuda_ms(fn_a, iters=iters, warmup=warmup))
    b.append(cuda_ms(fn_b, iters=iters, warmup=warmup))
  return statistics.median(a), statistics.median(b)


def device_busy(fn, top: int = 6, pad_s: float = 0.05,
                only: str = "") -> dict:
  """Run ``fn`` once under ``torch.profiler`` (device activity only, so the
  host pays no tracing cost per operation): the union of the card's kernel
  intervals against the CUDA-event time of the call, and the kernels that
  took the most device time.  ``busy_ms`` is None where the profiler
  recorded no device event.  The window is padded by ``pad_s`` of host
  sleep on both sides of the call: the profiler keeps only device events
  that fall inside its window on the host's clock, and late in a long
  process a window of a few short launches came back empty (the road
  grid's PageRank row, 20 launches of 0.018 ms, in every whole run of
  PR 22) while longer windows in the same phase lost a share of theirs.
  ``only``: count only the kernels whose names hold it."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t_in = time.perf_counter()
    time.sleep(pad_s)
    t_call = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    t_done = time.perf_counter()
    time.sleep(pad_s)
  wall_ms = start.elapsed_time(end)
  events = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and only in e.name]
  # A kernel is one (stream, name, start, end): a road-grid window once
  # gave half the card's time a launch of its neighbours, as if it had
  # counted each event twice.
  kernels = list({(e.device_resource_id, e.name, e.time_range.start,
                   e.time_range.end): e for e in events}.values())
  spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
  # Where the events sat on the trace's clock (ms from its start) beside
  # where the call ran on the host's (ms from entering the window): an
  # offset between the two clocks shows as a shift of the first.
  placed = {"call_ms": [(t_call - t_in) * 1e3, (t_done - t_in) * 1e3],
            "events_ms": ([spans[0][0] / 1e3, max(hi for _, hi in spans) / 1e3]
                          if spans else None)}
  busy_us, cur = 0.0, None
  for lo, hi in spans:
    if cur is None or lo > cur[1]:
      if cur is not None:
        busy_us += cur[1] - cur[0]
      cur = [lo, hi]
    else:
      cur[1] = max(cur[1], hi)
  if cur is not None:
    busy_us += cur[1] - cur[0]
  by_name: dict = {}
  for e in kernels:
    by_name[e.name[:90]] = (by_name.get(e.name[:90], 0.0)
                            + e.time_range.elapsed_us() / 1e3)
  busy_ms = busy_us / 1e3 if kernels else None
  return {"wall_ms": wall_ms, "kernels": len(kernels),
          "duplicates": len(events) - len(kernels), "busy_ms": busy_ms,
          "busy_share": None if busy_ms is None else busy_ms / wall_ms,
          "top_kernels_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
          "placed": placed}


LOST_SHARE = 0.01  # the share of a window's launches the profiler may lose
# (or find in excess)
# The pad of each window taken before a launch's card time is given up: a
# window whose events do not match its launches is taken again with a
# wider pad (late in a whole run one lost 24 of 130 events three times
# over at 0.05 s).
WINDOW_PADS_S = (0.05, 0.5, 2.0)


def launch_busy(fn, launches: int, kernels: int = 1,
                only: str = "") -> dict:
  """:func:`device_busy` of ``fn`` (over the kernels named with ``only``),
  which makes ``launches`` launches of ``kernels`` kernels each, with
  ``ms``, the card's time a launch (all its kernels).  A window whose
  profiler lost more than :data:`LOST_SHARE` of the launches' events, or
  saw that share more than launched, is taken again with the next pad of
  :data:`WINDOW_PADS_S`; after the last ``ms`` is None (not measured).
  ``windows`` holds the events each window saw, ``duplicates`` the events
  each reported twice, ``placed`` where each window's events and call
  sat."""
  seen, twice, placed = [], [], []
  for pad_s in WINDOW_PADS_S:
    busy = device_busy(fn, pad_s=pad_s, only=only)
    seen.append(busy["kernels"])
    twice.append(busy["duplicates"])
    placed.append(busy["placed"])
    if abs(busy["kernels"] - launches * kernels) <= (
        launches * kernels * LOST_SHARE):
      break
  else:
    return busy | {"ms": None, "windows": seen, "duplicates": twice,
                   "placed": placed}
  return busy | {"ms": busy["busy_ms"] / busy["kernels"] * kernels,
                 "windows": seen, "duplicates": twice, "placed": placed}


def busy_line(what: str, busy: dict) -> str:
  if busy["busy_ms"] is None:
    return f"{what}: device busy share not measured (no device events)"
  tops = "; ".join(f"{ms:.2f} ms {name}" for name, ms in busy["top_kernels_ms"])
  return (f"{what}: {busy['kernels']} kernels, device busy "
          f"{busy['busy_ms']:.2f} of {busy['wall_ms']:.2f} ms "
          f"({busy['busy_share']:.3f}); most device time: {tops}")


# ---------------------------------------------------------------------------
# Phase 2: kernel against plain
# ---------------------------------------------------------------------------

SEMIRINGS = {  # name -> (process_op, reduce)
    "min_plus": ("msg_plus_edge", "min"),
    "plus_times": ("msg_times_edge", "add"),
    "max_times": ("msg_times_edge", "max"),
    "bfs": ("msg_plus_one", "min"),
    "pagerank": ("msg", "add"),
    # The reference's plus_dst, (e - m * d) * m, and its min.
    "plus_dst": ("edge_minus_msg_dst_times_msg", "add"),
    "min_dst": ("edge_minus_msg_dst_times_msg", "min"),
}
DST_OP = "edge_minus_msg_dst_times_msg"


class Traced(typing.NamedTuple):
  """A lambda-only program of phases 1-4: its process, its reduce, the
  message dtypes of its instances, the edge values' dtype (None: the
  message's), the destination property's (None: not read) and, for a
  process that mixes the lanes of a [n, K] message, the K of its
  instances (empty: a lanewise process, one instance for Q = 1 and 8)."""

  fn: object
  reduce: str
  dtypes: tuple
  edge: object = None
  dst: object = None
  lanes: tuple = ()

  def dst_dtype(self, dtype):
    """The destination property's dtype at message dtype ``dtype`` (``dst``
    "msg": the message's)."""
    return dtype if self.dst == "msg" else self.dst


# The lane widths of phase 2's lane-mixing instances (float32: one thread a
# message, teams of 4, 16 (9 used, 4-byte loads) and 32, and 32 threads of 8
# lanes, two 16-byte loads each).
MIXED_LANES = (3, 16, 33, 128, 256)


@functools.lru_cache(maxsize=None)
def traced_programs() -> dict:
  """name -> :class:`Traced`: per-edge functions written only as lambdas,
  none among the five shipped forms, so that each runs a kernel instance
  generated from its trace.  ``e + m`` is ``msg_plus_edge`` with its
  operands swapped (the trace is compared node for node, with no algebra),
  timed against the shipped instance; ``ops`` reaches the comparisons,
  ``where``, ``sqrt``, ``abs``, a division by a constant, ``exp`` and
  ``neg`` (phase 2 only).  Then processes that mix the lanes of a
  [n, K] message (collaborative filtering's with its latent matrix as the
  one leaf; a lane dot score, K_out = 1, by max and by min; a lane softmax
  weight in float32 and bfloat16) and processes over bfloat16 or mixed
  dtypes (PageRank's ``0.85 * m`` in bfloat16, SSSP's ``m + e`` on float16
  edges with a float32 result, int32 messages times float32 edges).  Made
  once, so that each keeps its cached trace."""
  import torch
  f32, f16, bf16, i32 = (torch.float32, torch.float16, torch.bfloat16,
                         torch.int32)

  def dot(m, e, d):
    return (m * d).sum(-1)
  return {
      "widest": Traced(lambda m, e, d: torch.minimum(m, e), "max", (f32,)),
      "damped_pr": Traced(lambda m, e, d: 0.85 * m, "add", (f32, f16)),
      "int_where": Traced(
          lambda m, e, d: torch.where(m < 1000, m * 2 + 1, m), "min", (i32,)),
      "sssp_e_plus_m": Traced(lambda m, e, d: e + m, "min", (f32,)),
      "ops": Traced(lambda m, e, d: torch.where(
          m > e, torch.sqrt(torch.abs(m)) / 3, torch.exp(-e) * m), "max",
                    (f32, f16)),
      "cf_one_leaf": Traced(
          lambda m, e, d: (e - (m * d).sum(-1, keepdim=True)) * m, "add",
          (f32, f16, bf16), dst="msg", lanes=MIXED_LANES),
      "dot_score": Traced(dot, "max", (f32, f16, bf16), dst="msg",
                          lanes=MIXED_LANES),
      "dot_score_min": Traced(dot, "min", (f32,), dst=f32, lanes=(33,)),
      "lane_softmax_weight": Traced(
          lambda m, e, d: torch.exp(m - m.amax(-1, keepdim=True)) * e, "add",
          (f32, bf16), lanes=MIXED_LANES),
      "pr_bf16": Traced(lambda m, e, d: 0.85 * m, "add", (bf16,)),
      "sssp_half_edges": Traced(lambda m, e, d: m + e, "min", (f32,),
                                edge=f16),
      "int_times_float": Traced(lambda m, e, d: m * e, "min", (i32,),
                                edge=f32),
  }


def traced_expr(name: str, dtype, lane: bool, k=None):
  """The traced process of ``traced_programs()[name]`` at message dtype
  ``dtype``, in the lane form (``[n, Q]`` messages; ``k`` lanes for a
  lane-mixing one) or the scalar one; never a shipped form."""
  from repro_torch.kernels import process_expr
  prog = traced_programs()[name]
  expr = process_expr.trace(
      prog.fn, dtype, lane=lane or bool(prog.lanes), k=k,
      edge_dtype=prog.edge or dtype,
      dst_dtype=prog.dst_dtype(dtype) or dtype,
      kd=(k or 1) if prog.dst is not None else 1,
      reads_dst=prog.dst is not None)
  if (not isinstance(expr, process_expr.ProcessExpr) or expr.shipped
      or bool(prog.lanes) != expr.lane_mixing):
    raise AssertionError(f"traced program {name} at {dtype}: {expr}")
  return expr


def traced_instances() -> list:
  """(name, dtype, K or None) of every generated instance."""
  return [(name, dt, k) for name, prog in traced_programs().items()
          for dt in prog.dtypes for k in (prog.lanes or (None,))]


def traced_libraries(ell_mod) -> dict:
  """(name, dtype, K or None) -> the generated library of each traced
  program's instance."""
  return {(name, dt, k): ell_mod.library_for(
      traced_expr(name, dt, False, k), traced_programs()[name].reduce)
          for name, dt, k in traced_instances()}


# The float tolerances of an add (and of a process with a float lane sum):
# rtol, with atol rtol times the largest magnitude of the plain result.
RTOL = {"torch.float32": 1e-5, "torch.float16": 1e-2,
        "torch.bfloat16": 2e-2}


def compare(y, yr, r, rr, reduce_kind: str, what: str, exact=None) -> float:
  """Raise unless kernel (y, r) agrees with plain (yr, rr); returns the max
  absolute difference of y.  ``exact`` (default: a min or max, or
  integers): bitwise; else within :data:`RTOL` of the dtype."""
  import torch
  if not torch.equal(r, rr):
    raise AssertionError(f"{what}: recv differs")
  yf, yrf = y.double(), yr.double()
  finite, nan = torch.isfinite(yrf), torch.isnan(yrf)
  inf = ~finite & ~nan
  if not (torch.equal(torch.isnan(yf), nan)
          and torch.equal(torch.isfinite(yf), finite)
          and torch.equal(yf[inf], yrf[inf])):
    raise AssertionError(f"{what}: non-finite entries differ")
  err = float((yf[finite] - yrf[finite]).abs().max()) if finite.any() else 0.0
  if exact is None:
    exact = reduce_kind != "add" or not y.is_floating_point()
  if exact:
    if not torch.equal(y[~nan], yr[~nan]):
      raise AssertionError(f"{what}: not bitwise equal (max err {err})")
    return err
  rtol = RTOL[str(y.dtype)]
  scale = float(yrf[finite].abs().max()) if finite.any() else 0.0
  torch.testing.assert_close(yf, yrf, rtol=rtol, atol=rtol * scale,
                             equal_nan=True, msg=lambda m: f"{what}: {m}")
  return err


def random_mask(gen, n_pad, width, kind="random", p_mask=0.7):
  """``random``: independent slots; ``sorted``: prefix rows of random
  lengths in descending order (several lane segments, no mask read);
  ``edge_rows``: random rows among empty rows and rows whose only set slot
  is the last.  Short rows: ``short`` prefix rows of 0, 1, 3, 4 and 5
  slots in descending order (a two-lane segment, then one-lane rows, then
  empty ones); ``short_unsorted`` prefix rows of 0-4 slots in no order
  (every row one lane, empty rows among them); ``short_holes`` random
  slots among the first 4 (holed masks, one lane); ``lane_boundary``
  40 rows of 5 slots, then rows of 3 (the one-lane class begins inside
  the second 32-row chunk).  ``lane_rows``: runs of 32 rows of
  :data:`LANE_ROW_RUNS` extents in turn (the lane-vector grid's row
  classes: a warp a row, two teams, one team), every other row holed with
  its last slot kept."""
  import torch
  dev = "cuda"
  slot = torch.arange(width, device=dev)[None]
  if kind == "sorted":
    lens = torch.randint(0, width + 1, (n_pad,), generator=gen, device=dev)
    lens = lens.sort(descending=True).values
    return slot < lens[:, None]
  if kind in ("short", "short_unsorted"):
    choice = torch.tensor([0, 1, 3, 4, 5] if kind == "short"
                          else [0, 1, 2, 3, 4], device=dev)
    lens = choice[torch.randint(0, 5, (n_pad,), generator=gen, device=dev)]
    if kind == "short":
      lens = lens.sort(descending=True).values
    return slot < lens[:, None].clamp(max=width)
  if kind == "short_holes":
    return (slot < 4) & (torch.rand((n_pad, width), generator=gen,
                                    device=dev) < 0.6)
  if kind == "lane_boundary":
    lens = torch.full((n_pad,), 3, device=dev)
    lens[:40] = 5
    return slot < lens[:, None].clamp(max=width)
  if kind == "lane_rows":
    runs = [run[i % len(run)] for run in LANE_ROW_RUNS for i in range(32)]
    lens = torch.tensor(runs, device=dev).repeat(-(-n_pad // len(runs)))
    lens = lens[:n_pad, None].clamp(max=width)
    holes = torch.rand((n_pad, width), generator=gen, device=dev) < 0.3
    holes[::2] = False
    holes[slot == lens - 1] = False
    return (slot < lens) & ~holes
  mask = torch.rand((n_pad, width), generator=gen, device=dev) < p_mask
  if kind == "edge_rows":
    mask[::3] = False
    mask[1::3] = False
    mask[1::3, -1] = True
  return mask


# The row extents of the ``lane_rows`` mask, in runs of 32 rows.
LANE_ROW_RUNS = ((152, 33, 32, 31), (5, 4), (1, 0))


def random_ell(gen, n_pad, width, n_src, q, dtype, p_mask=0.7, p_act=0.8,
               mask_kind="random"):
  """A random ELL block on the card; ``p_act`` > 1 makes every source
  active."""
  import torch
  dev = "cuda"
  cols = torch.randint(0, n_src, (n_pad, width), generator=gen,
                       device=dev, dtype=torch.int32)
  vals = (torch.rand((n_pad, width), generator=gen, device=dev) * 1.9 + 0.1)
  mask = random_mask(gen, n_pad, width, mask_kind, p_mask)
  act = torch.rand((n_src,), generator=gen, device=dev) < p_act
  if dtype == torch.int32:
    msg = torch.randint(0, 1000, (n_src, q), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = vals.to(torch.int32)
  else:
    msg = torch.randn((n_src, q), generator=gen, device=dev).to(dtype)
    vals = vals.to(dtype)
  return cols, vals, mask, msg, act


def phase_kernel_sweep(ell_mod, ref_mod) -> dict:
  import torch
  gen = torch.Generator(device="cuda").manual_seed(0)
  cases = []
  for shape in [(8, 8, 8, 1), (64, 16, 100, 1), (128, 24, 50, 4),
                (256, 8, 256, 8)]:
    for sem in ("min_plus", "plus_times", "max_times"):
      cases.append((shape, sem, torch.float32, {}))
  for q in (1, 8):
    cases += [((512, 40, 700, q), "min_plus", torch.float16, {}),
              ((512, 40, 700, q), "bfs", torch.int32, {}),
              ((512, 40, 700, q), "pagerank", torch.float32, {})]
  # Query tiles that do not divide Q, and other block shapes.
  cases += [((300, 33, 310, 6), "min_plus", torch.float32,
             {"block_queries": 4}),
            ((300, 33, 310, 12), "plus_times", torch.float32,
             {"block_queries": 8, "block_rows": 32}),
            ((300, 33, 310, 3), "max_times", torch.float32,
             {"block_queries": 1, "block_rows": 1})]
  # NaN in about 1% of the messages and edge values: a min or max over a
  # NaN is NaN, as torch.amin/amax give it.
  nan_cases = [((256, 24, 300, q), sem, dtype, {"nan": True})
               for q in (1, 8)
               for sem, dtype in (("min_plus", torch.float32),
                                  ("max_times", torch.float32),
                                  ("plus_times", torch.float32),
                                  ("min_plus", torch.float16))]
  cases += nan_cases
  # Every source active: the kernel reads no active flag.
  for q in (1, 8):
    cases += [((600, 152, 900, q), "pagerank", torch.float32,
               {"mask": "sorted", "all_active": True}),
              ((600, 152, 900, q), "bfs", torch.int32, {"all_active": True}),
              ((300, 40, 310, q), "plus_dst", torch.float32,
               {"kd": q, "mask": "edge_rows", "all_active": True})]
  # The destination-reading form in both grids, with a [n_pad, 1] and a
  # [n_pad, Q] property; masks with several lane segments, empty rows and
  # last-slot-only rows; rows of 152 slots, as in the phase-3 graph.
  for q in (1, 8):
    for kd in sorted({1, q}):
      for mask_kind in ("random", "sorted", "edge_rows"):
        cases += [((600, 152, 900, q), "plus_dst", torch.float32,
                   {"kd": kd, "mask": mask_kind}),
                  ((300, 40, 310, q), "min_dst", torch.float32,
                   {"kd": kd, "mask": mask_kind}),
                  ((300, 40, 310, q), "plus_dst", torch.float16,
                   {"kd": kd, "mask": mask_kind}),
                  ((300, 40, 310, q), "min_dst", torch.int32,
                   {"kd": kd, "mask": mask_kind})]
    for mask_kind in ("sorted", "edge_rows"):
      cases += [((600, 152, 900, q), sem, dtype, {"mask": mask_kind})
                for sem, dtype in (("bfs", torch.int32),
                                   ("min_plus", torch.float32),
                                   ("pagerank", torch.float32))]
  # Short rows (the one-lane class and its boundary with two lanes), every
  # form, Q = 1 and 8, every source active and 10% active; width 6 takes
  # the scalar slot loads.
  short = ("short", "short_unsorted", "short_holes", "lane_boundary")
  for mask_kind in short:
    for q in (1, 8):
      for p_act in (2.0, 0.1):
        for sem in SEMIRINGS:
          dtype = torch.int32 if sem == "bfs" else torch.float32
          kw = {"mask": mask_kind, "p_act": p_act}
          if SEMIRINGS[sem][0] == DST_OP:
            kw["kd"] = q
          cases.append(((300, 8, 310, q), sem, dtype, kw))
        cases.append(((300, 8, 310, q), "min_plus", torch.float16,
                      {"mask": mask_kind, "p_act": p_act}))
  for mask_kind in ("short", "short_holes"):
    for sem in ("min_plus", "pagerank", "bfs"):
      cases.append(((300, 6, 310, 1), sem,
                    torch.int32 if sem == "bfs" else torch.float32,
                    {"mask": mask_kind, "p_act": 0.5}))
  max_err = 0.0
  for shape, sem, dtype, kw in cases:
    n_pad, width, n_src, q = shape
    op, red = SEMIRINGS[sem]
    desc, kw = dict(kw), dict(kw)
    cols, vals, mask, msg, act = random_ell(
        gen, n_pad, width, n_src, q, dtype,
        p_act=2.0 if kw.pop("all_active", False) else kw.pop("p_act", 0.8),
        mask_kind=kw.pop("mask", "random"))
    if kw.pop("nan", False):
      msg[torch.rand(msg.shape, generator=gen, device="cuda") < 0.01] = (
          float("nan"))
      vals[torch.rand(vals.shape, generator=gen, device="cuda") < 0.01] = (
          float("nan"))
    kd = kw.pop("kd", None)
    if kd is None:
      dprop = None
    elif dtype == torch.int32:
      dprop = torch.randint(-3, 4, (n_pad, kd), generator=gen, device="cuda",
                            dtype=torch.int32)
    else:
      dprop = torch.randn((n_pad, kd), generator=gen, device="cuda").to(dtype)
    y, r = ell_mod.ell_spmv(cols, vals, mask, msg, act, process_op=op,
                            reduce_kind=red, dprop=dprop, **kw)
    if dprop is None:
      dprop = torch.zeros((n_pad, 1), dtype=dtype, device="cuda")
    yr, rr = ref_mod.ell_spmv_ref(cols, vals, mask, msg, act, dprop,
                                  process=ell_mod.plain_process(op),
                                  reduce_kind=red)
    torch.cuda.synchronize()
    what = f"{shape} {sem} {dtype} {desc} Kd={dprop.shape[1]}"
    if msg.is_floating_point() and torch.isnan(msg).any():
      what += " with NaN"
      if not torch.isnan(yr).any():
        raise AssertionError(f"{what}: no NaN reached the output")
    max_err = max(max_err, compare(y, yr, r, rr, red, what))
  # All sources inactive: identity everywhere, recv all zero.
  cols, vals, mask, msg, act = random_ell(gen, 64, 16, 64, 1, torch.float32)
  y, r = ell_mod.ell_spmv(cols, vals, mask, msg, torch.zeros_like(act),
                          process_op="msg_plus_edge", reduce_kind="min")
  torch.cuda.synchronize()
  if r.any() or not torch.isinf(y).all():
    raise AssertionError("all-inactive case: expected identity rows")
  log(f"phase 2: kernel == plain on {len(cases) + 1} cases "
      f"(max abs err {max_err:.3g})")
  half = half_sums(ell_mod, ref_mod)
  traced = traced_sweep(ell_mod, ref_mod, gen)
  return {"cases": len(cases) + 1, "max_abs_err": max_err,
          "half_sums": half, "traced": traced}


def half_sums(ell_mod, ref_mod) -> dict:
  """The shipped ``msg`` instance's float16 sums on one row whose slots
  name sources 0..W-1, every source active: it sums in float and rounds
  once, as the reference's kernel sums a tile (``jnp.sum`` of float16) and
  as the plain version sums a row.  4,000 terms of 1.0 give 4,000; 2,048
  and then 3,999 ones give 6,048 (a float16 sum stalls at 2,048 on the
  thread that holds the first term); 500 terms in [0.5, 1.5] (float16
  values) come within one float16 ulp of the float64 sum, at Q = 1 and on
  the query-tiled grid at Q = 8; the plain version the same."""
  import numpy as np
  import torch
  rng = np.random.default_rng(25)
  rows = {"ones_4000": np.ones((4000, 1)),
          "stall_6048": np.concatenate([[[2048.0]], np.ones((3999, 1))]),
          "uniform_500": rng.uniform(0.5, 1.5, (500, 1)),
          "uniform_500_q8": rng.uniform(0.5, 1.5, (500, 8))}
  exact = {"ones_4000": 4000.0, "stall_6048": 6048.0}
  out = {}
  for name, terms in rows.items():
    msg = torch.from_numpy(terms).half().cuda()
    w = msg.shape[0]
    cols = torch.arange(w, dtype=torch.int32, device="cuda")[None]
    mask = torch.ones((1, w), dtype=torch.bool, device="cuda")
    vals = torch.ones((1, w), dtype=torch.float16, device="cuda")
    act = torch.ones((w,), dtype=torch.bool, device="cuda")
    y, r = ell_mod.ell_spmv(cols, vals, mask, msg, act, process_op="msg",
                            reduce_kind="add")
    yr, rr = ref_mod.ell_spmv_ref(cols, vals, mask, msg, act,
                                  torch.zeros((1, 1), dtype=torch.float16,
                                              device="cuda"),
                                  process=ell_mod.plain_process("msg"),
                                  reduce_kind="add")
    torch.cuda.synchronize()
    want = msg.double().sum(dim=0).cpu().numpy()
    ulp = np.spacing(want.astype(np.float16)).astype(np.float64)
    got = {"kernel": y.double().cpu().numpy()[0],
           "plain": yr.double().cpu().numpy()[0]}
    for what, v in got.items():
      ok = (v.tolist() == [exact[name]] if name in exact
            else bool((np.abs(v - want) <= ulp).all()))
      if not ok or r.tolist() != [1] or rr.tolist() != [1]:
        raise AssertionError(f"phase 2: float16 sum {name} ({what}): "
                             f"{v.tolist()}, float64 sum {want.tolist()}")
    out[name] = {"kernel": got["kernel"].tolist(),
                 "float64": want.tolist()}
  log(f"phase 2: shipped float16 sums in float: " + "; ".join(
      f"{k} {v['kernel'][:2]} (float64 {v['float64'][:2]})"
      for k, v in out.items()))
  return out


def traced_operands(gen, name: str, dtype, shape, kw: dict, k=None):
  """A random ELL block for an instance of ``traced_programs()[name]``:
  ``random_ell``'s at the message dtype and width (``k`` lanes for a
  lane-mixing one), the edge values cast to the program's edge dtype and a
  destination property of width Kd = K where it reads one."""
  import torch
  prog = traced_programs()[name]
  n_pad, width, n_src, q = shape
  cols, vals, mask, msg, act = random_ell(
      gen, n_pad, width, n_src, k or q, dtype, p_act=kw.get("p_act", 0.8),
      mask_kind=kw.get("mask", "random"))
  if prog.edge is not None:
    vals = (torch.rand((n_pad, width), generator=gen, device="cuda") * 1.9
            + 0.1).to(prog.edge)
  dprop = None
  if prog.dst is not None:
    dprop = torch.randn((n_pad, k or 1), generator=gen,
                        device="cuda").to(prog.dst_dtype(dtype))
  return cols, vals, mask, msg, act, dprop


def traced_sweep(ell_mod, ref_mod, gen) -> dict:
  """Every generated instance against its plain version (the program's
  callable on the card).  A lanewise one over the sweep's case set: random,
  degree-sorted prefix and empty / last-slot-only rows at 152 slots; the
  short-row masks (sorted, unsorted, holed, a lane-class boundary) at 8
  slots, every source and 10% active; the scalar slot loads at 6; NaN
  among the messages and edge values; Q = 1 and 8 each.  A lane-mixing one
  at its K: random, prefix and empty / last-slot-only rows at 40 slots with
  80%, all and no sources active, holed short rows at 8 slots and the
  scalar slot loads at 6.  Bitwise where the reduce is min or max and the
  process has no float lane sum (or the values are integers), else within
  :data:`RTOL`."""
  import torch
  cases = []
  for q in (1, 8):
    for mask_kind in ("random", "sorted", "edge_rows"):
      for p_act in (0.8, 2.0):
        cases.append(((600, 152, 900, q), {"mask": mask_kind,
                                           "p_act": p_act}))
    for mask_kind in ("short", "short_unsorted", "short_holes",
                      "lane_boundary"):
      for p_act in (2.0, 0.1):
        cases.append(((300, 8, 310, q), {"mask": mask_kind, "p_act": p_act}))
    cases.append(((256, 24, 300, q), {"nan": True}))
  for mask_kind in ("short", "short_holes"):
    cases.append(((300, 6, 310, 1), {"mask": mask_kind, "p_act": 0.5}))
  lane_cases = [((300, 40, 310, None), {"mask": mask_kind, "p_act": p_act})
                for mask_kind in ("random", "sorted", "edge_rows")
                for p_act in (0.8, 2.0, 0.0)]
  lane_cases += [((300, 8, 310, None), {"mask": "short_holes",
                                        "p_act": 0.5}),
                 ((300, 6, 310, None), {"mask": "short", "p_act": 0.8})]
  lane_cases += [((300, 152, 310, None), {"mask": "lane_rows",
                                          "p_act": p_act})
                 for p_act in (0.8, 2.0)]
  count, max_err, per = 0, 0.0, {}
  for name, dtype, k in traced_instances():
    prog = traced_programs()[name]
    # A float lane sum rounds in another order than the plain version.
    exact = None
    if k is not None and any(op in ("lane_sum", "lane_mean") for op, *_ in
                             traced_expr(name, dtype, True, k).nodes):
      exact = False
    err = 0.0
    for shape, kw in (cases if k is None else lane_cases):
      if kw.get("nan") and dtype == torch.int32:
        continue
      cols, vals, mask, msg, act, dprop = traced_operands(
          gen, name, dtype, shape, kw, k)
      if kw.get("nan"):
        msg[torch.rand(msg.shape, generator=gen, device="cuda") < 0.01] = (
            float("nan"))
        vals[torch.rand(vals.shape, generator=gen, device="cuda") < 0.01] = (
            float("nan"))
      expr = traced_expr(name, dtype, lane=msg.shape[1] > 1 or k is not None,
                         k=k)
      y, r = ell_mod.ell_spmv(cols, vals, mask, msg, act, process=expr,
                              reduce_kind=prog.reduce, dprop=dprop)
      dp = (torch.zeros((shape[0], 1), dtype=dtype, device="cuda")
            if dprop is None else dprop)
      yr, rr = ref_mod.ell_spmv_ref(cols, vals, mask, msg, act, dp,
                                    process=expr.plain,
                                    reduce_kind=prog.reduce)
      torch.cuda.synchronize()
      if y.shape != yr.shape or y.dtype != yr.dtype:
        raise AssertionError(f"traced {name} {dtype} K={k} {shape}: y "
                             f"{y.dtype}{list(y.shape)}, plain "
                             f"{yr.dtype}{list(yr.shape)}")
      err = max(err, compare(y, yr, r, rr, prog.reduce,
                             f"traced {name} {dtype} K={k} {shape} {kw}",
                             exact=exact))
      count += 1
    per[f"{name},{dtype}" + ("" if k is None else f",K={k}")] = err
    max_err = max(max_err, err)
  log(f"phase 2: generated instances == plain on {count} cases "
      f"(max abs err {max_err:.3g}; by program {json.dumps(per)})")
  return {"cases": count, "max_abs_err": max_err, "by_program": per}


# ---------------------------------------------------------------------------
# Phase 3: the slice at full size
# ---------------------------------------------------------------------------


def build_graph(scale: int, seed: int = 0):
  import numpy as np
  from repro_torch.core import graph as G
  from repro_torch.graphs import remove_self_loops, rmat_edges, symmetrize
  t0 = time.perf_counter()
  src, dst = rmat_edges(scale, 16, abc=(0.57, 0.19, 0.19), seed=seed)
  t1 = time.perf_counter()
  src, dst = remove_self_loops(src, dst)
  src, dst = symmetrize(src, dst)
  t2 = time.perf_counter()
  w = np.random.default_rng(seed + 1).uniform(0.1, 2.0, src.shape[0]
                                              ).astype(np.float32)
  n = 1 << scale
  g = G.build_ell(src, dst, w, n=n, device="cuda")
  import torch
  torch.cuda.synchronize()
  t3 = time.perf_counter()
  stats = {"n": n, "edges": int(src.shape[0]), "width": g.width,
           "n_pad": g.n_pad,
           "packed_edges": int(g.mask.sum()),
           "spill_edges": 0 if g.spill is None else int(g.spill.emask.sum()),
           "rmat_s": t1 - t0, "symmetrize_s": t2 - t1,
           "build_ell_s": t3 - t2}
  return g, src, dst, w, stats


def bfs_numpy(src, dst, n, root):
  """Independent level-synchronous BFS on host arrays (the check of phase
  3's small input)."""
  import numpy as np
  dist = np.full(n, -1, np.int64)
  dist[root] = 0
  frontier = np.array([root])
  order = np.argsort(src, kind="stable")
  s_sorted, d_sorted = src[order], dst[order]
  starts = np.searchsorted(s_sorted, np.arange(n + 1))
  level = 0
  while frontier.size:
    level += 1
    nbrs = np.unique(np.concatenate([d_sorted[starts[u]:starts[u + 1]]
                                     for u in frontier]))
    nbrs = nbrs[dist[nbrs] < 0]
    dist[nbrs] = level
    frontier = nbrs
  return dist


GRADIENT_SWEEPS = 3
# The sweeps' change to p is compared, not p itself: one sweep moves a row
# of one slot by about 2.5e-6, which a tolerance on p (about 0.25) would not
# see.  The change's atol is 16 float32 ulps of 0.5, above which few p lie:
# the two paths may round p + change differently by an ulp or two a sweep.
GRADIENT_ATOL = 1e-6


def gradient_program(lanewise: bool):
  """Each edge (u -> v) sends ``(w - p_u * p_v) * p_u``, the kernel's
  destination-reading form; ``p_v += gamma * (sum - lam * p_v)``."""
  from repro_torch.core.vertex_program import GraphProgram
  gamma, lam = 1e-5, 0.05
  return GraphProgram(process_op=DST_OP, reduce_kind="add",
                      apply=lambda red, old: old + gamma * (red - lam * old),
                      lanewise=lanewise, name="gradient_sweep")


def phase_slice(scale: int, num_queries: int, ell_mod):
  import numpy as np
  import torch
  from repro_torch.algos import bfs, pagerank, sssp
  from repro_torch.core.engine import run_fixed_iters
  from repro_torch.algos.bfs import UNREACHED
  from repro_torch.core.backends import Plan
  from repro_torch.kernels import coo_spmv as coo_mod
  from repro_torch.service import (BfsFamily, GraphQueryServer, QuerySpec,
                                   ServerDriver)

  kernel, plain = Plan(backend="cuda_ell"), Plan(backend="ell")

  # Small input first: the kernel path against an independent host BFS.
  gs, s_src, s_dst, _, _ = build_graph(10, seed=5)
  n_s = 1 << 10
  root = int(s_dst[0])
  got = bfs(gs, root, n_s, backend=kernel).cpu().numpy()
  want = bfs_numpy(s_src, s_dst, n_s, root)
  got = np.where(got == UNREACHED, -1, got)
  if not np.array_equal(got, want):
    raise AssertionError("BFS on the scale-10 graph disagrees with host BFS")
  log("phase 3: scale-10 BFS through cuda_ell == independent host BFS")

  g, src, dst, w, gstats = build_graph(scale)
  n = gstats["n"]
  log("phase 3: graph " + json.dumps(gstats))
  deg = np.bincount(dst, minlength=n)
  sources = np.random.default_rng(2).choice(np.flatnonzero(deg > 0),
                                            num_queries, replace=False)
  specs = [QuerySpec("bfs", int(s)) for s in sources]
  half = num_queries // 2

  ell_mod.launches.reset()
  coo_mod.launches.reset()
  coo_mod.torch_path.update(dict.fromkeys(coo_mod.torch_path, 0))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  server = GraphQueryServer(g, BfsFamily(n), num_slots=8, backend=kernel)
  t_setup = time.perf_counter() - t0
  t0 = time.perf_counter()
  qids = server.submit_many(specs[:half])
  drained = server.drain()
  results = {s.source: drained[q] for s, q in zip(specs[:half], qids)}
  with ServerDriver(server) as driver:
    qids = server.submit_many(specs[half:])
    for s, q in zip(specs[half:], qids):
      results[s.source] = server.result(q, timeout=600.0)
  torch.cuda.synchronize()
  t_serve = time.perf_counter() - t0
  if driver.error is not None:
    raise driver.error
  if len(results) != num_queries or any(r is None for r in results.values()):
    raise AssertionError("not every query was answered")
  stats = server.stats()
  supersteps = stats["counters"].get("supersteps", 0.0)
  launches_serve = dict(ell_mod.launches.by_config)
  if ell_mod.launches.multi == 0:
    raise AssertionError("the server's rounds never launched the kernel")
  log(f"phase 3: served {num_queries} BFS queries in {t_serve:.3f} s "
      f"({num_queries / t_serve:.3f} queries/s, {supersteps:.0f} supersteps, "
      f"server set-up {t_setup:.3f} s, kernel launches {launches_serve})")

  # Every served query (both halves: drain() and the driver's thread) again
  # through the plain torch ELL path, bitwise.
  check = specs
  ref_server = GraphQueryServer(g, BfsFamily(n), num_slots=8, backend=plain)
  ref_qids = ref_server.submit_many(check)
  ref = ref_server.drain()
  ref_server.close()
  for s, q in zip(check, ref_qids):
    if not np.array_equal(results[s.source], ref[q]):
      raise AssertionError(f"BFS query {s.source}: cuda_ell != ell")
    reached = int((ref[q] != UNREACHED).sum())
    if reached < 2:
      raise AssertionError(f"BFS query {s.source} reached {reached} vertex")
  server.close()
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  log(f"phase 3: {len(check)} served queries == Plan('ell') bitwise "
      f"(peak device memory {peak_gib:.2f} GiB)")

  before = ell_mod.launches.single
  root = int(sources[0])
  t0 = time.perf_counter()
  d_k = bfs(g, root, n, backend=kernel)
  torch.cuda.synchronize()
  t_bfs = time.perf_counter() - t0
  if not torch.equal(d_k, bfs(g, root, n, backend=plain)):
    raise AssertionError("single-query BFS: cuda_ell != ell")
  s_k = sssp(g, root, n, backend=kernel)
  if not torch.equal(s_k, sssp(g, root, n, backend=plain)):
    raise AssertionError("single-query SSSP: cuda_ell != ell")
  out_deg = torch.from_numpy(np.bincount(src, minlength=n).astype(
      np.float32)).cuda()
  pr_k = pagerank(g, out_deg, num_iters=20, backend=kernel)
  pr_p = pagerank(g, out_deg, num_iters=20, backend=plain)
  torch.testing.assert_close(pr_k, pr_p, rtol=1e-4, atol=0.0)
  if not (torch.isfinite(pr_k).all() and torch.isfinite(s_k[d_k != UNREACHED]
                                                          ).all()):
    raise AssertionError("non-finite ranks or reachable distances")
  if ell_mod.launches.single <= before:
    raise AssertionError("single-query entry points never launched the kernel")
  log(f"phase 3: single-query BFS ({t_bfs:.3f} s), SSSP, PageRank(20) "
      "through cuda_ell == Plan('ell')")

  # A program that reads the destination property: gradient sweeps in the
  # manner of collaborative filtering, on one lane and on eight.
  gen = torch.Generator(device="cuda").manual_seed(3)
  all_active = torch.ones((n,), dtype=torch.bool, device="cuda")
  for q in (1, 8):
    shape = (n,) if q == 1 else (n, q)
    p0 = torch.rand(shape, generator=gen, device="cuda") * 0.5
    prog = gradient_program(lanewise=q > 1)
    before = ell_mod.launches.total
    got = run_fixed_iters(g, prog, p0, all_active, GRADIENT_SWEEPS,
                          backend=kernel).prop
    if ell_mod.launches.total - before != GRADIENT_SWEEPS:
      raise AssertionError("the gradient sweeps did not launch the kernel "
                           "once a sweep")
    want = run_fixed_iters(g, prog, p0, all_active, GRADIENT_SWEEPS,
                           backend=plain).prop
    if not torch.isfinite(got).all():
      raise AssertionError("gradient sweeps: non-finite values")
    torch.testing.assert_close(got - p0, want - p0, rtol=1e-5,
                               atol=GRADIENT_ATOL)
    del got, want
  log(f"phase 3: {GRADIENT_SWEEPS} destination-reading gradient sweeps on 1 "
      "and 8 lanes through cuda_ell == Plan('ell')")
  stats = {"graph": gstats, "queries": num_queries, "serve_s": t_serve,
           "queries_per_s": num_queries / t_serve, "supersteps": supersteps,
           "server_setup_s": t_setup, "peak_device_gib": peak_gib,
           "launches": dict(ell_mod.launches.by_config),
           "launches_single": ell_mod.launches.single,
           "launches_multi": ell_mod.launches.multi,
           "launches_serve": launches_serve,
           "single_bfs_s": t_bfs,
           "coo_launches": dict(coo_mod.launches.by_config),
           "coo_torch_path": dict(coo_mod.torch_path)}
  # The spill merge of every call above (cuda_ell's and Plan("ell")'s) on
  # the COO kernel; a CUDA call that kept the PyTorch path is counted by
  # its reason.
  log(f"phase 3: COO kernel launches {stats['coo_launches']}, CUDA calls "
      f"on the PyTorch path {stats['coo_torch_path']}")
  if g.spill is not None and coo_mod.launches.total == 0:
    raise AssertionError("phase 3: the spill merge never launched the COO "
                         "kernel")

  # Programs written only as lambdas: their traced processes run generated
  # instances of the kernel (the shipped forms' counts were read above).
  traced, traced_launches, traced_calls = traced_runs(
      "phase 3", g, out_deg, ell_mod, lane_every=4)
  stats.update(traced=traced, traced_launches=traced_launches)
  # Lane-mixing and mixed-dtype programs on the same graph.
  mixed, mixed_launches, mixed_calls = mixed_runs("phase 3", g, out_deg,
                                                  ell_mod)
  stats.update(mixed=mixed, mixed_launches=mixed_launches)
  traced_launches.update(mixed_launches)
  traced_calls.update(mixed_calls)

  # The kernel's calls on this run's data, for phase 4 to time: the BFS and
  # SSSP again, and the 32 queries again through drain().  These launches
  # come after the main path's counts were read.
  def serve_again():
    again = GraphQueryServer(g, BfsFamily(n), num_slots=8, backend=kernel)
    again.submit_many(specs)
    again.drain()
    again.close()

  recorded = {"bfs,Q=1": record_calls(lambda: bfs(g, root, n, backend=kernel)),
              "sssp,Q=1": record_calls(
                  lambda: sssp(g, root, n, backend=kernel)),
              "bfs,Q=8": record_calls(serve_again)}
  recorded.update({f"traced:{k}": v for k, v in traced_calls.items()})
  stats["recorded_calls"] = {k: len(v) for k, v in recorded.items()}
  log(f"phase 3: recorded kernel calls {stats['recorded_calls']}")
  edges = {"src": src, "dst": dst, "w": w, "root": root, "sources": sources}
  return stats, g, recorded, edges


TRACED_PR_ITERS = 20
TRACED_SOURCES = 8  # the lane widest path's sources
# The lane widest path on the road grid runs this many supersteps (3,001
# to converge; Plan("ell") took 20.8 s of them, run AX, PR 23).
TRACED_ROAD_LANE_ITERS = 512


def traced_graph_programs(g, out_deg, lane_iters=None) -> dict:
  """The lambda-only programs of ``traced_programs()`` as vertex programs on
  graph ``g``: name -> (program, lane, run(plan) -> (result,
  supersteps)).  Widest path (max of min) and its 8-source lane form from
  vertex 0 and every n/8-th vertex (``lane_iters`` supersteps, or to
  convergence), the damped PageRank (20 sweeps, every vertex active), the
  int32 ``where`` from vertex 0 (min), and SSSP as ``e + m`` from vertex
  0."""
  import torch
  from repro_torch.core.engine import (run_batched, run_fixed_iters,
                                       run_graph_program)
  from repro_torch.core.vertex_program import GraphProgram, lanewise_activate
  fns = traced_programs()
  n, dev = g.n, out_deg.device
  neg_inf, inf = float("-inf"), float("inf")
  widest = GraphProgram(
      process_message=fns["widest"].fn, reduce_kind="max",
      apply=torch.maximum, needs_recv=False, inert_message=neg_inf,
      lanewise=True, process_reads_dst=False, name="widest_path")
  widest_q = dataclasses.replace(widest, activate=lanewise_activate,
                                 name="widest_path_lanes")
  deg = out_deg.clamp(min=1.0)
  damped = GraphProgram(
      process_message=fns["damped_pr"].fn, reduce_kind="add",
      send_message=lambda r: r / deg, apply=lambda red, old: 0.15 + red,
      process_reads_dst=False, name="damped_pagerank")
  int_where = GraphProgram(
      process_message=fns["int_where"].fn, reduce_kind="min",
      apply=torch.minimum, process_reads_dst=False, name="int_where")
  e_plus_m = GraphProgram(
      process_message=fns["sssp_e_plus_m"].fn, reduce_kind="min",
      apply=torch.minimum, process_reads_dst=False, name="sssp_e_plus_m")
  sources = torch.arange(TRACED_SOURCES, device=dev) * (n // TRACED_SOURCES)

  def seeded(fill, value, dtype, q=None):
    shape = (n,) if q is None else (n, q)
    prop = torch.full(shape, fill, dtype=dtype, device=dev)
    active = torch.zeros(shape, dtype=torch.bool, device=dev)
    if q is None:
      prop[0], active[0] = value, True
    else:
      lanes = torch.arange(q, device=dev)
      prop[sources, lanes], active[sources, lanes] = value, True
    return prop, active

  def single(prog, fill, value, dtype):
    def run(plan):
      st = run_graph_program(g, prog, *seeded(fill, value, dtype),
                             backend=plan)
      return st.prop, int(st.iteration)
    return run

  def lanes(plan):
    st = run_batched(g, widest_q, *seeded(0.0, inf, torch.float32,
                                          TRACED_SOURCES), backend=plan,
                     **({} if lane_iters is None
                        else {"max_iters": lane_iters}))
    return st.prop, int(st.iteration)

  def pagerank(plan):
    every = torch.ones((n,), dtype=torch.bool, device=dev)
    r0 = torch.ones((n,), dtype=torch.float32, device=dev)
    st = run_fixed_iters(g, damped, r0, every, TRACED_PR_ITERS, backend=plan)
    return st.prop, TRACED_PR_ITERS

  return {
      "widest": (widest, False, single(widest, 0.0, inf, torch.float32)),
      "widest_q8": (widest_q, True, lanes),
      "damped_pr": (damped, False, pagerank),
      "int_where": (int_where, False, single(int_where, 2**31 - 1, 0,
                                             torch.int32)),
      "sssp_e_plus_m": (e_plus_m, False, single(e_plus_m, inf, 0.0,
                                                torch.float32)),
  }


def traced_runs(phase: str, g, out_deg, ell_mod, every: int = 1,
                lane_every: int = 1, lane_iters=None) -> tuple:
  """Each lambda-only program through ``Plan("cuda_ell")`` and
  ``Plan("ell")`` on graph ``g``: min, max and int32 results bitwise, the
  damped PageRank within rtol 1e-4 after its sweeps; each must launch the
  kernel (counted from 0 just before its kernel run, read just after).
  Returns the record, the launches by counter key and, per program, every
  ``every``-th kernel call (``lane_every``-th of the lane program) of a
  first run, which also warms up (for the kernels line)."""
  import torch
  from repro_torch.core.backends import Plan
  programs = traced_graph_programs(g, out_deg, lane_iters)
  kernel, plain = Plan("cuda_ell"), Plan("ell")
  out, launches, recorded = {}, {}, {}
  for name, (prog, lane, run) in programs.items():
    recorded[name] = record_calls(lambda: run(kernel),
                                  every=lane_every if lane else every)
    ell_mod.launches.reset()
    (got, steps), sec = timed(lambda: run(kernel))
    counts = dict(ell_mod.launches.by_config)
    if not counts or any(k.split("/")[-1] != counts_name(name, lane)
                         for k in counts):
      raise AssertionError(f"{phase}: traced {name} launched {counts}")
    for k, v in counts.items():
      launches[k] = launches.get(k, 0) + v
    (want, steps_p), sec_p = timed(lambda: run(plain))
    if name == "damped_pr":
      torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    elif not torch.equal(got, want) or steps != steps_p:
      raise AssertionError(f"{phase}: traced {name}: cuda_ell != Plan('ell')")
    if not bool(torch.isfinite(got.float()).any()):
      raise AssertionError(f"{phase}: traced {name}: no finite value")
    err = float((got.double() - want.double()).abs().nan_to_num().max())
    out[name] = {"launches": counts, "supersteps": steps, "seconds": sec,
                 "plain_seconds": sec_p, "max_abs_err": err}
    log(f"{phase}: traced {name} ({prog.name}): {steps} supersteps, "
        f"launches {counts}, cuda_ell {sec:.3f} s, Plan('ell') {sec_p:.3f} "
        "s; " + (f"max abs err {err:.3g} at rtol 1e-4"
                 if name == "damped_pr" else "equal bitwise"))
    del got, want
  torch.cuda.empty_cache()
  return out, launches, recorded


MIXED_PR_RTOL = 2e-2  # the bfloat16 PageRank: cuda_ell against Plan("ell")
# The bfloat16 PageRank's largest relative gap to the float32 run on
# cuda_ell, after 20 sweeps and after one: a few roundings a sweep, damped
# by 0.85.  A scatter that adds bfloat16 terms in bfloat16 stalls at a hub
# and misses most of its sum.
MIXED_PR_GAP = 5e-2
DOT_SCORE_K = 16       # the dot score's message and property lanes


def half_edges(g):
  """``g`` with its edge values (and its spill's) in float16."""
  import torch
  spill = None if g.spill is None else dataclasses.replace(
      g.spill, w=g.spill.w.to(torch.float16))
  return dataclasses.replace(g, vals=g.vals.to(torch.float16), spill=spill)


def mixed_runs(phase: str, g, out_deg, ell_mod) -> tuple:
  """The mixed-dtype and lane-mixing programs on graph ``g`` through
  ``Plan("cuda_ell")`` and ``Plan("ell")``: the damped PageRank in
  bfloat16 (20 sweeps, within
  ``MIXED_PR_RTOL``; its largest gap to the float32 run within
  ``MIXED_PR_GAP``), SSSP as
  ``m + e`` with float32 messages on the graph's edge values in float16
  (bitwise, equal supersteps), and one superstep of the lane dot score
  over a K = 16 message and property (max; rtol 1e-5: a float lane sum).
  Each must launch its own generated instance (counted from 0 just before
  its kernel run, read just after).  Returns the record, the launches by
  counter key and each program's kernel calls, recorded on a first run."""
  import torch
  from repro_torch.core import spmv as spmv_mod
  from repro_torch.core.backends import Plan
  from repro_torch.core.engine import run_fixed_iters, run_graph_program
  from repro_torch.core.vertex_program import GraphProgram
  fns = traced_programs()
  n, dev = g.n, out_deg.device
  bf16 = torch.bfloat16
  kernel, plain = Plan("cuda_ell"), Plan("ell")
  deg = out_deg.clamp(min=1.0)
  every = torch.ones((n,), dtype=torch.bool, device=dev)
  g16 = half_edges(g)

  def pr_program(dtype):
    d = deg.to(dtype)
    return GraphProgram(
        process_message=(fns["pr_bf16"] if dtype == bf16
                         else fns["damped_pr"]).fn, reduce_kind="add",
        send_message=lambda r: r / d, apply=lambda red, old: 0.15 + red,
        process_reads_dst=False, name=f"damped_pagerank_{dtype}")
  got_prog = (pr_program(bf16), pr_program(torch.float32))

  def pagerank(plan):
    r0 = torch.ones((n,), dtype=bf16, device=dev)
    return run_fixed_iters(g, got_prog[0], r0, every, TRACED_PR_ITERS,
                           backend=plan).prop, TRACED_PR_ITERS

  half = GraphProgram(process_message=fns["sssp_half_edges"].fn,
                      reduce_kind="min", apply=torch.minimum,
                      process_reads_dst=False, name="sssp_half_edges")

  def sssp_half(plan):
    prop = torch.full((n,), float("inf"), device=dev)
    active = torch.zeros((n,), dtype=torch.bool, device=dev)
    prop[0], active[0] = 0.0, True
    st = run_graph_program(g16, half, prop, active, backend=plan)
    return st.prop, int(st.iteration)

  gen = torch.Generator(device="cuda").manual_seed(24)
  dot_msg = torch.rand((n, DOT_SCORE_K), generator=gen, device=dev)
  dot_dst = torch.rand((n, DOT_SCORE_K), generator=gen, device=dev)
  dot = GraphProgram(process_message=fns["dot_score"].fn, reduce_kind="max",
                     process_reads_dst=True, name="dot_score")

  def dot_score(plan):
    y, _ = spmv_mod.spmv(g, dot_msg, every, dot_dst, dot, backend=plan)
    return y, 1

  runs = {"pr_bf16": (pagerank, bf16, None),
          "sssp_half_edges": (sssp_half, torch.float32, None),
          "dot_score": (dot_score, torch.float32, DOT_SCORE_K)}
  out, launches, recorded = {}, {}, {}
  for name, (run, dtype, k) in runs.items():
    recorded[name] = record_calls(lambda: run(kernel))
    want_name = traced_expr(name, dtype, k is not None, k).name
    ell_mod.launches.reset()
    (got, steps), sec = timed(lambda: run(kernel))
    counts = dict(ell_mod.launches.by_config)
    if not counts or any(key.split("/")[-1] != want_name for key in counts):
      raise AssertionError(f"{phase}: {name} launched {counts}")
    for key, v in counts.items():
      launches[key] = launches.get(key, 0) + v
    (want, steps_p), sec_p = timed(lambda: run(plain))
    if got.dtype != want.dtype or got.shape != want.shape:
      raise AssertionError(f"{phase}: {name}: {got.dtype}{list(got.shape)} "
                           f"against {want.dtype}{list(want.shape)}")
    if name == "sssp_half_edges":
      if not torch.equal(got, want) or steps != steps_p:
        raise AssertionError(f"{phase}: {name}: cuda_ell != Plan('ell')")
      how = "equal bitwise"
    else:
      rtol = MIXED_PR_RTOL if name == "pr_bf16" else 1e-5
      torch.testing.assert_close(
          got.float(), want.float(), rtol=rtol,
          atol=rtol * float(want.float().abs().max()),
          msg=lambda m: f"{phase}: {name}: {m}")
      how = f"within rtol {rtol}"
    if not bool(torch.isfinite(got.float()).any()):
      raise AssertionError(f"{phase}: {name}: no finite value")
    err = float((got.double() - want.double()).abs().nan_to_num().max())
    out[name] = {"launches": counts, "supersteps": steps, "seconds": sec,
                 "plain_seconds": sec_p, "max_abs_err": err}
    extra = ""
    if name == "pr_bf16":
      # Split by whether a vertex has spilled edges, whose sums the COO
      # scatter folds in, after the 20 sweeps and after one.
      spilled = torch.zeros((n,), dtype=torch.bool, device=dev)
      if g.spill is not None:
        spilled[g.spill.dst[g.spill.emask].long()] = True
      split = {}
      for sweeps in (TRACED_PR_ITERS, 1):
        r16 = run_fixed_iters(g, got_prog[0], torch.ones((n,), dtype=bf16,
                                                          device=dev), every,
                              sweeps, backend=kernel).prop.float()
        r32 = run_fixed_iters(g, got_prog[1], torch.ones((n,), device=dev),
                              every, sweeps, backend=kernel).prop
        gaps = ((r16 - r32) / r32.abs().clamp(min=1e-30)).abs()
        split[f"{sweeps} sweeps"] = {
            k: float(gaps[m].max()) if bool(m.any()) else None
            for k, m in (("all", torch.ones_like(spilled)),
                         ("no_spill", ~spilled), ("spilled", spilled))}
      out[name]["max_rel_gap_to_f32"] = split
      extra = ("; largest relative gap to the float32 run "
               + json.dumps(split))
      if not max(v["all"] for v in split.values()) <= MIXED_PR_GAP:
        raise AssertionError(f"{phase}: {name}: gap to the float32 run "
                             f"over {MIXED_PR_GAP}: {json.dumps(split)}")
    log(f"{phase}: {name}: {steps} supersteps, launches {counts}, cuda_ell "
        f"{sec:.3f} s, Plan('ell') {sec_p:.3f} s; max abs err {err:.3g}, "
        f"{how}{extra}")
    del got, want
  torch.cuda.empty_cache()
  return out, launches, recorded


def mixed_rows(phase: str, g, ell_mod, ref_mod, gen, csr: dict,
               launches: dict, recorded: dict) -> tuple:
  """The kernels line's rows of the mixed-dtype and lane-mixing instances
  on graph ``g``: the bfloat16 PageRank with every source active
  (``torch.sparse.mm`` over
  0.85s in bfloat16 beside it, where it runs), SSSP on float16 edges on
  the calls recorded from its own run, and the lane dot score on a random
  K = 16 message and property."""
  import torch
  single = "src/repro/kernels/ell_spmv.py:192"
  f32, bf16 = torch.float32, torch.bfloat16
  entries, records = [], {}
  g16 = half_edges(g)
  rows = (("pr_bf16,bf16,add,Q=1", "pr_bf16", g, bf16, 1, None, None,
           {"library_scale": 0.85}),
          ("sssp_half_edges,f32+f16->f32,min,Q=1", "sssp_half_edges", g16,
           f32, 1, None, recorded["traced:sssp_half_edges"], {}),
          (f"dot_score,f32,max,K={DOT_SCORE_K},K_out=1", "dot_score", g, f32,
           DOT_SCORE_K, DOT_SCORE_K, None,
           {"exact": False, "library_null": "no single PyTorch call takes "
            "a row's max over its edges of a per-edge dot product"}))
  for label, prog, graph, dtype, q, kd, calls, kw in rows:
    expr = traced_expr(prog, dtype, q > 1, q if q > 1 else None)
    if calls is not None:
      calls = [(c[0], c[1]) for c in calls]
      if not calls or any(m.shape[1] != q or m.dtype != dtype
                          for m, _ in calls):
        raise AssertionError(f"{phase}: {label}: the recorded calls are "
                             "not its own")
    name = f"ell_spmv[{label},traced]"
    entry, records[name] = time_ell(
        phase, graph, ell_mod, ref_mod, gen, csr, name, expr,
        traced_programs()[prog].reduce, dtype, q, kd, single, calls,
        launches, **kw)
    entries.append(entry)
  del g16
  torch.cuda.empty_cache()
  return entries, records


def counts_name(name: str, lane: bool) -> str:
  """The launch counter's instance name of a traced program."""
  import torch
  base = "widest" if name == "widest_q8" else name
  dtype = torch.int32 if base == "int_where" else torch.float32
  return traced_expr(base, dtype, lane).name


def record_calls(fn, every: int = 1) -> list:
  """Run ``fn`` with the ``cuda_ell`` backend's kernel calls recorded:
  ``(msg, active, keyword arguments)`` of every ``every``-th call from the
  first, copied before its launch."""
  from repro_torch.kernels import ops as kops
  calls, launch, seen = [], kops.ell_spmv, [0]

  def recording(cols, vals, mask, msg, active, **kw):
    if seen[0] % every == 0:
      calls.append((msg.clone(), active.clone(), kw))
    seen[0] += 1
    return launch(cols, vals, mask, msg, active, **kw)

  kops.ell_spmv = recording
  try:
    fn()
  finally:
    kops.ell_spmv = launch
  return calls


# ---------------------------------------------------------------------------
# Phase 4: timings and the kernels line
# ---------------------------------------------------------------------------


def time_ell(phase: str, g, ell_mod, ref_mod, gen, csr: dict, name: str,
             op, red: str, dtype, q: int, kd, replaces: str, calls,
             launches: dict, library_scale=None, dprop=None, exact=None,
             library_null=None):
  """One row of the kernels line: the ELL kernel on graph ``g`` held
  against its plain version on ``calls`` (``(msg, active)`` pairs; None:
  one call of random messages with every source active, as each PageRank
  and gradient sweep runs), timed with CUDA events beside the plain version
  (and ``torch.sparse.mm`` for PageRank's form, or for a traced process
  ``library_scale * m`` summed), with its byte bound.  ``op`` is a shipped
  form's name or a traced process (a generated instance unless it equals a
  form).  ``csr`` memoizes the graph's CSR matrices for ``torch.sparse.mm``.
  Returns the row and its record: the all-slots bound, the kernel's own
  time on the card (``torch.profiler``'s device events, by
  :func:`launch_busy`, None where every window lost events: the events'
  time also holds the host's pace of issuing calls), the device events the
  profiler saw with and without padding its window (see
  :func:`device_busy`) and the bound's share of each time.  ``dprop``: the
  destination property (default: random, ``kd`` wide, in ``dtype``);
  ``exact``: as :func:`compare`'s; ``library_null``: why no library call
  is timed.  A lane-mixing process's bound is the larger of its bytes and
  its operations (the trace's per-edge ops on each active valid slot over
  the float32 rate); its message gathers (every active valid slot's K
  values) are logged beside it, not counted: each input is counted once."""
  import torch
  n, n_pad, width = g.n, g.n_pad, g.width
  active = torch.ones((n,), dtype=torch.bool, device="cuda")
  ext = {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
         "segments": ell_mod.row_segments(g.row_end)}
  valid_slots = int(g.mask.sum())
  random_calls = calls is None
  if random_calls:
    if dtype == torch.int32:
      msg = torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                          dtype=torch.int32)
    else:
      msg = torch.rand((n, q), generator=gen, device="cuda").to(dtype)
    calls = [(msg, active)]
  if dprop is None and kd is not None:
    dprop = torch.rand((n_pad, kd), generator=gen, device="cuda").to(
        dtype if not isinstance(op, str) and op.dst_dtype is None
        else (dtype if isinstance(op, str) else op.dst_dtype))
  dp = (torch.zeros((n_pad, 1), dtype=dtype, device="cuda")
        if dprop is None else dprop)
  traced = not isinstance(op, str)
  form = {"process": op} if traced else {"process_op": op}
  process = op.plain if traced else ell_mod.plain_process(op)

  def kernel(m, a):
    return ell_mod.ell_spmv(g.cols, g.vals, g.mask, m, a, **form,
                            reduce_kind=red, dprop=dprop, **ext)

  def plain(m, a):
    return ref_mod.ell_spmv_ref(g.cols, g.vals, g.mask, m, a, dp,
                                process=process, reduce_kind=red)

  def run_all(fn):
    def run():
      for m, a in calls:
        fn(m, a)
    return run

  err = 0.0
  for m, a in calls:
    y, r = kernel(m, a)
    yr, rr = plain(m, a)
    err = max(err, compare(y, yr, r, rr, red, name, exact=exact))
  del yr, rr
  plain_ms = cuda_ms(run_all(plain), iters=3 if random_calls else 1,
                     warmup=0) / len(calls)
  # At least 128 launches in the profiler's padded window; beside it, for
  # the record, the window of PR 22 (20 launches, unpadded).
  reps, old_reps = max(1, -(-128 // len(calls))), max(1, 20 // len(calls))
  window = reps * len(calls)
  unpadded = device_busy(
      lambda: [run_all(kernel)() for _ in range(old_reps)], pad_s=0.0)
  busy = launch_busy(lambda: [run_all(kernel)() for _ in range(reps)],
                     window, ell_mod.kernels_per_call(op))
  device_ms = busy["ms"]
  size = calls[0][0].element_size()
  edge = op.reads_edge if traced else op in ell_mod.EDGE_OPS
  lanes = traced and op.lane_mixing
  k_out = op.k_out if lanes else q
  out_size = torch.empty((), dtype=op.out_dtype if traced else dtype
                         ).element_size()
  # Bytes the work needs, whatever implements it, a launch on average:
  # cols of the valid slots, vals for a process that reads the edge, of the
  # valid slots whose source is active (no other is needed), one row
  # extent per packed row, active once for each source some valid slot
  # names, the messages of those that are active, dprop once for each row
  # with such a slot, y and recv once.
  live_slots = active_msgs = live_rows = 0
  named = torch.zeros((n,), dtype=torch.bool, device="cuda")
  named[g.cols[g.mask].long()] = True
  for _, a in calls:
    live = g.mask & a[g.cols]
    live_slots += int(live.sum()) / len(calls)
    active_msgs += int((named & a).sum()) / len(calls)
    live_rows += int(live.any(1).sum()) / len(calls)
  edge_slots = live_slots if edge else 0
  vsize = g.vals.element_size()
  need = (valid_slots * 4 + edge_slots * vsize + 4 * n_pad
          + active_msgs * q * size + int(named.sum())
          + (0 if dprop is None else live_rows * dprop.shape[1]
             * dprop.element_size())
          + n_pad * k_out * out_size + n_pad)
  bound_ms, bound_by = need / H100_BYTES_PER_S * 1e3, "bytes"
  ops_ms = gather_bytes = None
  if lanes:
    # The trace's operations on one edge (K a lane op or lane reduction, 1
    # a per-edge op) and the reduce's K_out, on each active valid slot.
    per_edge = sum(q if shape == "vec" or node_op.startswith("lane_")
                   else 1 for node_op, _, shape, _, _ in op.nodes) + k_out
    ops_ms = live_slots * per_edge / H100_F32_OPS_PER_S * 1e3
    gather_bytes = live_slots * q * size
    if ops_ms > bound_ms:
      bound_ms, bound_by = ops_ms, "operations"
  # Every ELL slot's mask, cols (and vals) byte and every message: the
  # all-slots count, kept for the record.
  full = (n_pad * width * (5 + (vsize if edge else 0)) + n * q * size + n
          + n_pad * k_out * out_size + n_pad)
  library_ms = None
  scale = 1.0 if op == "msg" else library_scale
  if scale is not None and csr.get((scale, dtype), 0) is None:
    scale = None  # the library refused this dtype (its reason is logged)
  if scale is not None:
    # torch.sparse.mm on the same matrix as CSR: plus_times over the
    # pattern, each value ``scale`` (PageRank's form passes the message
    # through; the damped one scales it).
    if (scale, dtype) not in csr:
      # The packed ELL matrix as CSR, columns sorted within each row.
      rows, slots = g.mask.nonzero(as_tuple=True)
      src_ids = g.cols[rows, slots].long()
      order = torch.argsort(rows * n + src_ids)
      rows, slots, src_ids = rows[order], slots[order], src_ids[order]
      crow = torch.zeros(n_pad + 1, dtype=torch.int64, device="cuda")
      crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n_pad), 0)
      vals = torch.full(src_ids.shape, scale, dtype=dtype, device="cuda")
      csr[scale, dtype] = torch.sparse_csr_tensor(crow, src_ids, vals,
                                                  size=(n_pad, n))
      del rows, slots, src_ids, order
    m, a = calls[0]
    x = torch.where(a[:, None], m, 0.0)
    try:
      y_lib = torch.sparse.mm(csr[scale, dtype], x)
      torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
      # A yardstick only: the reason goes to the record and the log.
      library_null = f"torch.sparse.mm refuses {dtype}: {exc}"[:300]
      csr[scale, dtype] = None
      scale = None
  if scale is not None:
    rtol = 1e-4 if dtype == torch.float32 else RTOL[str(dtype)]
    torch.testing.assert_close(y_lib.float(), y.float(), rtol=rtol,
                               atol=rtol * float(y.float().abs().max()))
    # Timed in turns with the kernel, so that both see the same card.
    kernel_ms, library_ms = paired_ms(
        run_all(kernel), lambda: torch.sparse.mm(csr[scale, dtype], x))
  else:
    kernel_ms = cuda_ms(run_all(kernel), iters=max(1, 20 // len(calls)),
                        repeats=5) / len(calls)
  del y, r
  generated = traced and op.shipped is None
  entry = {
      "name": name, "route": "cuda",
      "source": ("src/repro_torch/kernels/csrc/ell_spmv_body.cuh"
                 if generated else "src/repro_torch/kernels/csrc/ell_spmv.cu"),
      "replaces": replaces,
      "launches": int(launches.get(ell_mod.config_key(
          q, dtype, red, op.name if traced else op, lanes), 0)),
      "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
      "bound_ms": bound_ms, "bound_by": bound_by,
      "library_ms": library_ms}
  record = {"ell_array_bound_ms": full / H100_BYTES_PER_S * 1e3,
            "device_ms": device_ms, "window_launches": window,
            "device_events": busy["kernels"],
            "device_events_by_window": busy["windows"],
            "device_events_twice": busy["duplicates"],
            "device_events_placed": busy["placed"],
            "unpadded_window_launches": old_reps * len(calls),
            "device_events_unpadded": unpadded["kernels"],
            "bound_share": entry["bound_ms"] / kernel_ms,
            "device_bound_share": (None if device_ms is None
                                   else entry["bound_ms"] / device_ms),
            "byte_bound_ms": need / H100_BYTES_PER_S * 1e3,
            "ops_bound_ms": ops_ms, "gather_bytes": gather_bytes,
            "library_null": library_null}
  log(f"{phase}: {name}: kernel {kernel_ms:.4f} ms a launch over "
      f"{len(calls)} call(s) (bound share {record['bound_share']:.3f}), "
      f"on the card {device_ms} ms (share "
      f"{record['device_bound_share']}; {busy['windows']} device events of "
      f"{window} launches"
      + ("" if not any(busy["duplicates"]) else
         f", {busy['duplicates']} reported twice")
      + f"; unpadded, {unpadded['kernels']} of "
      f"{old_reps * len(calls)}), "
      f"plain {plain_ms:.3f} ms, bound "
      f"{entry['bound_ms']:.4f} ms ({bound_by}), ELL-array bound "
      f"{record['ell_array_bound_ms']:.4f} ms, library {library_ms}"
      + ("" if device_ms is not None else
         f"; no window's events matched its launches, placed "
         f"{json.dumps(busy['placed'])}")
      + ("" if gather_bytes is None else
         f", message gathers {gather_bytes / 1e6:.1f} MB (not in the bound)")
      + ("" if library_null is None else f" ({library_null})"))
  torch.cuda.empty_cache()
  return entry, record


def paired_device_ms(calls, fns: dict, turns: int = 2) -> dict:
  """The card's time a call of each function in ``fns`` (name -> fn(m,
  a)) over ``calls``, by ``torch.profiler``, in turns (a, b, b, a, ...):
  the mean of ``turns`` windows each.  A function with a turn whose every
  window lost events or saw too many (:func:`launch_busy`) gets None, not
  measured: this
  compares two times and checks nothing, and ``lost`` keeps the windows
  and where their events sat."""
  order = list(fns) + list(fns)[::-1]
  got = {k: [] for k in fns}
  windows = {k: [] for k in fns}
  lost = {}
  reps = max(1, -(-128 // len(calls)))
  for _ in range(turns // 2 if turns > 1 else 1):
    for k in order:
      busy = launch_busy(lambda: [fns[k](m, a) for _ in range(reps)
                                  for m, a in calls], reps * len(calls))
      windows[k].append({"windows": busy["windows"],
                         "duplicates": busy["duplicates"]})
      if busy["ms"] is None:
        lost.setdefault(k, []).append(
            {"launches": reps * len(calls), "windows": busy["windows"],
             "placed": busy["placed"]})
      got[k].append(busy["ms"])
  return {k: None if k in lost else sum(v) / len(v)
          for k, v in got.items()} | {"turns": got, "windows": windows,
                                      "lost": lost}


def traced_rows(phase: str, g, ell_mod, ref_mod, gen, csr: dict,
                launches: dict, recorded: dict, sssp_calls: list,
                tag: str = "") -> tuple:
  """The kernels line's rows of the generated instances on graph ``g``:
  widest path at Q = 1 and 8 and the int32 ``where`` on the calls recorded
  from their own runs, the damped PageRank with every source active (with
  ``torch.sparse.mm`` over 0.85s), and SSSP as ``e + m`` on the shipped
  SSSP's recorded calls; then the ``e + m`` instance's device time against
  the shipped ``msg_plus_edge`` on those calls, in turns."""
  import torch
  f32, i32 = torch.float32, torch.int32
  single, tiled = ("src/repro/kernels/ell_spmv.py:192",
                   "src/repro/kernels/ell_spmv.py:165")
  rows = (
      ("widest,f32,max,Q=1", "widest", f32, 1, single,
       recorded["traced:widest"], None),
      ("widest,f32,max,Q=8", "widest", f32, TRACED_SOURCES, tiled,
       recorded["traced:widest_q8"], None),
      ("damped_pr,f32,add,Q=1", "damped_pr", f32, 1, single, None, 0.85),
      ("int_where,int32,min,Q=1", "int_where", i32, 1, single,
       recorded["traced:int_where"], None),
      ("sssp_e_plus_m,f32,min,Q=1", "sssp_e_plus_m", f32, 1, single,
       sssp_calls, None))
  entries, records = [], {}
  for label, prog, dtype, q, replaces, calls, scale in rows:
    expr = traced_expr(prog, dtype, lane=q > 1)
    red = traced_programs()[prog].reduce
    if calls is not None:
      calls = [(c[0], c[1]) for c in calls]
      if not calls or any(m.shape[1] != q or m.dtype != dtype
                          for m, _ in calls):
        raise AssertionError(f"{phase}: {label}: the recorded calls are "
                             "not its own")
    name = f"ell_spmv[{tag}{label},traced]"
    entry, records[name] = time_ell(
        phase, g, ell_mod, ref_mod, gen, csr, name, expr, red, dtype, q,
        None, replaces, calls, launches, library_scale=scale)
    entries.append(entry)
  ext = {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
         "segments": ell_mod.row_segments(g.row_end)}
  calls = [(c[0], c[1]) for c in sssp_calls]
  generated = traced_expr("sssp_e_plus_m", f32, lane=False)
  paired = paired_device_ms(calls, {
      "msg_plus_edge": lambda m, a: ell_mod.ell_spmv(
          g.cols, g.vals, g.mask, m, a, process_op="msg_plus_edge",
          reduce_kind="min", **ext),
      "e_plus_m": lambda m, a: ell_mod.ell_spmv(
          g.cols, g.vals, g.mask, m, a, process=generated, reduce_kind="min",
          **ext)})
  if paired["lost"]:
    paired["ratio"] = None
    log(f"{phase}: SSSP on its {len(calls)} recorded calls, the card's ms a "
        "launch in turns: not measured, no window of a turn saw one event "
        f"a launch: {json.dumps(paired['lost'])}")
  else:
    paired["ratio"] = paired["e_plus_m"] / paired["msg_plus_edge"]
    log(f"{phase}: SSSP on its {len(calls)} recorded calls, the card's ms a "
        f"launch in turns: shipped msg_plus_edge "
        f"{paired['msg_plus_edge']:.5f}, generated e + m "
        f"{paired['e_plus_m']:.5f} (ratio {paired['ratio']:.4f})")
  return entries, records, paired


# The COO kernel's rows of the kernels line.  Its float sums are held to
# this share of each destination's sum of |terms| against the PyTorch path:
# two float32 sums of n terms in different orders differ by about
# sqrt(n) * 6e-8 of it (4e-5 at CF's largest run, 5e5 ratings), and a
# dropped edge of any run under 10^4 edges, or a tile's dropped carry,
# exceeds it.
COO_ADD_TOL = 1e-4


def gather_floor_ms(ids, n_src: int, vecs: int) -> dict:
  """The card's time of ``tools/gather_floor.cu`` over ``ids``: each id's
  row of a float32 table ``[n_src, 4 * vecs]`` (16 bytes a thread) read
  and summed, with nothing else; None where every window lost events."""
  import torch
  from repro_torch.kernels import _build
  if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))
  import gather_floor
  lib = _build.CudaLibrary(str(ROOT / "tools" / "gather_floor.cu"),
                           gather_floor._bind).load()
  blocks = lib.gather_floor_blocks(256)
  table = torch.rand((n_src, 4 * vecs), device="cuda")
  out = torch.empty(blocks * 256, device="cuda")
  stream = torch.cuda.current_stream().cuda_stream

  def launch():
    rc = lib.gather_floor_launch(ids.data_ptr(), ids.numel(),
                                 table.data_ptr(), vecs, out.data_ptr(),
                                 blocks, 256, stream)
    if rc != 0:
      raise RuntimeError(f"gather_floor_launch failed: {rc}")
  launch()
  busy = launch_busy(lambda: [launch() for _ in range(32)], 32,
                     only="gather_kernel")
  return {"ms": busy["ms"], "bytes_a_row": 16 * vecs}


def time_coo(phase: str, name: str, g, msg, active, dprop, prog,
             launches: dict, tiled: bool = False, library=None,
             library_null=None):
  """One row of the kernels line: the COO kernel (``kernels/coo_spmv.py``)
  on COO graph ``g`` for one call, held against its plain version on the
  same card tensors (``core/spmv.py::_spmv_coo_torch``, or
  ``_spmv_coo_tiled_torch`` where ``tiled``, the plan CF's phase V takes):
  recv, min and max bitwise, add within :data:`COO_ADD_TOL` of each
  destination's sum of |terms|.  Timed with CUDA events (in turns with
  ``library``, a call computing the same, where given), and on the card by
  :func:`launch_busy` over its own kernels (the frontier pass, the reduce,
  the carry pass where a run crosses tiles).  The bound is the bytes the
  call needs: per real edge 4 of ``src`` and 4 of the edge value where the
  process reads it; each source a valid edge names, its message and active
  flag once; each destination with an edge, its result and recv once, and
  its property where read.  The message gathers' floor (:func:`
  gather_floor_ms` over the valid edges' sources) is logged beside it.
  ``launches``: the COO counter's counts on the main path."""
  import torch
  from repro_torch.core import spmv as S
  from repro_torch.kernels import coo_spmv as K
  call = K.route(g, msg, active, dprop, prog)
  if call is None:
    raise AssertionError(f"{phase}: {name}: the COO kernel did not take the "
                         f"call ({K.torch_path})")

  def kernel():
    return K.spmv(call, g, active)

  def plain():
    if tiled:
      return S._spmv_coo_tiled_torch(g, msg, active, dprop, prog, None, True)
    return S._spmv_coo_torch(g, msg, active, dprop, prog)

  (y, recv), (y_t, recv_t) = kernel(), plain()
  if not torch.equal(recv, recv_t):
    raise AssertionError(f"{phase}: {name}: recv differs")
  if prog.reduce_kind == "add":
    r, _, dst = S._coo_process(g, 0, g.capacity, msg, active, dprop, prog)
    size = torch.zeros_like(y_t).index_add_(0, dst, r.abs())
    del r, dst
    gap = (y - y_t).abs()
    err = float(gap.max())
    share = float((gap / size.clamp(min=1e-30)).max())
    if not bool((gap <= COO_ADD_TOL * size).all()):
      raise AssertionError(f"{phase}: {name}: |kernel - plain| reaches "
                           f"{share:.3g} of a sum of |terms| (> "
                           f"{COO_ADD_TOL})")
    del size, gap
  else:
    if not torch.equal(y, y_t):
      raise AssertionError(f"{phase}: {name}: y differs")
    err, share = 0.0, 0.0
  del y_t, recv_t
  plain_ms = cuda_ms(plain, iters=3, warmup=1)
  kernels = 3 if call.table.num_splits else 2
  reps = 128
  busy = launch_busy(lambda: [kernel() for _ in range(reps)], reps, kernels,
                     only="coo_gather")
  library_ms = None
  if library is not None:
    y_lib = library()
    torch.cuda.synchronize()
    torch.testing.assert_close(y_lib.reshape(y.shape), y, rtol=1e-4,
                               atol=1e-4 * float(y.abs().max()))
    del y_lib
    kernel_ms, library_ms = paired_ms(kernel, library)
  else:
    kernel_ms = cuda_ms(kernel, repeats=5)
  del y, recv
  process = call.process
  traced = not isinstance(process, str)
  edge = (process.reads_edge if traced
          else process in ("msg_plus_edge", "msg_times_edge"))
  reads_dst = traced and process.reads_dst
  k_out = K._out(call)[1]
  real = g.emask
  valid = real & active[g.src]
  sources = int(torch.unique(g.src[valid]).numel())
  dsts = int(torch.unique(g.dst[real]).numel())
  row = msg.shape[1] if msg.ndim == 2 else 1
  size = msg.element_size()
  need = (int(real.sum()) * (4 + (g.w.element_size() if edge else 0))
          + sources * (row * size + 1) + dsts * (k_out * size + 1))
  if reads_dst:
    need += dsts * (dprop.shape[1] if dprop.ndim == 2 else 1) * size
  bound_ms = need / H100_BYTES_PER_S * 1e3
  floor = gather_floor_ms(call.table.src[valid].contiguous(), msg.shape[0],
                          max(1, row // 4))
  lanes = traced and process.lane_mixing
  entry = {
      "name": name, "route": "cuda",
      "source": ("src/repro_torch/kernels/csrc/coo_spmv_body.cuh"
                 if traced and process.shipped is None
                 else "src/repro_torch/kernels/csrc/coo_spmv.cu"),
      "replaces": "none: XLA's scatters in src/repro/core/spmv.py:197",
      "launches": int(launches.get("coo/" + K.config_key(
          row, msg.dtype, prog.reduce_kind,
          process.name if traced else process, lanes), 0)),
      "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
      "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}
  record = {"device_ms": busy["ms"], "window_launches": reps,
            "device_events": busy["kernels"],
            "device_events_by_window": busy["windows"],
            "kernels_a_call": kernels, "err_share_of_terms": share,
            "bound_share": bound_ms / kernel_ms,
            "device_bound_share": (None if busy["ms"] is None
                                   else bound_ms / busy["ms"]),
            "bytes": need, "edges": int(real.sum()), "sources": sources,
            "destinations": dsts, "tiles": call.table.num_tiles,
            "splits": call.table.num_splits, "gather_floor": floor,
            "library_null": library_null}
  log(f"{phase}: {name}: kernel {kernel_ms:.4f} ms a call, on the card "
      f"{busy['ms']} ms ({busy['windows']} events of {reps} x {kernels}), "
      f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes; share "
      f"{record['bound_share']:.3f}), gather floor {floor['ms']} ms, "
      f"library {library_ms}, max abs err {err:.3g} ({share:.3g} of a sum "
      f"of |terms|)"
      + ("" if library_null is None else f" ({library_null})"))
  torch.cuda.empty_cache()
  return entry, record


def phase_timing(g, ell_mod, ref_mod, launches: dict, recorded: dict,
                 traced_launches: dict, coo_launches: dict):
  import torch
  from repro_torch.core.spmv import merge_spill
  from repro_torch.kernels.ops import spmv_ell_cuda
  from repro_torch.algos.multi import multi_bfs_program

  gen = torch.Generator(device="cuda").manual_seed(7)
  n = g.n
  active = torch.ones((n,), dtype=torch.bool, device="cuda")
  ext = {"row_end": g.row_end, "mask_prefix": g.mask_prefix,
         "segments": ell_mod.row_segments(g.row_end)}
  entries = []
  records = {}  # each row's all-slots bound, device time and bound shares
  # name, op, reduce, dtype, Q, Kd (None: no dprop), replaces, and the
  # phase-3 calls it is timed on (None: one call with every source active,
  # as each PageRank and gradient sweep runs).
  configs = [
      ("ell_spmv[bfs,int32,min,Q=1]", "msg_plus_one", "min", torch.int32, 1,
       None, "src/repro/kernels/ell_spmv.py:192", "bfs,Q=1"),
      ("ell_spmv[bfs,int32,min,Q=8]", "msg_plus_one", "min", torch.int32, 8,
       None, "src/repro/kernels/ell_spmv.py:165", "bfs,Q=8"),
      ("ell_spmv[sssp,f32,min,Q=1]", "msg_plus_edge", "min", torch.float32,
       1, None, "src/repro/kernels/ell_spmv.py:192", "sssp,Q=1"),
      ("ell_spmv[pagerank,f32,add,Q=1]", "msg", "add", torch.float32, 1,
       None, "src/repro/kernels/ell_spmv.py:192", None),
      ("ell_spmv[gradient,f32,add,Q=1,dprop]", DST_OP, "add", torch.float32,
       1, 1, "src/repro/kernels/ell_spmv.py:192", None),
      ("ell_spmv[gradient,f32,add,Q=8,dprop]", DST_OP, "add", torch.float32,
       8, 8, "src/repro/kernels/ell_spmv.py:165", None),
  ]
  csr = {}
  for name, op, red, dtype, q, kd, replaces, key in configs:
    calls = None
    if key is not None:
      calls = [(m, a) for m, a, kw in recorded[key]]
      if not calls or any(
          (kw["process_op"], kw["reduce_kind"]) != (op, red)
          or m.shape[1] != q or m.dtype != dtype
          for m, _, kw in recorded[key]):
        raise AssertionError(f"{name}: the recorded calls are not its own")
    entry, records[name] = time_ell(
        "phase 4", g, ell_mod, ref_mod, gen, csr, name, op, red, dtype, q,
        kd, replaces, calls, launches)
    entries.append(entry)
  traced, traced_records, paired = traced_rows(
      "phase 4", g, ell_mod, ref_mod, gen, csr, traced_launches, recorded,
      recorded["sssp,Q=1"])
  entries += traced
  records.update(traced_records)
  records["sssp_shipped_vs_generated"] = paired
  mixed, mixed_records = mixed_rows("phase 4", g, ell_mod, ref_mod, gen, csr,
                                    traced_launches, recorded)
  entries += mixed
  records.update(mixed_records)
  del csr

  # The kernel's time by frontier: all sources active (no slot reads an
  # active flag), 10% active (a message is read only for an active source)
  # and all but one (every flag and message).
  frontiers = {
      "all": active,
      "10%": torch.rand((n,), generator=gen, device="cuda") < 0.1,
      "all_but_one": active.clone().index_fill_(
          0, torch.tensor([n - 1], device="cuda"), False)}
  by_frontier = {}
  for name, op, red, dtype, q in (
      ("bfs,Q=1", "msg_plus_one", "min", torch.int32, 1),
      ("sssp,Q=1", "msg_plus_edge", "min", torch.float32, 1),
      ("pagerank,Q=1", "msg", "add", torch.float32, 1),
      ("bfs,Q=8", "msg_plus_one", "min", torch.int32, 8)):
    msg = (torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                         dtype=torch.int32) if dtype == torch.int32
           else torch.rand((n, q), generator=gen, device="cuda"))
    by_frontier[name] = {}
    for f, a in frontiers.items():
      by_frontier[name][f] = cuda_ms(lambda: ell_mod.ell_spmv(
          g.cols, g.vals, g.mask, msg, a, process_op=op, reduce_kind=red,
          **ext), repeats=3)
  log("phase 4: kernel ms by frontier " + json.dumps(by_frontier))

  # One superstep of the kernel backend on this graph, split into the
  # kernel and the COO spill merge (BFS program, int32 messages).
  prog = multi_bfs_program()
  split = {}
  for q in (1, 8):
    msg = torch.randint(0, 64, (n, q), generator=gen, device="cuda",
                        dtype=torch.int32)
    m = msg[:, 0] if q == 1 else msg
    y = m.clone()
    recv = torch.zeros((n,), dtype=torch.bool, device="cuda")
    split[f"Q={q}"] = {
        "superstep_spmv_ms": cuda_ms(lambda: spmv_ell_cuda(
            g, m, active, m, prog, segments=ext["segments"]), iters=10),
        "kernel_ms": cuda_ms(lambda: ell_mod.ell_spmv(
            g.cols, g.vals, g.mask, msg, active, process_op=prog.process_op,
            reduce_kind="min", **ext), iters=10),
        "spill_merge_ms": cuda_ms(lambda: merge_spill(
            g, y, recv, m, active, m, prog), iters=10)}
  log("phase 4: superstep split " + json.dumps(split))

  # The COO kernel on this graph's spill (the hub rows' edges past the ELL
  # width): SSSP at Q = 1 under two frontiers and at Q = 8 (a served query
  # tile), PageRank's add beside torch.sparse.mm over the spill as CSR.
  sp = g.spill
  if sp is not None:
    from repro_torch.core.vertex_program import GraphProgram
    sssp_prog = GraphProgram(process_op="msg_plus_edge", reduce_kind="min")
    rank_prog = GraphProgram(process_op="msg", reduce_kind="add")
    m1 = torch.rand((n,), generator=gen, device="cuda") * 10
    m8 = torch.rand((n, 8), generator=gen, device="cuda") * 10
    rows = [(f"sssp,f32,min,Q={m.shape[1] if m.ndim == 2 else 1},{f}", m, f)
            for m in (m1, m8) for f in ("all", "10%")]
    for label, m, f in rows:
      entry, records[f"coo:{label}"] = time_coo(
          "phase 4", f"coo_spmv[{label},spill]", sp, m, frontiers[f], m,
          sssp_prog, coo_launches,
          library_null="no single PyTorch call takes a min over edges")
      entries.append(entry)
    real = sp.emask
    csr_spill = torch.sparse_coo_tensor(
        torch.stack([sp.dst[real], sp.src[real]]),
        torch.ones(int(real.sum()), device="cuda"), (n, n)).coalesce(
        ).to_sparse_csr()
    col = m1[:, None].contiguous()
    entry, records["coo:pagerank,f32,add,Q=1,all"] = time_coo(
        "phase 4", "coo_spmv[pagerank,f32,add,Q=1,all,spill]", sp, m1,
        active, m1, rank_prog, coo_launches,
        library=lambda: torch.sparse.mm(csr_spill, col))
    entries.append(entry)
    del csr_spill, col, m1, m8
  return entries, records, split, by_frontier


# ---------------------------------------------------------------------------
# Phase 5: the paper's five algorithms and Table 3 on the card
# ---------------------------------------------------------------------------

# The paper's Table 3: GraphMat's time over native code's (none for SSSP).
PAPER_TABLE3 = {"pagerank": 1.15, "bfs": 1.18, "sssp": None, "tc": 2.10,
                "cf": 0.73}
PAPER_GEOMEAN = 1.20
# Triangle counting: RMAT with the paper's TC parameters, edge factor 16,
# self-loops removed, DAG-oriented.  The reference's bitmap design gathers
# [E, n/32] int32 words a COO phase, E·n/8 bytes a tensor: 8.5 GB at scale
# 16 (1.04 M DAG edges) and about 34 GB at scale 17, where the phases' few
# live tensors no longer fit.  So scale 16, the largest whose peak stays
# under the limit.
TC_SCALE = 16
TC_PEAK_LIMIT_GIB = 60.0
# Collaborative filtering at the Netflix Prize's size: users, items, ratings
# drawn per user (before the generator drops repeated pairs); K as in
# benchmarks/bench_algorithms.py.
CF_SHAPE = (480_189, 17_770, 209)
CF_K, CF_SWEEPS, CF_LAM = 16, 3, 0.05
# The ratings are uniform random (no structure to learn), and gradient
# descent with one step size is stable only below about 1/(the largest
# degree x the mean rating): a popular item is rated by every user.  So the
# factors start where every prediction is the mean rating (a 2% spread), the
# step is that bound, and 3 sweeps can only fit the residual means: the RMSE
# falls just below the mean rating's.  GraphMat's and the native CF differ
# only in the order of their sums (atomics on the card), so they are held
# to CF_TOL times the largest change the sweeps made to p (under 1% of p's
# size, which a tolerance on p would not see).
CF_INIT_SPREAD = 0.02
CF_TOL = 1e-3


# Whole runs of GraphMat and native are timed in 3 turns, each call after
# one warm-up call.
TURNS = {"iters": 1, "repeats": 3, "warmup": 1}


def plan_name(plan) -> str:
  extra = ",".join(f"{k}={v}" for k, v in plan.kernel_kwargs().items())
  return plan.backend + (f"[{extra}]" if extra else "")


def phase_suite_graph(g, edges: dict, ell_mod) -> dict:
  """PageRank, BFS and SSSP: GraphMat through the kernel against the native
  baselines on the phase-3 graph's edges; then the autotuned plans."""
  import numpy as np
  import torch
  from repro_torch.algos import bfs, pagerank, sssp
  from repro_torch.algos.multi import bfs_columns, multi_bfs_program
  from repro_torch.algos.native import (native_bfs, native_pagerank,
                                        native_sssp)
  from repro_torch.algos.pagerank import init_prop, pagerank_program
  from repro_torch.core.backends import Plan, Planner

  kernel = Plan(backend="cuda_ell")
  n, root = g.n, edges["root"]
  src = torch.from_numpy(edges["src"].astype(np.int64)).cuda()
  dst = torch.from_numpy(edges["dst"].astype(np.int64)).cuda()
  w = torch.from_numpy(edges["w"]).cuda()
  out_deg = torch.bincount(src, minlength=n).to(torch.float32)
  runs = {
      "pagerank": (lambda: pagerank(g, out_deg, num_iters=20, backend=kernel),
                   lambda: native_pagerank(src, dst, out_deg, n, 20)),
      "bfs": (lambda: bfs(g, root, n, backend=kernel),
              lambda: native_bfs(src, dst, n, root)),
      "sssp": (lambda: sssp(g, root, n, backend=kernel),
               lambda: native_sssp(src, dst, w, n, root)),
  }
  ell_mod.launches.reset()
  got = {algo: gm() for algo, (gm, _) in runs.items()}
  torch.cuda.synchronize()
  launches = dict(ell_mod.launches.by_config)
  if ell_mod.launches.total == 0:
    raise AssertionError("phase 5: GraphMat never launched the kernel")
  out = {"launches": launches}
  for algo, (gm, nat) in runs.items():
    want = nat()
    if algo == "pagerank":
      torch.testing.assert_close(got[algo], want, rtol=1e-4, atol=0.0)
    elif not torch.equal(got[algo], want):
      raise AssertionError(f"phase 5: GraphMat {algo} != native {algo}")
    err = float((got[algo].double() - want.double()).abs().max()) if (
        algo == "pagerank") else 0.0
    gm_ms, nat_ms = paired_ms(gm, nat, **TURNS)
    out[algo] = {"graphmat_ms": gm_ms, "native_ms": nat_ms,
                 "ratio": gm_ms / nat_ms, "max_abs_err": err}
    log(f"phase 5: {algo} on RMAT-{int(np.log2(n))}: GraphMat (cuda_ell) "
        f"{gm_ms:.3f} ms, native {nat_ms:.3f} ms, ratio "
        f"{gm_ms / nat_ms:.3f} (paper {PAPER_TABLE3[algo]}); "
        + ("equal bitwise" if algo != "pagerank"
           else f"max abs err {err:.3g} at rtol 1e-4"))
  del got
  log(f"phase 5: kernel launches of GraphMat's PageRank, BFS and SSSP "
      f"{launches}")

  # Measured planning on the same graph: PageRank (Q = 1) and BFS at Q = 8.
  planner = Planner()
  tuned = {}
  pr_prog, bfs_prog = pagerank_program(), multi_bfs_program()
  every = torch.ones((n,), dtype=torch.bool, device="cuda")
  dist0, active0 = bfs_columns(
      torch.as_tensor(edges["sources"][:8], device="cuda"), n)
  for name, prog, prop, active, q in (
      ("pagerank,Q=1", pr_prog, init_prop(out_deg), every, 1),
      ("bfs,Q=8", bfs_prog, dist0, active0, 8)):
    t0 = time.perf_counter()
    best = planner.autotune(g, prog, prop, active, num_iters=2, repeats=3)
    seconds = time.perf_counter() - t0
    (measured,) = [v for k, v in planner.timings.items() if k[1:] == (
        prog.name, q)]
    table = {plan_name(p): (None if t is None else t * 1e3)
             for p, t in measured}
    heuristic = planner.plan(g, prog, q)
    tuned[name] = {"ms_per_2_supersteps": table, "winner": plan_name(best),
                   "heuristic": plan_name(heuristic), "seconds": seconds}
    log(f"phase 5: autotune {name} (2 supersteps, median of 3, ms): "
        + ", ".join(f"{k} {'skipped' if v is None else f'{v:.3f}'}"
                    for k, v in table.items())
        + f"; winner {plan_name(best)}; Planner.plan picks "
        f"{plan_name(heuristic)} ({seconds:.1f} s)")
  out["autotune"] = tuned
  return out


def scipy_triangles(src, dst, n: int, chunk: int = 4096) -> int:
  """Independent host count on the DAG's CSR A: Σ over row chunks R of
  (A[R] @ A) ∘ A[R]; chunks keep the product within host memory, since the
  hubs make A @ A dense in places."""
  import numpy as np
  import scipy.sparse as sp
  a = sp.csr_matrix((np.ones(src.shape[0], np.int64), (src, dst)),
                    shape=(n, n))
  return int(sum(int((a[lo:lo + chunk] @ a).multiply(a[lo:lo + chunk]).sum())
                 for lo in range(0, n, chunk)))


CF_KERNEL_SWEEPS = 2


def cf_on_kernel(users, items, ratings, g2u, g2i, p0, gamma: float,
                 ell_mod, ref_mod) -> tuple:
  """Collaborative filtering at the Netflix Prize's size with the
  reference CF's process and apply on its latent matrix as the one leaf
  (the program the reference's ``_pallas_eligible`` passes): the
  item-to-user graph built as ELL, phase U through ``Plan("cuda_ell")``
  (the lane-vector grid, K = 16), phase V where ``Planner.plan`` sends it;
  ``CF_KERNEL_SWEEPS`` sweeps held to the port's ``collaborative_filtering``
  through ``Plan("coo")`` from the same ``p0`` within ``CF_TOL`` times the
  largest change the sweeps made; a sweep's host-clock seconds both ways;
  the kernel's row of the kernels line on the first sweep's phase-U call,
  and the COO kernel's on phase V's.
  """
  import numpy as np
  import torch
  from repro_torch.algos import collaborative_filtering
  from repro_torch.kernels import coo_spmv as coo_mod
  from repro_torch.core.backends import Plan, Planner
  from repro_torch.core.engine import run_fixed_iters
  from repro_torch.core.graph import build_ell
  from repro_torch.core.vertex_program import GraphProgram
  nu, ni, _ = CF_SHAPE
  ncf = nu + ni
  t0 = time.perf_counter()
  g2u_ell = build_ell(items + nu, users, ratings, n=ncf, device="cuda")
  torch.cuda.synchronize()
  t_build = time.perf_counter() - t0
  spilled = 0 if g2u_ell.spill is None else int(g2u_ell.spill.emask.sum())
  prog = GraphProgram(
      process_message=traced_programs()["cf_one_leaf"].fn, reduce_kind="add",
      apply=lambda red, old: old + gamma * (red - CF_LAM * old),
      process_reads_dst=True, name="cf_one_leaf")
  kernel, coo = Plan("cuda_ell"), Plan("coo")
  v_plan = Planner().plan(g2i, prog)
  every = torch.ones((ncf,), dtype=torch.bool, device="cuda")

  def sweeps(count):
    p = p0
    for _ in range(count):
      p = run_fixed_iters(g2u_ell, prog, p, every, 1, backend=kernel).prop
      p = run_fixed_iters(g2i, prog, p, every, 1, backend=v_plan).prop
    return p

  def plain(count):
    return collaborative_filtering(g2u, g2i, ncf, CF_K, num_iters=count,
                                   gamma=gamma, lam=CF_LAM, p0=p0,
                                   backend=coo)

  ell_mod.launches.reset()
  coo_mod.launches.reset()
  coo_mod.torch_path.update(dict.fromkeys(coo_mod.torch_path, 0))
  p_k = sweeps(CF_KERNEL_SWEEPS)
  torch.cuda.synchronize()
  launches = dict(ell_mod.launches.by_config)
  coo_launches = dict(coo_mod.launches.by_config)
  coo_torch_path = dict(coo_mod.torch_path)
  if ell_mod.launches.total == 0:
    raise AssertionError("phase 5: CF on cuda_ell never launched the kernel")
  if coo_mod.launches.total == 0:
    raise AssertionError("phase 5: CF's phase V never launched the COO "
                         "kernel")
  p_c = plain(CF_KERNEL_SWEEPS)
  if not bool(torch.isfinite(p_k).all()):
    raise AssertionError("phase 5: CF on cuda_ell: non-finite factors")
  err = float((p_k - p_c).abs().max())
  change = float((p_c - p0).abs().max())
  (_, sweep_s) = timed(lambda: sweeps(1))
  (_, sweep_coo_s) = timed(lambda: plain(1))
  log(f"phase 5: CF (one-leaf process, K={CF_K}) at the Netflix Prize's "
      f"size: item-to-user ELL width {g2u_ell.width}, {spilled:,} of "
      f"{len(users):,} ratings spilled (built in {t_build:.1f} s); phase U "
      f"through cuda_ell, phase V through {plan_name(v_plan)}; kernel "
      f"launches {launches}, COO kernel launches {coo_launches}, CUDA calls "
      f"on the PyTorch path {coo_torch_path}; {CF_KERNEL_SWEEPS} sweeps: "
      f"max|cuda_ell - "
      f"coo| {err:.3g} (max change {change:.3g}); a sweep {sweep_s:.3f} s "
      f"against {sweep_coo_s:.3f} s through coo (host clock)")
  if not err <= CF_TOL * change:
    raise AssertionError(f"phase 5: CF on cuda_ell != coo ({err:.3g} > "
                         f"{CF_TOL} x {change:.3g})")
  record = {"width": g2u_ell.width, "spilled": spilled, "build_s": t_build,
            "phase_v_plan": plan_name(v_plan), "launches": launches,
            "coo_launches": coo_launches, "coo_torch_path": coo_torch_path,
            "sweeps": CF_KERNEL_SWEEPS, "max_abs_err": err,
            "max_change": change, "sweep_s": sweep_s,
            "sweep_coo_s": sweep_coo_s}
  del p_k, p_c
  expr = traced_expr("cf_one_leaf", torch.float32, True, CF_K)
  gen = torch.Generator(device="cuda").manual_seed(5)
  dprop = p0[g2u_ell.row_of.clamp(max=ncf - 1)].contiguous()
  entry, record["row"] = time_ell(
      "phase 5", g2u_ell, ell_mod, ref_mod, gen, {},
      f"ell_spmv[cf_one_leaf,f32,add,K={CF_K},netflix,traced]", expr, "add",
      torch.float32, CF_K, CF_K, "src/repro/kernels/ell_spmv.py:192",
      [(p0, every)], launches, dprop=dprop, exact=False,
      library_null="no single PyTorch call sums (e - m.d) m over a row's "
      "edges")
  del g2u_ell, dprop
  torch.cuda.empty_cache()
  # Phase V's call: the COO kernel's lane-mixing instance on the
  # user-to-item graph, every source active.
  coo_entry, record["coo_row"] = time_coo(
      "phase 5", f"coo_spmv[cf_one_leaf,f32,add,K={CF_K},netflix,traced]",
      g2i, p0, every, p0, prog, coo_launches,
      tiled=v_plan.backend == "coo_tiled",
      library_null="no single PyTorch call sums (e - m.d) m over a run's "
      "edges")
  return record, [entry, coo_entry]


def phase_suite_tc_cf(ell_mod, ref_mod, seed: int = 11) -> tuple:
  """Triangle counting and collaborative filtering, GraphMat against the
  native baselines and an independent check each; then CF with the
  one-leaf process on the kernel (:func:`cf_on_kernel`).  Returns the
  record and the kernels line's CF rows."""
  import numpy as np
  import torch
  from repro_torch.algos import collaborative_filtering, triangle_count
  from repro_torch.algos.collab_filter import build_bipartite
  from repro_torch.algos.native import native_cf, native_tc
  from repro_torch.core.backends import Plan
  from repro_torch.core.graph import build_coo
  from repro_torch.graphs import (bipartite_ratings, dag_orient,
                                  remove_self_loops, rmat_edges)
  from repro_torch.graphs.rmat import RMAT_TC

  coo = Plan(backend="coo")
  out = {}
  t0 = time.perf_counter()
  ts, td = remove_self_loops(*rmat_edges(TC_SCALE, 16, RMAT_TC, seed=seed))
  ts, td = dag_orient(ts, td)
  n = 1 << TC_SCALE
  fwd, rev = build_coo(ts, td, n=n), build_coo(td, ts, n=n)
  src = torch.from_numpy(ts.astype(np.int64)).cuda()
  dst = torch.from_numpy(td.astype(np.int64)).cuda()
  t_build = time.perf_counter() - t0
  gib = 2.0**30
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  got = int(triangle_count(fwd, rev, n, backend=coo))
  peak_gm = torch.cuda.max_memory_allocated() / gib
  torch.cuda.reset_peak_memory_stats()
  nat = int(native_tc(src, dst, n))
  peak_nat = torch.cuda.max_memory_allocated() / gib
  t0 = time.perf_counter()
  host = scipy_triangles(ts, td, n)
  t_host = time.perf_counter() - t0
  log(f"phase 5: TC on RMAT-{TC_SCALE} (abc {RMAT_TC}, {ts.shape[0]:,} DAG "
      f"edges, built in {t_build:.1f} s): GraphMat {got:,}, native {nat:,}, "
      f"scipy {host:,} ({t_host:.1f} s); peak device memory GraphMat "
      f"{peak_gm:.2f} GiB, native {peak_nat:.2f} GiB")
  if not got == nat == host:
    raise AssertionError("phase 5: triangle counts disagree")
  if peak_gm > TC_PEAK_LIMIT_GIB:
    raise AssertionError(f"phase 5: TC peak {peak_gm:.2f} GiB is over "
                         f"{TC_PEAK_LIMIT_GIB} GiB")
  gm_ms, nat_ms = paired_ms(
      lambda: triangle_count(fwd, rev, n, backend=coo),
      lambda: native_tc(src, dst, n), **TURNS)
  out["tc"] = {"scale": TC_SCALE, "n": n, "dag_edges": int(ts.shape[0]),
               "triangles": got, "peak_gib": peak_gm,
               "native_peak_gib": peak_nat, "graphmat_ms": gm_ms,
               "native_ms": nat_ms, "ratio": gm_ms / nat_ms,
               "scipy_s": t_host, "build_s": t_build}
  log(f"phase 5: TC GraphMat (coo) {gm_ms:.3f} ms, native {nat_ms:.3f} ms, "
      f"ratio {gm_ms / nat_ms:.3f} (paper {PAPER_TABLE3['tc']})")
  out["tc"]["profile"] = device_busy(
      lambda: triangle_count(fwd, rev, n, backend=coo))
  out["tc"]["native_profile"] = device_busy(lambda: native_tc(src, dst, n))
  log(busy_line("phase 5: TC GraphMat", out["tc"]["profile"]))
  log(busy_line("phase 5: TC native", out["tc"]["native_profile"]))
  del fwd, rev, src, dst
  torch.cuda.empty_cache()

  # Collaborative filtering at the Netflix Prize's size.
  nu, ni, per_user = CF_SHAPE
  t0 = time.perf_counter()
  users, items, ratings = bipartite_ratings(nu, ni, per_user, seed=seed)
  g2u, g2i, ncf = build_bipartite(users, items, ratings, nu, ni)
  u = torch.from_numpy(users.astype(np.int64)).cuda()
  i = torch.from_numpy(items.astype(np.int64)).cuda() + nu
  r = torch.from_numpy(ratings).cuda()
  torch.cuda.synchronize()
  t_build = time.perf_counter() - t0
  mean = float(ratings.mean(dtype=np.float64))
  max_deg = int(max(np.bincount(users).max(), np.bincount(items).max()))
  gamma = 1.0 / (max_deg * mean)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  p0 = (mean / CF_K) ** 0.5 * (1.0 + CF_INIT_SPREAD * (
      torch.rand((ncf, CF_K), generator=gen, device="cuda") - 0.5))

  def rmse(p):
    pred = (p[u] * p[i]).sum(dim=-1)
    return float((pred.double() - r.double()).pow(2).mean().sqrt())

  def gm():
    return collaborative_filtering(g2u, g2i, ncf, CF_K, num_iters=CF_SWEEPS,
                                   gamma=gamma, lam=CF_LAM, p0=p0, backend=coo)

  def nat():
    return native_cf(u, i, r, ncf, CF_K, CF_SWEEPS, gamma, CF_LAM, p0=p0)

  torch.cuda.reset_peak_memory_stats()
  p_gm = gm()
  peak_gm = torch.cuda.max_memory_allocated() / gib
  p_nat, p_nat2 = nat(), nat()
  base = float((r.double() - mean).pow(2).mean().sqrt())
  init, got_rmse, nat_rmse = rmse(p0), rmse(p_gm), rmse(p_nat)
  change = float((p_nat - p0).abs().max())
  err = float((p_gm - p_nat).abs().max())
  noise = float((p_nat2 - p_nat).abs().max())
  scale = float(p_nat.abs().max())
  log(f"phase 5: CF on {len(users):,} ratings ({nu:,} users, {ni:,} items, "
      f"{per_user} drawn a user, built in {t_build:.1f} s), K={CF_K}, "
      f"{CF_SWEEPS} sweeps, gamma {gamma:.4g}: RMSE {init:.6f} -> GraphMat "
      f"{got_rmse:.6f}, native {nat_rmse:.6f}; the mean rating's {base:.6f}; "
      f"max|GraphMat - native| {err:.3g} (native run to run {noise:.3g}; "
      f"max change {change:.3g}, max|p| {scale:.3g}); peak device memory "
      f"{peak_gm:.2f} GiB")
  if not (np.isfinite(got_rmse) and got_rmse < base and got_rmse < init):
    raise AssertionError("phase 5: CF's RMSE did not fall below the mean "
                         "rating's")
  if not err <= CF_TOL * change:
    raise AssertionError(f"phase 5: GraphMat CF != native CF ({err:.3g} > "
                         f"{CF_TOL} x {change:.3g})")
  del p_gm, p_nat, p_nat2
  gm_ms, nat_ms = paired_ms(gm, nat, **TURNS)
  out["cf"] = {"users": nu, "items": ni, "drawn_per_user": per_user,
               "ratings": int(len(users)), "k": CF_K, "sweeps": CF_SWEEPS,
               "gamma": gamma, "rmse_init": init, "rmse": got_rmse,
               "rmse_native": nat_rmse, "rmse_mean_rating": base,
               "max_abs_err": err, "native_run_to_run": noise,
               "max_change": change, "max_abs_p": scale,
               "peak_gib": peak_gm, "graphmat_ms": gm_ms,
               "native_ms": nat_ms, "ratio": gm_ms / nat_ms,
               "build_s": t_build}
  log(f"phase 5: CF GraphMat (coo) {gm_ms:.3f} ms, native {nat_ms:.3f} ms "
      f"for {CF_SWEEPS} sweeps, ratio {gm_ms / nat_ms:.3f} (paper "
      f"{PAPER_TABLE3['cf']})")
  out["cf"]["profile"] = device_busy(gm)
  out["cf"]["native_profile"] = device_busy(nat)
  log(busy_line("phase 5: CF GraphMat", out["cf"]["profile"]))
  log(busy_line("phase 5: CF native", out["cf"]["native_profile"]))
  out["cf_kernel"], cf_entries = cf_on_kernel(users, items, ratings, g2u,
                                              g2i, p0, gamma, ell_mod,
                                              ref_mod)
  return out, cf_entries


def table3(suite: dict) -> dict:
  """The five graphmat/native ratios, their geomean, and the geomean of the
  four the paper has, beside the paper's."""
  ratios = {a: suite[a]["ratio"] for a in PAPER_TABLE3}

  def geomean(vals):
    return math.exp(sum(math.log(v) for v in vals) / len(vals))
  paper_four = [a for a, v in PAPER_TABLE3.items() if v is not None]
  return {"ratios": ratios, "paper": PAPER_TABLE3,
          "geomean": geomean(ratios.values()),
          "geomean_paper_four": geomean([ratios[a] for a in paper_four]),
          "paper_geomean": PAPER_GEOMEAN}


# ---------------------------------------------------------------------------
# Phase 6: the selective-scan kernel against plain, and its time
# ---------------------------------------------------------------------------

FALCON_SCAN = (4, 2048, 8192, 16)  # B, S, d_inner, N of the phase-7 prefill


def scan_inputs(gen, b, s, c, n):
  """u, dt, a, bmat, cmat on the card (the reference kernel test's draws)."""
  import torch
  dev = "cuda"
  u = torch.randn((b, s, c), generator=gen, device=dev)
  dt = torch.nn.functional.softplus(
      torch.randn((b, s, c), generator=gen, device=dev)) * 0.1
  a = -torch.exp(torch.randn((c, n), generator=gen, device=dev))
  bm = torch.randn((b, s, n), generator=gen, device=dev)
  cm = torch.randn((b, s, n), generator=gen, device=dev)
  return u, dt, a, bm, cm


def compare_scan(y, yr, atol: float, what: str) -> float:
  """Raise unless kernel y agrees with plain yr (NaN where it has NaN);
  returns the max absolute difference over finite entries."""
  import torch
  if not torch.equal(torch.isnan(y), torch.isnan(yr)):
    raise AssertionError(f"{what}: NaN entries differ")
  torch.testing.assert_close(y, yr, rtol=2e-4, atol=atol, equal_nan=True,
                             msg=lambda m: f"{what}: {m}")
  fin = torch.isfinite(yr)
  return float((y[fin] - yr[fin]).abs().max()) if fin.any() else 0.0


def scan_bound(b, s, c, n, sm_clock_hz: float) -> dict:
  """The least time for one launch, the larger of two floors.  Bytes: u, dt
  read once, y written once, a, bmat, cmat read once, at the data-sheet
  rate.  Operations: the float32 arithmetic (dt·u once per (b,s,c); per
  (b,s,c,n) dt·a, exp, dtu·B, the h update's multiply-add and y's = 7) at
  the data-sheet rate, and the exponentials at the SFU rate and the card's
  max SM clock; the two units run side by side, so the slower one sets the
  operations' floor."""
  nbytes = 4 * (3 * b * s * c + c * n + 2 * b * s * n)
  ops = b * s * c * (1 + 7 * n)
  bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
  f32_ms = ops / H100_F32_OPS_PER_S * 1e3
  sfu_ms = b * s * c * n / (H100_SMS * SFU_PER_CLOCK_PER_SM * sm_clock_hz) * 1e3
  ops_ms = max(f32_ms, sfu_ms)
  return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
          "f32_ops_ms": f32_ms, "sfu_exp_ms": sfu_ms, "ops_ms": ops_ms,
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_scan(ss_mod, ref_fn) -> dict:
  import torch
  gen = torch.Generator(device="cuda").manual_seed(11)
  b, s, c, _ = FALCON_SCAN
  chosen = ss_mod.lanes_for(b, c)
  cases = []  # (shape, (seq_chunk, c_tile), kind)
  for shape in [(1, 16, 8, 4), (2, 32, 16, 8), (2, 64, 32, 16)]:
    for sc, ct in [(8, 8), (16, 16)]:
      cases.append((shape, (sc, ct), "random"))
  # Every choice of lanes per channel (lanes_for picks it from B·C).
  for bb in (1, 2, 4):
    cases.append(((bb, 64, c, 16), (64, c), "random"))
  # Edge cases at the prefill shape's B and C, so at its lanes.
  for n in (4, 8, 16):
    cases += [((b, 100, c, n), (100, c), "S=100, not a multiple of the "
               "16-step run"),
              ((b, 64, c + 8, n), (64, c + 8), f"C={c + 8}, not a multiple "
               "of the block's channels"),
              ((b, 64, c, n), (64, c), "dt=0"),
              ((b, 64, c, n), (64, c), "large dt"),
              ((b, 64, c, n), (64, c), "NaN in u")]
  cases.append(((b, 48, c, 5), (16, c), "N=5, below the compiled width 8"))
  max_err, lanes_run = 0.0, set()
  for shape, (sc, ct), kind in cases:
    u, dt, a, bm, cm = scan_inputs(gen, *shape)
    if kind == "dt=0":
      dt.zero_()
    elif kind == "large dt":
      dt = 1e5 * (1.0 + torch.rand(dt.shape, generator=gen, device="cuda"))
      if float(dt.min() * a.abs().min()) < 104.0:
        raise AssertionError("large-dt case: exp(dt·a) does not underflow")
      # u scaled down so that dt·u and y stay of order 1, where the
      # absolute tolerance means something.
      u = u * 1e-5
    elif kind == "NaN in u":
      u[0, 10, 5] = float("nan")
      u[1, 0, 77] = float("nan")
    y = ss_mod.selective_scan(u, dt, a, bm, cm, seq_chunk=sc, c_tile=ct)
    yr = ref_fn(u, dt, a, bm, cm)
    torch.cuda.synchronize()
    lanes = ss_mod.lanes_for(shape[0], shape[2])
    lanes_run.add(lanes)
    what = f"{shape} chunks {(sc, ct)} lanes {lanes} {kind}"
    if kind == "dt=0" and y.any():
      raise AssertionError(f"{what}: state left 0")
    if kind == "NaN in u" and not (torch.isnan(y[0, 10:, 5]).all()
                                   and torch.isnan(y[1, :, 77]).all()):
      raise AssertionError(f"{what}: NaN did not reach the output")
    if kind != "random" and lanes != chosen:
      raise AssertionError(f"{what}: not at the prefill's {chosen} lanes")
    max_err = max(max_err, compare_scan(y, yr, 2e-5, what))
  if lanes_run != set(ss_mod.LANE_CHOICES):
    raise AssertionError(f"the sweep ran lanes {sorted(lanes_run)} only")
  log(f"phase 6: scan kernel == plain on {len(cases)} cases, lanes "
      f"{sorted(lanes_run)}, edge cases at {chosen} (max abs err "
      f"{max_err:.3g})")

  # Full width, at the prefill shape and at one batch row.
  out = {"sweep_cases": len(cases), "sweep_max_abs_err": max_err,
         "lanes": chosen}
  sm_clock = max_sm_clock_hz()
  for shape in (FALCON_SCAN, (1,) + FALCON_SCAN[1:]):
    args = scan_inputs(gen, *shape)
    yr = ref_fn(*args)
    torch.cuda.synchronize()
    scale = float(yr.abs().max())
    y = ss_mod.selective_scan(*args)
    err = compare_scan(y, yr, 2e-5 * scale, f"full width {shape}")
    del y
    kernel_ms = cuda_ms(lambda: ss_mod.selective_scan(*args))
    bound = scan_bound(*shape, sm_clock)
    lanes = ss_mod.lanes_for(shape[0], shape[2])
    if shape == FALCON_SCAN:
      plain_ms = cuda_ms(lambda: ref_fn(*args), iters=2, warmup=1)
      out.update(full_width_max_abs_err=err, full_width_max_abs_y=scale,
                 ms=kernel_ms, plain_ms=plain_ms, bound=bound)
    else:
      out["b1"] = {"ms": kernel_ms, "max_abs_err": err, "max_abs_y": scale,
                   "lanes": lanes, "bound": bound}
    log(f"phase 6: {shape}, lanes {lanes}: {kernel_ms:.4f} ms, max|y| "
        f"{scale:.3g}, max abs err {err:.3g}, bound {bound['bound_ms']:.4f} "
        f"ms ({bound['bound_by']}; bytes {bound['bytes_ms']:.4f}, f32 ops "
        f"{bound['f32_ops_ms']:.4f}, exp at the SFU rate "
        f"{bound['sfu_exp_ms']:.4f})")
    del args, yr
    torch.cuda.empty_cache()
  log(f"phase 6: selective_scan at {FALCON_SCAN}: {out['ms']:.4f} ms, plain "
      f"{out['plain_ms']:.2f} ms, max abs err {out['full_width_max_abs_err']:.3g}")
  return out


# ---------------------------------------------------------------------------
# Phase 7: the LM serving slice at full width
# ---------------------------------------------------------------------------


def phase_lm(ss_mod, seed: int = 0) -> dict:
  import torch
  from repro_torch import configs
  from repro_torch._tree import tree_leaves, tree_map
  from repro_torch.models.common import init_params, num_params
  from repro_torch.models.transformer import build_model
  from repro_torch.serve import generate, make_decode_step, make_prefill

  cfg = configs.get_config("falcon_mamba_7b").scaled(ssm_impl="fused")
  model = build_model(cfg)
  vocab = cfg.vocab_size
  torch.cuda.reset_peak_memory_stats()
  gen = torch.Generator(device="cuda").manual_seed(seed)
  t0 = time.perf_counter()
  params = init_params(model.defs(), gen)
  torch.cuda.synchronize()
  t_init = time.perf_counter() - t0
  n_params = num_params(model.defs())
  log(f"phase 7: {cfg.name} ({cfg.num_layers} layers, {n_params:,} params, "
      f"{n_params * 4 / 2**30:.2f} GiB f32) initialized in {t_init:.3f} s")

  b, s = 4, 2048
  tokens = torch.randint(0, vocab, (b, s), generator=gen, device="cuda",
                         dtype=torch.int32)
  prefill = make_prefill(model)
  ss_mod.launches = 0
  t0 = time.perf_counter()
  logits = prefill(params, {"tokens": tokens})
  torch.cuda.synchronize()
  t_first = time.perf_counter() - t0
  launches = ss_mod.launches
  if launches != cfg.num_layers:
    raise AssertionError(f"prefill launched the scan kernel {launches} "
                         f"times, not once per layer ({cfg.num_layers})")
  if logits.shape != (b, s, cfg.padded_vocab(1)):
    raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
  if not torch.isfinite(logits).all():
    raise AssertionError("prefill logits are not finite")
  del logits
  prefill_ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), iters=3,
                       warmup=1)
  log(f"phase 7: prefill {b}x{s} tokens: {launches} scan launches, finite "
      f"logits; first call {t_first:.3f} s, then {prefill_ms:.2f} ms "
      f"(CUDA events)")

  # The same prompts cut to 32 tokens: prefill (fused scan) against the
  # decode path (recurrence, no kernel), then generate's greedy tokens.
  p, new = 32, 16
  short = tokens[:, :p].contiguous()
  ss_mod.launches = 0
  pre_last = prefill(params, {"tokens": short})[:, -1, :vocab].float()
  if ss_mod.launches != cfg.num_layers:
    raise AssertionError("short prefill did not launch once per layer")
  step = make_decode_step(model)
  cache = model.init_cache(b, p + new)
  ss_mod.launches = 0
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  timed_from = 4
  for i in range(p):
    if i == timed_from:
      start.record()
    logits, cache = step(params, short[:, i:i + 1], cache, i)
  end.record()
  end.synchronize()
  decode_ms = start.elapsed_time(end) / (p - timed_from)
  dec_last = logits[:, -1, :vocab].float()
  out = generate(model, params, short, max_new=new)
  torch.cuda.synchronize()
  if ss_mod.launches != 0:
    raise AssertionError("the decode path launched the scan kernel")
  busy_prefill = device_busy(lambda: prefill(params, {"tokens": tokens}))
  log(busy_line(f"phase 7: prefill {b}x{s}", busy_prefill))
  busy_decode = device_busy(lambda: step(params, short[:, :1], cache, p))
  log(busy_line(f"phase 7: decode step B={b}", busy_decode))
  if out.shape != (b, p + new) or not torch.equal(out[:, :p], short):
    raise AssertionError(f"generate returned {tuple(out.shape)}")
  if not ((out >= 0) & (out < vocab)).all():
    raise AssertionError("generated token out of range")
  if not torch.isfinite(dec_last).all():
    raise AssertionError("decode logits are not finite")
  scale = float(pre_last.abs().max())
  err = float((pre_last - dec_last).abs().max())
  log(f"phase 7: prefill vs decode logits after {p} tokens: max abs err "
      f"{err:.4g}, max|logit| {scale:.4g} ({err / scale:.4g} of it; "
      f"tolerance {PREFILL_DECODE_TOL})")
  if err > PREFILL_DECODE_TOL * scale:
    raise AssertionError("prefill and decode logits disagree")
  top2 = torch.topk(pre_last, 2, dim=-1).values
  sure = (top2[:, 0] - top2[:, 1]) > 2 * err  # no error can flip the argmax
  agree = pre_last.argmax(-1) == out[:, p]
  if not agree[sure].all():
    raise AssertionError("prefill argmax != first generated token where the "
                         "top-2 margin exceeds twice the error")
  log(f"phase 7: decode step {decode_ms:.2f} ms at B={b}; generate: "
      f"{new} tokens; prefill argmax == first generated token for "
      f"{int(agree.sum())}/{b} prompts ({int(sure.sum())} with a top-2 margin "
      f"above twice the error)")

  # Prefill against decode again in float32 compute (the same weights).
  m32 = build_model(cfg.scaled(dtype="float32"))
  ss_mod.launches = 0
  pre32 = make_prefill(m32)(params, {"tokens": short})[:, -1, :vocab]
  if ss_mod.launches != cfg.num_layers:
    raise AssertionError("f32 prefill did not launch once per layer")
  step32 = make_decode_step(m32)
  cache = m32.init_cache(b, p)
  for i in range(p):
    logits, cache = step32(params, short[:, i:i + 1], cache, i)
  dec32 = logits[:, -1, :vocab]
  del cache, logits
  scale32 = float(pre32.abs().max())
  err32 = float((pre32 - dec32).abs().max())
  top2 = torch.topk(pre32, 2, dim=-1).values
  sure32 = (top2[:, 0] - top2[:, 1]) > 2 * err32
  agree32 = pre32.argmax(-1) == dec32.argmax(-1)
  log(f"phase 7: f32 compute, prefill vs decode logits after {p} tokens: "
      f"max abs err {err32:.4g}, max|logit| {scale32:.4g} "
      f"({err32 / scale32:.4g} of it; tolerance {PREFILL_DECODE_F32_TOL}); "
      f"argmax equal for {int(agree32.sum())}/{b} ({int(sure32.sum())} "
      f"with a top-2 margin above twice the error)")
  if err32 > PREFILL_DECODE_F32_TOL * scale32 or not agree32[sure32].all():
    raise AssertionError("f32 prefill and decode logits disagree")

  # Casting every matrix to bf16, as each forward and decode step does.
  mats = [params["lm_head"], *tree_leaves(params["layers"])]

  def cast_all():
    for t in mats:
      t.to(cfg.compute_dtype)  # each copy is freed at once, as in a layer

  cast_ms = cuda_ms(cast_all, iters=3, warmup=1)

  # forward, fused against assoc: 2 layers, B=1, S=512.
  cfg2 = cfg.scaled(num_layers=2)
  two = {**params, "layers": tree_map(lambda t: t[:2], params["layers"])}
  batch = {"tokens": tokens[:1, :512]}
  with torch.inference_mode():
    lf = build_model(cfg2).forward(two, batch)[0].float()
    la = build_model(cfg2.scaled(ssm_impl="assoc")).forward(two, batch)[0]
  la = la.float()
  fa_scale = float(la.abs().max())
  fa_err = float((lf - la).abs().max())
  log(f"phase 7: forward fused vs assoc (2 layers, 1x512): max abs err "
      f"{fa_err:.4g}, max|logit| {fa_scale:.4g} ({fa_err / fa_scale:.4g} of "
      f"it; tolerance {FUSED_ASSOC_TOL})")
  if not (torch.isfinite(lf).all() and fa_err <= FUSED_ASSOC_TOL * fa_scale):
    raise AssertionError("fused and assoc forward disagree")
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  log(f"phase 7: weight cast f32->bf16 {cast_ms:.2f} ms per forward or "
      f"step; peak device memory {peak_gib:.2f} GiB")
  return {"config": cfg.name, "num_layers": cfg.num_layers,
          "params": n_params, "init_s": t_init, "prefill_batch": [b, s],
          "prefill_first_s": t_first, "prefill_ms": prefill_ms,
          "scan_launches_per_prefill": launches,
          "decode_step_ms": decode_ms, "decode_batch": b,
          "prefill_profile": busy_prefill, "decode_profile": busy_decode,
          "weight_cast_ms": cast_ms,
          "prefill_decode_max_abs_err": err, "prefill_max_abs_logit": scale,
          "argmax_agree": int(agree.sum()), "argmax_sure": int(sure.sum()),
          "f32_prefill_decode_max_abs_err": err32,
          "f32_prefill_max_abs_logit": scale32,
          "fused_assoc_max_abs_err": fa_err,
          "fused_assoc_max_abs_logit": fa_scale,
          "peak_device_gib": peak_gib}


# ---------------------------------------------------------------------------
# Phase 8: the 2-D distributed runner on the card
# ---------------------------------------------------------------------------

DIST_GRIDS = ((2, 2, "gloo"), (1, 1, "nccl"))  # R, C, process-group backend
DIST_QUERIES = 8
DIST_PR_ITERS = 20
DIST_SHUFFLE_SEED = 3  # examples/distributed_pagerank.py's relabelling


def prepare_2d(edges: dict, n: int, out_dir: pathlib.Path) -> dict:
  """Relabel the phase-3 edges with ``shuffle_vertices`` (so that block
  populations balance) and partition them once for each grid of phase 8,
  here in the parent: each rank maps its own block from ``out_dir``."""
  import numpy as np
  from repro_torch.core.distributed import partition_2d
  from repro_torch.graphs import shuffle_vertices
  t0 = time.perf_counter()
  src, dst, perm = shuffle_vertices(edges["src"], edges["dst"], n,
                                    seed=DIST_SHUFFLE_SEED)
  out = {"src": src, "dst": dst, "w": edges["w"], "n": n,
         "root": int(perm[edges["root"]]),
         "sources": perm[edges["sources"][:DIST_QUERIES]].tolist(),
         "grids": {}}
  for R, C, _ in DIST_GRIDS:
    dg = partition_2d(src, dst, edges["w"], n=n, R=R, C=C)
    path = out_dir / f"{R}x{C}"
    dg.save(path)
    np.save(path / "out_deg.npy",
            np.bincount(src, minlength=dg.n_pad).astype(np.float32))
    pop = dg.emask.sum(axis=-1)
    out["grids"][f"{R}x{C}"] = {
        "dir": str(path), "n_pad": dg.n_pad,
        "capacity": int(dg.src.shape[-1]), "block_edges_max": int(pop.max()),
        "block_edges_mean": float(pop.mean())}
    del dg
  out["prepare_s"] = time.perf_counter() - t0
  log(f"phase 8: relabelled and partitioned in the parent in "
      f"{out['prepare_s']:.1f} s; block populations " + json.dumps(
          {k: {f: v[f] for f in ("block_edges_max", "block_edges_mean")}
               for k, v in out["grids"].items()}))
  return out


def pagerank_sweeps_program():
  """PageRank with every vertex active in every superstep, as the paper's
  fixed sweeps run (``run_fixed_iters`` re-arms the frontier).  Under the
  default frontier of changed vertices a vertex whose float32 rank stops
  changing drops out, so two runs that sum in other orders (the 2-D
  reduce against one device) would part by more than rounding."""
  import dataclasses
  import torch
  from repro_torch.algos.pagerank import pagerank_program
  return dataclasses.replace(
      pagerank_program(), name="pagerank_sweeps",
      activate=lambda old, new: torch.ones_like(new["deg"], dtype=torch.bool))


def rank_2d(grid, graph_dir: str, root: int, sources: list) -> dict:
  """One rank of phase 8 (a spawned process): BFS, SSSP, PageRank and
  batched BFS on its block, each once to warm up and once timed, then once
  more with the superstep split recorded."""
  import numpy as np
  import torch
  import torch.distributed as dist
  from repro_torch.algos.bfs import UNREACHED, bfs_program
  from repro_torch.algos.multi import bfs_columns, multi_bfs_program
  from repro_torch.algos.sssp import sssp_program
  from repro_torch.core import distributed as D
  from repro_torch.core.backends import Plan
  from repro_torch.kernels import ell_spmv

  torch.cuda.set_device(0)
  ell_spmv.launches.reset()
  dev = torch.device("cuda", 0)
  dg = D.DistGraph.load(graph_dir)
  block = dg.block(grid.i, grid.j, dev)
  n_pad = dg.n_pad
  one = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
  one[root] = True
  dist0 = torch.full((n_pad,), UNREACHED, dtype=torch.int32, device=dev)
  dist0[root] = 0
  sp0 = torch.full((n_pad,), float("inf"), device=dev)
  sp0[root] = 0.0
  deg = torch.from_numpy(np.load(pathlib.Path(graph_dir) / "out_deg.npy"))
  pr0 = {"rank": torch.ones((n_pad,), device=dev), "deg": deg.to(dev)}
  mb0, ma0 = bfs_columns(torch.tensor(sources, device=dev), n_pad)
  coo = Plan(backend="coo")
  runs = {
      "bfs": lambda t: D.run_graph_program_2d(
          block, bfs_program(), dist0, one, grid, backend=coo, timings=t),
      "sssp": lambda t: D.run_graph_program_2d(
          block, sssp_program(), sp0, one, grid, backend=coo, timings=t),
      "pagerank": lambda t: D.run_graph_program_2d(
          block, pagerank_sweeps_program(), pr0, torch.ones_like(one), grid,
          max_iters=DIST_PR_ITERS, backend=coo, timings=t),
      "multi_bfs": lambda t: D.run_graph_program_2d_batched(
          block, multi_bfs_program(), mb0, ma0, grid, backend=coo,
          timings=t),
  }
  out = {"edges": int(block.emask.sum())}
  for name, run in runs.items():
    run(None)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    fin = run(None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split: dict = {}
    run(split)
    res = {"wall_s": wall, "split_s": split,
           "supersteps": int(fin.iteration)}
    if grid.rank == 0:
      prop = fin.prop["rank"] if name == "pagerank" else fin.prop
      res["prop"] = prop.cpu()
      if name == "multi_bfs":
        res["iters"] = fin.iters.cpu()
    out[name] = res
  out["ell_launches"] = ell_spmv.launches.total
  return out


def phase_2d(prep: dict) -> dict:
  """The 2-D runner on the card against the single-device engine through
  ``Plan("coo")`` on the same relabelled edges."""
  import numpy as np
  import torch
  from repro_torch.algos.bfs import UNREACHED, bfs_program
  from repro_torch.algos.multi import bfs_columns, multi_bfs_program
  from repro_torch.algos.pagerank import pagerank_program
  from repro_torch.algos.sssp import sssp_program
  from repro_torch.core import distributed as D
  from repro_torch.core import graph as G
  from repro_torch.core.backends import Plan
  from repro_torch.core.engine import run_batched, run_graph_program

  n, root = prep["n"], prep["root"]
  coo = Plan(backend="coo")
  g = G.build_coo(prep["src"], prep["dst"], prep["w"], n=n, device="cuda")
  one = torch.zeros((n,), dtype=torch.bool, device="cuda")
  one[root] = True
  dist0 = torch.full((n,), UNREACHED, dtype=torch.int32, device="cuda")
  dist0[root] = 0
  sp0 = torch.full((n,), float("inf"), device="cuda")
  sp0[root] = 0.0
  deg = torch.bincount(g.src[g.emask], minlength=n).to(torch.float32)
  mb0, ma0 = bfs_columns(torch.tensor(prep["sources"], device="cuda"), n)
  t0 = time.perf_counter()
  ref = {
      "bfs": run_graph_program(g, bfs_program(), dist0, one, backend=coo),
      "sssp": run_graph_program(g, sssp_program(), sp0, one, backend=coo),
      "pagerank": run_graph_program(
          g, pagerank_sweeps_program(),
          {"rank": torch.ones((n,), device="cuda"), "deg": deg},
          torch.ones_like(one), max_iters=DIST_PR_ITERS, backend=coo),
      "multi_bfs": run_batched(g, multi_bfs_program(), mb0, ma0,
                               backend=coo)}
  torch.cuda.synchronize()
  ref_s = time.perf_counter() - t0
  want = {k: (v.prop["rank"] if k == "pagerank" else v.prop).cpu()
          for k, v in ref.items()}
  steps = {k: int(v.iteration) for k, v in ref.items()}
  ref_iters = ref["multi_bfs"].iters.cpu()
  del ref, g
  torch.cuda.empty_cache()
  log(f"phase 8: single-device reference (coo) in {ref_s:.2f} s, supersteps "
      + json.dumps(steps))

  out = {"reference_supersteps": steps, "reference_s": ref_s,
         "partition": {k: {f: v[f] for f in v if f != "dir"}
                       for k, v in prep["grids"].items()},
         "prepare_s": prep["prepare_s"], "runs": {}}
  for R, C, backend in DIST_GRIDS:
    key = f"{R}x{C}"
    t0 = time.perf_counter()
    ranks = D.launch(rank_2d, R, C, prep["grids"][key]["dir"], root,
                     prep["sources"], backend=backend)
    launch_s = time.perf_counter() - t0
    got = ranks[0]
    for name in ("bfs", "sssp", "pagerank", "multi_bfs"):
      res = got[name]
      if res["supersteps"] != steps[name]:
        raise AssertionError(f"phase 8: {key} {name} ran {res['supersteps']}"
                             f" supersteps, the single device {steps[name]}")
      p = res["prop"][:n]
      if name == "pagerank":
        torch.testing.assert_close(p, want[name], rtol=1e-4, atol=0.0)
      elif not torch.equal(p, want[name]):
        raise AssertionError(f"phase 8: {key} {name} != single device")
      if name == "multi_bfs" and not torch.equal(res["iters"], ref_iters):
        raise AssertionError(f"phase 8: {key} per-query supersteps differ")
    if any(r["ell_launches"] for r in ranks):
      raise AssertionError("phase 8: a COO block launched the ELL kernel")
    run = {"backend": backend, "ranks": R * C, "launch_s": launch_s}
    for name in ("bfs", "sssp", "pagerank", "multi_bfs"):
      k = got[name]["supersteps"]
      # Ranks wait for one another in the collectives: the slowest rank's
      # wall time is the run's, and its split is printed.
      slow = max(ranks, key=lambda r: r[name]["wall_s"])[name]
      run[name] = {"supersteps": k, "wall_ms": slow["wall_s"] * 1e3,
                   "ms_per_superstep": slow["wall_s"] * 1e3 / k,
                   "split_ms_per_superstep": {
                       s: v * 1e3 / k for s, v in slow["split_s"].items()}}
      if name == "pagerank":
        run[name]["max_abs_err"] = float(
            (got[name]["prop"][:n].double() - want[name].double()).abs().max())
      log(f"phase 8: {key} ({backend}, {R * C} ranks on one card) {name}: "
          f"{k} supersteps, {slow['wall_s'] * 1e3:.2f} ms "
          f"({slow['wall_s'] * 1e3 / k:.3f} ms a superstep); split ms a "
          f"superstep " + json.dumps(
              {s: round(v, 4) for s, v in
               run[name]["split_ms_per_superstep"].items()})
          + (" == single device bitwise" if name != "pagerank"
             else f", max abs err {run[name]['max_abs_err']:.3g} at rtol "
             "1e-4"))
    out["runs"][key] = run
    log(f"phase 8: {key} launch of {R * C} ranks took {launch_s:.1f} s")
  return out


# ---------------------------------------------------------------------------
# Phase 9: Granite-8B at full width (the dense family)
# ---------------------------------------------------------------------------

# Prefill against decode logits after 32 tokens of 36 layers, in bf16: the
# two paths round to bf16 at other places (the chunked softmax's f32 result
# and the decode path's grouped one), as the Falcon check does; the limit
# is the Falcon one, set before the first run.  The float32 check binds the
# arithmetic.
GQA_PREFILL_DECODE_TOL = 0.08
GQA_PREFILL_DECODE_F32_TOL = 1e-3
# chunked_attention against dense_attention on one layer's bf16 prefill
# tensors: both compute in f32 and round the result to bf16 once, so they
# may differ by one bf16 step (2^-8 of a value) where the f32 sums round to
# either side: limit 2^-7 of max|out|.
CHUNKED_DENSE_TOL = 2.0 ** -7
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate, data sheet


def phase_granite(seed: int = 0) -> dict:
  import torch
  from repro_torch import configs
  from repro_torch._tree import tree_leaves
  from repro_torch.models import attention as attn
  from repro_torch.models import transformer as T
  from repro_torch.models.common import (embed_lookup, init_params,
                                         num_params, rms_norm)
  from repro_torch.models.transformer import build_model
  from repro_torch.serve import generate, make_decode_step, make_prefill

  cfg = configs.get_config("granite_8b")
  model = build_model(cfg)
  vocab = cfg.vocab_size
  torch.cuda.reset_peak_memory_stats()
  gen = torch.Generator(device="cuda").manual_seed(seed)
  t0 = time.perf_counter()
  params = init_params(model.defs(), gen)
  torch.cuda.synchronize()
  t_init = time.perf_counter() - t0
  n_params = num_params(model.defs())
  log(f"phase 9: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
      f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of {cfg.head_dim}, "
      f"d_ff {cfg.d_ff}, vocab {vocab}; {n_params:,} params, "
      f"{n_params * 4 / 2**30:.2f} GiB f32) initialized in {t_init:.3f} s")

  b, s, chunk = 4, 2048, 1024
  tokens = torch.randint(0, vocab, (b, s), generator=gen, device="cuda",
                         dtype=torch.int32)
  prefill = make_prefill(model)
  t0 = time.perf_counter()
  logits = prefill(params, {"tokens": tokens})
  torch.cuda.synchronize()
  t_first = time.perf_counter() - t0
  if logits.shape != (b, s, cfg.padded_vocab(1)):
    raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
  if not torch.isfinite(logits).all():
    raise AssertionError("prefill logits are not finite")
  del logits
  prefill_ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), iters=3,
                       warmup=1)
  log(f"phase 9: prefill {b}x{s} tokens (kv_chunk {chunk}): finite logits; "
      f"first call {t_first:.3f} s, then {prefill_ms:.2f} ms (CUDA events, "
      f"mean of 3), {b * s / prefill_ms * 1e3:.0f} prompt tokens/s")

  # One decode step at B = 4 against a 4,096-slot cache at position 2,048.
  step = make_decode_step(model)
  long_cache = model.init_cache(b, 2 * s)
  tok = tokens[:, :1].contiguous()
  decode_ms = cuda_ms(lambda: step(params, tok, long_cache, s), iters=10,
                      warmup=2)
  busy_prefill = device_busy(lambda: prefill(params, {"tokens": tokens}))
  log(busy_line(f"phase 9: prefill {b}x{s}", busy_prefill))
  busy_decode = device_busy(lambda: step(params, tok, long_cache, s))
  log(busy_line(f"phase 9: decode step B={b} at pos {s}", busy_decode))
  del long_cache
  log(f"phase 9: decode step {decode_ms:.2f} ms at B={b}, pos {s} of a "
      f"{2 * s}-slot cache ({b / decode_ms * 1e3:.1f} tokens/s)")

  # The prompts cut to 32 tokens: prefill against the decode path, then
  # generate's greedy tokens.
  p, new = 32, 16
  short = tokens[:, :p].contiguous()
  pre_last = prefill(params, {"tokens": short})[:, -1, :vocab].float()
  cache = model.init_cache(b, p + new)
  for i in range(p):
    logits, cache = step(params, short[:, i:i + 1], cache, i)
  dec_last = logits[:, -1, :vocab].float()
  del cache, logits
  out = generate(model, params, short, max_new=new)
  torch.cuda.synchronize()
  if out.shape != (b, p + new) or not torch.equal(out[:, :p], short):
    raise AssertionError(f"generate returned {tuple(out.shape)}")
  if not ((out >= 0) & (out < vocab)).all():
    raise AssertionError("generated token out of range")
  if not torch.isfinite(dec_last).all():
    raise AssertionError("decode logits are not finite")
  scale = float(pre_last.abs().max())
  err = float((pre_last - dec_last).abs().max())
  top2 = torch.topk(pre_last, 2, dim=-1).values
  sure = (top2[:, 0] - top2[:, 1]) > 2 * err
  agree = pre_last.argmax(-1) == out[:, p]
  log(f"phase 9: prefill vs decode logits after {p} tokens: max abs err "
      f"{err:.4g}, max|logit| {scale:.4g} ({err / scale:.4g} of it; "
      f"tolerance {GQA_PREFILL_DECODE_TOL}); generate: {new} tokens; prefill "
      f"argmax == first generated token for {int(agree.sum())}/{b} prompts "
      f"({int(sure.sum())} with a top-2 margin above twice the error)")
  if err > GQA_PREFILL_DECODE_TOL * scale:
    raise AssertionError("prefill and decode logits disagree")
  if not agree[sure].all():
    raise AssertionError("prefill argmax != first generated token where the "
                         "top-2 margin exceeds twice the error")

  # The same in float32 compute (the same weights).
  m32 = build_model(cfg.scaled(dtype="float32"))
  pre32 = make_prefill(m32)(params, {"tokens": short})[:, -1, :vocab]
  step32 = make_decode_step(m32)
  cache = m32.init_cache(b, p)
  for i in range(p):
    logits, cache = step32(params, short[:, i:i + 1], cache, i)
  dec32 = logits[:, -1, :vocab]
  del cache, logits
  scale32 = float(pre32.abs().max())
  err32 = float((pre32 - dec32).abs().max())
  top2 = torch.topk(pre32, 2, dim=-1).values
  sure32 = (top2[:, 0] - top2[:, 1]) > 2 * err32
  agree32 = pre32.argmax(-1) == dec32.argmax(-1)
  log(f"phase 9: f32 compute, prefill vs decode logits after {p} tokens: "
      f"max abs err {err32:.4g}, max|logit| {scale32:.4g} "
      f"({err32 / scale32:.4g} of it; tolerance "
      f"{GQA_PREFILL_DECODE_F32_TOL}); argmax equal for "
      f"{int(agree32.sum())}/{b} ({int(sure32.sum())} with a top-2 margin "
      f"above twice the error)")
  if err32 > GQA_PREFILL_DECODE_F32_TOL * scale32 or not agree32[sure32].all():
    raise AssertionError("f32 prefill and decode logits disagree")

  # One layer at the prefill's shapes: its attention and SwiGLU blocks, and
  # chunked attention against dense attention and against the library's
  # flash attention (a yardstick, not on the path).
  lp0 = T._layer(params["layers"], 0)
  with torch.inference_mode():
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    h = rms_norm(x, lp0["ln1"], cfg.norm_eps)
    q, k, v = attn.gqa_qkv(lp0["attn"], h, pos, cfg)
    rep = cfg.num_heads // cfg.num_kv_heads
    k, v = attn._repeat_kv(k, rep), attn._repeat_kv(v, rep)
    chunked = attn.chunked_attention(q, k, v, pos, pos, kv_chunk=chunk)
    dense = attn.dense_attention(q, k, v, pos, pos)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True).transpose(1, 2)
    att_scale = float(dense.float().abs().max())
    cd_err = float((chunked.float() - dense.float()).abs().max())
    sdpa_err = float((sdpa.float() - dense.float()).abs().max())
    if not cd_err <= CHUNKED_DENSE_TOL * att_scale:
      raise AssertionError(f"chunked attention != dense ({cd_err:.4g})")
    del dense
    chunked_ms, sdpa_ms = paired_ms(
        lambda: attn.chunked_attention(q, k, v, pos, pos, kv_chunk=chunk),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=3, repeats=3, warmup=1)
    attn_block_ms = cuda_ms(lambda: T._attn_apply(lp0, x, pos, cfg,
                                                  kv_chunk=chunk),
                            iters=3, warmup=1)
    ffn_block_ms = cuda_ms(lambda: T._ffn_apply(lp0, x, cfg), iters=3,
                           warmup=1)
  del q, k, v, qt, kt, vt, chunked, sdpa, x, h
  # FLOPs of the layer's attention core (QKᵀ and PV over every chunk, as
  # the reference computes them) and of SDPA's causal half.
  attn_flops = 4 * b * s * s * cfg.num_heads * cfg.head_dim
  mats = [t for t in tree_leaves(params["layers"]) if t.dim() == 3]
  mats.append(params["lm_head"])

  def cast_all():
    for t in mats:
      t.to(cfg.compute_dtype)

  cast_ms = cuda_ms(cast_all, iters=3, warmup=1)
  log(f"phase 9: one layer at {b}x{s}: attention block {attn_block_ms:.2f} "
      f"ms, SwiGLU block {ffn_block_ms:.2f} ms (x{cfg.num_layers} = "
      f"{(attn_block_ms + ffn_block_ms) * cfg.num_layers:.1f} ms); weight "
      f"cast f32->bf16 {cast_ms:.2f} ms per forward or step")
  log(f"phase 9: chunked attention [{b}, {s}, {cfg.num_heads}, "
      f"{cfg.head_dim}] bf16: {chunked_ms:.3f} ms "
      f"({attn_flops / chunked_ms / 1e9:.1f} TFLOP/s f32 counted over every "
      f"chunk), max abs err vs dense {cd_err:.4g}, max|out| "
      f"{att_scale:.4g} ({cd_err / att_scale:.4g} of it; tolerance "
      f"{CHUNKED_DENSE_TOL:.4g}); scaled_dot_product_attention "
      f"(causal, a yardstick) {sdpa_ms:.3f} ms, max abs err vs dense "
      f"{sdpa_err:.4g}")
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  log(f"phase 9: peak device memory {peak_gib:.2f} GiB")
  # Every matrix but the embedding table multiplies each prompt token.
  gemm_flops = 2 * b * s * (n_params - cfg.padded_vocab(1) * cfg.d_model)
  return {"config": cfg.name, "num_layers": cfg.num_layers,
          "params": n_params, "init_s": t_init, "prefill_batch": [b, s],
          "kv_chunk": chunk, "prefill_first_s": t_first,
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": b * s / prefill_ms * 1e3,
          "prefill_gemm_flops": gemm_flops,
          "prefill_attention_flops": attn_flops * cfg.num_layers,
          "decode_step_ms": decode_ms, "decode_batch": b,
          "decode_pos": s, "decode_cache_slots": 2 * s,
          "prefill_profile": busy_prefill, "decode_profile": busy_decode,
          "prefill_decode_max_abs_err": err, "prefill_max_abs_logit": scale,
          "argmax_agree": int(agree.sum()), "argmax_sure": int(sure.sum()),
          "f32_prefill_decode_max_abs_err": err32,
          "f32_prefill_max_abs_logit": scale32,
          "layer_attention_block_ms": attn_block_ms,
          "layer_swiglu_block_ms": ffn_block_ms, "weight_cast_ms": cast_ms,
          "chunked_attention_ms": chunked_ms, "sdpa_ms": sdpa_ms,
          "chunked_dense_max_abs_err": cd_err,
          "sdpa_dense_max_abs_err": sdpa_err,
          "attention_max_abs_out": att_scale,
          "peak_device_gib": peak_gib}



# ---------------------------------------------------------------------------
# Phase 10: Mixtral-8x7B and DeepSeek-V2 at full width (the moe family)
# ---------------------------------------------------------------------------

# (config, layers kept of its published depth): the cut that fits the f32
# weights and the prefill's temporaries on one 80 GB card (Mixtral 8 of 32
# layers, 44.23 GiB; DeepSeek-V2 2 of 60, 33.50 GiB).
MOE_CUTS = (("mixtral_8x7b", 8), ("deepseek_v2_236b", 2))
# Prefill against decode after 32 tokens, at a capacity factor under which
# no group drops an edge (E / k: an expert may take every token of its
# group), on every prompt, within the GQA bounds.  In float32 the two paths
# route alike and are the same arithmetic up to float32 rounding.  In bf16
# one rounding step of a router logit (attention rounded at other places)
# moves some tokens to other experts; these routing flips are counted and
# logged, and the bound holds with them (a flip changes one of k gated
# terms of one token in one layer).
MOE_PREFILL_DECODE_TOL = GQA_PREFILL_DECODE_TOL
MOE_PREFILL_DECODE_F32_TOL = GQA_PREFILL_DECODE_F32_TOL
# One layer's MoE block in float32 compute: sort against onehot dispatch,
# and the combine against spmv_coo on the bipartite token-slot graph.  Both
# sides form the same products and add them in other orders (k terms a
# token, and zeros): limit 1e-5 of max|y|.
MOE_CROSS_TOL = 1e-5


class RouteRecorder:
  """For the length of a ``with`` block, wraps the port's
  ``_route_group_sort`` (which ``moe_forward`` looks up at each call) and
  records, call by call, which experts each token went to ([G, Tg, E]
  bool) and how many (token, expert) edges the capacity cut dropped.  The
  script's own instrument: the package has no such hook."""

  def __init__(self):
    from repro_torch.models import moe
    self.moe, self.calls = moe, []

  def __enter__(self):
    import torch
    orig = self.orig = self.moe._route_group_sort

    def recording(logits, x, top_k, num_experts, capacity):
      xe, aux = orig(logits, x, top_k, num_experts, capacity)
      e_sorted, _, tok_sorted, _, keep = aux
      g, tg = logits.shape[:2]
      chosen = torch.zeros((g, tg, num_experts), dtype=torch.bool,
                           device=logits.device)
      grp = torch.arange(g, device=logits.device)[:, None]
      chosen[grp, tok_sorted, e_sorted] = True
      self.calls.append((chosen, int((~keep).sum())))
      return xe, aux

    self.moe._route_group_sort = recording
    return self

  def __exit__(self, *exc):
    self.moe._route_group_sort = self.orig


def moe_prefill_vs_decode(model, params, short) -> dict:
  """The last position's logits of ``make_prefill`` against 32 decode steps
  on ``short`` [B, P], with each path's routing recorded: per prompt the
  max abs error and the (layer, position) pairs routed to other experts;
  the edges the prefill's groups dropped."""
  import torch
  from repro_torch.serve import make_decode_step, make_prefill
  cfg = model.cfg
  b, p = short.shape
  L = cfg.num_layers
  with RouteRecorder() as rec_p:
    pre = make_prefill(model)(params, {"tokens": short})
  pre = pre[:, -1, :cfg.vocab_size].float()
  step = make_decode_step(model)
  cache = model.init_cache(b, p)
  with RouteRecorder() as rec_d:
    for i in range(p):
      logits, cache = step(params, short[:, i:i + 1], cache, i)
  dec = logits[:, -1, :cfg.vocab_size].float()
  del cache, logits
  pre_sets = torch.stack([c[0] for c in rec_p.calls])          # [L,B,P,E]
  dec_sets = torch.stack([
      torch.cat([rec_d.calls[i * L + layer][0] for i in range(p)], dim=1)
      for layer in range(L)])
  flips = (pre_sets != dec_sets).any(-1).sum(dim=(0, 2))      # [B]
  err = (pre - dec).abs().amax(-1)                             # [B]
  return {"max_abs_err": float(err.max()),
          "max_abs_logit": float(pre.abs().max()),
          "err_by_prompt": err.tolist(), "flips_by_prompt": flips.tolist(),
          "prefill_dropped_edges": sum(c[1] for c in rec_p.calls),
          "decode_dropped_edges": sum(c[1] for c in rec_d.calls),
          "edges": L * b * p * cfg.top_k,
          "argmax_agree": int((pre.argmax(-1) == dec.argmax(-1)).sum())}


def phase_moe(arch: str, num_layers: int, seed: int = 0) -> dict:
  import torch
  from repro_torch import configs
  from repro_torch.core import graph as graphlib
  from repro_torch.core.spmv import spmv_coo
  from repro_torch.core.vertex_program import GraphProgram
  from repro_torch.models import moe as moelib
  from repro_torch.models import transformer as T
  from repro_torch.models.common import (embed_lookup, init_params,
                                         num_params, rms_norm)
  from repro_torch.models.transformer import build_model
  from repro_torch.serve import generate, make_decode_step, make_prefill

  full = configs.get_config(arch)
  cfg = full.scaled(num_layers=num_layers)
  model = build_model(cfg)
  vocab, cd = cfg.vocab_size, cfg.compute_dtype
  k, n_exp = cfg.top_k, cfg.num_experts
  torch.cuda.reset_peak_memory_stats()
  gen = torch.Generator(device="cuda").manual_seed(seed)
  t0 = time.perf_counter()
  params = init_params(model.defs(), gen)
  torch.cuda.synchronize()
  t_init = time.perf_counter() - t0
  n_params = num_params(model.defs())
  attn_kind = (f"MLA, {cfg.num_heads} heads, kv_lora {cfg.kv_lora_rank}"
               if cfg.use_mla else
               f"GQA {cfg.num_heads}/{cfg.num_kv_heads} heads of "
               f"{cfg.head_dim}, window {cfg.sliding_window}")
  log(f"phase 10: {cfg.name} cut to {num_layers} of {full.num_layers} "
      f"layers at its published widths (d_model {cfg.d_model}, {attn_kind}; "
      f"{n_exp} experts of {cfg.moe_d_ff} top-{k}, "
      f"{cfg.num_shared_experts} shared; vocab {vocab}): {n_params:,} "
      f"params, {n_params * 4 / 2**30:.2f} GiB f32, initialized in "
      f"{t_init:.3f} s")

  b, s, chunk = 4, 2048, 1024
  tokens = torch.randint(0, vocab, (b, s), generator=gen, device="cuda",
                         dtype=torch.int32)
  prefill = make_prefill(model)
  t0 = time.perf_counter()
  logits = prefill(params, {"tokens": tokens})
  torch.cuda.synchronize()
  t_first = time.perf_counter() - t0
  if logits.shape != (b, s, cfg.padded_vocab(1)):
    raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
  if not torch.isfinite(logits).all():
    raise AssertionError("prefill logits are not finite")
  del logits
  prefill_ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}), iters=3,
                       warmup=1)
  log(f"phase 10: {cfg.name} prefill {b}x{s} tokens: finite logits; first "
      f"call {t_first:.3f} s, then {prefill_ms:.2f} ms (CUDA events, mean "
      f"of 3), {b * s / prefill_ms * 1e3:.0f} prompt tokens/s")

  step = make_decode_step(model)
  long_cache = model.init_cache(b, 2 * s)
  tok = tokens[:, :1].contiguous()
  decode_ms = cuda_ms(lambda: step(params, tok, long_cache, s), iters=5,
                      warmup=2)
  busy_prefill = device_busy(lambda: prefill(params, {"tokens": tokens}))
  log(busy_line(f"phase 10: {cfg.name} prefill {b}x{s}", busy_prefill))
  busy_decode = device_busy(lambda: step(params, tok, long_cache, s))
  log(busy_line(f"phase 10: {cfg.name} decode step B={b} at pos {s}",
                busy_decode))
  del long_cache
  log(f"phase 10: {cfg.name} decode step {decode_ms:.2f} ms at B={b}, pos "
      f"{s} of a {2 * s}-slot cache ({b / decode_ms * 1e3:.1f} tokens/s)")

  # The edges each layer's routing groups drop in the prefill: the layers
  # stepped one by one, the port's _route_group_sort on each MoE input.
  tg = min(cfg.moe_group_size, s)
  groups = b * s // tg
  cap = moelib._group_capacity(cfg, tg)
  pos = torch.arange(s, dtype=torch.int32, device="cuda")
  drops = []
  with torch.inference_mode():
    x = embed_lookup(params["embed"], tokens, cd)
    for i in range(num_layers):
      lp = T._layer(params["layers"], i)
      h = T._attn_apply(lp, x, pos, cfg, kv_chunk=chunk)
      hn = rms_norm(h, lp["ln2"], cfg.norm_eps).reshape(groups, tg, -1)
      if i == 0:
        x0, h0, hn0 = x, h, hn
      lg = torch.einsum("gtd,de->gte", hn, lp["moe"]["router"].to(cd))
      _, aux = moelib._route_group_sort(lg, hn, k, n_exp, cap)
      lost = (~aux[4]).sum(dim=-1)                             # [G]
      drops.append({"layer": i, "share": float(lost.sum()) / (b * s * k),
                    "worst_group_share": float(lost.max()) / (tg * k)})
      x, _ = T._ffn_apply(lp, h, cfg)
    del x, h, hn, lg, aux
  log(f"phase 10: {cfg.name} dropped (token, expert) edges of the {b}x{s} "
      f"prefill at capacity_factor {cfg.capacity_factor} ({groups} groups "
      f"of {tg} tokens, capacity {cap} a group): " + ", ".join(
          f"layer {d['layer']} {d['share']:.4f} (worst group "
          f"{d['worst_group_share']:.4f})" for d in drops))

  # The prompts cut to 32 tokens: generate, and prefill against decode at
  # the config's capacity factor (drops, no bound) and at one under which
  # nothing drops, in bf16 and in float32 compute.
  p, new = 32, 16
  short = tokens[:, :p].contiguous()
  out = generate(model, params, short, max_new=new)
  torch.cuda.synchronize()
  if out.shape != (b, p + new) or not torch.equal(out[:, :p], short):
    raise AssertionError(f"generate returned {tuple(out.shape)}")
  if not ((out >= 0) & (out < vocab)).all():
    raise AssertionError("generated token out of range")
  at_cfg = moe_prefill_vs_decode(model, params, short)
  log(f"phase 10: {cfg.name} generate: {new} tokens; prefill vs decode "
      f"after {p} tokens at capacity_factor {cfg.capacity_factor}: max abs "
      f"err {at_cfg['max_abs_err']:.4g}, max|logit| "
      f"{at_cfg['max_abs_logit']:.4g}; the prefill dropped "
      f"{at_cfg['prefill_dropped_edges']} of {at_cfg['edges']} edges, decode "
      f"{at_cfg['decode_dropped_edges']}; routing flips by prompt "
      f"{at_cfg['flips_by_prompt']} (no bound: capacity drops)")
  nd_factor = n_exp / k
  nodrop = {}
  for dtype, tol in (("bfloat16", MOE_PREFILL_DECODE_TOL),
                     ("float32", MOE_PREFILL_DECODE_F32_TOL)):
    m = build_model(cfg.scaled(capacity_factor=nd_factor, dtype=dtype))
    r = nodrop[dtype] = moe_prefill_vs_decode(m, params, short)
    log(f"phase 10: {cfg.name} {dtype}, capacity_factor {nd_factor:g}: "
        f"prefill vs decode after {p} tokens: max abs err "
        f"{r['max_abs_err']:.4g}, max|logit| {r['max_abs_logit']:.4g} "
        f"({r['max_abs_err'] / r['max_abs_logit']:.4g} of it; tolerance "
        f"{tol}); dropped {r['prefill_dropped_edges']} and "
        f"{r['decode_dropped_edges']} edges; routing flips by prompt "
        f"{r['flips_by_prompt']}; argmax equal for {r['argmax_agree']}/{b}")
    if r["prefill_dropped_edges"] or r["decode_dropped_edges"]:
      raise AssertionError(f"{dtype}: edges dropped at capacity_factor "
                           f"{nd_factor}")
    if r["max_abs_err"] > tol * r["max_abs_logit"]:
      raise AssertionError(f"{dtype} prefill and decode logits disagree")

  # One layer at the prefill's shape: its blocks, then the MoE block's
  # cross-checks in float32 compute.
  lp0 = T._layer(params["layers"], 0)
  mp = lp0["moe"]
  with torch.inference_mode():
    def route():
      lg = torch.einsum("gtd,de->gte", hn0, mp["router"].to(cd))
      return moelib._route_group_sort(lg, hn0, k, n_exp, cap)

    xe, aux = route()
    ye = moelib._experts(mp, xe, cfg)
    attn_ms = cuda_ms(lambda: T._attn_apply(lp0, x0, pos, cfg,
                                            kv_chunk=chunk), iters=3, warmup=1)
    route_ms = cuda_ms(route, iters=3, warmup=1)
    experts_ms = cuda_ms(lambda: moelib._experts(mp, xe, cfg), iters=3,
                         warmup=1)
    combine_ms = cuda_ms(lambda: moelib._combine_group_sort(ye, aux, tg),
                         iters=3, warmup=1)
    ffn_ms = cuda_ms(lambda: T._ffn_apply(lp0, h0, cfg), iters=3, warmup=1)
    cast_ms = cuda_ms(lambda: [mp[w].to(cd) for w in ("w_gate", "w_up",
                                                      "w_down")],
                      iters=3, warmup=1)
    del xe, aux, ye

    cfg32 = cfg.scaled(dtype="float32")
    hn32 = hn0.float()
    y_sort = moelib.moe_forward(mp, hn32.reshape(b, s, -1), cfg32,
                                group_size=tg, moe_impl="sort")
    y_oh = moelib.moe_forward(mp, hn32.reshape(b, s, -1), cfg32,
                              group_size=tg, moe_impl="onehot")
    y_scale = float(y_sort.abs().max())
    so_err = float((y_sort - y_oh).abs().max())
    del y_sort, y_oh
    lg32 = torch.einsum("gtd,de->gte", hn32, mp["router"])
    xe, aux = moelib._route_group_sort(lg32, hn32, k, n_exp, cap)
    ye = moelib._experts(mp, xe, cfg32)
    y_comb = moelib._combine_group_sort(ye, aux, tg).reshape(b * s, -1)
    # The bipartite graph: vertices [0, B·S) are tokens, then one per
    # (group, expert, slot); an edge slot -> token per kept edge, valued
    # by its gate.
    e_sorted, slot_pos, tok_sorted, gate_sorted, keep = aux
    grp = torch.arange(groups, device="cuda")[:, None]
    src = b * s + (grp * n_exp + e_sorted) * cap + slot_pos
    dst = grp * tg + tok_sorted
    kept = keep.reshape(-1)
    n_vert = b * s + groups * n_exp * cap
    g = graphlib.build_coo(src.reshape(-1)[kept].cpu().numpy(),
                           dst.reshape(-1)[kept].cpu().numpy(),
                           gate_sorted.reshape(-1)[kept].cpu().numpy(),
                           n=n_vert)
    msg = torch.cat([torch.zeros((b * s, cfg.d_model), device="cuda"),
                     ye.reshape(-1, cfg.d_model)])
    prog = GraphProgram(process_message=lambda m, ev, dp: m * ev,
                        reduce_kind="add", process_reads_dst=False)
    y_spmv, _ = spmv_coo(g, msg, torch.ones(n_vert, dtype=torch.bool,
                                            device="cuda"), msg, prog)
    comb_scale = float(y_comb.abs().max())
    cs_err = float((y_spmv[:b * s] - y_comb).abs().max())
    n_edges = int(kept.sum())
    del lg32, xe, aux, ye, y_comb, msg, y_spmv, g, hn32
  log(f"phase 10: {cfg.name} one layer at {b}x{s}: attention block "
      f"{attn_ms:.2f} ms; MoE block {ffn_ms:.2f} ms, of it routing and "
      f"dispatch {route_ms:.2f}, expert GEMMs {experts_ms:.2f} (the f32->bf16 "
      f"cast of the expert weights {cast_ms:.2f} of it), combine "
      f"{combine_ms:.2f}")
  log(f"phase 10: {cfg.name} layer 0 in float32: sort vs onehot dispatch "
      f"max abs err {so_err:.4g} (max|y| {y_scale:.4g}, tolerance "
      f"{MOE_CROSS_TOL} of it); combine vs spmv_coo (PLUS_TIMES on the "
      f"bipartite graph, {n_vert:,} vertices, {n_edges:,} kept edges) max "
      f"abs err {cs_err:.4g} (max|y| {comb_scale:.4g})")
  if not so_err <= MOE_CROSS_TOL * y_scale:
    raise AssertionError(f"sort != onehot dispatch ({so_err:.4g})")
  if not cs_err <= MOE_CROSS_TOL * comb_scale:
    raise AssertionError(f"combine != spmv_coo ({cs_err:.4g})")
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  log(f"phase 10: {cfg.name} peak device memory {peak_gib:.2f} GiB")
  return {"config": cfg.name, "num_layers": num_layers,
          "published_layers": full.num_layers, "params": n_params,
          "init_s": t_init, "prefill_batch": [b, s], "kv_chunk": chunk,
          "prefill_first_s": t_first, "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": b * s / prefill_ms * 1e3,
          "decode_step_ms": decode_ms, "decode_batch": b, "decode_pos": s,
          "decode_cache_slots": 2 * s, "prefill_profile": busy_prefill,
          "decode_profile": busy_decode, "group_tokens": tg,
          "capacity": cap, "dropped_edges": drops,
          "prefill_vs_decode_at_config": at_cfg,
          "no_drop_capacity_factor": nd_factor,
          "prefill_vs_decode_no_drop": nodrop,
          "layer_attention_block_ms": attn_ms, "layer_moe_block_ms": ffn_ms,
          "layer_route_dispatch_ms": route_ms,
          "layer_expert_gemms_ms": experts_ms,
          "layer_expert_weight_cast_ms": cast_ms,
          "layer_combine_ms": combine_ms,
          "sort_onehot_max_abs_err": so_err, "moe_max_abs_y": y_scale,
          "combine_spmv_max_abs_err": cs_err,
          "combine_max_abs_y": comb_scale, "bipartite_vertices": n_vert,
          "bipartite_edges": n_edges, "peak_device_gib": peak_gib}


# ---------------------------------------------------------------------------
# Phase 11: Zamba2-7B, SeamlessM4T-medium and InternVL2-26B at full width
# (the hybrid, encdec and vlm families)
# ---------------------------------------------------------------------------

# (config, layers kept of its published depth, None = all): Zamba2-7B's
# 25.15 GiB and SeamlessM4T-medium's 3.64 GiB of f32 weights fit whole;
# InternVL2-26B's 73.99 GiB do not leave room for a prefill, so 24 of its
# 48 layers run (39.12 GiB).
FAMILY_CUTS = (("zamba2_7b", None), ("seamless_m4t_medium", None),
               ("internvl2_26b", 24))
# The stub frontends' outputs are drawn N(0, 1) and scaled as the
# reference's training data scales them (src/repro/train/data.py:39-40 and
# :46-49).
FRONTEND_SCALE = 0.02
# Zamba2 prefill against decode after 32 tokens, in bf16: 94 blocks (81
# Mamba-2, the shared block 13 times) round to bf16 at other places in the
# two paths (the SSD's chunked matmuls against the one-token recurrence,
# [4, 32]-row against [4, 1]-row matmuls).  Falcon's Mamba-1 reading grew
# about linearly with depth (1.0% of max|logit| at 4 layers, 6.2% at 64, on
# an H100), which puts 94 blocks near 9%; the limit is set above that,
# before the first run.  The float32 check binds the arithmetic: there the
# two paths differ only by float32 rounding.
HYBRID_PREFILL_DECODE_TOL = 0.12
HYBRID_PREFILL_DECODE_F32_TOL = GQA_PREFILL_DECODE_F32_TOL
# SeamlessM4T with every xattn.wo zeroed, and InternVL2 with no vision
# embeddings, are the dense decoder's comparison (12 and 24 layers against
# Granite's 36): the GQA bound.  As configured (the memory, or an image
# prefix), decode cannot see the frontend (ROADMAP Queue 3, item 9): the
# gap is reported with no bound.
FRONTEND_FREE_PREFILL_DECODE_TOL = GQA_PREFILL_DECODE_TOL


def prefill_vs_decode(model, params, batch) -> dict:
  """The last position's logits of ``make_prefill`` on ``batch`` against
  decoding its tokens one by one from an empty cache: the max abs error,
  max|logit|, the argmax agreement and, for encdec, max|ck| of the final
  cache."""
  import torch
  from repro_torch.serve import make_decode_step, make_prefill
  vocab = model.cfg.vocab_size
  short = batch["tokens"]
  b, p = short.shape
  pre = make_prefill(model)(params, batch)[:, -1, :vocab].float()
  step = make_decode_step(model)
  cache = model.init_cache(b, p)
  for i in range(p):
    logits, cache = step(params, short[:, i:i + 1], cache, i)
  dec = logits[:, -1, :vocab].float()
  if not (torch.isfinite(pre).all() and torch.isfinite(dec).all()):
    raise AssertionError("prefill or decode logits are not finite")
  err = float((pre - dec).abs().max())
  top2 = torch.topk(pre, 2, dim=-1).values
  sure = (top2[:, 0] - top2[:, 1]) > 2 * err
  agree = pre.argmax(-1) == dec.argmax(-1)
  out = {"max_abs_err": err, "max_abs_logit": float(pre.abs().max()),
         "argmax_agree": int(agree.sum()), "argmax_sure": int(sure.sum()),
         "argmax_agree_where_sure": bool(agree[sure].all())}
  if "ck" in cache:
    out["max_abs_ck"] = float(cache["ck"].abs().max())
  return out


def pvd_line(what: str, r: dict, tol) -> str:
  bound = "no bound" if tol is None else f"tolerance {tol}"
  ck = (f", max|ck| of the decode cache {r['max_abs_ck']:.4g}"
        if "max_abs_ck" in r else "")
  return (f"{what}: max abs err {r['max_abs_err']:.4g}, max|logit| "
          f"{r['max_abs_logit']:.4g} ({r['max_abs_err'] / r['max_abs_logit']:.4g}"
          f" of it; {bound}); argmax equal for {r['argmax_agree']}/4 "
          f"({r['argmax_sure']} with a top-2 margin above twice the error)"
          f"{ck}")


def check_pvd(r: dict, tol: float, what: str) -> None:
  if r["max_abs_err"] > tol * r["max_abs_logit"]:
    raise AssertionError(f"{what}: prefill and decode logits disagree")
  if not r["argmax_agree_where_sure"]:
    raise AssertionError(f"{what}: argmax differs where the top-2 margin "
                         "exceeds twice the error")


def ssd_work(b: int, s: int, cfg) -> dict:
  """The SSD's einsum FLOPs at [B, S] (counted as the reference forms them)
  and the float32 bytes of one [B, nc, C, C, H] temporary."""
  from repro_torch.models.ssm import mamba2_dims
  _, h, p, n = mamba2_dims(cfg)
  c = min(cfg.ssm_chunk, s)
  nc = s // c
  flops = 2 * b * nc * c * (c * n + c * h * p + 2 * h * n * p)
  return {"einsum_flops": flops, "temporary_bytes": 4 * b * nc * c * c * h}


def phase_family(arch: str, num_layers, seed: int = 0) -> dict:
  import torch
  from repro_torch import configs
  from repro_torch.models import ssm as ssmlib
  from repro_torch.models import transformer as T
  from repro_torch.models.common import init_params, num_params, rms_norm
  from repro_torch.models.transformer import build_model
  from repro_torch.serve import generate, make_decode_step, make_prefill

  full = configs.get_config(arch)
  cfg = full if num_layers is None else full.scaled(num_layers=num_layers)
  model = build_model(cfg)
  fam, vocab, cd, d = cfg.family, cfg.vocab_size, cfg.compute_dtype, cfg.d_model
  torch.cuda.reset_peak_memory_stats()
  gen = torch.Generator(device="cuda").manual_seed(seed)
  t0 = time.perf_counter()
  params = init_params(model.defs(), gen)
  torch.cuda.synchronize()
  t_init = time.perf_counter() - t0
  n_params = num_params(model.defs())
  if fam == "hybrid":
    seg, per, tail = model._hybrid_split()
    shape = (f"{seg} segments of the shared attention block ({cfg.num_heads}"
             f"/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}) "
             f"and {per} Mamba-2 blocks, then {tail} ({cfg.ssm_expand * d} "
             f"channels, heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, "
             f"chunk {cfg.ssm_chunk})")
  elif fam == "encdec":
    shape = (f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
             f"layers, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
             f"{cfg.d_ff}, memory {cfg.encoder_seq} frames")
  else:
    shape = (f"GQA {cfg.num_heads}/{cfg.num_kv_heads} heads of "
             f"{cfg.head_dim}, rope_theta {cfg.rope_theta:g}, "
             f"d_ff {cfg.d_ff}, {cfg.frontend_seq} vision embeddings")
  cut = ("all layers" if num_layers is None else
         f"cut to {num_layers} of {full.num_layers} layers")
  log(f"phase 11: {cfg.name} [{fam}] at its published widths, {cut} "
      f"(d_model {d}, {shape}; vocab {vocab}): {n_params:,} params, "
      f"{n_params * 4 / 2**30:.2f} GiB f32, initialized in {t_init:.3f} s")

  # The prefill batch: 4 sequences of 2,048 positions, with the stub
  # frontend's output (InternVL2: 256 vision positions + 1,792 tokens, the
  # split of src/repro/launch/specs.py:46-52).
  b, s, chunk = 4, 2048, 1024
  n_vis = cfg.frontend_seq if fam == "vlm" else 0
  tokens = torch.randint(0, vocab, (b, s - n_vis), generator=gen,
                         device="cuda", dtype=torch.int32)
  batch = {"tokens": tokens}
  if fam == "encdec":
    batch["enc_frames"] = torch.randn(
        (b, cfg.encoder_seq, d), generator=gen, device="cuda") * FRONTEND_SCALE
  if fam == "vlm":
    batch["vision_embeds"] = torch.randn(
        (b, n_vis, d), generator=gen, device="cuda") * FRONTEND_SCALE
  prefill = make_prefill(model)
  t0 = time.perf_counter()
  logits = prefill(params, batch)
  torch.cuda.synchronize()
  t_first = time.perf_counter() - t0
  if logits.shape != (b, s, cfg.padded_vocab(1)):
    raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
  if not torch.isfinite(logits).all():
    raise AssertionError("prefill logits are not finite")
  del logits
  prefill_ms = cuda_ms(lambda: prefill(params, batch), iters=3, warmup=1)
  log(f"phase 11: {cfg.name} prefill {b}x{s} positions (kv_chunk {chunk}"
      + (f"; memory {b}x{cfg.encoder_seq} frames" if fam == "encdec" else "")
      + (f"; {n_vis} vision + {s - n_vis} tokens" if fam == "vlm" else "")
      + f"): finite logits; first call {t_first:.3f} s, then "
      f"{prefill_ms:.2f} ms (CUDA events, mean of 3), "
      f"{b * s / prefill_ms * 1e3:.0f} prompt positions/s")

  step = make_decode_step(model)
  long_cache = model.init_cache(b, 2 * s)
  tok = tokens[:, :1].contiguous()
  decode_ms = cuda_ms(lambda: step(params, tok, long_cache, s), iters=5,
                      warmup=2)
  busy_prefill = device_busy(lambda: prefill(params, batch))
  log(busy_line(f"phase 11: {cfg.name} prefill {b}x{s}", busy_prefill))
  busy_decode = device_busy(lambda: step(params, tok, long_cache, s))
  log(busy_line(f"phase 11: {cfg.name} decode step B={b} at pos {s}",
                busy_decode))
  del long_cache
  log(f"phase 11: {cfg.name} decode step {decode_ms:.2f} ms at B={b}, pos "
      f"{s} of a {2 * s}-slot cache ({b / decode_ms * 1e3:.1f} tokens/s)")

  # The prompts cut to 32 tokens: generate's greedy tokens, then prefill
  # against decode.
  p, new = 32, 16
  short = tokens[:, :p].contiguous()
  out = generate(model, params, short, max_new=new)
  torch.cuda.synchronize()
  if out.shape != (b, p + new) or not torch.equal(out[:, :p], short):
    raise AssertionError(f"generate returned {tuple(out.shape)}")
  if not ((out >= 0) & (out < vocab)).all():
    raise AssertionError("generated token out of range")
  log(f"phase 11: {cfg.name} generate: {new} greedy tokens after {p}-token "
      f"prompts")
  pvd = {}
  if fam == "hybrid":
    for dtype, tol in (("bfloat16", HYBRID_PREFILL_DECODE_TOL),
                       ("float32", HYBRID_PREFILL_DECODE_F32_TOL)):
      m = model if dtype == "bfloat16" else build_model(
          cfg.scaled(dtype=dtype))
      r = pvd[dtype] = prefill_vs_decode(m, params, {"tokens": short})
      log(pvd_line(f"phase 11: {cfg.name} {dtype} compute, prefill vs "
                   f"decode after {p} tokens", r, tol))
      check_pvd(r, tol, f"{cfg.name} {dtype}")
  elif fam == "encdec":
    r = pvd["as_configured"] = prefill_vs_decode(
        model, params, {"tokens": short, "enc_frames": batch["enc_frames"]})
    log(pvd_line(f"phase 11: {cfg.name} prefill (with the memory) vs decode "
                 f"(a zero cross cache, ROADMAP Queue 3 item 9) after {p} "
                 f"tokens", r, None))
    if r["max_abs_ck"] != 0.0:
      raise AssertionError("the cross cache is not zeros")
    layers = params["layers"]
    no_x = {**params, "layers": {**layers, "xattn": {
        **layers["xattn"], "wo": torch.zeros_like(layers["xattn"]["wo"])}}}
    r = pvd["xattn_wo_zeroed"] = prefill_vs_decode(
        model, no_x, {"tokens": short, "enc_frames": batch["enc_frames"]})
    del no_x
    log(pvd_line(f"phase 11: {cfg.name} every xattn.wo zeroed (a copy of the "
                 f"weights), prefill vs decode after {p} tokens", r,
                 FRONTEND_FREE_PREFILL_DECODE_TOL))
    check_pvd(r, FRONTEND_FREE_PREFILL_DECODE_TOL, f"{cfg.name} wo zeroed")
  else:
    vis = batch["vision_embeds"]
    r = pvd["image_prefix"] = prefill_vs_decode(
        model, params, {"tokens": short, "vision_embeds": vis})
    log(pvd_line(f"phase 11: {cfg.name} prefill ({n_vis} vision embeddings + "
                 f"{p} tokens) vs decode ({p} tokens, ROADMAP Queue 3 item "
                 f"9)", r, None))
    r = pvd["no_image"] = prefill_vs_decode(
        model, params, {"tokens": short, "vision_embeds": vis[:, :0]})
    log(pvd_line(f"phase 11: {cfg.name} no vision embeddings, prefill vs "
                 f"decode after {p} tokens", r,
                 FRONTEND_FREE_PREFILL_DECODE_TOL))
    check_pvd(r, FRONTEND_FREE_PREFILL_DECODE_TOL, f"{cfg.name} no image")

  # One layer's blocks at the prefill's shape.
  blocks = {}
  with torch.inference_mode():
    x = model.embed_inputs(params, batch)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")

    def timed(name, fn):
      blocks[name] = cuda_ms(fn, iters=3, warmup=1)

    if fam == "hybrid":
      lp = T._layer(T._layer(params["segments"], 0), 0)
      sp = lp["ssm"]
      hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
      z, _, xh, dt, bmat, cmat = ssmlib._mamba2_in(sp, hn, cfg)
      a = -torch.exp(sp["a_log"].float())
      y = ssmlib._ssd_chunk_scan(xh, dt, a, bmat, cmat, cfg.ssm_chunk)
      timed("mamba2_block", lambda: model._mamba2_block(lp, x))
      timed("mamba2_projections_conv", lambda: ssmlib._mamba2_in(sp, hn, cfg))
      timed("ssd_chunk_scan", lambda: ssmlib._ssd_chunk_scan(
          xh, dt, a, bmat, cmat, cfg.ssm_chunk))
      timed("mamba2_gate_norm_out", lambda: ssmlib._mamba2_out(sp, y, xh, z,
                                                               cfg))
      timed("shared_block", lambda: model._shared_block(params, x, pos, chunk))
      del z, xh, dt, bmat, cmat, y, hn
    elif fam == "encdec":
      mem = batch["enc_frames"].to(cd)
      enc_pos = torch.arange(mem.shape[1], dtype=torch.int32, device="cuda")
      le, ld = T._layer(params["encoder"], 0), T._layer(params["layers"], 0)
      mem_n = rms_norm(mem, params["enc_ln_f"], cfg.norm_eps)
      timed("encoder_layer", lambda: T._ffn_apply(le, T._attn_apply(
          le, mem, enc_pos, cfg, causal=False, kv_chunk=chunk), cfg))
      timed("decoder_self_attention", lambda: T._attn_apply(
          ld, x, pos, cfg, kv_chunk=chunk))
      timed("decoder_cross_attention", lambda: T._cross_attn(
          ld, x, mem_n, pos, enc_pos, cfg, chunk))
      timed("decoder_swiglu", lambda: T._ffn_apply(ld, x, cfg))
      del mem, mem_n
    else:
      lp = T._layer(params["layers"], 0)
      timed("attention", lambda: T._attn_apply(lp, x, pos, cfg,
                                               kv_chunk=chunk))
      timed("swiglu", lambda: T._ffn_apply(lp, x, cfg))
    del x
  log(f"phase 11: {cfg.name} one layer at {b}x{s}: " + ", ".join(
      f"{name} {ms:.2f} ms" for name, ms in blocks.items()))
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  log(f"phase 11: {cfg.name} peak device memory {peak_gib:.2f} GiB")
  rec = {"config": cfg.name, "family": fam, "num_layers": cfg.num_layers,
         "published_layers": full.num_layers, "params": n_params,
         "init_s": t_init, "prefill_batch": [b, s], "kv_chunk": chunk,
         "prefill_first_s": t_first, "prefill_ms": prefill_ms,
         "prefill_positions_per_s": b * s / prefill_ms * 1e3,
         "decode_step_ms": decode_ms, "decode_batch": b, "decode_pos": s,
         "decode_cache_slots": 2 * s, "prefill_profile": busy_prefill,
         "decode_profile": busy_decode, "prefill_vs_decode": pvd,
         "layer_block_ms": blocks, "peak_device_gib": peak_gib}
  if fam == "hybrid":
    rec["ssd"] = ssd_work(b, s, cfg)
  return rec


# ---------------------------------------------------------------------------
# Phase 12: training Granite-3-2B on the card; the eval path's fused scan
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite_3_2b"
TRAIN_BATCH = (4, 2048)  # 8,192 tokens a step: the prefill cells' positions
TRAIN_STEPS = 8          # 1 warm-up, 6 timed, 1 under the profiler
# Remat full against none at 4 layers, bf16 compute: both run the same
# kernels on the same inputs (full remat runs each layer's forward again),
# so the gradients should agree to far below one bf16 step; the bound,
# set before the first run, is 2^-8 of each leaf's max|g|, one bf16 step.
REMAT_GRAD_TOL = 2.0 ** -8
# The card against the host, 2 layers in float32 compute (TF32 off): the
# same arithmetic summed in other orders by cuBLAS and the CPU's BLAS over
# dot products of up to 8,192 terms; set before the first run: the loss
# within rtol 1e-5, each gradient leaf within 1e-4 of its max|g|.
HOST_LOSS_RTOL = 1e-5
HOST_GRAD_TOL = 1e-4
# Resume against an uninterrupted run, 6 steps at 2 layers: the restored
# state must equal the saved one bit for bit; the final parameters are
# reported bit for bit or not, and held within 1e-6 (a few float32 steps
# of weights near 1, well under what a step at these learning rates
# moves them).
RESUME_PARAM_ATOL = 1e-6
EVAL_ARCH, EVAL_LAYERS = "falcon_mamba_7b", 8


def grads_of(model, params, batch):
  """The training loss and its gradients with respect to every parameter
  leaf, as a train step forms them, without the update."""
  from repro_torch.train.steps import make_loss_fn, value_and_grad
  (total, _), grads = value_and_grad(make_loss_fn(model))(params, batch)
  return total, grads


def grad_gap(got, want) -> float:
  """The largest, over the leaves, of max|got − want| / max|want|."""
  from repro_torch._tree import tree_flatten_with_path
  worst = 0.0
  for (_, g), (_, w) in zip(tree_flatten_with_path(got),
                            tree_flatten_with_path(want)):
    w = w.float()
    scale = float(w.abs().max())
    worst = max(worst, float((g.float().to(w.device) - w).abs().max())
                / max(scale, 1e-30))
  return worst


KERNEL_CLASSES = (  # (class, substrings of a kernel's name), first match
    ("f32 GEMM (attention's einsums)", ("gemm_f32f32", "sgemm")),
    ("bf16 GEMM", ("gemm", "nvjet", "cutlass", "xmma")),
    ("fill (zeros)", ("FillFunctor",)),
    ("float add", ("CUDAFunctor_add<float>",)),
    ("copy and cast", ("copy_kernel",)),
    ("reduction", ("reduce_kernel",)),
    ("other elementwise", ("",)))


def kernel_classes(by_name) -> dict:
  """Device ms by kernel class, from (name, ms) pairs."""
  out = {c: 0.0 for c, _ in KERNEL_CLASSES}
  for name, ms in by_name:
    cls = next(c for c, keys in KERNEL_CLASSES if any(k in name for k in keys))
    out[cls] += ms
  return out


def register_config(name: str, cfg) -> None:
  """Make ``cfg`` reachable as ``repro_torch.configs.get_config(name)`` (a
  transient config module, as ``examples/train_lm_torch.py`` makes one)."""
  import types
  mod = types.ModuleType(f"repro_torch.configs.{name}")
  mod.CONFIG = cfg
  sys.modules[mod.__name__] = mod


def phase_train(seed: int = 0) -> dict:
  import torch
  from repro_torch import configs
  from repro_torch._tree import tree_leaves, tree_map
  from repro_torch.launch import train as train_driver
  from repro_torch.models.common import init_params, num_params
  from repro_torch.models.transformer import build_model
  from repro_torch.train import adamw_init, make_train_step, synthetic_batch
  from repro_torch.train.checkpoint import restore_checkpoint
  from repro_torch.train.optimizer import adamw_update

  out = {}
  # a. Full width and depth, remat full, through the train step.
  cfg = configs.get_config(TRAIN_ARCH)
  model = build_model(cfg)
  torch.cuda.reset_peak_memory_stats()
  gen = torch.Generator(device="cuda").manual_seed(seed)
  t0 = time.perf_counter()
  params = init_params(model.defs(), gen)
  opt = adamw_init(params)
  torch.cuda.synchronize()
  t_init = time.perf_counter() - t0
  n_params = num_params(model.defs())
  state_gib = 4 * n_params * 4 / 2**30
  log(f"phase 12: {cfg.name} at its published widths and depth "
      f"({cfg.num_layers} layers, d_model {cfg.d_model}, GQA "
      f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
      f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied embeddings, remat "
      f"{cfg.remat}): {n_params:,} params; parameters, gradients and two "
      f"AdamW moments {state_gib:.2f} GiB f32; initialized in {t_init:.3f} s")
  b, s = TRAIN_BATCH
  batches = [synthetic_batch(cfg, b, s, step=i, seed=seed) for i in (0, 1)]
  step = make_train_step(model, peak_lr=3e-4, warmup=2, total_steps=100)
  metrics = []
  t0 = time.perf_counter()
  params, opt, m = step(params, opt, batches[0])
  metrics.append(m)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - t0
  events = [torch.cuda.Event(enable_timing=True)
            for _ in range(TRAIN_STEPS - 1)]
  events[0].record()
  for i in range(1, TRAIN_STEPS - 1):
    params, opt, m = step(params, opt, batches[i % 2])
    metrics.append(m)
    events[i].record()
  torch.cuda.synchronize()
  step_ms = [events[i - 1].elapsed_time(events[i])
             for i in range(1, TRAIN_STEPS - 1)]
  last = []
  busy = device_busy(lambda: last.append(
      step(params, opt, batches[(TRAIN_STEPS - 1) % 2])), top=10**6)
  classes = kernel_classes(busy["top_kernels_ms"])
  busy["top_kernels_ms"] = busy["top_kernels_ms"][:8]
  params, opt, m = last[0]
  metrics.append(m)
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  losses = [float(m["loss"]) for m in metrics]
  gnorms = [float(m["grad_norm"]) for m in metrics]
  lrs = [float(m["lr"]) for m in metrics]
  mean_ms = sum(step_ms) / len(step_ms)
  log(f"phase 12: train step {b}x{s} tokens: first {first_s:.3f} s, then "
      f"{mean_ms:.2f} ms (CUDA events, mean of {len(step_ms)}; "
      + ", ".join(f"{x:.2f}" for x in step_ms)
      + f"), {b * s / mean_ms * 1e3:.0f} tokens/s")
  log(f"phase 12: losses over {TRAIN_STEPS} steps on two alternating "
      f"batches " + ", ".join(f"{x:.4f}" for x in losses)
      + "; grad norms " + ", ".join(f"{x:.3f}" for x in gnorms)
      + "; lr " + ", ".join(f"{x:.3g}" for x in lrs))
  if not all(map(math.isfinite, losses + gnorms)):
    raise AssertionError("phase 12: a loss or grad norm is not finite")
  if not sum(losses[-2:]) < sum(losses[:2]):
    raise AssertionError("phase 12: the loss did not fall")
  log(busy_line(f"phase 12: train step {b}x{s}", busy))
  log("phase 12: device ms by kernel class " + ", ".join(
      f"{c} {ms:.2f}" for c, ms in classes.items()))
  log(f"phase 12: peak device memory over the steps {peak_gib:.2f} GiB "
      f"(state {state_gib:.2f} GiB)")
  # The optimizer update alone, on zero gradients at lr 0 (the same
  # arithmetic and bytes as a step's; the parameters do not move).
  zeros = tree_map(torch.zeros_like, params)
  lr0 = torch.zeros((), device="cuda")
  update_ms = cuda_ms(lambda: adamw_update(zeros, opt, params, lr=lr0),
                      iters=3, warmup=1)
  del zeros
  log(f"phase 12: optimizer update {update_ms:.2f} ms (CUDA events, mean of "
      f"3), forward+backward by difference {mean_ms - update_ms:.2f} ms "
      f"({(mean_ms - update_ms) / mean_ms:.3f} of the step)")
  # The GEMMs' bf16 FLOPs a step: every layer matrix multiplies each token
  # in the forward, its recomputation and the two backward products, the
  # tied unembedding in the forward and its two backward products.
  vpad = cfg.padded_vocab(1)
  layer_params = n_params - vpad * cfg.d_model
  gemm_flops = 8 * b * s * layer_params + 6 * b * s * cfg.d_model * vpad
  out["train"] = {
      "config": cfg.name, "num_layers": cfg.num_layers, "params": n_params,
      "state_gib": state_gib, "init_s": t_init, "batch": [b, s],
      "first_step_s": first_s, "step_ms": step_ms, "mean_step_ms": mean_ms,
      "tokens_per_s": b * s / mean_ms * 1e3, "losses": losses,
      "grad_norms": gnorms, "lrs": lrs, "profile": busy,
      "device_ms_by_class": classes,
      "update_ms": update_ms, "peak_device_gib": peak_gib,
      "gemm_flops": gemm_flops,
      "gemm_bound_ms": gemm_flops / H100_BF16_OPS_PER_S * 1e3}
  del params, opt, m, metrics, last, batches, busy
  torch.cuda.empty_cache()

  # b. Remat full against none at 4 layers; the card against the host at
  # 2 layers in float32.
  remat = {}
  cfg4 = cfg.scaled(num_layers=4)
  p4 = init_params(build_model(cfg4).defs(), gen)
  batch = synthetic_batch(cfg4, b, s, step=2, seed=seed)
  base_gib = torch.cuda.memory_allocated() / 2**30
  grads = {}
  for mode in ("full", "none"):
    torch.cuda.reset_peak_memory_stats()
    _, grads[mode] = grads_of(build_model(cfg4.scaled(remat=mode)), p4, batch)
    torch.cuda.synchronize()
    remat[f"peak_gib_{mode}"] = torch.cuda.max_memory_allocated() / 2**30
  gap = remat["grad_gap"] = grad_gap(grads["full"], grads["none"])
  remat["bitwise"] = all(torch.equal(x, y) for x, y in zip(
      tree_leaves(grads["full"]), tree_leaves(grads["none"])))
  log(f"phase 12: 4 layers, {b}x{s}, bf16 compute: peak device memory with "
      f"remat full {remat['peak_gib_full']:.2f} GiB, none "
      f"{remat['peak_gib_none']:.2f} GiB (weights and batch {base_gib:.2f}); "
      f"gradients full vs none: largest gap {gap:.3g} of a leaf's max|g| "
      f"(bit for bit: {remat['bitwise']}; tolerance {REMAT_GRAD_TOL:.4g})")
  if not gap <= REMAT_GRAD_TOL:
    raise AssertionError("phase 12: remat full and none disagree")
  del p4, grads, batch
  torch.cuda.empty_cache()

  cfg2 = cfg.scaled(num_layers=2, dtype="float32")
  model2 = build_model(cfg2)
  p2 = init_params(model2.defs(), gen)
  batch = synthetic_batch(cfg2, 1, 256, step=3, seed=seed)
  loss_c, g_c = grads_of(model2, p2, batch)
  t0 = time.perf_counter()
  loss_h, g_h = grads_of(model2, tree_map(lambda t: t.cpu(), p2),
                         {k: v.cpu() for k, v in batch.items()})
  host_s = time.perf_counter() - t0
  host_gap = grad_gap(g_c, g_h)
  loss_rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
  log(f"phase 12: 2 layers, 1x256, f32 compute, card vs host: loss "
      f"{float(loss_c):.6f} vs {float(loss_h):.6f} (rel {loss_rel:.3g}, "
      f"tolerance {HOST_LOSS_RTOL}); largest gradient gap {host_gap:.3g} of "
      f"a leaf's max|g| (tolerance {HOST_GRAD_TOL}); host pass {host_s:.1f} s")
  if not (loss_rel <= HOST_LOSS_RTOL and host_gap <= HOST_GRAD_TOL):
    raise AssertionError("phase 12: the card and the host disagree")
  out["remat"] = remat
  out["host"] = {"loss_card": float(loss_c), "loss_host": float(loss_h),
                 "loss_rel": loss_rel, "grad_gap": host_gap,
                 "host_s": host_s}
  del p2, g_c, g_h, batch
  torch.cuda.empty_cache()

  # c. Checkpoint and resume through the driver, at 2 layers.
  name = f"{TRAIN_ARCH}_l2"
  register_config(name, cfg.scaled(num_layers=2))
  common = ["--arch", name, "--batch", "4", "--seq", "256", "--seed",
            str(seed), "--log-every", "1"]
  with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
    t0 = time.perf_counter()
    first = train_driver.train(common + ["--steps", "3", "--ckpt-dir", d,
                                         "--ckpt-every-s", "0"])
    t_first = time.perf_counter() - t0
    saved = {"params": first["params"], "opt": first["opt"]}
    restored = restore_checkpoint(d, 3, saved)
    same_saved = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(restored), tree_leaves(saved)))
    del restored, saved, first
    t0 = time.perf_counter()
    second = train_driver.train(common + ["--steps", "6", "--ckpt-dir", d])
    t_second = time.perf_counter() - t0
  whole = train_driver.train(common + ["--steps", "6"])
  pairs = list(zip(tree_leaves((second["params"], second["opt"])),
                   tree_leaves((whole["params"], whole["opt"]))))
  bitwise = all(torch.equal(x, y) for x, y in pairs)
  p_gap = max(float((x.float() - y.float()).abs().max())
              for x, y in pairs[:len(tree_leaves(whole["params"]))])
  log(f"phase 12: launch/train.py at 2 layers: 3 steps checkpointed every "
      f"step ({t_first:.1f} s), restart to 6 resumed at step "
      f"{second['start']} ({t_second:.1f} s); restored == saved bit for bit: "
      f"{same_saved}; losses {second['losses']} vs uninterrupted "
      f"{whole['losses'][3:]}; final state bit for bit: {bitwise}, largest "
      f"parameter gap {p_gap:.3g} (tolerance {RESUME_PARAM_ATOL})")
  if not (same_saved and second["start"] == 3
          and p_gap <= RESUME_PARAM_ATOL):
    raise AssertionError("phase 12: resume differs from the uninterrupted run")
  out["resume"] = {"restored_equals_saved": same_saved,
                   "resumed_at": second["start"], "final_bitwise": bitwise,
                   "param_gap": p_gap, "first_run_s": t_first,
                   "second_run_s": t_second,
                   "losses_resumed": second["losses"],
                   "losses_whole": whole["losses"]}
  del second, whole, pairs
  torch.cuda.empty_cache()
  return out


def phase_eval_fused(ss_mod, seed: int = 0) -> dict:
  """The eval step of Falcon-Mamba-7B (8 of 64 layers, full width) with
  the fused scan and with ``assoc``; a fused train step must raise."""
  import torch
  from repro_torch import configs
  from repro_torch.models.common import init_params
  from repro_torch.models.transformer import build_model
  from repro_torch.train import (adamw_init, make_eval_step,
                                 make_train_step, synthetic_batch)

  full = configs.get_config(EVAL_ARCH)
  cfg = full.scaled(num_layers=EVAL_LAYERS, ssm_impl="fused")
  fused = build_model(cfg)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  params = init_params(fused.defs(), gen)
  b, s = TRAIN_BATCH
  batch = synthetic_batch(cfg, b, s, step=0, seed=seed)
  ss_mod.launches = 0
  got = make_eval_step(fused)(params, batch)
  launches = ss_mod.launches
  want = make_eval_step(build_model(cfg.scaled(ssm_impl="assoc")))(params,
                                                                   batch)
  lf, la = float(got["loss"]), float(want["loss"])
  rel = abs(lf - la) / abs(la)
  eval_ms = cuda_ms(lambda: make_eval_step(fused)(params, batch), iters=2,
                    warmup=1)
  log(f"phase 12: {cfg.name} eval step ({EVAL_LAYERS} of {full.num_layers} "
      f"layers, {b}x{s}): fused loss {lf:.5f} with {launches} scan launches, "
      f"assoc {la:.5f} (rel {rel:.3g}, tolerance {FUSED_ASSOC_TOL}); fused "
      f"eval {eval_ms:.2f} ms")
  if not (math.isfinite(lf) and rel <= FUSED_ASSOC_TOL):
    raise AssertionError("phase 12: fused and assoc eval losses disagree")
  if launches != EVAL_LAYERS:
    raise AssertionError(f"phase 12: {launches} scan launches in an eval "
                         f"step of {EVAL_LAYERS} layers")
  small = {k: v[:1, :256] for k, v in batch.items()}
  try:
    make_train_step(fused)(params, adamw_init(params), small)
  except RuntimeError as e:
    refused = str(e)
  else:
    raise AssertionError("phase 12: a fused train step did not raise")
  log(f"phase 12: a fused train step raises: {refused}")
  del params
  torch.cuda.empty_cache()
  return {"config": cfg.name, "num_layers": EVAL_LAYERS, "batch": [b, s],
          "scan_launches_per_eval": launches, "loss_fused": lf,
          "loss_assoc": la, "loss_rel": rel, "eval_ms": eval_ms,
          "fused_train_step_error": refused}


# ---------------------------------------------------------------------------
# Phase 13: the sharded LM on a 1×1 DeviceMesh; the dry run on the card
# ---------------------------------------------------------------------------

SHARD_ARCH = "granite_3_2b"
SHARD_BATCH = (4, 2048)
SHARD_SCAN_ARCH, SHARD_SCAN_LAYERS = "falcon_mamba_7b", 8
# NVIDIA's data sheet, H100 SXM: dense bf16 tensor-core rate (700 W).
H100_BF16_FLOPS_PER_S = 989e12
# The dry run's cells, traced in a child process on a fake process group
# (no card): the reference test's two cells and its skip, and the two steps
# of this phase on a fake 1×1 mesh at the sizes the card runs them.  Each
# cell's record (``launch/dryrun.py``'s JSON) goes to DRYRUN_RECORDS.
DRYRUN_RECORDS = OUT_DIR / "dryrun"
DRYRUN_CHILD = r"""
import json, os, sys, time
from repro_torch.launch.dryrun import run_cell, build_cell, SkipCell
keys = ("devices", "flops", "product_flops", "bytes_accessed",
        "collective_bytes", "argument_size_in_bytes", "temp_size_in_bytes",
        "output_size_in_bytes", "trace_s")
out = {}
records = %(records)r
os.makedirs(records, exist_ok=True)
def cell(name, *a, **k):
    rec = run_cell(*a, **k)
    with open(os.path.join(records, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    out[name] = {key: rec[key] for key in keys}
    print(name, json.dumps(out[name]), flush=True)
cell("prefill_1x1", "granite-3-2b", "prefill_32k", False, mesh_shape=(1, 1),
     batch=%(b)d, seq=%(s)d)
cell("train_1x1", "granite-3-2b", "train_4k", False, mesh_shape=(1, 1),
     batch=%(b)d, seq=%(s)d, fsdp=False)
cell("decode_32k_seq", "granite-3-2b", "decode_32k", False,
     cache_layout="seq")
cell("train_4k_2x16x16", "granite-3-2b", "train_4k", True)
try:
    build_cell("granite-3-2b", "long_500k", False)
    out["long_500k_skipped"] = False
except SkipCell as e:
    out["long_500k_skipped"] = str(e)
print("RESULT:" + json.dumps(out), flush=True)
"""


def start_dryrun_child():
  """Start the dry run's child (host only: it never sees the card); its
  output goes to ``chiprun_out/dryrun_child.log``, and each cell's record
  to ``DRYRUN_RECORDS`` (phase 15's roofline reads them)."""
  import os
  import shutil
  OUT_DIR.mkdir(exist_ok=True)
  shutil.rmtree(DRYRUN_RECORDS, ignore_errors=True)
  env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
             CUDA_VISIBLE_DEVICES="")
  logf = open(OUT_DIR / "dryrun_child.log", "w")
  code = DRYRUN_CHILD % {"b": SHARD_BATCH[0], "s": SHARD_BATCH[1],
                         "records": str(DRYRUN_RECORDS)}
  proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                          stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT)
  proc.logf = logf
  proc.t0 = time.perf_counter()
  return proc


def stop_dryrun_child(proc) -> None:
  if proc.poll() is None:
    proc.kill()
    proc.wait()
  proc.logf.close()


def collect_dryrun_child(proc, timeout: float = 600) -> dict:
  """Wait for the child; its failure fails the run."""
  try:
    rc = proc.wait(timeout=timeout)
  finally:
    stop_dryrun_child(proc)
  text = (OUT_DIR / "dryrun_child.log").read_text()
  lines = [l for l in text.splitlines() if l.startswith("RESULT:")]
  if rc != 0 or not lines:
    raise AssertionError(f"phase 13: the dry run's child failed (rc {rc}):\n"
                         + text[-3000:])
  out = json.loads(lines[-1][len("RESULT:"):])
  out["wall_s"] = time.perf_counter() - proc.t0
  return out


def storage_bytes(tree) -> int:
  """Summed ``untyped_storage().nbytes()`` of a tree's tensors (a DTensor's
  local shard)."""
  from torch.distributed.tensor import DTensor
  from repro_torch._tree import tree_leaves
  total = 0
  for t in tree_leaves(tree):
    if isinstance(t, DTensor):
      t = t.to_local()
    total += t.untyped_storage().nbytes()
  return total


def bitwise(got, want, what: str) -> None:
  """``got`` (DTensors or tensors) equal to ``want`` bit for bit, leaf by
  leaf."""
  from torch.distributed.tensor import DTensor
  from repro_torch._tree import tree_flatten_with_path
  import torch
  for (k, g), (_, w) in zip(tree_flatten_with_path(got),
                            tree_flatten_with_path(want)):
    g = g.to_local() if isinstance(g, DTensor) else g
    if not torch.equal(g, w):
      err = float((g.float() - w.float()).abs().max())
      raise AssertionError(f"phase 13: {what} {k or ''} differs from the "
                           f"unsharded one (max abs {err:.3g})")


def phase_sharded(ss_mod, ell_mod, child, seed: int = 0) -> dict:
  """The sharded LM on the card: Granite-3-2B's prefill, gradients and train
  step as DTensors on a 1×1 mesh against the unsharded port, the dry run's
  predictions against the card's run, and the fused scan through
  ``local_map``."""
  import socket
  import torch
  import torch.distributed as dist
  from torch.distributed.device_mesh import init_device_mesh

  with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
  dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                          world_size=1, rank=0,
                          device_id=torch.device("cuda", 0))
  try:
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    out = {"mesh": "1x1 (data, model), NCCL, world size 1"}
    out.update(_sharded_granite(mesh, seed, child))
    torch.cuda.empty_cache()
    out["falcon_fused"] = _sharded_scan(mesh, ss_mod, ell_mod, seed)
  finally:
    dist.destroy_process_group()
  return out


def _place_batch(batch, mesh, cfg):
  from repro_torch.launch import specs as S
  from repro_torch.models import common as cm
  b, s = batch["tokens"].shape
  _, specs = S.batch_specs(cfg, b, s, ("data",), 1,
                           with_labels="labels" in batch)
  return cm.distribute_params(batch, S.named(mesh, specs))


def _sharded_granite(mesh, seed: int, child) -> dict:
  import torch
  from repro_torch import configs
  from repro_torch.analysis import analyze
  from repro_torch.launch import specs as S
  from repro_torch.models import common as cm
  from repro_torch.models.transformer import build_model
  from repro_torch.serve.engine import make_prefill
  from repro_torch.train import adamw_init, make_train_step, synthetic_batch

  cfg = configs.get_config(SHARD_ARCH)
  plain = build_model(cfg)
  sharded = build_model(cfg, tp=1, dp_spec="data")
  defs = sharded.defs()
  gen = torch.Generator(device="cuda").manual_seed(seed)
  params = cm.init_params(defs, gen)
  sp = cm.distribute_params(params, cm.param_shardings(defs, mesh))
  shared = all(a.to_local().untyped_storage().data_ptr()
               == b.untyped_storage().data_ptr()
               for a, b in zip(_leaves(sp), _leaves(params)))
  b, s = SHARD_BATCH
  batch = synthetic_batch(cfg, b, s, step=0, seed=seed)
  prompt = {"tokens": batch["tokens"]}
  sprompt = _place_batch(prompt, mesh, cfg)
  sbatch = _place_batch(batch, mesh, cfg)
  log(f"phase 13: {cfg.name} ({cfg.num_layers} layers, "
      f"{cm.num_params(defs):,} params) placed by param_shardings on a 1x1 "
      f"('data', 'model') DeviceMesh over NCCL (world size 1), "
      f"build_model(tp=1, dp_spec='data'); the DTensor shards share the "
      f"unsharded parameters' storage: {shared}")
  pre_u, pre_s = make_prefill(plain), make_prefill(sharded)
  want = pre_u(params, prompt)
  got = pre_s(sp, sprompt)
  bitwise(got, want, "prefill logits")
  if not torch.isfinite(want).all():
    raise AssertionError("phase 13: prefill logits are not finite")
  del got, want
  # Both warmed by the check above.
  plain_ms = cuda_ms(lambda: pre_u(params, prompt), iters=3, warmup=0)
  shard_ms = cuda_ms(lambda: pre_s(sp, sprompt), iters=3, warmup=0)
  count = analyze(pre_s, sp, sprompt)
  prefill_flops = count["flops"]
  del count["out"]
  log(f"phase 13: prefill {b}x{s}: sharded logits == unsharded bit for bit; "
      f"{shard_ms:.2f} ms sharded, {plain_ms:.2f} ms unsharded (CUDA events, "
      f"mean of 3)")

  torch.cuda.synchronize()
  t0 = time.perf_counter()
  loss_u, g_u = grads_of(plain, params, batch)
  torch.cuda.synchronize()
  grad_plain_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  loss_s, g_s = grads_of(sharded, sp, sbatch)
  torch.cuda.synchronize()
  grad_shard_s = time.perf_counter() - t0
  bitwise(loss_s, loss_u, "loss")
  bitwise(g_s, g_u, "gradient")
  n_leaves = len(_leaves(g_u))
  del g_u, g_s
  torch.cuda.empty_cache()
  log(f"phase 13: loss {float(loss_u):.6f} and all {n_leaves} gradient "
      f"leaves: sharded == unsharded bit for bit; forward+backward "
      f"{grad_shard_s:.3f} s sharded, {grad_plain_s:.3f} s unsharded")

  # The moments as DTensors placed like their parameters (zeros_like); the
  # step count replicated: the placements opt_state_pspecs gives.
  opt = adamw_init(sp)
  opt = opt._replace(step=cm.named(mesh, cm.P()).place(opt.step))
  want_pl = S.named(mesh, S.opt_state_pspecs(defs))
  if [t.placements for t in _leaves(opt)] != \
      [sh.placements for sh in _leaves(want_pl)]:
    raise AssertionError("phase 13: the AdamW state is not placed as "
                         "opt_state_pspecs says")
  step = make_train_step(sharded, peak_lr=3e-4, warmup=2, total_steps=100)
  arg_prefill = storage_bytes((sp, sprompt))
  arg_train = storage_bytes((sp, opt, sbatch))
  count = analyze(step, sp, opt, sbatch)
  _, opt, m = count.pop("out")
  train_flops = count["flops"]
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, opt, m2 = step(sp, opt, sbatch)
  torch.cuda.synchronize()
  train_ms = (time.perf_counter() - t0) * 1e3
  losses = [float(m["loss"].full_tensor()), float(m2["loss"].full_tensor())]
  lrs = [float(m["lr"].full_tensor()), float(m2["lr"].full_tensor())]
  if not all(map(math.isfinite, losses)):
    raise AssertionError("phase 13: a sharded train step's loss is not "
                         "finite")
  log(f"phase 13: two sharded train steps (AdamW state placed by "
      f"opt_state_pspecs): losses {losses[0]:.6f}, {losses[1]:.6f} at lr "
      f"{lrs[0]:.3g}, {lrs[1]:.3g} (the warm-up's first lr is 0); the "
      f"second took {train_ms:.1f} ms (host clock, synchronized)")

  dry = collect_dryrun_child(child)
  checks = {}
  for name, real_flops, real_args in (
      ("prefill_1x1", prefill_flops, arg_prefill),
      ("train_1x1", train_flops, arg_train)):
    rec = dry[name]
    checks[name] = {"dry_flops": rec["flops"], "card_flops": real_flops,
                    "dry_argument_bytes": rec["argument_size_in_bytes"],
                    "card_storage_bytes": real_args,
                    "dry_temp_bytes": rec["temp_size_in_bytes"],
                    "trace_s": rec["trace_s"]}
    log(f"phase 13: dry run {name}: flops {rec['flops']:.6e} (card "
        f"{real_flops:.6e}), argument bytes {rec['argument_size_in_bytes']:,}"
        f" (card storage {real_args:,}), temp bytes "
        f"{rec['temp_size_in_bytes']:,}, traced in {rec['trace_s']} s")
    if rec["flops"] != real_flops:
      raise AssertionError(f"phase 13: {name}: the dry run's flops differ "
                           "from the card's count")
    if rec["argument_size_in_bytes"] != real_args:
      raise AssertionError(f"phase 13: {name}: the dry run's argument bytes "
                           "differ from what the card holds")
  shares = {}
  for name, flops, ms in (("prefill", prefill_flops, shard_ms),
                          ("train_step", train_flops, train_ms)):
    shares[name] = flops / (ms * 1e-3) / H100_BF16_FLOPS_PER_S
    log(f"phase 13: {name} {b}x{s}: {flops:.4e} FLOPs (analysis, the card's "
        f"run) / {ms:.2f} ms / {H100_BF16_FLOPS_PER_S:.3g} FLOP/s (data "
        f"sheet, dense bf16) = {shares[name]:.4f} of peak")
  for name in ("decode_32k_seq", "train_4k_2x16x16"):
    rec = dry[name]
    log(f"phase 13: dry run granite-3-2b {name} on {rec['devices']} fake "
        f"ranks: flops {rec['flops']:.4e}, collective bytes "
        f"{rec['collective_bytes']:.4e}, argument bytes "
        f"{rec['argument_size_in_bytes']:,}, temp bytes "
        f"{rec['temp_size_in_bytes']:,} a rank, traced in {rec['trace_s']} s")
  log(f"phase 13: dry run long_500k: {dry['long_500k_skipped']}; the child "
      f"took {dry['wall_s']:.1f} s")
  dec, trn = dry["decode_32k_seq"], dry["train_4k_2x16x16"]
  if not (dec["devices"] == 256 and trn["devices"] == 512
          and dec["flops"] > 0 and dec["collective_bytes"] < 1e9
          and trn["flops"] > 1e13 and dry["long_500k_skipped"]):
    raise AssertionError("phase 13: the dry run's cells miss the reference "
                         "test's bounds: " + json.dumps(dry))
  del sp, params, opt
  return {"config": cfg.name, "batch": [b, s], "shared_storage": shared,
          "prefill_ms": {"sharded": shard_ms, "unsharded": plain_ms},
          "fwd_bwd_s": {"sharded": grad_shard_s, "unsharded": grad_plain_s},
          "train_step_ms": train_ms, "losses": losses,
          "flops_share": shares, "dry_vs_card": checks, "dryrun": dry}


def _leaves(tree):
  from repro_torch._tree import tree_leaves
  return tree_leaves(tree)


def _sharded_scan(mesh, ss_mod, ell_mod, seed: int) -> dict:
  """Falcon-Mamba-7B, 8 of 64 layers at full width, ``ssm_impl="fused"``,
  on the 1×1 mesh: the CUDA scan through ``local_map``."""
  import torch
  from repro_torch import configs
  from repro_torch.models import common as cm
  from repro_torch.models.transformer import build_model
  from repro_torch.serve.engine import make_prefill
  from repro_torch.train import synthetic_batch

  full = configs.get_config(SHARD_SCAN_ARCH)
  cfg = full.scaled(num_layers=SHARD_SCAN_LAYERS, ssm_impl="fused")
  sharded = build_model(cfg, tp=1, dp_spec="data")
  defs = sharded.defs()
  params = cm.init_params(defs, torch.Generator(device="cuda")
                          .manual_seed(seed))
  sp = cm.distribute_params(params, cm.param_shardings(defs, mesh))
  b, s = SHARD_BATCH
  prompt = {"tokens": synthetic_batch(cfg, b, s, seed=seed)["tokens"]}
  want = make_prefill(build_model(cfg))(params, prompt)
  ss_mod.launches = 0
  ell_mod.launches.reset()
  got = make_prefill(sharded)(sp, _place_batch(prompt, mesh, cfg))
  launches = ss_mod.launches
  ell = ell_mod.launches.total
  bitwise(got, want, "fused-scan prefill logits")
  log(f"phase 13: {cfg.name} ({SHARD_SCAN_LAYERS} of {full.num_layers} "
      f"layers, ssm_impl='fused') prefill {b}x{s} on the 1x1 mesh: "
      f"{launches} scan launches through local_map (ELL {ell}); logits == "
      f"the unsharded fused prefill's bit for bit")
  if launches != SHARD_SCAN_LAYERS or ell:
    raise AssertionError(f"phase 13: {launches} scan launches (ELL {ell}) in "
                         f"a sharded prefill of {SHARD_SCAN_LAYERS} layers")
  return {"config": cfg.name, "num_layers": SHARD_SCAN_LAYERS,
          "scan_launches": launches, "ell_launches": ell}


# ---------------------------------------------------------------------------
# Phase 14: the examples on the card
# ---------------------------------------------------------------------------

# The RMAT sections run at scale 18, cut from the card's usual 20: each
# example builds its own graph on the host, and three more RMAT-20 builds
# would add about 70 s of host numpy to phases 3-5's.
EXAMPLE_SCALE = 18
ROAD_PR_ITERS = 20
# A road BFS or SSSP runs some 2,000 supersteps; every 16th kernel call is
# recorded and timed.
ROAD_RECORD_EVERY = 16
# The reference's fair-share split under saturation, at the example's own
# size (RMAT-10; tests/test_torch_examples_service.py holds the CPU to it).
EXAMPLE_FAIR_SPLIT = {"gold": 15, "free": 5}
EXAMPLE_PR_RTOL = 1e-5   # the road grid's PageRank: kernel vs Plan("ell")
DIST_PR_RTOL = 1e-4      # the 2-D delta-PageRank vs one device
SERVE_LM_CUT = ("mixtral_8x7b", 2)
# serve_lm's first greedy token is held to a prefill at this capacity
# factor, under which its 4 × 8 prompt tokens drop no (token, expert) edge.
NO_DROP_CAPACITY = 16.0


def load_example(name: str):
  """``examples/<name>.py`` as the module ``name``, with ``examples/`` on
  ``sys.path``: the distributed example's spawned ranks import it by that
  name."""
  import importlib
  path = str(ROOT / "examples")
  if path not in sys.path:
    sys.path.insert(0, path)
  return importlib.import_module(name)


def timed(fn):
  """``(fn(), seconds)`` on the host clock, ending in a device sync."""
  import torch
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, time.perf_counter() - t0


def examples_road(side: int, ell_mod, ref_mod):
  """The suite's road grid at ``side`` × ``side``: its SSSP section through
  ``build_coo``, then BFS, SSSP and PageRank through ``build_ell`` and
  ``Planner.plan`` (no forced plan), each against ``Plan("ell")``;
  ``Planner.autotune``; the kernel's rows for the kernels line."""
  import dataclasses
  import numpy as np
  import torch
  from repro_torch.algos import pagerank
  from repro_torch.algos.bfs import UNREACHED, bfs_program
  from repro_torch.algos.multi import bfs_column, sssp_column
  from repro_torch.algos.pagerank import init_prop, pagerank_program
  from repro_torch.algos.sssp import sssp_program
  from repro_torch.core import Plan, Planner, build_ell, run_graph_program

  suite = load_example("graph_analytics_suite_torch")
  dev = torch.device("cuda")
  (n, src, dst, w), gen_s = timed(lambda: suite.grid_road_graph(side))
  out = {"side": side, "n": n, "edges": len(src), "generate_s": gen_s}
  log(f"phase 14: road grid {side}x{side}: n = {n:,}, {len(src):,} edges, "
      f"generated in {gen_s:.2f} s")

  ell_mod.launches.reset()
  (coo_dist, mean), coo_s = timed(lambda: suite.road_sssp_section(side,
                                                                  "cuda"))
  out["suite_sssp_coo"] = {"mean": mean, "seconds": coo_s,
                           "ell_launches": ell_mod.launches.total}
  log(f"phase 14: the suite's road SSSP (build_coo): mean shortest distance "
      f"{mean:.2f} in {coo_s:.3f} s (graph build included)")

  g, build_s = timed(lambda: build_ell(src, dst, w, n=n, device="cuda"))
  planner = Planner()
  stats = dataclasses.asdict(planner.stats(g))
  out.update(build_ell_s=build_s, stats=stats)
  log(f"phase 14: road grid ELL built in {build_s:.2f} s; Planner.stats "
      + json.dumps(stats))
  out_deg = torch.from_numpy(np.bincount(src, minlength=n).astype(
      np.float32)).to(dev)
  every = torch.ones((n,), dtype=torch.bool, device=dev)

  def run_bfs(plan):
    st = run_graph_program(g, bfs_program(), *bfs_column(0, n, dev),
                           backend=plan)
    return st.prop, int(st.iteration)

  def run_sssp(plan):
    st = run_graph_program(g, sssp_program(), *sssp_column(0, n, dev),
                           backend=plan)
    return st.prop, int(st.iteration)

  def run_pagerank(plan):
    return (pagerank(g, out_deg, num_iters=ROAD_PR_ITERS, backend=plan),
            ROAD_PR_ITERS)

  runs = {"bfs": (bfs_program(), run_bfs), "sssp": (sssp_program(), run_sssp),
          "pagerank": (pagerank_program(), run_pagerank)}
  plain = Plan("ell")
  got, launches = {}, {}
  for algo, (prog, run) in runs.items():
    plan = planner.plan(g, prog)
    if plan.backend != "cuda_ell":
      raise AssertionError(f"phase 14: Planner.plan put the road grid's "
                           f"{algo} on {plan_name(plan)}, not cuda_ell")
    run(plan)  # warm-up: the kernel's row segments, the allocator
    ell_mod.launches.reset()
    (res, steps), sec = timed(lambda: run(plan))
    launches[algo] = dict(ell_mod.launches.by_config)
    if ell_mod.launches.total == 0:
      raise AssertionError(f"phase 14: the road grid's {algo} through "
                           f"{plan_name(plan)} launched no kernel")
    total = ell_mod.launches.total
    run(plain)
    (want, steps_p), sec_p = timed(lambda: run(plain))
    if algo == "pagerank":
      torch.testing.assert_close(res, want, rtol=EXAMPLE_PR_RTOL, atol=0.0)
      err = float((res.double() - want.double()).abs().max())
    elif not torch.equal(res, want) or steps != steps_p:
      raise AssertionError(f"phase 14: the road grid's {algo}: cuda_ell != "
                           "Plan('ell')")
    else:
      err = 0.0
    got[algo] = res
    out[algo] = {"plan": plan_name(plan), "launches": total,
                 "supersteps": steps, "seconds": sec,
                 "ms_per_superstep": sec / steps * 1e3,
                 "plain_seconds": sec_p,
                 "plain_ms_per_superstep": sec_p / steps_p * 1e3,
                 "max_abs_err": err}
    log(f"phase 14: road {algo}: Planner.plan picks {plan_name(plan)}; "
        f"{steps} supersteps, {total} kernel launches, {sec:.3f} s "
        f"({sec / steps * 1e3:.4f} ms a superstep); Plan('ell') "
        f"{sec_p:.3f} s ({sec_p / steps_p * 1e3:.4f} ms a superstep); "
        + ("max abs err " + f"{err:.3g} at rtol {EXAMPLE_PR_RTOL}"
           if algo == "pagerank" else "equal bitwise"))
  hops = got["bfs"]
  if bool((hops == UNREACHED).any()) or int(hops.max()) != 2 * (side - 1):
    raise AssertionError("phase 14: the road BFS missed a vertex or the "
                         "grid's diameter")
  if not torch.equal(got["sssp"], coo_dist):
    raise AssertionError("phase 14: the suite's COO SSSP != the ELL SSSP")
  log("phase 14: road BFS reaches every vertex at the grid's diameter "
      f"{2 * (side - 1)}; the suite's COO SSSP == the ELL SSSP bitwise")
  del coo_dist, got

  # Measured planning, as ROADMAP Queue 2 K2 asks: every candidate's time.
  tuned = {}
  for name, prog, prop, active in (
      ("bfs,Q=1", bfs_program(), *bfs_column(0, n, dev)),
      ("pagerank,Q=1", pagerank_program(), init_prop(out_deg), every)):
    best, seconds = timed(lambda: planner.autotune(g, prog, prop, active,
                                                   num_iters=2, repeats=3))
    (measured,) = [v for k, v in planner.timings.items()
                   if k[1:] == (prog.name, 1)]
    table = {plan_name(p): (None if t is None else t * 1e3)
             for p, t in measured}
    tuned[name] = {"ms_per_2_supersteps": table, "winner": plan_name(best),
                   "heuristic": plan_name(planner.plan(g, prog)),
                   "seconds": seconds}
    log(f"phase 14: road autotune {name} (2 supersteps, median of 3, ms): "
        + ", ".join(f"{k} {'skipped' if v is None else f'{v:.3f}'}"
                    for k, v in table.items())
        + f"; winner {plan_name(best)}; Planner.plan picks "
        f"{tuned[name]['heuristic']}")
  out["autotune"] = tuned

  # The kernel's rows: timed on every ROAD_RECORD_EVERY-th call of the
  # road BFS and SSSP, and on one all-active PageRank sweep.
  kernel = Plan("cuda_ell")
  recorded = {
      "bfs": record_calls(lambda: run_bfs(kernel), every=ROAD_RECORD_EVERY),
      "sssp": record_calls(lambda: run_sssp(kernel),
                           every=ROAD_RECORD_EVERY)}
  gen = torch.Generator(device="cuda").manual_seed(14)
  entries, csr, records = [], {}, {}
  for algo, op, red, dtype in (
      ("bfs", "msg_plus_one", "min", torch.int32),
      ("sssp", "msg_plus_edge", "min", torch.float32),
      ("pagerank", "msg", "add", torch.float32)):
    calls = ([(m, a) for m, a, _ in recorded[algo]] if algo in recorded
             else None)
    tname = "int32" if dtype == torch.int32 else "f32"
    name = f"ell_spmv[road-grid,{algo},{tname},{red},Q=1]"
    entry, records[name] = time_ell(
        "phase 14", g, ell_mod, ref_mod, gen, csr, name, op, red, dtype, 1,
        None, "src/repro/kernels/ell_spmv.py:192", calls, launches[algo])
    entries.append(entry)

  # The lambda-only programs on the road grid, their generated instances'
  # rows, and e + m against msg_plus_edge on the road SSSP's calls.
  traced, traced_launches, traced_calls = traced_runs(
      "phase 14", g, out_deg, ell_mod, every=ROAD_RECORD_EVERY,
      lane_every=ROAD_RECORD_EVERY, lane_iters=TRACED_ROAD_LANE_ITERS)
  out["traced"] = traced
  traced_calls = {f"traced:{k}": v for k, v in traced_calls.items()}
  traced_entries, traced_records, paired = traced_rows(
      "phase 14", g, ell_mod, ref_mod, gen, csr, traced_launches,
      traced_calls, recorded["sssp"], tag="road-grid,")
  entries += traced_entries
  records.update(traced_records)
  records["sssp_shipped_vs_generated"] = paired
  del recorded, traced_calls, csr, g
  torch.cuda.empty_cache()
  out["kernel_rows"] = records
  return out, entries


def examples_rmat(scale: int, ell_mod) -> dict:
  """The quickstart, the suite's PageRank and BFS, the multi-query service
  and the distributed PageRank at RMAT ``scale``; TC and CF at the suite's
  own sizes."""
  import numpy as np
  import torch
  from repro_torch.algos import pagerank
  from repro_torch.algos.native import native_bfs, native_pagerank
  from repro_torch.algos.pagerank import delta_pagerank_program
  from repro_torch.core import AUTO_PLAN, build_coo, run_graph_program
  from repro_torch.core.backends import base
  from repro_torch.graphs import (dedupe_edges, remove_self_loops,
                                  rmat_edges, shuffle_vertices, symmetrize)

  out = {"scale": scale}
  # The quickstart, declared (process_op) and as the reference's lambda,
  # whose trace equals the declared form: both run its shipped instance.
  qs = load_example("quickstart_torch")
  (g, n), build_s = timed(lambda: qs.build_graph(scale, "cuda"))
  forms = {}
  msg = torch.zeros((n,), dtype=torch.float32, device="cuda")
  for form, declared in (("process_op", True), ("lambda", False)):
    backend = base.resolve(AUTO_PLAN, g, msg, msg, qs.sssp_program(declared))
    qs.run_sssp(g, n, 6, declared)
    ell_mod.launches.reset()
    res, sec = timed(lambda: qs.run_sssp(g, n, 6, declared))
    forms[form] = dict(res, plan=backend.name, seconds=sec,
                       launches=ell_mod.launches.total)
  a, b = forms["process_op"], forms["lambda"]
  if not (torch.equal(a["dist"], b["dist"])
          and a["supersteps"] == b["supersteps"]):
    raise AssertionError("phase 14: the quickstart's two forms disagree")
  if (a["plan"], b["plan"]) != ("cuda_ell", "cuda_ell") or not (
      a["launches"] and b["launches"]):
    raise AssertionError("phase 14: the quickstart's declared form or its "
                         "lambda did not run the kernel: " + json.dumps(
                             {k: (v["plan"], v["launches"])
                              for k, v in forms.items()}))
  out["quickstart"] = {k: {f: v[f] for f in ("plan", "seconds", "launches",
                                             "supersteps", "reached")}
                       for k, v in forms.items()}
  out["quickstart"]["build_s"] = build_s
  log(f"phase 14: quickstart SSSP on RMAT-{scale} from vertex 6: "
      f"{a['supersteps']} supersteps, reached {a['reached']:,}/{n:,}; "
      f"process_op -> {a['plan']} {a['seconds'] * 1e3:.2f} ms "
      f"({a['launches']} launches), lambda -> {b['plan']} "
      f"{b['seconds'] * 1e3:.2f} ms ({b['launches']} launches); distances "
      "equal bitwise")
  del g, forms, a, b

  # The suite's PageRank and BFS, held to the native baselines.
  suite = load_example("graph_analytics_suite_torch")
  ell_mod.launches.reset()
  (ranks, top), pr_s = timed(lambda: suite.pagerank_section(scale, "cuda"))
  pr_launches = ell_mod.launches.total
  ell_mod.launches.reset()
  (hops, ecc), bfs_s = timed(lambda: suite.bfs_section(scale, "cuda"))
  bfs_launches = ell_mod.launches.total
  src, dst, n = suite.rmat_graph(scale)
  out_deg = torch.from_numpy(np.bincount(src, minlength=n).astype(np.float32))
  torch.testing.assert_close(
      ranks, native_pagerank(src, dst, out_deg, n, 20, device="cuda"),
      rtol=1e-4, atol=0.0)
  ss, dd = symmetrize(src, dst)
  if not torch.equal(hops, native_bfs(ss, dd, n, 0, device="cuda")):
    raise AssertionError("phase 14: the suite's BFS != native BFS")
  if not (pr_launches and bfs_launches):
    raise AssertionError("phase 14: the suite's PageRank or BFS launched no "
                         "kernel")
  out["suite"] = {"pagerank": {"top5": top, "seconds": pr_s,
                               "launches": pr_launches},
                  "bfs": {"eccentricity": ecc, "seconds": bfs_s,
                          "launches": bfs_launches}}
  log(f"phase 14: suite PageRank on RMAT-{scale}: top-5 {top}, {pr_s:.3f} s "
      f"with the graph build, {pr_launches} launches, == native at rtol "
      f"1e-4; BFS eccentricity from 0: {ecc}, {bfs_s:.3f} s, {bfs_launches} "
      "launches, == native bitwise")
  del ranks, hops

  # TC and CF at the suite's own sizes (phase 5 runs them at full size).
  tc, tc_s = timed(lambda: suite.triangle_section(10, "cuda"))
  (_, rmse, base_rmse), cf_s = timed(
      lambda: suite.collaborative_filtering_section(device="cuda"))
  if tc != 2921 or not np.isnan(rmse):
    raise AssertionError(f"phase 14: the suite's TC ({tc}) or CF (RMSE "
                         f"{rmse}) is not the reference's (2921, nan)")
  out["suite"].update(tc={"triangles": tc, "seconds": tc_s},
                      cf={"rmse": rmse, "baseline": base_rmse,
                          "seconds": cf_s})
  log(f"phase 14: suite TC at RMAT-10: {tc} triangles ({tc_s:.3f} s); CF "
      f"3000x500: RMSE {rmse} (the reference's nan; baseline "
      f"{base_rmse:.3f}) in {cf_s:.3f} s")

  # The multi-query service's four sections.
  mqs = load_example("multi_query_service_torch")
  graphs, build_s = timed(lambda: mqs.build_graphs(scale, "cuda"))
  served = {"build_s": build_s}
  for name, fn, queries in (("bfs", mqs.serve_bfs, 24),
                            ("ppr", mqs.serve_ppr, 10),
                            ("concurrent", mqs.serve_concurrent, 64),
                            ("fair_share", mqs.serve_fair_share, 40)):
    ell_mod.launches.reset()
    res = fn(graphs)
    rec = {"seconds": res["seconds"], "queries": queries,
           "queries_per_s": queries / res["seconds"],
           "ell_launches": ell_mod.launches.total}
    if "plan" in res:
      rec["plan"] = plan_name(res["plan"])
    served[name] = rec
    if name == "concurrent":
      tally, lat = res["tally"], res["latency_ms"]
      if sum(tally.values()) != queries:
        raise AssertionError(f"phase 14: concurrent tally {tally}")
      rec.update(tally=tally, latency_mean_ms=lat["mean"],
                 latency_max_ms=lat["max"], high_water=res["high_water"])
    if name == "fair_share":
      rec["mid"] = res["mid"]
    log(f"phase 14: service {name} on RMAT-{scale}: {queries} queries in "
        f"{res['seconds']:.3f} s ({rec['queries_per_s']:.2f} queries/s), "
        + json.dumps({k: v for k, v in rec.items()
                      if k not in ("seconds", "queries", "queries_per_s")}))
  fair = mqs.serve_fair_share(mqs.build_graphs(10, "cuda"))
  if fair["mid"] != EXAMPLE_FAIR_SPLIT:
    raise AssertionError(f"phase 14: fair share at RMAT-10 {fair['mid']}, "
                         f"the reference's {EXAMPLE_FAIR_SPLIT}")
  served["fair_share_rmat10"] = fair["mid"]
  log(f"phase 14: fair share at the example's RMAT-10: {fair['mid']} == the "
      "reference's split")
  out["service"] = served
  del graphs

  # The distributed PageRank: 4x2 gloo ranks sharing the card, against one
  # device on the same shuffled edges.
  dpr = load_example("distributed_pagerank_torch")
  res, dist_s = timed(lambda: dpr.pagerank_2d(scale, device="cuda"))
  s, d = rmat_edges(scale, 8, seed=21)
  s, d = remove_self_loops(s, d)
  s, d = dedupe_edges(s, d)
  s, d, _ = shuffle_vertices(s, d, 1 << scale, seed=3)
  n = 1 << scale
  deg = torch.from_numpy(np.bincount(s, minlength=n).astype(np.float32)).cuda()
  full_r = torch.full((n,), dpr.R_DAMP, device="cuda")
  st = run_graph_program(
      build_coo(s, d, n=n, device="cuda"),
      delta_pagerank_program(dpr.R_DAMP, dpr.TOL),
      {"rank": full_r, "delta": full_r.clone(), "deg": deg},
      torch.ones((n,), dtype=torch.bool, device="cuda"),
      max_iters=dpr.MAX_ITERS)
  one = st.prop["rank"].cpu()
  torch.testing.assert_close(torch.from_numpy(res["ranks"]), one,
                             rtol=DIST_PR_RTOL, atol=0.0)
  if res["supersteps"] != int(st.iteration) or not res["every_rank_equal"]:
    raise AssertionError("phase 14: the 2-D PageRank's supersteps or ranks "
                         "differ from one device")
  ms = res["seconds"] / res["supersteps"] * 1e3
  out["distributed"] = {"grid": [4, 2], "backend": "gloo",
                        "supersteps": res["supersteps"],
                        "num_active": res["num_active"],
                        "run_s": res["seconds"], "ms_per_superstep": ms,
                        "launch_s": dist_s, "top5": res["top"],
                        "max_rel_err": float(((torch.from_numpy(res["ranks"])
                                               - one).abs() / one).max())}
  log(f"phase 14: distributed PageRank on RMAT-{scale}, 4x2 gloo ranks on "
      f"one card: {res['supersteps']} supersteps, {ms:.3f} ms a superstep "
      f"(slowest rank, first run), launch {dist_s:.1f} s, top-5 "
      f"{res['top']}; == one device at rtol {DIST_PR_RTOL}")
  return out


def examples_serve_lm() -> dict:
  """The serve_lm example's model on the card, sampled then greedy; then
  Mixtral-8x7B at published widths, ``SERVE_LM_CUT`` layers, greedy."""
  import torch
  from repro_torch import configs
  from repro_torch.models.transformer import build_model
  from repro_torch.serve import make_prefill

  slm = load_example("serve_lm_torch")
  out = {}
  sampled = slm.serve(device="cuda")
  toks, prompt = sampled["tokens"], sampled["prompt"]
  if tuple(toks.shape) != (4, 32) or not torch.equal(toks[:, :8],
                                                      prompt.cpu()):
    raise AssertionError("phase 14: serve_lm's sampled tokens lost the "
                         "prompt")
  greedy = slm.serve(device="cuda", greedy=True, params=sampled["params"],
                     prompt=prompt)
  # A one-token decode group never drops a (token, expert) edge; the
  # prefill is held at a capacity factor under which it drops none either.
  cfg = sampled["model"].cfg
  nodrop = build_model(cfg.scaled(capacity_factor=NO_DROP_CAPACITY))
  logits = make_prefill(nodrop)(sampled["params"], {"tokens": prompt})
  first = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1).cpu()
  if not torch.equal(greedy["tokens"][:, 8].to(first.dtype), first):
    raise AssertionError("phase 14: serve_lm's first greedy token is not "
                         "the argmax of the prefill's last logits")
  out["example"] = {"sampled_s": sampled["seconds"],
                    "greedy_s": greedy["seconds"],
                    "tokens_per_s": 4 * 24 / greedy["seconds"]}
  log(f"phase 14: serve_lm's example model: 4 x 24 sampled tokens in "
      f"{sampled['seconds']:.3f} s, greedy {greedy['seconds']:.3f} s; the "
      "first greedy token == argmax of make_prefill's last logits (capacity "
      f"factor {NO_DROP_CAPACITY:g})")
  del sampled, greedy, logits

  arch, layers = SERVE_LM_CUT
  full = configs.get_config(arch)
  cfg = full.scaled(num_layers=layers)
  torch.cuda.reset_peak_memory_stats()
  warm = slm.serve(cfg, device="cuda", greedy=True, max_new=2)
  run = slm.serve(cfg, device="cuda", greedy=True, params=warm["params"],
                  prompt=warm["prompt"])
  peak = torch.cuda.max_memory_allocated() / 2**30
  n_params = sum(p.numel() for p in _leaves(warm["params"]))
  toks = run["tokens"]
  if tuple(toks.shape) != (4, 32) or not (
      (toks >= 0) & (toks < cfg.vocab_size)).all():
    raise AssertionError("phase 14: Mixtral's greedy tokens are malformed")
  out["mixtral"] = {"config": cfg.name, "num_layers": layers,
                    "params": n_params, "seconds": run["seconds"],
                    "tokens_per_s": 4 * 24 / run["seconds"],
                    "peak_gib": peak}
  log(f"phase 14: {cfg.name} at published widths, {layers} of "
      f"{full.num_layers} layers ({n_params:,} params): 4 x (8 + 24) greedy "
      f"tokens in {run['seconds']:.3f} s ({4 * 24 / run['seconds']:.2f} new "
      f"tokens/s), peak device memory {peak:.2f} GiB")
  del warm, run
  torch.cuda.empty_cache()
  return out


def phase_examples(scale: int, ell_mod, ref_mod):
  """Phase 14: the five torch examples' sections on the card."""
  t0 = time.perf_counter()
  road, entries = examples_road(1 << (scale // 2), ell_mod, ref_mod)
  rmat = examples_rmat(min(scale, EXAMPLE_SCALE), ell_mod)
  lm = examples_serve_lm()
  took = time.perf_counter() - t0
  log(f"phase 14: took {took:.1f} s")
  return {"road": road, "rmat": rmat, "serve_lm": lm, "seconds": took}, \
      entries


# ---------------------------------------------------------------------------
# Phase 15: the benchmark harness on the card
# ---------------------------------------------------------------------------

# The harness's RMAT sections run at scale 18, cut from 20: its triangle
# count runs two scales below the rest (benchmarks/bench_algorithms.py:125),
# and TC above scale 16 does not fit the card (an [E, n/32] gathered bitmap
# is 8.51 GB at scale 16 in phase 5).
BENCH_SCALE = 18
# cuda_ell's PageRank against ell's: the kernel sums in another order.
BENCH_PR_RTOL = 1e-4
# ``python -m benchmarks.run_torch --device cuda`` at the reference's own
# scale 12, scaling included: the reference CLI's section lines and row
# names in order, under run_torch's mapping (pallas -> cuda_ell; the port
# planner's kernel tiles r4 and r16 where the reference sweeps r128 and
# r512).  tests/test_torch_benchmarks.py holds this list to the reference's.
BENCH_CLI_ROWS = (
    "# --- fig4_table2_algorithms ---",
    "pagerank/graphmat_coo", "pagerank/graphmat_ell",
    "pagerank/graphmat_cuda_ell", "pagerank/native",
    "bfs/graphmat_coo", "bfs/graphmat_ell", "bfs/native",
    "sssp/graphmat_coo", "sssp/graphmat_ell", "sssp/native",
    "tri_count/graphmat", "tri_count/native",
    "collab_filter/graphmat", "collab_filter/native",
    "# --- multi_query_serving ---",
    *(f"multi_query/bfs_{be}_q{q}_{how}" for be in ("coo", "ell")
      for q in (1, 8, 64) for how in ("batched", "sequential")),
    "# --- table3_native_gap ---",
    *(f"native_gap/{a}" for a in ("pagerank", "bfs", "sssp", "tri_count",
                                  "collab_filter", "geomean")),
    "# --- fig7_optimizations ---",
    "opt_ladder/1_naive_coo", "opt_ladder/2_frontier", "opt_ladder/3_ell",
    "opt_ladder/4_cuda_ell", "opt_ladder/5_balance_unshuffled",
    "opt_ladder/5_balance_shuffled",
    "planner/coo_coo", "planner/coo_coo_tiled_t2", "planner/coo_coo_tiled_t8",
    "planner/coo_coo_tiled_t32",
    "planner/ell_ell", "planner/ell_cuda_ell", "planner/ell_cuda_ell_r4",
    "planner/ell_cuda_ell_r16",
    "# plan_report", "admission/fifo", "admission/fair", "# admission_report",
    "# --- fig5_scaling ---",
    *(f"scaling/pagerank_{t}" for t in ("1d_1", "1d_2", "1d_4", "1d_8",
                                        "2d_4", "2d_8")))


def cli_row_names(lines) -> list:
  """The section lines and row names of the CLI's CSV (after its header);
  a JSON comment row by its tag."""
  out = []
  for line in lines:
    if line.startswith("# ---"):
      out.append(line)
    elif line.startswith("# "):
      out.append(" ".join(line.split(" ")[:2]))
    else:
      out.append(line.split(",", 1)[0])
  return out


def run_bench_cli(timeout: float = 900) -> dict:
  """``python -m benchmarks.run_torch --device cuda`` in a child process
  (its Fig. 5 section counts in a child of its own); its output goes to
  ``chiprun_out/bench_cli.log``."""
  import os
  env = dict(os.environ, PYTHONPATH=os.pathsep.join(
      [str(ROOT / "src"), str(ROOT)]))
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, "-m", "benchmarks.run_torch", "--device", "cuda"],
      cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
  seconds = time.perf_counter() - t0
  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / "bench_cli.log").write_text(
      proc.stdout + "\n--- stderr ---\n" + proc.stderr)
  lines = proc.stdout.splitlines()
  errors = [line for line in lines if "/ERROR," in line]
  if proc.returncode != 0 or errors or not lines:
    raise AssertionError(f"phase 15: the benchmark CLI failed (rc "
                         f"{proc.returncode}, {errors}):\n"
                         + proc.stderr[-3000:])
  if lines[0] != "name,us_per_call,derived" or \
      cli_row_names(lines[1:]) != list(BENCH_CLI_ROWS):
    raise AssertionError("phase 15: the CLI's rows are not the reference's "
                         "under the mapping: " + json.dumps(
                             cli_row_names(lines[1:])))
  return {"rows": lines[1:], "seconds": seconds}


def _derived(rows, name: str, key: str) -> str:
  """The value of ``key=`` in row ``name``'s derived text."""
  (row,) = [r for r in rows if r.split(",", 1)[0] == name]
  (val,) = [kv.split("=", 1)[1] for kv in row.split(",", 2)[2].split()
            if kv.startswith(key + "=")]
  return val


def _report(rows, tag: str) -> dict:
  (line,) = [r for r in rows if r.startswith(f"# {tag} ")]
  return json.loads(line[len(f"# {tag} "):])


class LaunchesByPlan:
  """Replaces functions of the harness's modules, while it is entered, by
  wrappers that add the ELL kernel's launches during each call (its
  ``launches`` counter) to :attr:`counts` and keep the call's output in
  :attr:`outs`, both under ``"<function>:<plan tag>"`` of the call's
  ``backend=``; a ``Planner.autotune`` call, which runs every candidate
  plan, under ``"autotune:<graph class>"``."""

  def __init__(self, ell_mod, targets):
    self.ell_mod, self.targets = ell_mod, targets
    self.counts, self.outs, self._saved = {}, {}, []

  def _wrap(self, name, fn):
    from benchmarks.bench_optimizations_torch import _plan_tag
    from repro_torch.core.backends import as_plan

    def run(*args, **kw):
      if name == "autotune":  # a method: args[1] is the graph
        key = f"autotune:{type(args[1]).__name__}"
      else:
        key = f"{name}:{_plan_tag(as_plan(kw.get('backend')))}"
      before = self.ell_mod.launches.total
      out = fn(*args, **kw)
      self.counts[key] = (self.counts.get(key, 0)
                          + self.ell_mod.launches.total - before)
      self.outs[key] = out
      return out
    return run

  def __enter__(self):
    for mod, name in self.targets:
      fn = getattr(mod, name)
      self._saved.append((mod, name, fn))
      setattr(mod, name, self._wrap(name, fn))
    return self

  def __exit__(self, *exc):
    for mod, name, fn in self._saved:
      setattr(mod, name, fn)
    self._saved.clear()


def phase_benchmarks(scale: int, ell_mod) -> dict:
  """Phase 15: the port's benchmark harness (``benchmarks/*_torch.py``) on
  the card: the CLI in a child process at the reference's scale 12 with
  its Fig. 5 section; the Fig. 4 / Table 2, multi-query, Table 3 and Fig. 7
  sections in this process at RMAT ``scale``, each once, with the ELL
  kernel's launches counted by plan; the roofline over phase 13's dry-run
  records."""
  import contextlib
  import io

  import numpy as np
  import torch
  if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
  from benchmarks import bench_algorithms_torch as alg
  from benchmarks import bench_native_gap_torch as gap
  from benchmarks import bench_optimizations_torch as opt
  from benchmarks import roofline_torch
  from repro_torch.algos.pagerank import pagerank_program
  from repro_torch.core import build_ell
  from repro_torch.core.backends import Planner

  t0 = time.perf_counter()
  out = {"scale": scale}
  cli = out["cli"] = run_bench_cli()
  log(f"phase 15: python -m benchmarks.run_torch --device cuda (scale 12, "
      f"Fig. 5 at 14): exit 0 in {cli['seconds']:.1f} s, "
      f"{len(cli['rows'])} lines, no ERROR row, the reference's row names "
      "under the mapping")
  for r in cli["rows"]:
    log("phase 15: cli | " + r)

  targets = [(alg, name) for name in (
      "pagerank", "bfs", "sssp", "multi_bfs", "run_batched_rounds",
      "triangle_count", "collaborative_filtering")] + [
          (opt, "run_fixed_iters"), (opt, "sssp"), (Planner, "autotune")]
  ell_mod.launches.reset()
  with LaunchesByPlan(ell_mod, targets) as by_plan:
    rows_alg, s_alg = timed(lambda: alg.main(scale, "cuda"))
    rows_mq, s_mq = timed(lambda: alg.multi_query(scale, "cuda"))
    rows_gap = gap.gap_rows(rows_alg)
    rows_opt, s_opt = timed(lambda: opt.main(scale, device="cuda"))
  launches = ell_mod.launches.total
  counts = by_plan.counts
  log(f"phase 15: RMAT-{scale} sections: algorithms {s_alg:.1f} s, "
      f"multi_query {s_mq:.1f} s, optimizations {s_opt:.1f} s; ELL kernel "
      f"launches {launches} (by call and plan: {json.dumps(counts)})")
  for r in rows_alg + rows_mq + rows_gap + rows_opt:
    log("phase 15: rmat | " + r)

  # The kernel ran where a cuda_ell plan was asked for (autotune on the
  # ELL container times the cuda_ell candidates), and only there.
  tiny = build_ell(np.array([0, 1], np.int32), np.array([1, 0], np.int32),
                   n=2, device="cuda")
  ell_tags = [opt._plan_tag(c) for c in Planner().candidates(
      tiny, pagerank_program())]
  kernel_tags = [t for t in ell_tags if t.startswith("cuda_ell")]
  plans = _report(rows_opt, "plan_report")
  skipped = [t for t in ell_tags if t not in plans["ell"]["candidate_us"]]
  if skipped:
    raise AssertionError(f"phase 15: planner candidates skipped: {skipped}")
  need = ["pagerank:cuda_ell", "autotune:EllGraph"] + [
      f"run_fixed_iters:{t}" for t in kernel_tags]
  idle = [k for k in need if not counts.get(k)]
  stray = [k for k, v in counts.items() if v and k != "autotune:EllGraph"
           and not k.split(":")[1].startswith("cuda_ell")]
  if idle or stray or not launches:
    raise AssertionError("phase 15: the ELL kernel was not launched by "
                         f"{idle}, or launched by {stray}")
  if sum(counts.values()) != launches:
    raise AssertionError(f"phase 15: {launches} ELL kernel launches, of "
                         f"them {sum(counts.values())} by the wrapped calls")
  torch.testing.assert_close(by_plan.outs["pagerank:cuda_ell"],
                             by_plan.outs["pagerank:ell"],
                             rtol=BENCH_PR_RTOL, atol=0.0)
  for t in kernel_tags:
    torch.testing.assert_close(
        by_plan.outs[f"run_fixed_iters:{t}"].prop["rank"],
        by_plan.outs["run_fixed_iters:ell"].prop["rank"],
        rtol=BENCH_PR_RTOL, atol=0.0)
  log(f"phase 15: every cuda_ell candidate timed ({kernel_tags}); every "
      "launch in a wrapped call; the cuda_ell PageRank == ell's at rtol "
      f"{BENCH_PR_RTOL} (the harness's, and each of {kernel_tags} in the "
      "planner sweep); TC == native (the harness's assert)")
  del by_plan

  # The roofline over phase 13's dry-run records.
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    rc = roofline_torch.main(["--dir", str(DRYRUN_RECORDS)])
  table = buf.getvalue().splitlines()
  if rc != 0 or len(table) < 3:
    raise AssertionError("phase 15: the roofline found no dry-run record "
                         f"in {DRYRUN_RECORDS}")
  for line in table:
    log("phase 15: roofline | " + line)
  roof = {}
  for path in sorted(DRYRUN_RECORDS.glob("*.json")):
    rec = json.loads(path.read_text())
    if not rec.get("multi_pod"):
      roof[path.stem] = roofline_torch.analyze_record(rec)

  admission = _report(rows_opt, "admission_report")
  ratios = {a: float(_derived(rows_gap, f"native_gap/{a}",
                              "slowdown").rstrip("x"))
            for a in ("pagerank", "bfs", "sssp", "tri_count",
                      "collab_filter", "geomean")}
  summary = {
      # CF runs at the harness's fixed 2,000 x 400 x 16 at every scale, a
      # launch-bound size; the geomean over the other four is RMAT-18's.
      "table3_geomean": ratios["geomean"],
      "table3_geomean_rmat": float(np.exp(np.mean(np.log(
          [ratios[a] for a in ("pagerank", "bfs", "sssp", "tri_count")])))),
      "table3_collab_filter_2000x400": ratios["collab_filter"],
      "batched_speedup_q64": {
          be: float(_derived(rows_mq, f"multi_query/bfs_{be}_q64_sequential",
                             "batched_speedup").rstrip("x"))
          for be in ("coo", "ell")},
      "plans": {g: {k: plans[g][k] for k in ("heuristic", "autotuned")}
                for g in ("coo", "ell")},
      "admission": {p: {t: v["completed_at_saturation"]
                        for t, v in admission[p]["tenants"].items()}
                    for p in ("fifo", "fair")},
      "projected_speedup_4x2": float(_derived(
          cli["rows"], "scaling/pagerank_2d_8",
          "projected_speedup").rstrip("x")),
  }
  took = time.perf_counter() - t0
  out.update(rows={"algorithms": rows_alg, "multi_query": rows_mq,
                   "native_gap": rows_gap, "optimizations": rows_opt},
             seconds={"algorithms": s_alg, "multi_query": s_mq,
                      "optimizations": s_opt, "phase": took},
             launches=launches, launches_by_plan=counts,
             roofline={"table": table, "records": roof}, summary=summary)
  log(f"phase 15: took {took:.1f} s")
  return out


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--scale", type=int, default=20,
                  help="RMAT scale of the phase-3 graph (a smaller one "
                  "rehearses the run quickly)")
  args = ap.parse_args(argv)

  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 2
  if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
    print("chip_smoke: run from a checkout of the repository "
          "(src/repro_torch is missing)", file=sys.stderr)
    return 2
  sys.path.insert(0, str(ROOT / "src"))
  from repro_torch.kernels import _build
  from repro_torch.kernels import ell_spmv as ell_mod
  from repro_torch.kernels import ref as ref_mod
  from repro_torch.kernels import selective_scan as ss_mod
  from repro_torch.kernels.ref_selective_scan import selective_scan_ref

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  log(card)
  log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
      f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
  t0 = t_run = time.perf_counter()

  def mark(phase: str) -> None:
    log(f"{phase}: ended {time.perf_counter() - t_run:.1f} s into the run")

  generated = traced_libraries(ell_mod)
  _build.load_all([ell_mod.LIBRARY, ss_mod.LIBRARY, *generated.values()])
  builds = {}
  for lib in (ell_mod.LIBRARY, ss_mod.LIBRARY):
    info = lib.info
    builds[lib.source.name] = {k: info[k] for k in ("seconds", "log")}
    log(f"phase 1: built {info['path']} in {info['seconds']:.2f} s")
    log("\n".join(line for line in info["log"].splitlines()
                  if "registers" in line or "error" in line.lower())[:4000])
  # Each generated instance (the kernel over one traced process, one dtype
  # and reduce): its first use built it; a second load finds the build.
  for (name, dtype, k), lib in generated.items():
    if k is not None:
      name = f"{name},K={k}"
    info = lib.info
    ptxas = [line.split("ptxas info    : ")[-1]
             for line in info["log"].splitlines()
             if "registers" in line or "spill" in line]
    again = lib.reloaded()
    again.load()
    builds[f"generated:{name},{dtype}"] = {
        "path": info["path"], "seconds": info["seconds"],
        "cache_hit_seconds": again.info["seconds"], "ptxas": ptxas,
        "log": info["log"]}
    spilled = sum(int(x) for line in ptxas
                  for x in re.findall(r"(\d+) bytes spill", line))
    log(f"phase 1: built the instance of traced {name} ({dtype}) in "
        f"{info['seconds']:.2f} s, loaded again in "
        f"{again.info['seconds']:.2f} s; spill bytes {spilled}; " + "; ".join(
            line for line in ptxas if "registers" in line)[:1500])
  log(f"phase 1: {2 + len(generated)} builds took "
      f"{time.perf_counter() - t0:.2f} s (at most "
      f"{len(os.sched_getaffinity(0))} at once)")

  mark("phase 1")
  sweep = phase_kernel_sweep(ell_mod, ref_mod)
  mark("phase 2")
  slice_stats, g, recorded, edges = phase_slice(args.scale, 32, ell_mod)
  mark("phase 3")
  entries, ell_rows, split, by_frontier = phase_timing(
      g, ell_mod, ref_mod, slice_stats["launches"], recorded,
      slice_stats["traced_launches"], slice_stats["coo_launches"])
  mark("phase 4")
  suite = phase_suite_graph(g, edges, ell_mod)
  dist_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_2d_")
  prep = prepare_2d(edges, g.n, pathlib.Path(dist_tmp.name))
  del g, recorded, edges  # the graph phases' tensors, before TC's bitmaps
  torch.cuda.empty_cache()
  tc_cf, cf_entries = phase_suite_tc_cf(ell_mod, ref_mod)
  suite.update(tc_cf)
  suite["table3"] = t3 = table3(suite)
  log("phase 5: Table 3 on the card, graphmat/native: " + ", ".join(
      f"{a} {v:.3f} (paper {PAPER_TABLE3[a]})" for a, v in t3["ratios"].items())
      + f"; geomean {t3['geomean']:.3f} over five, "
      f"{t3['geomean_paper_four']:.3f} over the paper's four (paper "
      f"{PAPER_GEOMEAN})")
  torch.cuda.empty_cache()
  mark("phase 5")
  scan = phase_scan(ss_mod, selective_scan_ref)
  mark("phase 6")
  lm = phase_lm(ss_mod)
  lm["scan_share_of_prefill"] = (lm["scan_launches_per_prefill"] * scan["ms"]
                                 / lm["prefill_ms"])
  log(f"phase 7: {lm['scan_launches_per_prefill']} scan launches x "
      f"{scan['ms']:.4f} ms = {lm['scan_share_of_prefill']:.4f} of the "
      f"{lm['prefill_ms']:.2f} ms prefill")
  mark("phase 7")
  try:
    dist2d = phase_2d(prep)
  finally:
    dist_tmp.cleanup()
  del prep
  mark("phase 8")
  torch.cuda.empty_cache()
  ell_mod.launches.reset()
  ss_mod.launches = 0
  granite = phase_granite()
  granite["kernel_launches"] = {"ell_spmv": ell_mod.launches.total,
                                "selective_scan": ss_mod.launches}
  log("phase 9: kernel launches on the dense path (none is owed) "
      + json.dumps(granite["kernel_launches"]))
  mark("phase 9")
  torch.cuda.empty_cache()  # Granite's weights went with its phase
  ell_mod.launches.reset()
  ss_mod.launches = 0
  t0 = time.perf_counter()
  moe = {}
  for arch, layers in MOE_CUTS:
    moe[arch] = phase_moe(arch, layers)
    torch.cuda.empty_cache()
  log(f"phase 10: took {time.perf_counter() - t0:.1f} s")
  moe_launches = {"ell_spmv": ell_mod.launches.total,
                  "selective_scan": ss_mod.launches}
  log("phase 10: kernel launches on the moe path (none is owed) "
      + json.dumps(moe_launches))
  if any(moe_launches.values()):
    raise AssertionError("phase 10: a kernel was launched on the moe path")
  moe["kernel_launches"] = moe_launches
  torch.cuda.empty_cache()  # the MoE weights went with their phase
  ell_mod.launches.reset()
  ss_mod.launches = 0
  t0 = time.perf_counter()
  families = {}
  for arch, layers in FAMILY_CUTS:
    families[arch] = phase_family(arch, layers)
    torch.cuda.empty_cache()
  log(f"phase 11: took {time.perf_counter() - t0:.1f} s")
  family_launches = {"ell_spmv": ell_mod.launches.total,
                     "selective_scan": ss_mod.launches}
  log("phase 11: kernel launches on the hybrid, encdec and vlm paths (none "
      "is owed) " + json.dumps(family_launches))
  if any(family_launches.values()):
    raise AssertionError("phase 11: a kernel was launched on these paths")
  families["kernel_launches"] = family_launches
  torch.cuda.empty_cache()
  # The dry run's child is host-only: it runs beside phases 12 and 13.
  child = start_dryrun_child()
  try:
    ell_mod.launches.reset()
    ss_mod.launches = 0
    t0 = time.perf_counter()
    train = phase_train()
    train_launches = {"ell_spmv": ell_mod.launches.total,
                      "selective_scan": ss_mod.launches}
    log("phase 12: kernel launches on the train path (no backward exists "
        "for either kernel) " + json.dumps(train_launches))
    if any(train_launches.values()):
      raise AssertionError("phase 12: a kernel was launched on the train "
                           "path")
    train["kernel_launches"] = train_launches
    train["eval_fused"] = phase_eval_fused(ss_mod)
    log(f"phase 12: took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = phase_sharded(ss_mod, ell_mod, child)
    log(f"phase 13: took {time.perf_counter() - t0:.1f} s")
  finally:
    stop_dryrun_child(child)
  torch.cuda.empty_cache()
  entries += cf_entries
  examples, road_entries = phase_examples(args.scale, ell_mod, ref_mod)
  mark("phase 14")
  entries += road_entries
  torch.cuda.empty_cache()
  benchmarks = phase_benchmarks(min(args.scale, BENCH_SCALE), ell_mod)
  mark("phase 15")
  b, s, _, _ = FALCON_SCAN
  entries.append({
      "name": f"selective_scan[falcon-mamba-7b,f32,B={b},S={s}]",
      "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
      "replaces": "src/repro/kernels/selective_scan.py:78",
      "launches": lm["scan_launches_per_prefill"],
      "max_abs_err": scan["full_width_max_abs_err"], "ms": scan["ms"],
      "plain_ms": scan["plain_ms"], "bound_ms": scan["bound"]["bound_ms"],
      "bound_by": scan["bound"]["bound_by"], "library_ms": None})

  OUT_DIR.mkdir(exist_ok=True)
  (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
      "card": card, "build": builds, "sweep": sweep, "slice": slice_stats,
      "kernels": entries, "ell_rows": ell_rows,
      "ell_ms_by_frontier": by_frontier, "superstep_split": split,
      "suite": suite, "scan": scan, "lm": lm, "dist2d": dist2d,
      "granite": granite, "moe": moe, "families": families,
      "train": train, "sharded": sharded, "examples": examples,
      "benchmarks": benchmarks}, indent=1))
  log("phase 15: summary " + json.dumps(benchmarks["summary"]))
  log(card)
  print(json.dumps({"kernels": entries}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
