"""Mamba-1 fused selective scan (forward): the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/selective_scan.py::selective_scan_pallas``.
The kernel is ``csrc/selective_scan.cu``; its header says what it computes,
what bounds it (the exponentials at the SFU rate, just above the bytes: u
and dt read once and y written once, 12 bytes per (batch, step, channel);
the [B,S,C,N] state never reaches device memory) and how its design
answers that (:func:`lanes_for` threads per channel split the N states
and sum y with a warp-shuffle reduce-scatter; runs of timesteps are copied
into shared memory with ``cp.async``, double-buffered).

:func:`selective_scan` runs the kernel on CUDA tensors (through
:func:`scan_cuda`) and the plain version
(:func:`repro_torch.kernels.ref_selective_scan.selective_scan_ref`) on CPU
tensors; on a CUDA tensor it launches or raises.  :data:`launches` counts
the launches.  The scan has no backward, in either package: under autograd
it raises on both devices rather than return a ``y`` cut off from the graph.
"""

from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref_selective_scan import selective_scan_ref

MAX_STATE = 16  # the widest h the kernel keeps in registers
LANE_CHOICES = (2, 4, 8, 16)  # threads per channel the kernel compiles
# The kernel runs the fewest lanes per channel that give the grid
# TARGET_THREADS threads: 2 at [4, 2048, 8192, 16] and 8 at one batch row,
# the fastest of the four choices at each on an H100 (PERF.md).
TARGET_THREADS = 1 << 16


def lanes_for(batch: int, channels: int) -> int:
  """Lanes per channel :func:`selective_scan` launches for this shape."""
  for lanes in LANE_CHOICES:
    if batch * channels * lanes >= TARGET_THREADS:
      return lanes
  return LANE_CHOICES[-1]


launches = 0  # kernel launches, counted where the wrapper launches


def _bind(lib: ctypes.CDLL) -> None:
  fn = lib.graphmat_selective_scan
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("selective_scan.cu", _bind)


def _check(cond: bool, what: str) -> None:
  if not cond:
    raise ValueError(f"selective_scan: {what}")


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor, *,
                   seq_chunk: int = 256, c_tile: int = 128) -> torch.Tensor:
  """u, dt [B,S,C]; a [C,N] (negative); bmat, cmat [B,S,N] -> y [B,S,C] f32.

  y_t = C_t · h_t with h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·u_t, h_0 = 0.

  ``seq_chunk`` and ``c_tile`` are the TPU kernel's tiles.  They are checked
  as the JAX package checks them (each, cut to the axis it tiles, must
  divide it), so both packages take the same inputs; the CUDA kernel's own
  tiling is fixed and handles any S and C.

  Raises ``RuntimeError`` when grad mode is on and an input requires grad:
  the kernel writes ``y`` through raw pointers, so it has no backward (the
  reference's ``selective_scan_pallas`` cannot be differentiated either).
  The CPU's plain version refuses too, so the two devices agree.
  """
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (u, dt, a, bmat, cmat)):
    raise RuntimeError(
        "selective_scan has no backward: run it under torch.no_grad() or "
        "torch.inference_mode(), or train with ssm_impl='assoc'")
  _check(u.ndim == 3 and dt.shape == u.shape, "u and dt must be [B,S,C]")
  b, s, c = u.shape
  _check(a.ndim == 2 and a.shape[0] == c, "a must be [C,N]")
  n = a.shape[1]
  _check(bmat.shape == (b, s, n) and cmat.shape == (b, s, n),
         "bmat and cmat must be [B,S,N]")
  seq_chunk, c_tile = min(seq_chunk, s), min(c_tile, c)
  _check(s % seq_chunk == 0 and c % c_tile == 0,
         f"seq_chunk {seq_chunk} must divide S={s} and c_tile {c_tile} "
         f"must divide C={c}")
  u, dt, a, bmat, cmat = (x.float() for x in (u, dt, a, bmat, cmat))
  if all(t.device.type == "cpu" for t in (u, dt, a, bmat, cmat)):
    return selective_scan_ref(u, dt, a, bmat, cmat)
  return scan_cuda(u, dt, a, bmat, cmat)


def scan_cuda(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
  """The kernel on float32 CUDA tensors shaped as :func:`selective_scan`
  takes them, with :func:`lanes_for` the shape threads per channel."""
  global launches
  tensors = (u, dt, a, bmat, cmat)
  b, s, c = u.shape
  n = a.shape[1]
  _check(all(t.dtype == torch.float32 for t in tensors),
         "tensors must be float32")
  _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
  _check(1 <= n <= MAX_STATE, f"N={n} must be in 1..{MAX_STATE}")
  dev = u.device
  _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
         "all tensors must lie on one CUDA device")
  y = torch.empty((b, s, c), dtype=torch.float32, device=dev)
  if y.numel() == 0:
    return y
  lib = LIBRARY.load()
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.graphmat_selective_scan(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), b, s, c, n, lanes_for(b, c), stream)
  LIBRARY.check(rc, "selective_scan")
  launches += 1
  return y
