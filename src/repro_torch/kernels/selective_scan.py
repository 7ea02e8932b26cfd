"""Mamba-1 fused selective scan (forward): the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/selective_scan.py::selective_scan_pallas``.
The kernel is ``csrc/selective_scan.cu``; its header says what it computes,
what bounds it (bytes: u and dt read once and y written once, 12 bytes per
(batch, step, channel); the [B,S,C,N] state never reaches device memory)
and how its design answers that (one thread per channel walks the sequence
with h in registers; runs of timesteps are staged in shared memory).

:func:`selective_scan` runs the kernel on CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref_selective_scan.selective_scan_ref`) on CPU
tensors; on a CUDA tensor it launches or raises.  :data:`launches` counts
the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref_selective_scan import selective_scan_ref

MAX_STATE = 16  # the widest h the kernel keeps in registers

launches = 0  # kernel launches, counted where the wrapper launches


def _bind(lib: ctypes.CDLL) -> None:
  fn = lib.graphmat_selective_scan
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
  """
  global launches
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
  tensors = (u, dt, a, bmat, cmat)
  if all(t.device.type == "cpu" for t in tensors):
    return selective_scan_ref(u, dt, a, bmat, cmat)

  dev = u.device
  _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
         "all tensors must lie on one CUDA device")
  _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
  _check(1 <= n <= MAX_STATE, f"N={n} must be in 1..{MAX_STATE}")
  y = torch.empty((b, s, c), dtype=torch.float32, device=dev)
  if y.numel() == 0:
    return y
  lib = LIBRARY.load()
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.graphmat_selective_scan(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), b, s, c, n, stream)
  LIBRARY.check(rc, "selective_scan")
  launches += 1
  return y
