"""Build a kernel source with ``nvcc`` and load it with ``ctypes``.

Each CUDA source under ``csrc/`` is compiled for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into ``build/`` at
the repository root.  The file name carries a hash of the source, so an
edited source rebuilds.  Every source exports
``graphmat_cuda_error_string(int)``, which :meth:`CudaLibrary.check` uses
to turn a returned CUDA error code into an exception.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Callable, Iterable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
  home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  path = os.path.join(home, "bin", "nvcc")
  if os.path.exists(path):
    return path
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
  return found


class CudaLibrary:
  """One ``csrc/`` source, compiled once per source hash and loaded.

  ``bind(lib)`` declares the argument and result types of the source's
  entry points.  :attr:`info` holds the library path, the seconds the
  build took (0.0 when an earlier build was found) and the compiler's
  output (``-Xptxas -v``: registers, shared memory and spills per kernel).
  """

  def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
    self.source = CSRC / source
    self._bind = bind
    self._lib = None
    self._lock = threading.Lock()
    self.info: dict = {}

  def load(self) -> ctypes.CDLL:
    lib = self._lib  # once loaded, no lock: every launch asks
    if lib is not None:
      return lib
    with self._lock:
      if self._lib is not None:
        return self._lib
      digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
      out = BUILD_DIR / f"libgraphmat_{self.source.stem}_{digest}.so"
      seconds, log = 0.0, ""
      if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
          raise RuntimeError(
              f"nvcc failed on {self.source.name} ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
      lib = ctypes.CDLL(str(out))
      lib.graphmat_cuda_error_string.argtypes = [ctypes.c_int]
      lib.graphmat_cuda_error_string.restype = ctypes.c_char_p
      self._bind(lib)
      self.info.update(path=str(out), seconds=seconds, log=log)
      self._lib = lib
      return lib

  def check(self, rc: int, what: str) -> None:
    """Raise if the C entry point returned a CUDA error code."""
    if rc != 0:
      msg = self._lib.graphmat_cuda_error_string(rc).decode()
      raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def load_all(libraries: Iterable[CudaLibrary]) -> None:
  """Build and load several libraries at once, one ``nvcc`` each."""
  libraries = list(libraries)
  with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
    for future in [pool.submit(lib.load) for lib in libraries]:
      future.result()
