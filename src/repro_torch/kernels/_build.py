"""Build a kernel source with ``nvcc`` and load it with ``ctypes``.

Each CUDA source under ``csrc/``, and each source generated at run time
(the ELL kernel's instance for a traced process, ``kernels/ell_spmv.py``),
is compiled for ``sm_90a`` into its own shared library with a plain C
interface, at first use, into ``build/`` at the repository root.  The file
name carries a hash of the source, of every header under ``csrc/`` and of
the compiler flags, so an edited source or header rebuilds every library
that may include it; a library already built is loaded as it is (the
cache).  A build writes to a temporary name and renames it, under a lock,
so concurrent users see a whole library or none.  Every source exports
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
from typing import Callable, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GENERATED_DIR = BUILD_DIR / "generated"


def _headers() -> bytes:
  """Every header under ``csrc/``, in name order: part of each key."""
  return b"".join(p.name.encode() + p.read_bytes()
                  for p in sorted(CSRC.glob("*.cuh")))


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
  """One source, compiled once per key and loaded.

  ``source`` names a file under ``csrc/``; with ``text``, it names a
  generated source of that text, written under ``build/generated/``.
  ``bind(lib)`` declares the argument and result types of the source's
  entry points.  :attr:`info` holds the library path, the seconds the
  build took (0.0 when an earlier build was found) and the compiler's
  output (``-Xptxas -v``: registers, shared memory and spills per kernel).
  """

  def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None],
               text: Optional[str] = None):
    self.source = CSRC / source if text is None else GENERATED_DIR / source
    self._text = text
    self._bind = bind
    self._lib = None
    self._lock = threading.Lock()
    self.info: dict = {}

  def _key(self) -> str:
    text = (self.source.read_bytes() if self._text is None
            else self._text.encode())
    return hashlib.sha1(text + _headers() + " ".join(NVCC_FLAGS).encode()
                        ).hexdigest()[:12]

  def load(self) -> ctypes.CDLL:
    lib = self._lib  # once loaded, no lock: every launch asks
    if lib is not None:
      return lib
    with self._lock:
      if self._lib is not None:
        return self._lib
      digest = self._key()
      out = BUILD_DIR / f"libgraphmat_{self.source.stem}_{digest}.so"
      seconds, log = 0.0, ""
      if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        source = self.source
        if self._text is not None:
          GENERATED_DIR.mkdir(parents=True, exist_ok=True)
          source = GENERATED_DIR / f"{self.source.stem}_{digest}.cu"
          part = source.with_suffix(f".{os.getpid()}.{threading.get_ident()}")
          part.write_text(self._text)
          os.replace(part, source)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(source)],
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

  def reloaded(self) -> "CudaLibrary":
    """The same source as a library not yet loaded: its :meth:`load` finds
    this one's build (``info["seconds"]`` 0.0) unless a source or header
    changed since."""
    return CudaLibrary(self.source.name, self._bind, text=self._text)

  def check(self, rc: int, what: str) -> None:
    """Raise if the C entry point returned a CUDA error code."""
    if rc != 0:
      msg = self._lib.graphmat_cuda_error_string(rc).decode()
      raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def load_all(libraries: Iterable[CudaLibrary]) -> None:
  """Build and load several libraries at once, one ``nvcc`` each, all
  queued together and at most one running per CPU, in the order given (so
  the longest builds, given first, keep their pace: 29 builds at once on
  8 CPUs stretched the shipped ELL library's 35 s to 57 s)."""
  libraries = list(libraries)
  workers = max(1, min(len(libraries), len(os.sched_getaffinity(0))))
  with concurrent.futures.ThreadPoolExecutor(workers) as pool:
    for future in [pool.submit(lib.load) for lib in libraries]:
      future.result()
