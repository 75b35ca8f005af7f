"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with nvcc into a shared library with a plain C
interface under ``igneous_tpu_torch/build/`` and is loaded with ctypes. A
library's file name carries a hash of its source text and the nvcc flags,
so a library built from other source is never loaded. Nothing here runs at
import: the CPU tests import every module and there is no nvcc there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
  "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
  "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per-source build record: seconds spent in nvcc (0 when the library was
# already current) and what ptxas reported (registers, shared memory, spills)
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
  for cand in (
    os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
    shutil.which("nvcc"),
    "/usr/local/cuda/bin/nvcc",
  ):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
  """``build/lib<name>-<hash>.so``: the hash covers the source text of
  ``csrc/<name>.cu`` and the nvcc flags."""
  digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:8]}.so"


def build(name: str) -> Path:
  """Compile ``csrc/<name>.cu`` unless its library already exists."""
  src = CSRC_DIR / f"{name}.cu"
  out = library_path(name)
  if out.exists():
    BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": ""})
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".so.tmp{os.getpid()}")
  cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
  os.replace(tmp, out)
  BUILD_LOG[name] = {
    "seconds": time.perf_counter() - t0, "ptxas": proc.stderr,
  }
  return out


def load(name: str) -> ctypes.CDLL:
  """The loaded library for ``csrc/<name>.cu``, built on first use."""
  with _LOCK:
    lib = _LIBS.get(name)
    if lib is None:
      lib = ctypes.CDLL(str(build(name)))
      _LIBS[name] = lib
    return lib
