"""Build and load the port's native libraries at first use.

``csrc/<name>.cu`` (the CUDA kernels) compiles with nvcc and
``csrc/<name>.cpp`` (host code: the mesh simplifier) with g++, each into a
shared library with a plain C interface under ``igneous_tpu_torch/build/``,
loaded with ctypes. A library's file name carries a hash of its source text
and the compiler flags, so a library built from other source is never
loaded. A build that fails raises: no caller falls back to another
implementation. Nothing here runs at import: the CPU tests import every
module and there is no nvcc there.

With ``IGNEOUS_COMPILE_CACHE`` set, a library missing here is first
fetched from that store (``compile_cache``), and a library built here is
put there; each compiler run is charged to the device ledger as a
compile (``record_compile``).
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

from .. import compile_cache
from ..observability.device import LEDGER

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
  "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
  "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# the JAX package's flags for its native host libraries, so both build the
# same code from the same source
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per-source build record: seconds spent in the compiler (0 when the
# library was already current or came from the store) and what it
# reported on stderr (for nvcc, ptxas's registers, shared memory and
# spills); a library fetched from the store also has "store": "hit", its
# fetch seconds and the producer's build seconds ("saved_s")
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


def _source(name: str):
  """(source, flags, compiler) of ``name``: ``csrc/<name>.cu`` built by
  nvcc, else ``csrc/<name>.cpp`` built by g++."""
  cu = CSRC_DIR / f"{name}.cu"
  if cu.exists():
    return cu, NVCC_FLAGS, nvcc_path
  return CSRC_DIR / f"{name}.cpp", GXX_FLAGS, lambda: "g++"


def library_path(name: str) -> Path:
  """``build/lib<name>-<hash>.so``: the hash covers the source text and
  the compiler flags."""
  src, flags, _ = _source(name)
  digest = hashlib.sha256(src.read_bytes())
  digest.update(" ".join(flags).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:8]}.so"


def build(name: str) -> Path:
  """Compile ``name``'s source unless its library already exists here or
  in the library store."""
  out = library_path(name)
  if out.exists():
    BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": ""})
    return out
  src, flags, compiler = _source(name)
  kind = "nvcc" if src.suffix == ".cu" else "g++"
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  store = compile_cache.get_active()
  if store is not None:
    record = compile_cache.fetch(store, name, src, flags, kind, compiler, out)
    if record is not None:
      BUILD_LOG[name] = record
      return out
  tmp = out.with_suffix(f".so.tmp{os.getpid()}")
  try:
    cmd = [compiler(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
  except FileNotFoundError as e:
    raise RuntimeError(f"cannot build {src}: {e}") from e
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"{cmd[0]} failed for {src}:\n{proc.stderr}")
  os.replace(tmp, out)
  seconds = time.perf_counter() - t0
  BUILD_LOG[name] = {"seconds": seconds, "ptxas": proc.stderr}
  LEDGER.record_compile(name, seconds)
  if store is not None:
    compile_cache.publish(store, name, src, flags, kind, compiler, out, seconds)
  return out


def load(name: str) -> ctypes.CDLL:
  """The loaded library for ``csrc/<name>``, built on first use."""
  with _LOCK:
    lib = _LIBS.get(name)
    if lib is None:
      lib = ctypes.CDLL(str(build(name)))
      _LIBS[name] = lib
    return lib
