"""The kernel library store: the port's counterpart of
``igneous_tpu/compile_cache.py``.

JAX executables cannot carry over, so the store holds what the port
compiles: the shared libraries ``ops._build`` builds from ``csrc/`` (the
CUDA kernels with nvcc, the host libraries with g++). A worker that finds
its library in the store loads it with ``ctypes`` and runs no compiler.

Key: the library's name, its source digest and compiler flags (what
``_build.library_path`` hashes), the target (``sm_XY`` of the current CUDA
device for nvcc libraries, ``cpu`` for g++ ones), the compiler's
``--version`` text, ``torch.version.cuda`` and ``torch.__version__``. All
of it is digested (blake2b) into the storage key,

    libraries/<name>/<digest of all but the compiler>/<digest of all>.bin

so version skew is a natural miss. A worker with no compiler cannot know
the version, so it takes the entry under the first digest whose header
matches every other field: any compiler's build of exactly this source,
flags and target for this torch.

Entry wire format (as the JAX package's, with its own magic)::

    b"IGXL0001" | u32 header_len | header JSON | body

The header carries the full key, the body's blake2b digest and length,
and the producer's build seconds; the body is the library file.

Semantics (as the JAX package's):

========================  =============================================
condition                 behaviour
========================  =============================================
``IGNEOUS_COMPILE_CACHE``  the library is built as before
unset
entry absent              miss counter, build, write-once put
version or target skew    another digest: a natural miss
truncated or bit-flipped  moved under ``quarantine/``, corrupt counter,
entry                     build, and a good copy is put back
concurrent writers        write-once put (an exists check, and the
                          backend's atomic rename) converges on one entry
store unreadable or       error counter, build (no quiet fallback: a
unwritable                build that fails still raises)
========================  =============================================

The root is ``IGNEOUS_COMPILE_CACHE``, on the port's ``CloudFiles`` (any
of its protocols: file://, mem://, gs://, s3://). Counters: ``device.compile_cache.hit|miss|put|
corrupt|error`` and the device ledger's ``compile_cache`` record; a hit
credits the producer's build seconds as saved. Tuned configurations live
beside the entries under ``tuned/`` (``igneous_tpu_torch.tune``).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from .analysis import knobs
from .observability.device import LEDGER
from .storage_http import HttpError

CACHE_ENV = "IGNEOUS_COMPILE_CACHE"
MAGIC = b"IGXL0001"
ENTRY_PREFIX = "libraries/"
QUARANTINE_PREFIX = "quarantine/"
_DIGEST_SIZE = 20


class CompileCacheError(Exception):
  """An entry failed verification (magic, header, digest or key)."""


def compiler_version(exe) -> Optional[str]:
  """The ``--version`` text of the compiler ``exe`` (a path, or a callable
  that returns one), or None where it cannot be run."""
  try:
    path = exe() if callable(exe) else exe
    proc = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=120)
  except (OSError, RuntimeError, subprocess.SubprocessError):
    return None
  return proc.stdout.strip() if proc.returncode == 0 else None


def target(kind: str) -> str:
  """``sm_XY`` of the current CUDA device for an nvcc library, ``cpu``
  for a g++ one."""
  if kind != "nvcc":
    return "cpu"
  if not torch.cuda.is_available():
    return "none"
  major, minor = torch.cuda.get_device_capability()
  return f"sm_{major}{minor}"


def library_meta(name: str, src: Path, flags: List[str], kind: str,
                 version: Optional[str]) -> dict:
  """The full key of library ``name`` as a JSON-able dict; ``version``
  None where no compiler can be run."""
  return {
    "library": name,
    "source": hashlib.sha256(Path(src).read_bytes()).hexdigest(),
    "flags": " ".join(flags),
    "compiler": kind,
    "compiler_version": version,
    "target": target(kind),
    "torch": str(torch.__version__),
    "cuda": str(torch.version.cuda),
  }


def _digest(obj) -> str:
  return hashlib.blake2b(
    json.dumps(obj, sort_keys=True).encode("utf8"), digest_size=_DIGEST_SIZE
  ).hexdigest()


def _prefix(meta: dict) -> str:
  """The entries of every compiler version of this library and target."""
  rest = {k: v for k, v in meta.items() if k != "compiler_version"}
  return f"{ENTRY_PREFIX}{meta['library']}/{_digest(rest)}/"


def entry_key(meta: dict) -> str:
  return f"{_prefix(meta)}{_digest(meta)}.bin"


def encode_entry(meta: dict, body: bytes, build_s: float) -> bytes:
  header = json.dumps({
    "meta": meta,
    "body_digest": hashlib.blake2b(body, digest_size=_DIGEST_SIZE).hexdigest(),
    "body_len": len(body),
    "build_s": float(build_s),
    "created": time.time(),
  }, sort_keys=True).encode("utf8")
  return MAGIC + len(header).to_bytes(4, "big") + header + body


def decode_entry(data: bytes, meta: dict) -> Tuple[bytes, dict]:
  """(body, header) after full verification. ``meta``'s
  ``compiler_version`` None accepts any version. Raises
  CompileCacheError on any corruption, truncation or key mismatch."""
  hstart = len(MAGIC) + 4
  if len(data) < hstart or data[: len(MAGIC)] != MAGIC:
    raise CompileCacheError("bad magic")
  hend = hstart + int.from_bytes(data[len(MAGIC): hstart], "big")
  if hend > len(data):
    raise CompileCacheError("truncated header")
  try:
    header = json.loads(data[hstart:hend].decode("utf8"))
  except (UnicodeDecodeError, ValueError) as exc:
    raise CompileCacheError(f"unparseable header: {exc}") from exc
  body = data[hend:]
  if not isinstance(header, dict) or len(body) != header.get("body_len", -1):
    raise CompileCacheError("truncated body")
  if hashlib.blake2b(body, digest_size=_DIGEST_SIZE).hexdigest() != header.get("body_digest"):
    raise CompileCacheError("body digest mismatch")
  want = dict(meta)
  if want["compiler_version"] is None:
    want["compiler_version"] = (header.get("meta") or {}).get("compiler_version")
  if header.get("meta") != want:
    raise CompileCacheError("key meta mismatch")
  return body, header


class CompileCache:
  """The library store rooted at a CloudFiles path: entries under
  ``libraries/``, failed ones moved under ``quarantine/``."""

  def __init__(self, cloudpath: str):
    from .storage import CloudFiles

    self.cloudpath = cloudpath
    self.cf = CloudFiles(cloudpath)

  def get(self, meta: dict) -> Optional[Tuple[bytes, dict]]:
    """(body, header) of a verified entry, or None. A corrupt entry is
    quarantined and reads as a miss; with ``compiler_version`` None the
    entries of every compiler version are tried in key order. A store
    that cannot be read raises ``OSError``."""
    if meta["compiler_version"] is not None:
      keys = [entry_key(meta)]
    else:
      # entries only: a concurrent writer's temporary file is not one
      keys = sorted(k for k in self.cf.list(_prefix(meta)) if k.endswith(".bin"))
    for key in keys:
      data = self.cf.get(key)
      if data is None:
        continue
      try:
        return decode_entry(bytes(data), meta)
      except CompileCacheError:
        self.quarantine(key, bytes(data))
    return None

  def put(self, meta: dict, body: bytes, build_s: float) -> bool:
    """Write-once publish; False when the entry already exists (another
    writer won). A store that cannot be written raises ``OSError``."""
    key = entry_key(meta)
    if self.cf.exists(key):
      return False
    self.cf.put(key, encode_entry(meta, body, build_s))
    LEDGER.record_cache_event("puts", meta["library"])
    return True

  def quarantine(self, key: str, data: bytes) -> None:
    """Move a failed entry aside: the evidence stays, and the slot is
    free for the rebuilt library's put."""
    self.cf.put(QUARANTINE_PREFIX + key[len(ENTRY_PREFIX):], data)
    self.cf.delete(key)
    LEDGER.record_cache_event("corrupt", key[len(ENTRY_PREFIX):].split("/", 1)[0])


def get_active() -> Optional[CompileCache]:
  """The store at ``IGNEOUS_COMPILE_CACHE``; None where it is unset, or
  where no storage backend serves its scheme (the error counter ticks)."""
  spec = (knobs.get_str(CACHE_ENV) or "").strip()
  if not spec:
    return None
  try:
    return CompileCache(spec)
  except ValueError:
    LEDGER.record_cache_event("errors")
    return None


# a store that cannot be read or written: the filesystem's errors, and a
# gs:// or s3:// request refused or out of retries
STORE_ERRORS = (OSError, HttpError)


def fetch(store: CompileCache, name: str, src: Path, flags: List[str], kind: str,
          exe, out: Path) -> Optional[dict]:
  """Write library ``name`` from ``store`` to ``out``; returns its build
  record (fetch and saved seconds) on a hit, None on a miss or where the
  store cannot be read (the error counter ticks; the caller builds)."""
  t0 = time.perf_counter()
  try:
    meta = library_meta(name, src, flags, kind, compiler_version(exe))
    hit = store.get(meta)
  except STORE_ERRORS:
    LEDGER.record_cache_event("errors", name)
    return None
  if hit is None:
    LEDGER.record_cache_event("misses", name)
    return None
  body, header = hit
  tmp = out.with_suffix(f".so.fetch{os.getpid()}")
  tmp.write_bytes(body)
  os.replace(tmp, out)
  fetch_s = time.perf_counter() - t0
  saved_s = float(header.get("build_s") or 0.0)
  LEDGER.record_cache_event("hits", name, saved_s=saved_s, fetch_s=fetch_s)
  return {"seconds": 0.0, "ptxas": "", "store": "hit", "fetch_s": fetch_s,
          "saved_s": saved_s}


def publish(store: CompileCache, name: str, src: Path, flags: List[str], kind: str,
            exe, out: Path, build_s: float) -> bool:
  """Put the library just built at ``out`` into ``store``; False where it
  was there already or the store cannot be written (the error counter
  ticks)."""
  try:
    meta = library_meta(name, src, flags, kind, compiler_version(exe))
    return store.put(meta, out.read_bytes(), build_s)
  except STORE_ERRORS:
    LEDGER.record_cache_event("errors", name)
    return False
