"""Object storage for the port: file://, mem://, gs:// and s3://.

The port's own copy of ``igneous_tpu/storage.py``. It keeps the
CloudFiles file layout: an object compressed with gzip (or zstd) is stored
under ``<key>.gz`` (``<key>.zstd``) and read, listed and deleted under
``<key>``. Gzip is written with ``mtime=0``, so an object written by either
package is byte-identical; ``compress="gzip-N"`` writes level N under the
same ``.gz`` name. zstd needs the ``zstandard`` package, imported behind a
guard: without it a ``.zstd`` object still lists under its key, and reading
or writing one raises ``ImportError``.

gs:// (``storage_gcs.GCSBackend``) and s3:// (``storage_s3.S3Backend``)
speak the services' HTTP APIs on urllib with retries; ``register_protocol``
attaches a backend factory that takes precedence over them, and
``attach_memory_protocol`` serves a protocol from memory.
``set_backend_wrapper`` wraps every backend any protocol builds (the seam
a test uses to tear a write). Every successful ``put`` and ``put_stored``
hands the stored bytes to ``integrity.record_put`` (the write envelope).
The storage trace spans wait for the port's span plane.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
from typing import Dict, Iterable, Iterator, Optional, Tuple, Union

try:
  import zstandard
except ImportError:  # zstd is readable and writable only where the codec is installed
  zstandard = None

from . import integrity
from .observability import trace as _trace
from .lib import jsonify

COMPRESSION_EXTS = {"gzip": ".gz", "zstd": ".zstd", None: "", False: "", "": ""}
# explicit-level gzip ("gzip-1" ... "gzip-9") shares the .gz wire format:
# readers cannot tell levels apart, only writers choose
for _lvl in range(1, 10):
  COMPRESSION_EXTS[f"gzip-{_lvl}"] = ".gz"
_EXT_TO_COMPRESSION = {".gz": "gzip", ".zstd": "zstd"}


def wire_ext(compress) -> Optional[str]:
  """The stored filename extension a ``compress=`` choice gives ("" for
  none), or None for a method the port does not write: callers take that
  as "no compressed-domain move" and decode, where the method raises."""
  try:
    return COMPRESSION_EXTS[compress]
  except (KeyError, TypeError):
    return None


def method_for_ext(ext: str) -> Optional[str]:
  """Inverse of ``wire_ext``: the compression a stored extension implies
  (None for "", uncompressed)."""
  if not ext:
    return None
  return _EXT_TO_COMPRESSION.get(ext)


def stored_exts() -> Tuple[str, ...]:
  """Every extension a stored object may carry, "" first (the order
  ``CloudFiles.get_stored`` probes them in)."""
  return ("",) + tuple(_EXT_TO_COMPRESSION)


def compress_bytes(data: bytes, method) -> bytes:
  if method in (None, False, ""):
    return data
  if method == "gzip" or (isinstance(method, str) and method in COMPRESSION_EXTS
                          and method.startswith("gzip-")):
    level = 6 if method == "gzip" else int(method[5:])
    # mtime=0: re-running a task writes byte-identical objects
    return gzip.compress(data, compresslevel=level, mtime=0)
  if method == "zstd":
    if zstandard is None:
      raise ImportError(
        "zstd compression needs the 'zstandard' package, which this "
        "environment does not ship; use gzip or no compression"
      )
    return zstandard.ZstdCompressor().compress(data)
  raise ValueError(
    f"Unsupported compression: {method} (the port writes gzip, gzip-1..gzip-9, "
    "zstd or none)"
  )


def scratch_compression(default="gzip"):
  """Compression of intermediate files that a later task reads and deletes
  (skeleton fragments, CCL face planes): ``IGNEOUS_SCRATCH_COMPRESS`` picks
  gzip (level 6), gzip-1..gzip-9, zstd or none; unset keeps ``default``.
  zstd keeps ``default`` too where the ``zstandard`` package is missing, as
  in the JAX package."""
  val = os.environ.get("IGNEOUS_SCRATCH_COMPRESS", "").strip().lower()
  if not val:
    return default
  if val in ("none", "raw", "0", "off"):
    return None
  if val == "zstd":
    return default if zstandard is None else "zstd"
  if val == "gzip" or (val.startswith("gzip-") and val in COMPRESSION_EXTS):
    return val
  raise ValueError(
    f"IGNEOUS_SCRATCH_COMPRESS={val!r} unsupported: use "
    "gzip-1..gzip-9, gzip, zstd, or none"
  )


def scratch_gzip_level(default: int) -> int:
  """Gzip level of scratch files that callers compress themselves (the CCL
  face planes): the level ``scratch_compression`` picks, or ``default``
  where it picks no gzip level."""
  method = scratch_compression(f"gzip-{default}")
  if method == "gzip":
    return 6
  if isinstance(method, str) and method.startswith("gzip-"):
    return int(method[5:])
  return default


def decompress_bytes(data: bytes, method) -> bytes:
  if method in (None, False, ""):
    return data
  if method == "gzip":
    return gzip.decompress(data)
  if method == "zstd":
    if zstandard is None:
      raise ImportError(
        "reading a .zstd object needs the 'zstandard' package, which this "
        "environment does not ship"
      )
    return zstandard.ZstdDecompressor().decompress(data)
  raise ValueError(f"Unsupported compression: {method}")


class ExtractedPath:
  __slots__ = ("protocol", "path")

  def __init__(self, protocol: str, path: str):
    self.protocol = protocol
    self.path = path

  def __repr__(self):
    return f"{self.protocol}://{self.path}"


def extract_path(cloudpath: str) -> ExtractedPath:
  """The protocol and path of a cloudpath; a bare path means ``file://``."""
  if "://" in cloudpath:
    protocol, path = cloudpath.split("://", 1)
  else:
    protocol, path = "file", cloudpath
  if protocol == "precomputed":
    return extract_path(path)
  if protocol == "file":
    path = os.path.abspath(os.path.expanduser(path))
  return ExtractedPath(protocol, path.rstrip("/"))


def to_https_path(cloudpath: str) -> str:
  p = extract_path(cloudpath)
  return f"{p.protocol}://{p.path}"


normalize_path = to_https_path


class _FileBackend:
  def __init__(self, root: str):
    self.root = root

  def put(self, key: str, data: bytes):
    path = os.path.join(self.root, key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
    try:
      with open(tmp, "wb") as f:
        f.write(data)
      os.replace(tmp, path)  # atomic within a filesystem
    except BaseException:
      try:
        os.remove(tmp)
      except FileNotFoundError:
        pass
      raise

  def get(self, key: str) -> Optional[bytes]:
    try:
      with open(os.path.join(self.root, key), "rb") as f:
        return f.read()
    except FileNotFoundError:
      return None

  def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
    try:
      with open(os.path.join(self.root, key), "rb") as f:
        f.seek(start)
        return f.read(length)
    except FileNotFoundError:
      return None

  def delete(self, key: str):
    try:
      os.remove(os.path.join(self.root, key))
    except FileNotFoundError:
      pass

  def exists(self, key: str) -> bool:
    return os.path.isfile(os.path.join(self.root, key))

  def size(self, key: str) -> Optional[int]:
    try:
      return os.path.getsize(os.path.join(self.root, key))
    except FileNotFoundError:
      return None

  def list(self, prefix: str = "") -> Iterator[str]:
    # prefix is a path prefix, not necessarily a directory
    directory = os.path.dirname(prefix)
    scandir = os.path.join(self.root, directory) if directory else self.root
    if not os.path.isdir(scandir):
      return
    for dirpath, _dirnames, filenames in os.walk(scandir):
      rel = os.path.relpath(dirpath, self.root)
      rel = "" if rel == "." else rel + "/"
      for fname in sorted(filenames):
        key = rel + fname
        if key.startswith(prefix):
          yield key


_MEM_BUCKETS: Dict[str, Dict[str, bytes]] = {}
_MEM_LOCK = threading.Lock()


def clear_memory_storage():
  with _MEM_LOCK:
    _MEM_BUCKETS.clear()


class _MemBackend:
  """Process-local in-memory store (tests, scratch)."""

  def __init__(self, root: str):
    with _MEM_LOCK:
      self.files = _MEM_BUCKETS.setdefault(root, {})

  def put(self, key: str, data: bytes):
    with _MEM_LOCK:
      self.files[key] = bytes(data)

  def get(self, key: str) -> Optional[bytes]:
    with _MEM_LOCK:
      return self.files.get(key)

  def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
    data = self.get(key)
    return None if data is None else data[start : start + length]

  def delete(self, key: str):
    with _MEM_LOCK:
      self.files.pop(key, None)

  def exists(self, key: str) -> bool:
    with _MEM_LOCK:
      return key in self.files

  def size(self, key: str) -> Optional[int]:
    data = self.get(key)
    return None if data is None else len(data)

  def list(self, prefix: str = "") -> Iterator[str]:
    with _MEM_LOCK:
      keys = sorted(self.files)
    return (k for k in keys if k.startswith(prefix))


_PROTOCOL_HOOKS = {}
# wraps every backend any protocol builds: wrapper(backend, extracted_path)
_BACKEND_WRAPPER = None


def set_backend_wrapper(wrapper):
  """Install (or clear, with None) the wrapper applied to every backend
  that any protocol builds."""
  global _BACKEND_WRAPPER
  _BACKEND_WRAPPER = wrapper


def register_protocol(name: str, factory):
  """Attach ``factory(path) -> backend`` for ``<name>://``; it takes
  precedence over the port's own gs:// and s3:// clients."""
  _PROTOCOL_HOOKS[name] = factory


def attach_memory_protocol(protocol: str):
  """Serve ``<protocol>://`` from in-process memory buckets."""
  register_protocol(protocol, lambda path: _MemBackend(f"{protocol}://{path}"))


def _make_backend(pth: ExtractedPath):
  if pth.protocol == "file":
    backend = _FileBackend(pth.path)
  elif pth.protocol == "mem":
    backend = _MemBackend(pth.path)
  elif pth.protocol in _PROTOCOL_HOOKS:
    backend = _PROTOCOL_HOOKS[pth.protocol](pth.path)
  elif pth.protocol == "gs":
    from .storage_gcs import GCSBackend

    backend = GCSBackend(pth.path)
  elif pth.protocol == "s3":
    from .storage_s3 import S3Backend

    backend = S3Backend(pth.path)
  else:
    raise ValueError(
      f"Protocol {pth.protocol}:// not available in this environment. "
      f"Use register_protocol() to attach a backend."
    )
  if _BACKEND_WRAPPER is not None:
    backend = _BACKEND_WRAPPER(backend, pth)
  return backend


class CloudFiles:
  """get/put/list/delete against a storage root, with compression handling."""

  def __init__(self, cloudpath: str):
    self.cloudpath = cloudpath.rstrip("/")
    self.pth = extract_path(cloudpath)
    self.backend = _make_backend(self.pth)

  # -- write ---------------------------------------------------------------

  def put(self, key: str, content: Union[bytes, str], compress=None):
    if isinstance(content, str):
      content = content.encode("utf8")
    self.put_stored(key, compress_bytes(bytes(content), compress), compress)

  def put_stored(self, key: str, data: bytes, method) -> None:
    """Store bytes that already carry ``method``'s compression as they
    are, under the extension ``method`` implies (the write half of the
    zero-decode transfer), and record them in the write envelope."""
    stored_key = key + COMPRESSION_EXTS[method]
    payload = bytes(data)
    # a span only under a sampled task trace (else one thread-local check)
    with _trace.maybe_span("storage.put", protocol=self.pth.protocol):
      self.backend.put(stored_key, payload)
    integrity.record_put(self.cloudpath, stored_key, payload, backend=self.backend)

  def puts(self, files: Iterable, compress=None) -> int:
    """Put ``(key, content)`` pairs or ``{"path", "content"[, "compress"]}``
    dicts; returns how many."""
    total = 0
    for f in files:
      if isinstance(f, dict):
        self.put(f["path"], f["content"], compress=f.get("compress", compress))
      else:
        key, content = f
        self.put(key, content, compress=compress)
      total += 1
    return total

  def put_json(self, key: str, obj, compress=None):
    self.put(key, json.dumps(jsonify(obj)).encode("utf8"), compress=compress)

  # -- read ----------------------------------------------------------------

  def get_stored(self, key: str) -> Tuple[Optional[bytes], Optional[str]]:
    """(stored bytes, compression method) of ``key``, or (None, None)."""
    with _trace.maybe_span("storage.get", protocol=self.pth.protocol):
      data = self.backend.get(key)
      if data is not None:
        return data, None
      for ext, method in _EXT_TO_COMPRESSION.items():
        data = self.backend.get(key + ext)
        if data is not None:
          return data, method
      return None, None

  def get(self, key: Union[str, Iterable[str]], raw: bool = False):
    """The content of ``key`` (decompressed unless ``raw``), or None; for
    a list of keys, one ``{"path", "content", "error"}`` dict each."""
    if not isinstance(key, str):
      return [{"path": k, "content": self.get(k, raw=raw), "error": None} for k in key]
    data, method = self.get_stored(key)
    if data is None:
      return None
    return data if raw else decompress_bytes(data, method)

  def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
    """Ranged read of the exact (uncompressed) object ``key``."""
    return self.backend.get_range(key, start, length)

  def get_json(self, key: str):
    data = self.get(key)
    return None if data is None else json.loads(data.decode("utf8"))

  def exists(self, key: Union[str, Iterable[str]]):
    """True when ``key`` is stored, compressed or not; a dict for a list."""
    if not isinstance(key, str):
      return {k: self.exists(k) for k in key}
    return any(self.backend.exists(key + ext) for ext in ("", *_EXT_TO_COMPRESSION))

  def size(self, key: str) -> Optional[int]:
    """Stored bytes of ``key`` (as compressed), or None."""
    for ext in ("", *_EXT_TO_COMPRESSION):
      sz = self.backend.size(key + ext)
      if sz is not None:
        return sz
    return None

  # -- listing and deletion ------------------------------------------------

  def list(self, prefix: str = "", flat: bool = False) -> Iterator[str]:
    """Keys under ``prefix``, each once, with the compression extension
    taken off (``<key>.gz`` lists as ``<key>``); ``flat`` leaves out keys
    in subdirectories of ``prefix``."""
    seen = set()
    for key in self.backend.list(prefix):
      ext = os.path.splitext(key)[1]
      if ext in _EXT_TO_COMPRESSION:
        key = key[: -len(ext)]
      if flat and "/" in key[len(prefix):]:
        continue
      if key not in seen:
        seen.add(key)
        yield key

  def delete(self, keys: Union[str, Iterable[str]]):
    for k in [keys] if isinstance(keys, str) else list(keys):
      self.backend.delete(k)
      for ext in _EXT_TO_COMPRESSION:
        self.backend.delete(k + ext)

  def delete_prefix(self, prefix: str = ""):
    for key in list(self.backend.list(prefix)):
      self.backend.delete(key)

  def transfer_to(self, dest_cloudpath: str, paths: Optional[Iterable[str]] = None):
    """Copy stored objects (all, or ``paths``) to ``dest_cloudpath`` as
    they are stored."""
    dest = CloudFiles(dest_cloudpath)
    for key in self.list() if paths is None else paths:
      data, method = self.get_stored(key)
      if data is not None:
        dest.put(key + COMPRESSION_EXTS[method], data)

  def isdir(self) -> bool:
    if self.pth.protocol == "file":
      return os.path.isdir(self.pth.path)
    return any(True for _ in self.list())
