"""Object storage for the port: ``file://`` and ``mem://`` with gzip.

The port's own copy of ``igneous_tpu/storage.py``, trimmed to what the
downsample and connected-components paths use. It keeps the CloudFiles
file layout: an object compressed with gzip is stored under ``<key>.gz``
and read, listed and deleted under ``<key>``. Gzip is written with
``mtime=0``, so a chunk or scratch file written by either package is
byte-identical. gs://, s3:// and http(s)://, zstd, integrity manifests and
trace hooks are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import gzip
import json
import os
import threading
from typing import Dict, Iterable, Iterator, Optional, Tuple, Union

from .lib import jsonify

COMPRESSION_EXTS = {"gzip": ".gz", None: "", False: "", "": ""}
_EXT_TO_COMPRESSION = {".gz": "gzip"}


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


def compress_bytes(data: bytes, method) -> bytes:
  if method in (None, False, ""):
    return data
  if method == "gzip":
    # mtime=0: re-running a task writes byte-identical objects
    return gzip.compress(data, compresslevel=6, mtime=0)
  raise ValueError(f"Unsupported compression: {method} (the port writes gzip or none)")


def scratch_gzip_level(default: int) -> int:
  """Gzip level of scratch files that callers compress themselves (the CCL
  face planes): ``IGNEOUS_SCRATCH_COMPRESS=gzip-N`` picks N, ``gzip`` picks
  6; unset, or any other method, keeps ``default``."""
  val = os.environ.get("IGNEOUS_SCRATCH_COMPRESS", "").strip().lower()
  if val == "gzip":
    return 6
  if val.startswith("gzip-") and val[5:] in "123456789" and len(val) == 6:
    return int(val[5:])
  if val in ("", "none", "raw", "0", "off", "zstd"):
    return default
  raise ValueError(
    f"IGNEOUS_SCRATCH_COMPRESS={val!r} unsupported: use "
    "gzip-1..gzip-9, gzip, zstd, or none"
  )


def decompress_bytes(data: bytes, method) -> bytes:
  if method in (None, False, ""):
    return data
  if method == "gzip":
    return gzip.decompress(data)
  raise ValueError(f"Unsupported compression: {method}")


def extract_path(cloudpath: str) -> Tuple[str, str]:
  """(protocol, path) of a cloudpath; a bare path means ``file://``."""
  if "://" in cloudpath:
    protocol, path = cloudpath.split("://", 1)
  else:
    protocol, path = "file", cloudpath
  if protocol == "precomputed":
    return extract_path(path)
  if protocol == "file":
    path = os.path.abspath(os.path.expanduser(path))
  return protocol, path.rstrip("/")


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

  def delete(self, key: str):
    try:
      os.remove(os.path.join(self.root, key))
    except FileNotFoundError:
      pass

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

  def delete(self, key: str):
    with _MEM_LOCK:
      self.files.pop(key, None)

  def list(self, prefix: str = "") -> Iterator[str]:
    with _MEM_LOCK:
      keys = sorted(self.files)
    return (k for k in keys if k.startswith(prefix))

class CloudFiles:
  """get/put/list/delete against a storage root, with compression handling."""

  def __init__(self, cloudpath: str):
    self.cloudpath = cloudpath.rstrip("/")
    self.protocol, self.path = extract_path(cloudpath)
    if self.protocol == "file":
      self.backend = _FileBackend(self.path)
    elif self.protocol == "mem":
      self.backend = _MemBackend(self.path)
    else:
      raise NotImplementedError(
        f"{self.protocol}:// storage is not ported yet (ROADMAP.md); "
        "the port reads and writes file:// and mem://"
      )

  def put(self, key: str, content: Union[bytes, str], compress=None):
    if isinstance(content, str):
      content = content.encode("utf8")
    self.backend.put(
      key + COMPRESSION_EXTS[compress], compress_bytes(bytes(content), compress)
    )

  def put_json(self, key: str, obj, compress=None):
    self.put(key, json.dumps(jsonify(obj)).encode("utf8"), compress=compress)

  def get_stored(self, key: str) -> Tuple[Optional[bytes], Optional[str]]:
    """(stored bytes, compression method) of ``key``, or (None, None)."""
    data = self.backend.get(key)
    if data is not None:
      return data, None
    for ext, method in _EXT_TO_COMPRESSION.items():
      data = self.backend.get(key + ext)
      if data is not None:
        return data, method
    return None, None

  def put_stored(self, key: str, data: bytes, method) -> None:
    """Store bytes that already carry ``method``'s compression as they
    are, under the extension ``method`` implies: the write half of the
    zero-decode transfer."""
    self.backend.put(key + COMPRESSION_EXTS[method], bytes(data))

  def get(self, key: str) -> Optional[bytes]:
    data, method = self.get_stored(key)
    return None if data is None else decompress_bytes(data, method)

  def get_json(self, key: str):
    data = self.get(key)
    return None if data is None else json.loads(data.decode("utf8"))

  def list(self, prefix: str = "") -> Iterator[str]:
    """Keys under ``prefix``, each once, with the compression extension
    taken off (``<key>.gz`` lists as ``<key>``)."""
    seen = set()
    for key in self.backend.list(prefix):
      ext = os.path.splitext(key)[1]
      if ext in _EXT_TO_COMPRESSION:
        key = key[: -len(ext)]
      if key not in seen:
        seen.add(key)
        yield key

  def delete(self, keys: Union[str, Iterable[str]]):
    for k in [keys] if isinstance(keys, str) else list(keys):
      self.backend.delete(k)
      for ext in _EXT_TO_COMPRESSION:
        self.backend.delete(k + ext)
