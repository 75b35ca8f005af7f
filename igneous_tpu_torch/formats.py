"""From-spec ingest readers for volumetric file formats.

The port's whole copy of ``igneous_tpu/formats.py``, the readers of
``image create`` (npy, npy.gz, h5, nii, nii.gz, nrrd; ckl raises). NRRD and
NIfTI-1 are implemented here in numpy against their published
specifications (both are simple header-plus-raw-array containers); HDF5
needs h5py, imported only when an HDF5 file is read, and crackle its
library: without them they raise with instructions.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_NRRD_DTYPES = {
  "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
  "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
  "uint8_t": np.uint8,
  "short": np.int16, "int16": np.int16, "int16_t": np.int16,
  "ushort": np.uint16, "uint16": np.uint16, "uint16_t": np.uint16,
  "int": np.int32, "int32": np.int32, "int32_t": np.int32,
  "uint": np.uint32, "uint32": np.uint32, "uint32_t": np.uint32,
  "longlong": np.int64, "int64": np.int64, "int64_t": np.int64,
  "ulonglong": np.uint64, "uint64": np.uint64, "uint64_t": np.uint64,
  "float": np.float32, "double": np.float64,
}


def load_nrrd(path: str) -> np.ndarray:
  """Minimal NRRD reader (the teem NRRD0004 spec): text header lines up
  to a blank line, then the data blob. Supports raw/gzip encodings and
  little/big endian; returns the array in header axis order (NRRD is
  x-fastest, matching this package's (x, y, z) convention)."""
  with open(path, "rb") as f:
    blob = f.read()
  # the spec permits LF or CRLF line endings; the header ends at the
  # first blank line either way
  header_end = blob.find(b"\n\n")
  data_start = header_end + 2
  crlf_end = blob.find(b"\r\n\r\n")
  if crlf_end >= 0 and (header_end < 0 or crlf_end < header_end):
    header_end = crlf_end
    data_start = crlf_end + 4
  if header_end < 0:
    raise ValueError("malformed NRRD: no blank line terminating header")
  lines = blob[:header_end].decode("ascii", "replace").splitlines()
  if not lines or not lines[0].startswith("NRRD"):
    raise ValueError("not a NRRD file")
  fields = {}
  for line in lines[1:]:
    if line.startswith("#") or ":" not in line:
      continue
    key, val = line.split(":", 1)
    fields[key.strip().lower()] = val.strip().lstrip("=").strip()
  dtype = _NRRD_DTYPES.get(fields.get("type", ""))
  if dtype is None:
    raise ValueError(f"unsupported NRRD type: {fields.get('type')!r}")
  if "sizes" not in fields:
    raise ValueError("malformed NRRD: missing required 'sizes' field")
  sizes = [int(v) for v in fields["sizes"].split()]
  encoding = fields.get("encoding", "raw").lower()
  data = blob[data_start:]
  if encoding in ("gzip", "gz"):
    data = gzip.decompress(data)
  elif encoding != "raw":
    raise ValueError(f"unsupported NRRD encoding: {encoding!r}")
  endian = fields.get("endian", "little")
  dt = np.dtype(dtype).newbyteorder("<" if endian == "little" else ">")
  n = int(np.prod(sizes))
  arr = np.frombuffer(data, dtype=dt, count=n)
  # NRRD stores the FIRST size fastest; Fortran order puts axis 0 fastest
  return arr.reshape(sizes, order="F").astype(dtype, copy=False)


def load_hdf5(path: str, dataset: str = "main") -> np.ndarray:
  """HDF5 ingest via h5py: read the named dataset when present (``main``
  is the conventional EM-volume dataset name; ``--h5-dataset``), otherwise
  the first dataset in the file."""
  try:
    import h5py
  except ImportError as e:
    raise ValueError(
      "HDF5 ingest needs h5py; convert to .npy first (np.save(...))"
    ) from e
  with h5py.File(path, "r") as f:
    if dataset in f and isinstance(f[dataset], h5py.Dataset):
      return f[dataset][:]
    for key in f:
      if isinstance(f[key], h5py.Dataset):
        return f[key][:]
  raise ValueError(f"no dataset found in HDF5 file: {path}")


def load_nifti(path: str) -> np.ndarray:
  """Minimal NIfTI-1 reader (.nii / .nii.gz, single-file form): 348-byte
  header + voxel data at vox_offset. Returns the (x, y, z[, t]) array
  (NIfTI data is x-fastest / Fortran order)."""
  with open(path, "rb") as f:
    blob = f.read()
  if path.endswith(".gz") or blob[:2] == b"\x1f\x8b":
    blob = gzip.decompress(blob)
  if len(blob) < 352:
    raise ValueError("truncated NIfTI file")
  (sizeof_hdr,) = struct.unpack_from("<i", blob, 0)
  bo = "<"
  if sizeof_hdr != 348:
    (sizeof_hdr,) = struct.unpack_from(">i", blob, 0)
    if sizeof_hdr != 348:
      raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
    bo = ">"
  magic = blob[344:348]
  if magic == b"ni1\x00":
    raise ValueError(
      "two-file NIfTI (.hdr/.img pair) is not supported — the voxel data "
      "lives in a separate .img file; convert to single-file .nii first"
    )
  if magic != b"n+1\x00":
    raise ValueError(f"not a single-file NIfTI-1 (magic {magic!r})")
  dim = struct.unpack_from(bo + "8h", blob, 40)
  ndim = max(1, min(int(dim[0]), 7))
  shape = [max(1, int(d)) for d in dim[1:1 + ndim]]
  (datatype,) = struct.unpack_from(bo + "h", blob, 70)
  (vox_offset,) = struct.unpack_from(bo + "f", blob, 108)
  dtypes = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
  }
  if datatype not in dtypes:
    raise ValueError(f"unsupported NIfTI datatype code: {datatype}")
  dt = np.dtype(dtypes[datatype]).newbyteorder(bo)
  n = int(np.prod(shape))
  arr = np.frombuffer(blob, dtype=dt, count=n, offset=int(vox_offset))
  return arr.reshape(shape, order="F").astype(dtypes[datatype], copy=False)


def load_volume_file(path: str, h5_dataset: str = "main") -> np.ndarray:
  """Route an ingest file by extension."""
  low = path.lower()
  if low.endswith(".npy"):
    return np.load(path)
  if low.endswith(".npy.gz"):
    import io

    with open(path, "rb") as f:
      return np.load(io.BytesIO(gzip.decompress(f.read())))
  if low.endswith(".nrrd"):
    return load_nrrd(path)
  if low.endswith((".nii", ".nii.gz")):
    return load_nifti(path)
  if low.endswith((".h5", ".hdf5")):
    return load_hdf5(path, dataset=h5_dataset)
  if low.endswith(".ckl"):
    raise ValueError(
      "crackle (.ckl) ingest needs the crackle-codec package; decompress "
      "to .npy first."
    )
  raise ValueError(f"unrecognized volume file extension: {path}")
