"""Draco bitstream codec: pure-numpy encoder + decoder.

The port's own copy of ``igneous_tpu/draco.py``, the same bytes for the
same mesh. It implements the subset of the Draco 2.2 bitstream that any
conformant decoder (including Neuroglancer's) must accept: a
TRIANGULAR_MESH with MESH_SEQUENTIAL_ENCODING connectivity and a single
POSITION attribute carried by the SEQUENTIAL_ATTRIBUTE_ENCODER_QUANTIZATION
scheme (float32 input, quantized integer portable values, stored on the
uncompressed path). The sequential method trades compression ratio for
bit-exact simplicity; the quantization grid is what Neuroglancer's
multires renderer consumes (``mesh_multires.fragment_draco_settings``).

Wire-format notes (Draco bitstream spec v2.2, verified against the
google/draco decoder sources):
  header   : "DRACO" | u8 major | u8 minor | u8 encoder_type(1=mesh)
             | u8 encoder_method(0=sequential) | u16le flags
  connect. : varint num_faces | varint num_points | u8 method(1=plain)
             | indices (u8 if P<2^8, u16le if P<2^16, varint if P<2^21,
               else u32le), 3*num_faces of them
  attrs    : u8 num_attributes_decoders(=1)
             | varint num_attributes(=1)
             | u8 att_type(0=POSITION) | u8 data_type(9=FLOAT32)
             | u8 components(3) | u8 normalized(0) | varint unique_id(0)
             | u8 sequential_decoder_type(2=QUANTIZATION)
  portable : i8 prediction_method(-2=NONE) | u8 compressed(0)
             | u8 bytes_per_value(4) | u32le * 3 * num_points
             NOTE the stored values are zigzag symbols — the decoder runs
             ConvertSymbolsToSignedInts even on the uncompressed path
             whenever no prediction scheme is active, so the encoder must
             store 2*q for the (non-negative) quantized values q.
  transform: f32le min[3] | f32le range | u8 quantization_bits
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

MAGIC = b"DRACO"
TRIANGULAR_MESH = 1
MESH_SEQUENTIAL_ENCODING = 0
MESH_EDGEBREAKER_ENCODING = 1
METADATA_FLAG_MASK = 0x8000

ATT_POSITION = 0
DT_INT8, DT_UINT8, DT_INT16, DT_UINT16 = 1, 2, 3, 4
DT_INT32, DT_UINT32, DT_INT64, DT_UINT64 = 5, 6, 7, 8
DT_FLOAT32, DT_FLOAT64, DT_BOOL = 9, 10, 11
_DT_NUMPY = {
  DT_INT8: np.int8, DT_UINT8: np.uint8, DT_INT16: np.int16,
  DT_UINT16: np.uint16, DT_INT32: np.int32, DT_UINT32: np.uint32,
  DT_INT64: np.int64, DT_UINT64: np.uint64, DT_FLOAT32: np.float32,
  DT_FLOAT64: np.float64, DT_BOOL: np.uint8,
}

SEQ_GENERIC, SEQ_INTEGER, SEQ_QUANTIZATION, SEQ_NORMALS = 0, 1, 2, 3
PREDICTION_NONE = -2


def _varint(value: int) -> bytes:
  """Unsigned LEB128."""
  out = bytearray()
  value = int(value)
  while True:
    byte = value & 0x7F
    value >>= 7
    if value:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return bytes(out)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
  value = 0
  shift = 0
  while True:
    byte = data[pos]
    pos += 1
    value |= (byte & 0x7F) << shift
    if not byte & 0x80:
      return value, pos
    shift += 7


def _varint_array(vals: np.ndarray) -> bytes:
  """Vectorized LEB128 of a uint array (the >=2^16-vertex connectivity
  path would otherwise loop 3*num_faces times in the interpreter)."""
  vals = np.asarray(vals, dtype=np.uint64)
  nbytes = np.ones(len(vals), dtype=np.int64)
  for b in range(1, 5):
    nbytes[vals >= (np.uint64(1) << np.uint64(7 * b))] = b + 1
  offsets = np.zeros(len(vals) + 1, dtype=np.int64)
  np.cumsum(nbytes, out=offsets[1:])
  out = np.zeros(int(offsets[-1]), dtype=np.uint8)
  for b in range(5):
    sel = nbytes > b
    if not sel.any():
      break
    byte = (vals[sel] >> np.uint64(7 * b)) & np.uint64(0x7F)
    cont = (nbytes[sel] > b + 1).astype(np.uint64) << np.uint64(7)
    out[offsets[:-1][sel] + b] = (byte | cont).astype(np.uint8)
  return out.tobytes()


def _read_varint_array(
  data: bytes, pos: int, count: int
) -> Tuple[np.ndarray, int]:
  """Vectorized LEB128 decode of `count` values starting at `pos`."""
  if count == 0:
    return np.zeros(0, np.uint32), pos
  window = np.frombuffer(
    data, np.uint8, min(5 * count, len(data) - pos), pos
  )
  ends = np.flatnonzero((window & 0x80) == 0)[:count]
  if len(ends) < count:
    raise ValueError("truncated varint array")
  starts = np.concatenate([[0], ends[:-1] + 1])
  lengths = ends - starts + 1
  vals = np.zeros(count, dtype=np.uint64)
  for b in range(int(lengths.max())):
    sel = lengths > b
    vals[sel] |= (
      window[starts[sel] + b].astype(np.uint64) & np.uint64(0x7F)
    ) << np.uint64(7 * b)
  return vals.astype(np.uint32), pos + int(ends[-1]) + 1


class DecodedMesh(NamedTuple):
  vertices: np.ndarray            # (V, 3) float32, dequantized
  faces: np.ndarray               # (F, 3) uint32
  quantized: Optional[np.ndarray]  # (V, 3) uint32 lattice coords, or None
  quantization_origin: Optional[np.ndarray]
  quantization_range: Optional[float]
  quantization_bits: Optional[int]


def encode(
  vertices: np.ndarray,
  faces: np.ndarray,
  quantization_bits: int = 14,
  quantization_origin=None,
  quantization_range: Optional[float] = None,
) -> bytes:
  """Encode a triangle mesh as a Draco 2.2 sequential-method bitstream.

  The quantization lattice is ``origin + i * range / (2**bits - 1)`` per
  axis, matching DracoPy's settings contract; multires fragments pair this
  with the stored-lattice transform + 1-unit bins of
  mesh_multires.{to_stored_lattice, fragment_draco_settings}.
  """
  vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
  faces = np.asarray(faces, dtype=np.uint32).reshape(-1, 3)
  if not 1 <= quantization_bits <= 30:
    raise ValueError(f"quantization_bits must be in [1, 30]: {quantization_bits}")

  if quantization_origin is None:
    quantization_origin = (
      vertices.min(axis=0) if len(vertices) else np.zeros(3, np.float32)
    )
  origin = np.asarray(quantization_origin, dtype=np.float32).reshape(3)
  if quantization_range is None:
    ext = (vertices.max(axis=0) - origin) if len(vertices) else np.ones(3)
    quantization_range = float(max(np.max(ext), 1e-9))
  qrange = float(quantization_range)
  if qrange <= 0:
    raise ValueError(f"quantization_range must be positive: {qrange}")

  max_q = (1 << quantization_bits) - 1
  scale = max_q / qrange
  q = np.clip(
    np.floor((vertices.astype(np.float64) - origin) * scale + 0.5),
    0, max_q,
  ).astype(np.uint32)

  num_points = len(vertices)
  num_faces = len(faces)

  parts = [
    MAGIC, bytes([2, 2, TRIANGULAR_MESH, MESH_SEQUENTIAL_ENCODING]),
    struct.pack("<H", 0),
    _varint(num_faces), _varint(num_points),
    b"\x01",  # plain (uncompressed) connectivity
  ]
  idx = faces.reshape(-1)
  if num_points < (1 << 8):
    parts.append(idx.astype("<u1").tobytes())
  elif num_points < (1 << 16):
    parts.append(idx.astype("<u2").tobytes())
  elif num_points < (1 << 21):
    parts.append(_varint_array(idx))
  else:
    parts.append(idx.astype("<u4").tobytes())

  parts += [
    b"\x01",                       # num_attributes_decoders
    _varint(1),                    # num_attributes
    bytes([ATT_POSITION, DT_FLOAT32, 3, 0]),
    _varint(0),                    # unique_id
    bytes([SEQ_QUANTIZATION]),
    struct.pack("<b", PREDICTION_NONE),
    b"\x00",                       # compressed = 0
    b"\x04",                       # 4 bytes per stored value
    (q.astype(np.uint32) * np.uint32(2)).astype("<u4").tobytes(),  # zigzag
    origin.astype("<f4").tobytes(),
    struct.pack("<f", qrange),
    bytes([quantization_bits]),
  ]
  return b"".join(parts)


def decode(data: bytes) -> DecodedMesh:
  """Decode the sequential-method subset this module emits (plus integer /
  generic position attributes). Raises NotImplementedError on edgebreaker
  connectivity, rANS-compressed values, or prediction schemes — with the
  exact feature named, so a dataset produced by a fuller encoder fails
  loudly rather than corrupting."""
  if data[:5] != MAGIC:
    raise ValueError("not a draco stream (bad magic)")
  major, minor, enc_type, method = data[5], data[6], data[7], data[8]
  (flags,) = struct.unpack_from("<H", data, 9)
  pos = 11
  if (major, minor) < (2, 0):
    raise NotImplementedError(f"draco bitstream {major}.{minor} < 2.0")
  if enc_type != TRIANGULAR_MESH:
    raise NotImplementedError(f"encoder_type {enc_type} (want mesh)")
  if method != MESH_SEQUENTIAL_ENCODING:
    raise NotImplementedError(
      "edgebreaker connectivity not supported by this decoder"
    )
  if flags & METADATA_FLAG_MASK:
    raise NotImplementedError("draco metadata section")

  num_faces, pos = _read_varint(data, pos)
  num_points, pos = _read_varint(data, pos)
  conn_method = data[pos]
  pos += 1
  if conn_method != 1:
    raise NotImplementedError("rANS-compressed connectivity")
  n_idx = num_faces * 3
  if num_points < (1 << 8):
    idx = np.frombuffer(data, "<u1", n_idx, pos).astype(np.uint32)
    pos += n_idx
  elif num_points < (1 << 16):
    idx = np.frombuffer(data, "<u2", n_idx, pos).astype(np.uint32)
    pos += 2 * n_idx
  elif num_points < (1 << 21):
    idx, pos = _read_varint_array(data, pos, n_idx)
  else:
    idx = np.frombuffer(data, "<u4", n_idx, pos).copy()
    pos += 4 * n_idx
  faces = idx.reshape(-1, 3)

  num_att_decoders = data[pos]
  pos += 1
  # attribute descriptors for every decoder, then (same order) the data
  descs = []  # (attributes, seq_types) per attributes-decoder
  for _ in range(num_att_decoders):
    n_atts, pos = _read_varint(data, pos)
    atts = []
    for _ in range(n_atts):
      att_type, dtype, comps, normalized = data[pos:pos + 4]
      pos += 4
      _uid, pos = _read_varint(data, pos)
      atts.append((att_type, dtype, comps, normalized))
    seq_types = list(data[pos:pos + n_atts])
    pos += n_atts
    descs.append((atts, seq_types))

  result = {}
  for atts, seq_types in descs:
    # pass 1: portable values for every attribute of this decoder
    portable = []
    for (att_type, dtype, comps, _norm), seq in zip(atts, seq_types):
      n_vals = num_points * comps
      if seq in (SEQ_INTEGER, SEQ_QUANTIZATION):
        pred = struct.unpack_from("<b", data, pos)[0]
        pos += 1
        if pred != PREDICTION_NONE:
          raise NotImplementedError(f"prediction scheme {pred}")
        compressed = data[pos]
        pos += 1
        if compressed:
          raise NotImplementedError("rANS-compressed attribute values")
        nbytes = data[pos]
        pos += 1
        if nbytes != 4:
          raise NotImplementedError(f"{nbytes}-byte raw integer values")
        sym = np.frombuffer(data, "<u4", n_vals, pos)
        pos += 4 * n_vals
        # ConvertSymbolsToSignedInts: even → +s/2, odd → -(s+1)/2
        signed = np.where(
          sym & 1, -((sym.astype(np.int64) + 1) // 2), sym >> 1
        ).astype(np.int64)
        portable.append(signed.reshape(num_points, comps))
      elif seq == SEQ_GENERIC:
        npdt = np.dtype(_DT_NUMPY[dtype]).newbyteorder("<")
        vals = np.frombuffer(data, npdt, n_vals, pos).copy()
        pos += npdt.itemsize * n_vals
        portable.append(vals.reshape(num_points, comps))
      else:
        raise NotImplementedError(f"sequential decoder type {seq}")
    # pass 2: transform data (quantization params), same order
    for i, ((att_type, dtype, comps, _norm), seq) in enumerate(
      zip(atts, seq_types)
    ):
      if seq == SEQ_QUANTIZATION:
        qmin = np.frombuffer(data, "<f4", comps, pos).copy()
        pos += 4 * comps
        (qrange,) = struct.unpack_from("<f", data, pos)
        pos += 4
        qbits = data[pos]
        pos += 1
        qvals = portable[i].astype(np.uint32)
        dq = qmin + portable[i].astype(np.float64) * (
          qrange / ((1 << qbits) - 1)
        )
        if att_type == ATT_POSITION:
          result = {
            "vertices": dq.astype(np.float32), "quantized": qvals,
            "origin": qmin, "range": float(qrange), "bits": int(qbits),
          }
      elif att_type == ATT_POSITION:
        result = {
          "vertices": portable[i].astype(np.float32), "quantized": None,
          "origin": None, "range": None, "bits": None,
        }

  if not result:
    raise ValueError("no POSITION attribute in draco stream")
  return DecodedMesh(
    vertices=result["vertices"], faces=faces,
    quantized=result["quantized"],
    quantization_origin=result["origin"],
    quantization_range=result["range"],
    quantization_bits=result["bits"],
  )


# -- mesh_io codec hooks ------------------------------------------------------


def encode_to_bytes(mesh, **kw) -> bytes:
  return encode(mesh.vertices, mesh.faces, **kw)


def decode_to_mesh(data: bytes):
  from .mesh_io import Mesh

  dec = decode(data)
  return Mesh(dec.vertices, dec.faces)
