"""Compresso segmentation codec, in its ``cpsx`` container.

The port's own copy of ``igneous_tpu/compresso.py``: the same container,
byte for byte. It implements the Compresso scheme (Matejek, Haehn,
Lekschas, Mitzenmacher, Pfister, "Compresso: Efficient Compression of
Segmentation Data for Connectomics", MICCAI 2017):

  1. Per z-slice BOUNDARY MAP: voxel (x,y) is a boundary when its label
     differs from its +x or +y neighbor. Non-boundary labels therefore
     propagate right/down: if (x-1,y) is non-boundary, its label equals
     (x,y)'s.
  2. The boundary bitmap is split into 8x8x1 blocks; each block packs to
     a 64-bit WINDOW value (x fastest, LSB first). Distinct values form a
     codebook; blocks store codebook indices (segmentation boundary
     windows repeat heavily — most are all-zero).
  3. Per-slice connected components (4-connectivity) of the non-boundary
     voxels; each component's label is recorded once, in component-id
     order (IDS stream). Decode re-runs CC on the reconstructed boundary
     map — identical input, identical components.
  4. Boundary voxels recover their labels from the propagation rule:
     left neighbor non-boundary -> copy left; else up neighbor
     non-boundary -> copy up; else the voxel is INDETERMINATE and its
     label ships explicitly (LOCATIONS stream, x-fastest order).

All four streams index one sorted unique-label table, so wide labels are
stored once. Steps 1-4 are pure array transforms (numpy here); the CC
pass rides scipy.ndimage per slice.

The container (magic ``cpsx``) is this project's own, not the published
compresso v3 bitstream, so Precomputed info files advertise it as
``compresso-cpsx`` (``meta.advertised_encoding``): external readers fail
loudly on the unknown encoding instead of mis-decoding it as v3. The read
path (``codecs.py``) accepts both names.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

MAGIC = b"cpsx"
VERSION = 1
STEPS = (8, 8, 1)  # 8x8 windows pack to one u64 per block

_HEADER = struct.Struct("<4sBBIIIBBBQQIQB")  # 50 bytes


def _boundary_map(labels: np.ndarray) -> np.ndarray:
  """(x,y,z) bool: label differs from +x or +y neighbor (within slice)."""
  B = np.zeros(labels.shape, dtype=bool)
  B[:-1, :, :] |= labels[:-1, :, :] != labels[1:, :, :]
  B[:, :-1, :] |= labels[:, :-1, :] != labels[:, 1:, :]
  return B


def _pack_windows(B: np.ndarray) -> np.ndarray:
  """Boundary bitmap -> u64 window value per 8x8x1 block, block raster
  order (x-blocks fastest, then y, then z)."""
  sx, sy, sz = B.shape
  gx, gy = -(-sx // 8), -(-sy // 8)
  padded = np.zeros((gx * 8, gy * 8, sz), dtype=np.uint8)
  padded[:sx, :sy, :] = B
  # (gx,8,gy,8,z) -> (z,gy,gx, 8y,8x); each 8-bit x-run packs LSB-first
  blocks = (
    padded.reshape(gx, 8, gy, 8, sz).transpose(4, 2, 0, 3, 1)
  )
  rows = np.packbits(blocks, axis=-1, bitorder="little")  # (z,gy,gx,8,1)
  words = rows.reshape(sz, gy, gx, 8).copy().view("<u8")[..., 0]
  return words.ravel()


def _unpack_windows(words: np.ndarray, shape) -> np.ndarray:
  sx, sy, sz = shape
  gx, gy = -(-sx // 8), -(-sy // 8)
  rows = words.reshape(sz, gy, gx, 1).view("<u1").reshape(sz, gy, gx, 8)
  bits = np.unpackbits(rows, axis=-1, bitorder="little")
  bits = bits.reshape(sz, gy, gx, 8, 8).transpose(2, 4, 1, 3, 0)
  return bits.reshape(gx * 8, gy * 8, sz)[:sx, :sy, :].astype(bool)


def _cc_slices(nonboundary: np.ndarray):
  """Per-slice 4-connected components of the non-boundary mask.
  Yields (z, cc_array, n_components); numbering is scipy's scan order,
  identical between encode and decode because the input mask is."""
  from scipy import ndimage

  structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
  for z in range(nonboundary.shape[2]):
    cc, n = ndimage.label(nonboundary[:, :, z], structure=structure)
    yield z, cc, n


def _resolution_masks(B: np.ndarray):
  """Masks for the decode-time boundary-resolution rule (vectorizable:
  the rule only ever reads NON-boundary neighbors, whose labels come
  straight from the CC pass). Returns (from_left, from_up, indet)."""
  from_left = np.zeros_like(B)
  from_left[1:, :, :] = B[1:, :, :] & ~B[:-1, :, :]
  from_up = np.zeros_like(B)
  from_up[:, 1:, :] = B[:, 1:, :] & ~B[:, :-1, :]
  from_up &= ~from_left
  indet = B & ~from_left & ~from_up
  return from_left, from_up, indet


def _min_uint(n: int) -> np.dtype:
  for dt in ("<u1", "<u2", "<u4", "<u8"):
    if n <= np.iinfo(dt).max:
      return np.dtype(dt)
  raise ValueError(n)


def compress(img: np.ndarray, steps: Tuple[int, int, int] = STEPS) -> bytes:
  """img: (x,y,z) or (x,y,z,1) integer labels -> compresso bytes."""
  if img.ndim == 4:
    if img.shape[3] != 1:
      raise ValueError(f"compresso supports 1 channel, got {img.shape[3]}")
    img = img[..., 0]
  if tuple(steps) != STEPS:
    raise ValueError(f"only {STEPS} windows are supported, got {steps}")
  labels = np.ascontiguousarray(img)
  sx, sy, sz = labels.shape

  uniq = np.unique(labels)  # sorted
  B = _boundary_map(labels)

  ids = []
  for z, cc, n in _cc_slices(~B):
    if n == 0:
      continue
    # first-occurrence voxel of each component, in component-id order
    flat = cc.ravel()
    comp_vals, first = np.unique(flat, return_index=True)
    sel = comp_vals != 0
    ids.append(labels[:, :, z].ravel()[first[sel]])
  ids = np.concatenate(ids) if ids else np.zeros(0, labels.dtype)

  _fl, _fu, indet = _resolution_masks(B)
  # x-fastest enumeration so decode refills in the same order
  locations = labels.reshape(-1, sz, order="F").T[
    indet.reshape(-1, sz, order="F").T
  ]

  words = _pack_windows(B)
  values, win_idx = np.unique(words, return_inverse=True)

  label_w = _min_uint(max(len(uniq) - 1, 0))
  index_w = _min_uint(max(len(values) - 1, 0))
  ids_ix = np.searchsorted(uniq, ids).astype(label_w)
  loc_ix = np.searchsorted(uniq, locations).astype(label_w)

  header = _HEADER.pack(
    MAGIC, VERSION, labels.dtype.itemsize, sx, sy, sz,
    steps[0], steps[1], steps[2],
    len(uniq), len(ids_ix), len(values), len(loc_ix),
    index_w.itemsize,
  )
  return b"".join([
    header,
    uniq.astype(f"<u{labels.dtype.itemsize}").tobytes(),
    ids_ix.tobytes(),
    values.astype("<u8").tobytes(),
    win_idx.astype(index_w).tobytes(),
    loc_ix.tobytes(),
  ])


def decompress(data: bytes, shape=None, dtype=None) -> np.ndarray:
  """compresso bytes -> (x,y,z,1) labels. ``shape``/``dtype``, when
  given (the Precomputed read path knows them), are validated against
  the stream header."""
  (magic, version, width, sx, sy, sz, xs, ys, zs,
   n_labels, n_ids, n_values, n_locs, index_w) = _HEADER.unpack_from(data)
  if magic != MAGIC or version != VERSION:
    raise ValueError(
      f"not an igneous-tpu compresso stream (magic {magic!r} v{version})"
    )
  if (xs, ys, zs) != STEPS:
    raise ValueError(f"unsupported window {xs}x{ys}x{zs}")
  if shape is not None and tuple(shape[:3]) != (sx, sy, sz):
    raise ValueError(f"stream is {(sx, sy, sz)}, expected {tuple(shape)}")
  out_dtype = np.dtype(dtype) if dtype is not None else np.dtype(f"<u{width}")
  if out_dtype.itemsize != width:
    raise ValueError(f"stream stores {width}-byte labels, asked {out_dtype}")

  gx, gy = -(-sx // 8), -(-sy // 8)
  n_windows = gx * gy * sz
  label_w = _min_uint(max(n_labels - 1, 0))

  off = _HEADER.size
  uniq = np.frombuffer(data, f"<u{width}", n_labels, off)
  off += n_labels * width
  ids_ix = np.frombuffer(data, label_w, n_ids, off)
  off += n_ids * label_w.itemsize
  values = np.frombuffer(data, "<u8", n_values, off)
  off += n_values * 8
  win_idx = np.frombuffer(data, f"<u{index_w}", n_windows, off)
  off += n_windows * index_w
  loc_ix = np.frombuffer(data, label_w, n_locs, off)

  B = _unpack_windows(values[win_idx], (sx, sy, sz))

  out = np.zeros((sx, sy, sz), dtype=out_dtype)
  pos = 0
  for z, cc, n in _cc_slices(~B):
    if n == 0:
      continue
    # no np.concatenate([[0], ...]): int64+uint64 promotes to float64
    # and silently rounds 64-bit labels
    comp_labels = np.empty(n + 1, dtype=out_dtype)
    comp_labels[0] = 0
    comp_labels[1:] = uniq[ids_ix[pos : pos + n]]
    out[:, :, z] = comp_labels[cc]
    pos += n

  from_left, from_up, indet = _resolution_masks(B)
  out[1:, :, :][from_left[1:, :, :]] = (
    out[:-1, :, :][from_left[1:, :, :]]
  )
  out[:, 1:, :][from_up[:, 1:, :]] = out[:, :-1, :][from_up[:, 1:, :]]
  if n_locs:
    outT = out.reshape(-1, sz, order="F").T.copy()
    outT[indet.reshape(-1, sz, order="F").T] = uniq[loc_ix].astype(out_dtype)
    out = outT.T.reshape(sx, sy, sz, order="F")
  return np.asfortranarray(out[..., np.newaxis])
