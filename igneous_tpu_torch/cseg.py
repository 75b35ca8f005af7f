"""Neuroglancer ``compressed_segmentation`` codec.

The port's own copy of ``igneous_tpu/cseg.py``: the same bitstream, byte
for byte, from the same three implementations.

Format (github.com/google/neuroglancer, sliceview/compressed_segmentation):
the chunk is split per channel into a grid of blocks (default 8x8x8). The
file is a sequence of little-endian uint32 words:

  [channel offset table: num_channels words, offset of each channel start]
  per channel:
    [block headers: 2 words per block, x-fastest block order]
       word0 = lookup_table_offset (low 24 bits) | (encoded_bits << 24)
       word1 = encoded_values_offset
       (offsets in uint32 units relative to the channel start)
    [lookup tables + packed encoded values, interleaved as emitted]

Within a block, voxels are enumerated x-fastest over the block extent
*clipped to the chunk bounds*; each voxel stores an ``encoded_bits``-wide
index into the block's lookup table, packed LSB-first into uint32 words.
``encoded_bits`` ∈ {0,1,2,4,8,16,32}. Lookup table entries are uint32 (one
word) or uint64 (two words, low word first) matching the chunk dtype.

Blocks with identical lookup tables may share them; this encoder reuses the
previous block's table when equal (a common win on uniform regions).

Implementations:

  1. native C++ (``csrc/cseg.cpp``), built with g++ into
     ``igneous_tpu_torch/build/`` at first use (``ops._build``); a library
     that fails to build raises, and nothing falls back to numpy for it;
  2. bulk-NumPy (``_encode_channel`` / ``_decode_channel_np``): every block
     of the chunk is encoded/decoded at once — blocks are gathered into a
     (voxels, blocks) matrix per clipped-shape category, per-block tables
     come from one axis-wise sort, and bit packing/unpacking runs as one
     shift/or reduction across all blocks sharing a bit width;
  3. the per-block Python loops (``_encode_channel_loop`` /
     ``_decompress_loop``), kept as the executable specification: the
     tests pin (1) and (2) byte-identical to (3).

Each chunk takes the faster of (1) and (2) by its content
(``_prefers_numpy_encode``, ``_all_constant_blocks``); the choice changes
no output byte.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from .ops import _build

VALID_BITS = (0, 1, 2, 4, 8, 16, 32)

# _pick_bits as a table: index of the first VALID_BITS entry whose capacity
# (2^bits distinct values) covers ndist
_BITS_CAPACITY = np.array([1, 2, 4, 16, 256, 65536, 2**32], dtype=np.int64)
_BITS_VALUES = np.array(VALID_BITS, dtype=np.uint32)


def _pick_bits(n_distinct: int) -> int:
  need = max(int(np.ceil(np.log2(max(n_distinct, 1)))), 0)
  for b in VALID_BITS:
    if b >= need:
      return b
  raise ValueError(f"Too many distinct values in block: {n_distinct}")


def _ragged_arange(lengths: np.ndarray) -> np.ndarray:
  """[0..l0), [0..l1), ... concatenated (the ragged scatter index helper)."""
  lengths = np.asarray(lengths, dtype=np.int64)
  if lengths.size == 0 or int(lengths.sum()) == 0:
    return np.zeros(0, dtype=np.int64)
  excl = np.cumsum(lengths) - lengths
  return np.arange(int(lengths.sum()), dtype=np.int64) - np.repeat(excl, lengths)


def _axis_splits(extent: int, block: int):
  """[(start, stop, clipped_block_extent)] partitioning one axis into the
  full-block run and the (optional) clipped remainder."""
  full = (extent // block) * block
  out = []
  if full:
    out.append((0, full, block))
  if extent - full:
    out.append((full, extent, extent - full))
  return out


def _block_categories(shape3, block_size):
  """The ≤8 corner regions of the chunk whose blocks share one clipped
  shape; each yields (x-split, y-split, z-split)."""
  sx, sy, sz = shape3
  bx, by, bz = block_size
  return [
    (xs, ys, zs)
    for zs in _axis_splits(sz, bz)
    for ys in _axis_splits(sy, by)
    for xs in _axis_splits(sx, bx)
  ]


def _category_geometry(cat):
  (x0, x1, cx), (y0, y1, cy), (z0, z1, cz) = cat
  return (x0, y0, z0), (cx, cy, cz), (
    (x1 - x0) // cx, (y1 - y0) // cy, (z1 - z0) // cz
  )


def _category_bids(cat, block_size, gx, gy):
  """GLOBAL block index of each of a category's blocks, x-fastest (the
  header/stream order of the format)."""
  (x0, y0, z0), _, (nbx, nby, nbz) = _category_geometry(cat)
  bx, by, bz = block_size
  bid = (
    (x0 // bx + np.arange(nbx))[:, None, None]
    + gx * (
      (y0 // by + np.arange(nby))[None, :, None]
      + gy * (z0 // bz + np.arange(nbz))[None, None, :]
    )
  )
  return bid.ravel(order="F").astype(np.int64)


def _category_6d(region, cblock, nblocks3):
  """The region as a 6-axis [vx, jx, vy, jy, vz, jz] logical view."""
  cx, cy, cz = cblock
  nbx, nby, nbz = nblocks3
  return region.reshape((cx, nbx, cy, nby, cz, nbz), order="F")


def _category_vox(region, cblock, nblocks3):
  """Gather one category's blocks into vox[(block), (voxel)] — one
  C-contiguous row per block with x-fastest voxel order (the loop's
  enumeration order), rows in x-fastest block order."""
  cx, cy, cz = cblock
  nbx, nby, nbz = nblocks3
  # transposing the 6-axis view to (jz,jy,jx,vz,vy,vx) and C-reshaping
  # merges to rows b = jx + nbx*(jy + nby*jz) and columns
  # v = vx + cx*(vy + cy*vz), both x-fastest
  return np.ascontiguousarray(
    _category_6d(region, cblock, nblocks3).transpose(5, 3, 1, 4, 2, 0)
  ).reshape(nbx * nby * nbz, cx * cy * cz)


def _encode_channel(chan: np.ndarray, block_size: Tuple[int, int, int]) -> np.ndarray:
  """Bulk-NumPy encode of one channel; byte-identical to
  ``_encode_channel_loop``. chan: (sx, sy, sz) uint32/uint64 → uint32 words.
  """
  sx, sy, sz = chan.shape
  bx, by, bz = block_size
  gx, gy, gz = -(-sx // bx), -(-sy // by), -(-sz // bz)
  nblocks = gx * gy * gz
  if nblocks == 0:
    return np.zeros(0, dtype=np.uint32)
  words_per_entry = 2 if chan.dtype.itemsize == 8 else 1

  ndist_g = np.zeros(nblocks, dtype=np.int64)
  bits_g = np.zeros(nblocks, dtype=np.uint32)
  vw_g = np.zeros(nblocks, dtype=np.int64)  # value words per block
  # per-category deferred pieces: (global block ids, sorted-unique stream)
  # for the table scatter and (block ids, packed matrix) for values
  table_parts = []  # (bids, uniques concatenated in per-category block order)
  value_parts = []  # (bids_subset, packed (nwords, nsel) uint32)

  for cat in _block_categories((sx, sy, sz), (bx, by, bz)):
    (x0, y0, z0), cblock, nblocks3 = _category_geometry(cat)
    cx, cy, cz = cblock
    nb = int(np.prod(nblocks3))
    nvox = cx * cy * cz
    bids = _category_bids(cat, (bx, by, bz), gx, gy)
    region = chan[x0 : x0 + cx * nblocks3[0],
                  y0 : y0 + cy * nblocks3[1],
                  z0 : z0 + cz * nblocks3[2]]
    six = _category_6d(region, cblock, nblocks3)
    # constant-block fast path: real segmentation chunks are dominated by
    # blocks interior to one object, and all-voxels-equal-the-first
    # decides membership with one compare pass instead of a sort
    firsts = np.ascontiguousarray(six[0, :, 0, :, 0, :])
    uni = (
      (six == firsts[None, :, None, :, None, :])
      .all(axis=(0, 2, 4))
      .ravel(order="F")
    )
    firsts = firsts.ravel(order="F")
    ndist = np.ones(nb, dtype=np.int64)
    bits = np.zeros(nb, dtype=np.uint32)

    if bool(uni.all()):
      ndist_g[bids] = 1
      table_parts.append((bids, ndist, firsts))
      continue

    vox = _category_vox(region, cblock, nblocks3)
    nu = np.nonzero(~uni)[0]
    voxn = vox[nu]
    order = np.argsort(voxn, axis=1)
    svox = np.take_along_axis(voxn, order, axis=1)
    newv = np.empty(svox.shape, dtype=bool)
    newv[:, 0] = True
    newv[:, 1:] = svox[:, 1:] != svox[:, :-1]
    ranks = np.cumsum(newv, axis=1, dtype=np.int32) - 1
    ndist_nu = (ranks[:, -1] + 1).astype(np.int64)
    inv = np.empty(svox.shape, dtype=np.uint32)
    np.put_along_axis(inv, order, ranks.view(np.uint32), axis=1)

    cap_idx = np.searchsorted(_BITS_CAPACITY, ndist_nu, side="left")
    if int(cap_idx.max(initial=0)) >= len(_BITS_VALUES):
      raise ValueError(
        f"Too many distinct values in block: {int(ndist_nu.max())}"
      )
    ndist[nu] = ndist_nu
    bits[nu] = _BITS_VALUES[cap_idx]
    ndist_g[bids] = ndist
    bits_g[bids] = bits

    # per-block tables, block order: uniform rows contribute their single
    # value, sorted rows their svox[b, newv[b]] run (the row-major boolean
    # flatten keeps the stream per-block-contiguous and ascending)
    starts_c = np.cumsum(ndist) - ndist
    stream = np.empty(int(ndist.sum()), dtype=chan.dtype)
    stream[starts_c[uni]] = firsts[uni]
    dst = np.repeat(starts_c[nu], ndist_nu) + _ragged_arange(ndist_nu)
    stream[dst] = svox[newv]
    table_parts.append((bids, ndist, stream))

    bits_nu = bits[nu]
    for b in np.unique(bits_nu):
      b = int(b)
      sel = np.nonzero(bits_nu == b)[0]
      vpw = 32 // b
      nwords = -(-nvox // vpw)
      padded = np.zeros((len(sel), nwords * vpw), dtype=np.uint32)
      padded[:, :nvox] = inv[sel]
      shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(b))
      packed = np.bitwise_or.reduce(
        padded.reshape(len(sel), nwords, vpw) << shifts[None, None, :], axis=2
      ).astype(np.uint32)
      gsel = bids[nu[sel]]
      vw_g[gsel] = nwords
      value_parts.append((gsel, packed))

  # tables of every block concatenated in GLOBAL block order (the order the
  # loop emits them), so consecutive-block table equality — the sharing
  # rule — is one ragged compare
  starts_t = np.cumsum(ndist_g) - ndist_g
  tabcat = np.zeros(int(ndist_g.sum()), dtype=chan.dtype)
  for bids, ndist, stream in table_parts:
    dst = np.repeat(starts_t[bids], ndist) + _ragged_arange(ndist)
    tabcat[dst] = stream

  shared = np.zeros(nblocks, dtype=bool)
  cand = np.nonzero(ndist_g[1:] == ndist_g[:-1])[0] + 1
  if len(cand):
    L = ndist_g[cand]
    off = _ragged_arange(L)
    neq = (
      tabcat[np.repeat(starts_t[cand], L) + off]
      != tabcat[np.repeat(starts_t[cand - 1], L) + off]
    )
    mismatches = np.add.reduceat(neq, np.cumsum(L) - L)
    shared[cand] = mismatches == 0
  # sharing compares content with the immediately previous block: a shared
  # run's members all equal the last EMITTED table, so pairwise equality is
  # transitive — the same decision the loop's prev_table makes

  tw = np.where(shared, 0, ndist_g * words_per_entry)
  block_words = tw + vw_g
  starts = 2 * nblocks + np.cumsum(block_words) - block_words
  last_emitted = np.maximum.accumulate(
    np.where(shared, 0, np.arange(nblocks))
  )
  table_offset = starts[last_emitted]
  if bool((table_offset >= (1 << 24)).any()):
    raise ValueError("lookup table offset exceeds 24 bits; use smaller chunks")
  values_offset = starts + tw

  total = int(2 * nblocks + block_words.sum())
  out = np.empty(total, dtype=np.uint32)
  headers = out[: 2 * nblocks].reshape(nblocks, 2)
  headers[:, 0] = table_offset.astype(np.uint32) | (bits_g << np.uint32(24))
  headers[:, 1] = values_offset.astype(np.uint32)

  em = ~shared
  if bool(em.any()):
    tab_em = tabcat[np.repeat(em, ndist_g)]
    L = (ndist_g * words_per_entry)[em]
    dst = np.repeat(starts[em], L) + _ragged_arange(L)
    if words_per_entry == 2:
      t64 = tab_em.astype(np.uint64)
      tab_words = np.empty(tab_em.size * 2, dtype=np.uint32)
      tab_words[0::2] = (t64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
      tab_words[1::2] = (t64 >> np.uint64(32)).astype(np.uint32)
    else:
      tab_words = tab_em.astype(np.uint32)
    out[dst] = tab_words

  for bids, packed in value_parts:
    dst = values_offset[bids][:, None] + np.arange(packed.shape[1])[None, :]
    out[dst] = packed
  return out


def _encode_channel_loop(chan: np.ndarray, block_size: Tuple[int, int, int]) -> np.ndarray:
  """Per-block reference encoder (the executable spec the vectorized and
  native paths are pinned byte-identical against).
  chan: (sx, sy, sz) array of uint32 or uint64. Returns uint32 words."""
  sx, sy, sz = chan.shape
  bx, by, bz = block_size
  gx, gy, gz = -(-sx // bx), -(-sy // by), -(-sz // bz)
  nblocks = gx * gy * gz

  words_per_entry = 2 if chan.dtype.itemsize == 8 else 1

  headers = np.zeros(nblocks * 2, dtype=np.uint32)
  body: list = []  # list of uint32 arrays appended after the headers
  body_len = 0
  prev_table = None
  prev_table_offset = 0

  bi = 0
  for z0 in range(0, gz * bz, bz):
    for y0 in range(0, gy * by, by):
      for x0 in range(0, gx * bx, bx):
        block = chan[x0 : min(x0 + bx, sx), y0 : min(y0 + by, sy), z0 : min(z0 + bz, sz)]
        # x-fastest flattening == Fortran order for an (x,y,z) array
        flat = block.reshape(-1, order="F")
        table, idx = np.unique(flat, return_inverse=True)
        bits = _pick_bits(len(table))

        if (
          prev_table is not None
          and len(prev_table) == len(table)
          and np.array_equal(prev_table, table)
        ):
          table_offset = prev_table_offset
        else:
          table_offset = 2 * nblocks + body_len
          if words_per_entry == 2:
            t64 = table.astype(np.uint64)
            tw = np.empty(len(t64) * 2, dtype=np.uint32)
            tw[0::2] = (t64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            tw[1::2] = (t64 >> np.uint64(32)).astype(np.uint32)
          else:
            tw = table.astype(np.uint32)
          body.append(tw)
          body_len += len(tw)
          prev_table = table
          prev_table_offset = table_offset

        if table_offset >= (1 << 24):
          raise ValueError("lookup table offset exceeds 24 bits; use smaller chunks")

        values_offset = 2 * nblocks + body_len
        if bits > 0:
          n = len(idx)
          vals_per_word = 32 // bits
          nwords = -(-n // vals_per_word)
          padded = np.zeros(nwords * vals_per_word, dtype=np.uint32)
          padded[:n] = idx.astype(np.uint32)
          padded = padded.reshape(nwords, vals_per_word)
          shifts = (np.arange(vals_per_word, dtype=np.uint32) * np.uint32(bits))
          packed = np.bitwise_or.reduce(padded << shifts, axis=1).astype(np.uint32)
          body.append(packed)
          body_len += nwords

        headers[2 * bi] = np.uint32(table_offset) | (np.uint32(bits) << np.uint32(24))
        headers[2 * bi + 1] = np.uint32(values_offset)
        bi += 1

  if body:
    return np.concatenate([headers] + body)
  return headers


def cseg_lib() -> ctypes.CDLL:
  """``csrc/cseg.cpp``, built at first use; a failed build raises."""
  lib = _build.load("cseg")
  if not getattr(lib, "_configured", False):
    lib.cseg_encode_channel_strided.restype = ctypes.c_int64
    lib.cseg_encode_channel_strided.argtypes = [
      ctypes.c_void_p, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
      ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
    ]
    lib.cseg_free.restype = None
    lib.cseg_free.argtypes = [ctypes.POINTER(ctypes.c_uint32)]
    lib.cseg_decode_channel.restype = ctypes.c_int
    lib.cseg_decode_channel.argtypes = [
      ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib._configured = True
  return lib


def _native_encode_channel(chan: np.ndarray, block_size) -> "np.ndarray | None":
  """The C++ encoder. Stride-aware: Fortran-ordered download cutouts (and
  sliced views) encode in place with no ascontiguousarray copy. None when
  the encoder refuses the chunk (a lookup table offset past 24 bits): the
  numpy encoder then raises the same error."""
  lib = cseg_lib()
  item = chan.dtype.itemsize
  strides = [s // item for s in chan.strides]
  if any(s % item for s in chan.strides) or any(s <= 0 for s in strides):
    chan = np.ascontiguousarray(chan)  # exotic views: normalize first
    strides = [s // item for s in chan.strides]
  out = ctypes.POINTER(ctypes.c_uint32)()
  n = lib.cseg_encode_channel_strided(
    chan.ctypes.data_as(ctypes.c_void_p),
    1 if item == 8 else 0,
    *[int(v) for v in chan.shape],
    *[int(s) for s in strides],
    *[int(b) for b in block_size],
    ctypes.byref(out),
  )
  if n <= 0:
    return None
  try:
    return np.ctypeslib.as_array(out, shape=(n,)).copy()
  finally:
    lib.cseg_free(out)


def _prefers_numpy_encode(chan: np.ndarray, block_size) -> bool:
  """Probe a slab of the interior blocks for the constant-block fraction.
  Uniform-heavy chunks (the realistic mip-pyramid segmentation case)
  encode fastest on the bulk-NumPy compare path — it never visits most
  voxels twice — while dense chunks win on the native per-voxel walk.
  All paths emit identical bytes; this only picks the fastest."""
  sx, sy, sz = chan.shape
  bx, by, bz = [int(b) for b in block_size]
  nbx, nby, nbz = sx // bx, sy // by, sz // bz
  if nbx * nby * nbz == 0:
    return True  # no full interior block: tiny chunk, numpy is fine
  pz = max(nbz // 8, 1)  # ~1/8 z-slab: representative, nearly free
  region = chan[: nbx * bx, : nby * by, : pz * bz]
  six = region.reshape((bx, nbx, by, nby, bz, pz), order="F")
  uni = (six == six[0:1, :, 0:1, :, 0:1, :]).all(axis=(0, 2, 4))
  return float(uni.mean()) >= 0.5


def compress(img: np.ndarray, block_size: Sequence[int] = (8, 8, 8)) -> bytes:
  """img: (x, y, z, c) array of uint32/uint64 (smaller uints are widened)."""
  if img.ndim == 3:
    img = img[..., np.newaxis]
  if img.dtype.itemsize <= 4:
    img = img.astype(np.uint32, copy=False)
  else:
    img = img.astype(np.uint64, copy=False)

  num_channels = img.shape[3]
  channels = []
  offsets = np.zeros(num_channels, dtype=np.uint32)
  pos = num_channels
  for c in range(num_channels):
    chan = img[:, :, :, c]
    enc = None
    if not _prefers_numpy_encode(chan, block_size):
      enc = _native_encode_channel(chan, block_size)
    if enc is None:
      enc = _encode_channel(chan, tuple(int(b) for b in block_size))
    offsets[c] = pos
    pos += len(enc)
    channels.append(enc)
  return np.concatenate([offsets] + channels).tobytes()


def _native_decode_channel(words, shape3, dtype, block_size):
  lib = cseg_lib()
  words = np.ascontiguousarray(words)
  out = np.empty(shape3, dtype=dtype)
  rc = lib.cseg_decode_channel(
    words.ctypes.data_as(ctypes.c_void_p),
    len(words),
    1 if np.dtype(dtype).itemsize == 8 else 0,
    *[int(v) for v in shape3],
    *[int(b) for b in block_size],
    out.ctypes.data_as(ctypes.c_void_p),
  )
  if rc != 0:
    raise ValueError(f"corrupt compressed_segmentation stream (code {rc})")
  return out


def _corrupt(reason: str):
  # invalid offsets fail loudly instead of silently truncating (the
  # native, vectorized, and loop decoders must behave identically)
  raise ValueError(f"corrupt compressed_segmentation stream ({reason})")


def _stream_words(data) -> np.ndarray:
  """Read-only uint32 view of the stream; a length that is not a whole
  number of words is corruption, reported like every other decode fault."""
  if len(data) % 4:
    _corrupt(f"stream length {len(data)} not a multiple of 4")
  return np.frombuffer(data, dtype=np.uint32)


def _block_constants(words, toff, words_per_entry, work_dtype):
  """Lookup-table entry 0 of each block in ``toff`` (the value of every
  voxel of a bits==0 block)."""
  if words_per_entry == 2:
    lo = words[toff]
    hi = words[toff + 1]
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
  return words[toff].astype(work_dtype, copy=False)


def _decode_channel_np(words, base, shape3, block_size, words_per_entry,
                       work_dtype, out=None):
  """Bulk-NumPy decode of one channel → (sx, sy, sz) F-ordered array of
  ``work_dtype`` (uint32/uint64 matching the table entry width). Offsets
  are validated against the stream bounds exactly like the loop decoder."""
  sx, sy, sz = shape3
  bx, by, bz = block_size
  gx, gy, gz = -(-sx // bx), -(-sy // by), -(-sz // bz)
  nblocks = gx * gy * gz
  total = len(words)
  if out is None:
    out = np.empty((sx, sy, sz), dtype=work_dtype, order="F")
  if nblocks == 0:
    return out
  if base + 2 * nblocks > total:
    _corrupt("header out of range")
  hw = words[base : base + 2 * nblocks].astype(np.int64)
  w0 = hw[0::2]
  w1 = hw[1::2]
  bits_all = w0 >> 24
  bad = ~np.isin(bits_all, VALID_BITS)
  if bool(bad.any()):
    _corrupt(f"invalid bit width {int(bits_all[np.argmax(bad)])}")
  toff_all = base + (w0 & 0xFFFFFF)
  voff_all = base + w1

  for cat in _block_categories((sx, sy, sz), (bx, by, bz)):
    (x0, y0, z0), (cx, cy, cz), (nbx, nby, nbz) = _category_geometry(cat)
    nvox = cx * cy * cz
    bid = _category_bids(cat, (bx, by, bz), gx, gy)
    region = out[x0 : x0 + cx * nbx, y0 : y0 + cy * nby, z0 : z0 + cz * nbz]
    bits_cat = bits_all[bid]

    if bool((bits_cat == 0).all()):
      # constant blocks only (the dominant case on real segmentation):
      # one table-entry gather per block and a broadcast store through a
      # strided 6-axis view — no per-voxel index matrix at all
      if bool((toff_all[bid] + words_per_entry > total).any()):
        _corrupt("lookup table out of range")
      consts = _block_constants(words, toff_all[bid], words_per_entry,
                                work_dtype).astype(work_dtype, copy=False)
      s0, s1, s2 = region.strides
      view = np.lib.stride_tricks.as_strided(
        region, shape=(cx, nbx, cy, nby, cz, nbz),
        strides=(s0, s0 * cx, s1, s1 * cy, s2, s2 * cz),
      )
      view[...] = consts.reshape((nbx, nby, nbz), order="F")[
        None, :, None, :, None, :
      ]
      continue

    cat_vals = np.empty((len(bid), nvox), dtype=work_dtype)
    for b in np.unique(bits_cat):
      b = int(b)
      sel = np.nonzero(bits_cat == b)[0]
      gids = bid[sel]
      if b == 0:
        if bool((toff_all[gids] + words_per_entry > total).any()):
          _corrupt("lookup table out of range")
        cat_vals[sel] = _block_constants(
          words, toff_all[gids], words_per_entry, work_dtype
        ).astype(work_dtype, copy=False)[:, None]
        continue
      vpw = 32 // b
      nwords = -(-nvox // vpw)
      if bool((voff_all[gids] + nwords > total).any()):
        _corrupt("encoded values out of range")
      packed = words[voff_all[gids][:, None] + np.arange(nwords)[None, :]]
      shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(b))
      mask = np.uint32((1 << b) - 1) if b < 32 else np.uint32(0xFFFFFFFF)
      idx = (
        ((packed[:, :, None] >> shifts[None, None, :]) & mask)
        .reshape(len(sel), nwords * vpw)[:, :nvox]
        .astype(np.int64)
      )
      tlen = (idx.max(axis=1) + 1) * words_per_entry
      if bool((toff_all[gids] + tlen > total).any()):
        _corrupt("lookup table out of range")
      if words_per_entry == 2:
        lo = words[toff_all[gids][:, None] + 2 * idx]
        hi = words[toff_all[gids][:, None] + 2 * idx + 1]
        vals = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
      else:
        vals = words[toff_all[gids][:, None] + idx].astype(
          work_dtype, copy=False
        )
      cat_vals[sel] = vals
    # rows are (jz,jy,jx)-ordered blocks, columns (vz,vy,vx)-ordered
    # voxels (both x-fastest): undo the encode-side gather
    region[...] = (
      cat_vals.reshape((nbz, nby, nbx, cz, cy, cx))
      .transpose(5, 2, 4, 1, 3, 0)
      .reshape(region.shape, order="F")
    )
  return out


def _all_constant_blocks(words, base, nblocks) -> bool:
  """True when every block header of the channel carries bits==0 — the
  broadcast-fill numpy path then beats even the native per-voxel walk."""
  end = base + 2 * nblocks
  if base < 0 or end > len(words):
    return False  # malformed: let the real decoder raise with context
  return bool((words[base:end:2] >> np.uint32(24) == 0).all())


def decompress(
  data: bytes,
  shape: Sequence[int],
  dtype,
  block_size: Sequence[int] = (8, 8, 8),
) -> np.ndarray:
  """Returns an (x, y, z, c) array of ``dtype``."""
  # read-only view of the input: the decoders never write into the word
  # stream, and the output array is freshly allocated either way — the
  # old bytearray() copy was pure overhead per chunk
  words = _stream_words(data)
  sx, sy, sz, num_channels = [int(v) for v in shape]
  bx, by, bz = [int(b) for b in block_size]
  gx, gy, gz = -(-sx // bx), -(-sy // by), -(-sz // bz)
  nblocks = gx * gy * gz

  dtype = np.dtype(dtype)
  words_per_entry = 2 if dtype.itemsize == 8 else 1
  work_dtype = np.uint64 if words_per_entry == 2 else np.uint32
  out = np.empty(
    (sx, sy, sz, num_channels), dtype=work_dtype, order="F"
  )
  total_words = len(words)
  for c in range(num_channels):
    if c >= total_words:
      _corrupt("missing channel offset")
    base = int(words[c])
    end = int(words[c + 1]) if c + 1 < num_channels else total_words
    chan = None
    # all-constant channels take the broadcast-fill numpy path outright;
    # the native decoder (when the dtype width matches its word layout)
    # wins on dense chunks
    if (
      dtype.itemsize in (4, 8)
      and not _all_constant_blocks(words, base, nblocks)
    ):
      chan = _native_decode_channel(
        words[base:end], (sx, sy, sz), work_dtype, (bx, by, bz),
      )
    if chan is not None:
      out[..., c] = chan
    else:
      # each channel slice of the F-ordered output is itself
      # F-contiguous, so the channel decoder fills it in place
      _decode_channel_np(
        words, base, (sx, sy, sz), (bx, by, bz), words_per_entry,
        work_dtype, out=out[..., c],
      )
  return out.astype(dtype, copy=False)


def _decompress_loop(
  data: bytes,
  shape: Sequence[int],
  dtype,
  block_size: Sequence[int] = (8, 8, 8),
) -> np.ndarray:
  """Per-block reference decoder (the executable spec; golden-fixture
  tests pin ``decompress`` against it). Returns (x, y, z, c) ``dtype``."""
  words = _stream_words(data)
  sx, sy, sz, num_channels = [int(v) for v in shape]
  bx, by, bz = [int(b) for b in block_size]
  gx, gy, gz = -(-sx // bx), -(-sy // by), -(-sz // bz)
  dtype = np.dtype(dtype)
  words_per_entry = 2 if dtype.itemsize == 8 else 1

  out = np.zeros((sx, sy, sz, num_channels), dtype=np.uint64)

  total_words = len(words)
  for c in range(num_channels):
    if c >= total_words:
      _corrupt("missing channel offset")
    base = int(words[c])
    bi = 0
    for z0 in range(0, gz * bz, bz):
      for y0 in range(0, gy * by, by):
        for x0 in range(0, gx * bx, bx):
          if base + 2 * bi + 1 >= total_words:
            _corrupt("header out of range")
          w0 = int(words[base + 2 * bi])
          w1 = int(words[base + 2 * bi + 1])
          bits = w0 >> 24
          if bits not in VALID_BITS:
            _corrupt(f"invalid bit width {bits}")
          table_offset = base + (w0 & 0xFFFFFF)
          values_offset = base + w1
          cx = min(bx, sx - x0)
          cy = min(by, sy - y0)
          cz = min(bz, sz - z0)
          n = cx * cy * cz

          if bits == 0:
            idx = np.zeros(n, dtype=np.uint32)
          else:
            vals_per_word = 32 // bits
            nwords = -(-n // vals_per_word)
            if values_offset + nwords > total_words:
              _corrupt("encoded values out of range")
            packed = words[values_offset : values_offset + nwords]
            shifts = (np.arange(vals_per_word, dtype=np.uint32) * np.uint32(bits))
            mask = np.uint32((1 << bits) - 1) if bits < 32 else np.uint32(0xFFFFFFFF)
            unpacked = ((packed[:, None] >> shifts) & mask).reshape(-1)[:n]
            idx = unpacked.astype(np.uint32)

          max_idx = int(idx.max()) if n else 0
          tlen = (max_idx + 1) * words_per_entry
          if table_offset + tlen > total_words:
            _corrupt("lookup table out of range")
          traw = words[table_offset : table_offset + tlen]
          if words_per_entry == 2:
            table = traw[0::2].astype(np.uint64) | (
              traw[1::2].astype(np.uint64) << np.uint64(32)
            )
          else:
            table = traw.astype(np.uint64)

          block = table[idx].reshape((cx, cy, cz), order="F")
          out[x0 : x0 + cx, y0 : y0 + cy, z0 : z0 + cz, c] = block
          bi += 1

  return out.astype(dtype)


def decompress_region(
  data: bytes,
  shape: Sequence[int],
  dtype,
  lo: Sequence[int],
  hi: Sequence[int],
  block_size: Sequence[int] = (8, 8, 8),
  channel: int = 0,
) -> np.ndarray:
  """Decode only the blocks overlapping [lo, hi) → (hi-lo) (x, y, z) array.

  The random-access path that makes compressed_segmentation usable as an
  IN-RAM representation: per-label masks decode O(label bbox) voxels,
  never the whole cutout.
  """
  words = _stream_words(data)
  sx, sy, sz, num_channels = [int(v) for v in shape]
  bx, by, bz = [int(b) for b in block_size]
  gx, gy, gz = -(-sx // bx), -(-sy // by), -(-sz // bz)
  lo = [max(0, int(v)) for v in lo]
  hi = [min(s, int(v)) for s, v in zip((sx, sy, sz), hi)]
  out = np.zeros(
    (hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]), dtype=dtype
  )
  if out.size == 0:
    return out
  base = int(words[channel])
  is64 = np.dtype(dtype).itemsize == 8

  for bzi in range(lo[2] // bz, -(-hi[2] // bz)):
    for byi in range(lo[1] // by, -(-hi[1] // by)):
      for bxi in range(lo[0] // bx, -(-hi[0] // bx)):
        bidx = bxi + gx * (byi + gy * bzi)
        w0 = int(words[base + 2 * bidx])
        w1 = int(words[base + 2 * bidx + 1])
        table_off = w0 & 0xFFFFFF
        bits = (w0 >> 24) & 0xFF
        dx = min(bx, sx - bxi * bx)
        dy = min(by, sy - byi * by)
        dz = min(bz, sz - bzi * bz)
        nvox = dx * dy * dz
        if bits == 0:
          packed = np.zeros(nvox, dtype=np.int64)
        else:
          vals_per_word = 32 // bits
          nwords = -(-nvox // vals_per_word)
          enc = words[base + w1 : base + w1 + nwords]
          pos = np.arange(nvox)
          packed = (
            (enc[pos // vals_per_word] >> ((pos % vals_per_word) * bits))
            & np.uint32((1 << bits) - 1)
          ).astype(np.int64)
        if is64:
          lo32 = words[base + table_off + 2 * packed]
          hi32 = words[base + table_off + 2 * packed + 1]
          vals = lo32.astype(np.uint64) | (
            hi32.astype(np.uint64) << np.uint64(32)
          )
        else:
          vals = words[base + table_off + packed]
        block = vals.astype(dtype).reshape((dx, dy, dz), order="F")
        x0, y0, z0 = bxi * bx, byi * by, bzi * bz
        src = tuple(
          slice(max(lo[a] - o, 0), min(hi[a] - o, d))
          for a, (o, d) in enumerate(((x0, dx), (y0, dy), (z0, dz)))
        )
        dst = tuple(
          slice(max(o - lo[a], 0), max(o - lo[a], 0) + (s.stop - s.start))
          for a, (o, s) in enumerate(((x0, src[0]), (y0, src[1]), (z0, src[2])))
        )
        out[dst] = block[src]
  return out
