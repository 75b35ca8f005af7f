"""The union schedule of the CUDA tile_resolve (csrc/ccl.cu), modelled in
numpy and held against the kernel's contract.

The kernel links each run of equal labels along x inside a warp's 32
voxels with a ballot, then unites every foreground voxel only with the
neighbours its pruning rules keep (its "joins"). The model below computes
the same run heads and joins, runs a plain union-find over them, and the
partition with its minimum roots must equal cuda_ccl.tile_resolve_plain's
and the Pallas tile_resolve's (interpret mode) bit for bit: a join the
rules drop wrongly would split a component here. Every join must also be
a real neighbour pair with equal labels. This is the part of the kernel's
design that a CPU can check; the kernel itself is checked on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from igneous_tpu.ops import pallas_ccl
from igneous_tpu_torch.ops import cuda_ccl

WARP = 32
# the rows (dz, dy) of the lexicographically negative half, in bit order:
# bit 3*r + dx + 1 joins offset (dz, dy, dx) of row r; bit 12 is (0, 0, -1)
ROWS = ((-1, -1), (-1, 0), (-1, 1), (0, -1))


def _offset(bit: int):
  if bit == 12:
    return (0, 0, -1)
  dz, dy = ROWS[bit // 3]
  return (dz, dy, bit % 3 - 1)


def schedule(tile: np.ndarray, connectivity: int):
  """(tz, ty, tx) int32 labels -> (run head, join mask) per flat voxel, as
  the kernel's step 1 computes them: head is the first voxel of the run
  within the 32-voxel warp segment (-1 on background); bit b of the mask
  joins the voxel with its neighbour at ``_offset(b)``."""
  tz, ty, tx = tile.shape
  lab = tile.reshape(-1)
  n = lab.size
  i = np.arange(n)
  z, y, x = i // (ty * tx), (i // tx) % ty, i % tx
  fg = lab != 0
  lane = i % WARP

  def same(j, ok):
    return ok & (lab[np.clip(j, 0, n - 1)] == lab)

  left = fg & same(i - 1, x > 0)
  head = np.maximum.accumulate(np.where((lane == 0) | ~left, i, -1))
  bits = np.where(left & (lane == 0), 1 << 12, 0)
  degree = {6: 1, 18: 2, 26: 3}[connectivity]
  for r, (dz, dy) in enumerate(ROWS):
    deg = (dz != 0) + (dy != 0)
    if deg > degree:
      continue
    inside = (z + dz >= 0) & (y + dy >= 0) & (y + dy < ty)
    j = i + dz * ty * tx + dy * tx
    c0 = same(j, inside)
    cm = same(j - 1, inside & (x > 0))
    cp = same(j + 1, inside & (x + 1 < tx))
    if deg == degree:  # the row offers dx = 0 only
      bits |= (c0 & ~(left & cm)) << (3 * r + 1)
    else:
      bits |= np.where(
        left, (~c0 & cp) << (3 * r + 2),
        np.where(c0, 1 << (3 * r + 1), (cm << (3 * r)) | (cp << (3 * r + 2))),
      )
  return np.where(fg, head, -1), np.where(fg, bits, 0)


def schedule_roots(labt: np.ndarray, connectivity: int):
  """The kernel's output under the model's schedule, and the number of
  unions it asked for, over (T, tz, ty, tx) tiles. Step 2 unites each
  voxel's joins with finds that start from the parents of the two voxels;
  step 3 lets every run head find its root, then reads every foreground
  voxel's root two steps up. A voxel that is not its run's head must still
  point at its head after step 2."""
  out = np.empty_like(labt)
  unions = 0
  allowed = {tuple(o) for o in cuda_ccl.neighbor_offsets(connectivity)}
  for t, tile in enumerate(labt):
    tz, ty, tx = tile.shape
    lab = tile.reshape(-1)
    heads, bits = schedule(tile, connectivity)
    par = heads.copy()

    def find(v):
      while par[v] != v:
        par[v] = par[par[v]]
        v = par[v]
      return v

    for v in np.flatnonzero(bits):
      zyx = np.array(np.unravel_index(v, tile.shape))
      a = par[v]
      for b in range(13):
        if not bits[v] >> b & 1:
          continue
        off = _offset(b)
        nz, ny, nx = zyx + off
        assert off in allowed and 0 <= nz < tz and 0 <= ny < ty and 0 <= nx < tx
        w = v + off[0] * ty * tx + off[1] * tx + off[2]
        assert lab[w] == lab[v]
        a, c = find(a), find(par[w])
        a, c = min(a, c), max(a, c)
        par[c] = a
        unions += 1
    i = np.arange(lab.size)
    run_head = (heads == i) & (lab != 0)
    rest = (lab != 0) & ~run_head
    assert np.array_equal(par[rest], heads[rest])
    for h in np.flatnonzero(run_head):
      par[h] = find(h)
    out[t] = np.where(lab != 0, par[np.maximum(par, 0)], i).reshape(tile.shape)
  return out, unions


def _tiles(kind: str, shape, rng):
  T, tz, ty, tx = shape
  z, y, x = np.meshgrid(np.arange(tz), np.arange(ty), np.arange(tx), indexing="ij")
  if kind == "multilabel":
    return ((rng.random(shape) < 0.6) * rng.integers(1, 4, shape)).astype(np.int32)
  if kind == "snake":  # rows along x on even y, joined at alternating ends
    end = np.where((y // 2) % 2 == 0, tx - 1, 0)
    plane = ((y % 2 == 0) | (x == end)) & (z % 2 == 0)
    plane |= (z % 2 == 1) & (y == 0) & (x == 0)
    return np.broadcast_to(plane, shape).astype(np.int32) * rng.integers(1, 3, (T, 1, 1, 1)).astype(np.int32)
  if kind == "full":
    return np.full(shape, 7, np.int32)
  # checkerboard: no face neighbours share a label; edges and corners do
  board = ((x + y + z) % 2 + 1).astype(np.int32)
  return np.broadcast_to(board, shape) * rng.integers(1, 3, (T, 1, 1, 1)).astype(np.int32)


# tx below 32, above 32 and not a multiple of it (runs cross warps inside a
# row, and warps cross rows), and 64 (a run crosses warps at x = 32)
SHAPES = [(3, 3, 5, 7), (2, 3, 4, 40), (2, 2, 3, 64), (2, 2, 4, 32)]


@pytest.mark.parametrize("kind", ["multilabel", "snake", "full", "checkerboard"])
@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_schedule_resolves_like_plain_and_pallas(shape, connectivity, kind):
  labt = _tiles(kind, shape, np.random.default_rng(sum(shape) + connectivity))
  got, _ = schedule_roots(labt, connectivity)
  plain = cuda_ccl.tile_resolve_plain(torch.from_numpy(labt), connectivity).numpy()
  pallas = np.asarray(pallas_ccl.tile_resolve(jnp.asarray(labt), connectivity, interpret=True))
  assert np.array_equal(plain, pallas)
  assert np.array_equal(got, plain)


def _pairs(labt: np.ndarray, connectivity: int) -> int:
  """Same-label foreground neighbour pairs inside the tiles, each once."""
  T, tz, ty, tx = labt.shape
  count = 0
  for off in cuda_ccl.neighbor_offsets(connectivity):
    if off >= (0, 0, 0):
      continue
    src = labt[:, *(slice(max(-d, 0), s - max(d, 0)) for d, s in zip(off, (tz, ty, tx)))]
    nb = labt[:, *(slice(max(d, 0), s - max(-d, 0)) for d, s in zip(off, (tz, ty, tx)))]
    count += int(((src == nb) & (src != 0)).sum())
  return count


@pytest.mark.parametrize("connectivity", [6, 18, 26])
def test_schedule_prunes_pairs(connectivity):
  """On a full (4, 4, 32) tile every row is one run, and the rules unite
  each run once with each neighbouring run of the negative half that
  touches it: the run before it in y and in z, and at 18 and 26 the two
  diagonal runs of the plane below, while a union per pair would take 31
  more for each of those. On random labels the unions stay below the
  pairs too."""
  _, unions = schedule_roots(_tiles("full", (1, 4, 4, 32), None), connectivity)
  per_run = 4 * 3 + 3 * 4 + (0 if connectivity == 6 else 2 * 3 * 3)
  assert unions == per_run
  labt = _tiles("multilabel", (2, 4, 6, 40), np.random.default_rng(0))
  _, unions = schedule_roots(labt, connectivity)
  assert 0 < unions < _pairs(labt, connectivity)
