"""Ragged paged batching on the port's device.

Counterpart of ``igneous_tpu/parallel/paged.py`` (its pyramid, CCL and EDT
parts). The batched executors take same-shape cutouts only; a grid's edge
cutouts are clamped to other shapes. Here every cutout is cut into fixed
(pz, py, px) pages with each page's valid extent beside it, and a round of
pages runs through the same launches whatever the cutouts' shapes. The
outputs are bit for bit the solo paths':

- **Pooling pyramid**: the page is chosen so that every cumulative factor
  divides it (``pages_compatible``), so no pooling window straddles two
  pages and page origins stay window-aligned at every mip. Before each
  step a clamp-gather replicates each axis's last valid row into the
  page's slack, the value the solo path's edge padding gives a partial
  window, re-clamped against the ceil-divided extent at every level (after
  one 2x2x1 step of an even extent e, the slack row would otherwise be
  pool(r[e-1], r[e-1]) instead of the solo pool(r[e-2], r[e-1])). The
  pages and their reassembly stay on the card; each item and mip is one
  copy to the host.
- **CCL**: pages tile the zero-padded volume and the tile grid divides the
  page (``ccl_page_compatible``), so one ``tile_resolve`` launch resolves
  every tile of every page of a round, as the solo path tiles one volume.
  Page-local roots become volume-global flat indices on the card, and one
  ``_merge_tile_roots`` per item stitches the tile seams and the page
  seams alike.
- **EDT**: its passes run along whole lines, so the EDT pages by shape:
  every item is zero-padded to the fleet's per-axis maximum plus the
  black border, rounded up to a page multiple. With ``black_border=True``
  the appended zeros only lengthen the border's background run, so every
  foreground distance keeps its value.

Where the JAX package pads its page rounds with zero filler pages, rounds
its canonical EDT shape up to a power-of-two page count and rounds K up to
a power of two, all to bound its compiled signatures, the port does none
of it: PyTorch compiles no signatures, and the outputs are the same.

Knobs: ``IGNEOUS_PAGE_SHAPE=pz,py,px`` (default 32,32,32) and
``IGNEOUS_PAGE_BATCH`` (pages a round, default 32, rounded up to a power
of two), each resolved as ``tune.resolve`` says: the environment, then
the tuned file of this device kind, then the default. The device ledger
records each round's page slack as pad waste (``record_pad_waste``).

``PagedGlobalRunner`` is the multi-host entry point (``multihost``): each
rank of a pod runs ``page_pyramid`` on its own range of a global page
table (``multihost.page_partition``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import get_device
from ..observability.device import LEDGER, execute_span, transfer_span
from ..ops import cuda_pooling
from ..ops.cuda_pooling import SIGNED_VIEW
from ..ops.pooling import _normalize_factors, _pool_once, _work_array, route
from ..tune import resolve
from .executor import join_planes, split_planes, sync

_DEFAULT_PAGE = (32, 32, 32)
_DEFAULT_PAGE_BATCH = 32
_BIG = np.iinfo(np.int32).max


def page_shape() -> Tuple[int, int, int]:
  """The fixed page shape (pz, py, px), in the device's (z, y, x) order.

  The default 32^3 is divided by every standard mip factor chain up to
  five halvings and by both CCL tile defaults."""
  raw = resolve("IGNEOUS_PAGE_SHAPE") or ""
  if not raw:
    return _DEFAULT_PAGE
  parts = tuple(int(v) for v in raw.replace(" ", "").split(","))
  if len(parts) != 3 or any(p <= 0 for p in parts):
    raise ValueError(
      f"IGNEOUS_PAGE_SHAPE must be three positive ints 'pz,py,px': {raw!r}"
    )
  return parts


def page_round_cap() -> int:
  """Pages a round: ``IGNEOUS_PAGE_BATCH`` rounded up to a power of two
  (the reference's power-of-two multiple of the device count, on one
  card)."""
  want = int(resolve("IGNEOUS_PAGE_BATCH") or _DEFAULT_PAGE_BATCH)
  if want <= 0:
    raise ValueError("IGNEOUS_PAGE_BATCH must be positive")
  cap = 1
  while cap < want:
    cap <<= 1
  return cap


def pages_compatible(factors, page: Optional[Tuple[int, int, int]] = None) -> bool:
  """True iff every per-mip cumulative factor divides the page on its
  axis: then no pooling window straddles a page boundary and page origins
  stay window-aligned at every mip."""
  page = page or page_shape()
  cum = [1, 1, 1]
  for (fx, fy, fz) in factors:
    for i, f in enumerate((fz, fy, fx)):
      cum[i] *= int(f)
      if cum[i] <= 0 or page[i] % cum[i]:
        return False
  return True


def ccl_page_compatible(page: Optional[Tuple[int, int, int]] = None) -> bool:
  """True iff the CCL tile grid divides the page, so page boundaries are
  tile boundaries and one host merge stitches both kinds of seam."""
  from ..ops.ccl import _tile_shape

  page = page or page_shape()
  return all(p % min(t, p) == 0 for t, p in zip(_tile_shape(), page))


def _ceil_chain(extent, factors):
  """Per-mip extents of one region under the factor chain (z, y, x)."""
  e = tuple(int(v) for v in extent)
  out = []
  for (fx, fy, fz) in factors:
    e = tuple(-(-a // f) for a, f in zip(e, (fz, fy, fx)))
    out.append(e)
  return out


def to_pages(vol: torch.Tensor, page) -> torch.Tensor:
  """(..., Zp, Yp, Xp) with each of Zp, Yp, Xp a multiple of the page ->
  (n, ..., pz, py, px) contiguous pages, z-major then y then x."""
  pz, py, px = page
  *lead, Zp, Yp, Xp = vol.shape
  nz, ny, nx = Zp // pz, Yp // py, Xp // px
  L = len(lead)
  v = vol.reshape(*lead, nz, pz, ny, py, nx, px)
  order = [L, L + 2, L + 4, *range(L), L + 1, L + 3, L + 5]
  return v.permute(order).reshape(nz * ny * nx, *lead, pz, py, px).contiguous()


def from_pages(pages: torch.Tensor, grid) -> torch.Tensor:
  """The inverse of ``to_pages``: (n, ..., qz, qy, qx) pages of an
  (nz, ny, nx) grid -> (..., nz*qz, ny*qy, nx*qx)."""
  nz, ny, nx = grid
  *lead, qz, qy, qx = pages.shape[1:]
  L = len(lead)
  v = pages.reshape(nz, ny, nx, *lead, qz, qy, qx)
  order = [*range(3, 3 + L), 0, 3 + L, 1, 4 + L, 2, 5 + L]
  return v.permute(order).reshape(*lead, nz * qz, ny * qy, nx * qx)


def _padded(t: torch.Tensor, page) -> torch.Tensor:
  """(..., Z, Y, X) zero-padded at the high end to page multiples."""
  Z, Y, X = t.shape[-3:]
  pads = [(-s) % p for s, p in zip((Z, Y, X), page)]
  return torch.nn.functional.pad(t, (0, pads[2], 0, pads[1], 0, pads[0]))


def _runs(todo):
  """Entries (item, page index, ...) of a round -> [item, j0, j1] runs of
  consecutive pages of one item."""
  runs = []
  for i, j, *_ in todo:
    if runs and runs[-1][0] == i and runs[-1][2] == j:
      runs[-1][2] += 1
    else:
      runs.append([i, j, j + 1])
  return runs


# ---------------------------------------------------------------------------
# paged pooling pyramid


def clamp_pages(x: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
  """(P, c, pz, py, px) pages and their (P, 3) int64 valid extents (z, y,
  x) -> the pages with every row past the extent replaced by the last
  valid one along each axis (``min(arange, ext - 1)``; a page of extent 0
  clamps to row 0). Gathers run on the signed view of unsigned types."""
  dtype = x.dtype
  x = x.view(SIGNED_VIEW.get(dtype, dtype))
  P = x.shape[0]
  for a in range(3):
    n = x.shape[a + 2]
    idx = torch.minimum(
      torch.arange(n, device=x.device).view(1, n),
      (ext[:, a : a + 1] - 1).clamp(min=0),
    )
    shape = [P, 1, 1, 1, 1]
    shape[a + 2] = n
    x = torch.gather(x, a + 2, idx.view(shape).expand(x.shape))
  return x.view(dtype)


def page_pyramid(pages, ext, factors, method: str, sparse: bool) -> List[torch.Tensor]:
  """The page kernel: (P, c, pz, py, px) pages and (P, 3) extents -> per
  mip (P, c, ...) pages. Each level clamps, then pools: ``route``'s
  leading run of 2x2x1 levels with one ``pool2x2x1`` launch over every
  page of the round, the other levels with the plain step. The extents
  ceil-divide alongside, so each level re-clamps against its own valid
  region; what lies past it is slack that reassembly crops."""
  dtype = torch.empty(0, dtype=pages.dtype).numpy().dtype
  run = route(factors, method, sparse, dtype)
  x, e = pages, ext
  outs = []
  for level, f in enumerate(factors):
    x = clamp_pages(x, e)
    if level < run:
      x = cuda_pooling.pool2x2x1(x, method)
    else:
      P, c = x.shape[:2]
      y = _pool_once(x.reshape((P * c,) + x.shape[2:]), f, method, sparse)
      x = y.reshape((P, c) + y.shape[1:]).contiguous()
    fzyx = torch.tensor((f[2], f[1], f[0]), dtype=torch.int64, device=e.device)
    e = torch.div(e + fzyx - 1, fzyx, rounding_mode="floor")
    outs.append(x)
  return outs


class PagedPyramid:
  """Incremental paged pyramid over a ragged fleet of cutouts.

  Packs every item (x, y, z[, c]) into fixed pages on the card, runs them
  in rounds of ``page_round_cap`` pages, and reassembles per-item per-mip
  outputs bit for bit those of ``pooling.downsample``. Between rounds a
  caller may shed the items none of whose pages has run
  (:meth:`split_unstarted`), for other hosts to take.
  """

  def __init__(
    self,
    imgs: Sequence[np.ndarray],
    factor,
    num_mips: int = 1,
    method: str = "average",
    sparse: bool = False,
    page: Optional[Tuple[int, int, int]] = None,
  ):
    if not imgs:
      raise ValueError("need at least one image")
    self.factors = _normalize_factors(factor, num_mips)
    self.page = tuple(page or page_shape())
    if not pages_compatible(self.factors, self.page):
      raise ValueError(
        f"factor chain {self.factors} does not divide page {self.page}; "
        "use the solo path (see pages_compatible)"
      )
    dts = {img.dtype for img in imgs}
    cs = {1 if img.ndim == 3 else img.shape[3] for img in imgs}
    if len(dts) != 1 or len(cs) != 1:
      raise ValueError("paged fleets must share dtype and channel count")
    self._orig_dtype = next(iter(dts))
    self._c = next(iter(cs))
    self.method = method
    self.sparse = sparse
    self.device = get_device()
    self._squeeze = [img.ndim == 3 for img in imgs]
    self.cap = page_round_cap()

    # the device dtype rules of pooling.downsample (_work_array); items
    # go to the card once, cut into pages there
    self._grids: List[Optional[torch.Tensor]] = []
    self._shapes: List[Tuple[int, int, int]] = []
    self._entries = []  # (item, page index, (ez, ey, ex))
    self._left = []
    pz, py, px = self.page
    nbytes = sum(img.nbytes for img in imgs)
    with telemetry.stage("h2d"), transfer_span("h2d", nbytes, self.device):
      for i, img in enumerate(imgs):
        work = _work_array(img, method)
        self._work_dtype = work.dtype
        t = torch.from_numpy(work.transpose(3, 2, 1, 0)).to(self.device)
        self._dtype = t.dtype
        self._signed = SIGNED_VIEW.get(t.dtype, t.dtype)
        t = t.contiguous().view(self._signed)  # pads and copies on the signed view
        Z, Y, X = t.shape[1:]
        self._shapes.append((Z, Y, X))
        self._grids.append(to_pages(_padded(t, self.page), self.page))
        n0 = len(self._entries)
        for oz in range(0, Z, pz):
          for oy in range(0, Y, py):
            for ox in range(0, X, px):
              ext = (min(pz, Z - oz), min(py, Y - oy), min(px, X - ox))
              self._entries.append((i, len(self._entries) - n0, ext))
        self._left.append(len(self._entries) - n0)
    self._outs: List[Optional[List[torch.Tensor]]] = [None] * len(imgs)
    self._results = {}
    self._next = 0
    self._released: set = set()

  @property
  def n_items(self) -> int:
    return len(self._shapes)

  @property
  def pending(self) -> bool:
    return self._next < len(self._entries)

  @property
  def rounds_remaining(self) -> int:
    return -(-(len(self._entries) - self._next) // self.cap)

  def split_unstarted(self) -> List[int]:
    """Drop every item none of whose pages has run and return their
    indices (in order), marking them released (``results`` leaves them
    out); the items in flight stay, in order, to finish. The lease
    batcher's flagged worker hands the dropped members back to the queue."""
    started = {e[0] for e in self._entries[: self._next]}
    rest = self._entries[self._next :]
    dropped = sorted({e[0] for e in rest} - started)
    if dropped:
      ds = set(dropped)
      self._entries = self._entries[: self._next] + [
        e for e in rest if e[0] not in ds
      ]
      self._released.update(ds)
      for i in ds:
        self._grids[i] = None
    return dropped

  def run_round(self) -> List[int]:
    """Run the next round of pages; returns the indices of the items it
    completed (whose :meth:`result` is then available)."""
    todo = self._entries[self._next : self._next + self.cap]
    if not todo:
      return []
    self._next += len(todo)
    runs = _runs(todo)
    # the page packer's own slack: pages beyond each cutout's valid extent
    # (no filler pages: rounds are not padded to the cap)
    pz, py, px = self.page
    itemsize = self._work_dtype.itemsize * self._c
    real = sum(ez * ey * ex for _, _, (ez, ey, ex) in todo) * itemsize
    LEDGER.record_pad_waste(len(todo) * pz * py * px * itemsize - real, real)
    with telemetry.stage("kernel"):
      with execute_span(
        f"pooling.paged_pyramid[{self.method}]", len(todo) * pz * py * px * self._c,
        device=self.device, signature=(len(todo), self.page, self.factors),
      ):
        pages = torch.cat([self._grids[i][j0:j1] for i, j0, j1 in runs])
        ext = torch.tensor([e for _, _, e in todo], dtype=torch.int64).to(self.device)
        outs = page_pyramid(
          pages.view(self._dtype), ext, self.factors, self.method, self.sparse
        )
        outs = [o.view(self._signed) for o in outs]
        r = 0
        for i, j0, j1 in runs:
          if self._outs[i] is None:
            n = len(self._grids[i])
            self._outs[i] = [torch.empty((n,) + o.shape[1:], dtype=o.dtype, device=o.device)
                             for o in outs]
          for dst, o in zip(self._outs[i], outs):
            dst[j0:j1] = o[r : r + j1 - j0]
          r += j1 - j0
      sync(self.device)
    done = []
    for i, j0, j1 in runs:
      self._left[i] -= j1 - j0
      if self._left[i] == 0:
        self._finish(i)
        done.append(i)
    return done

  def _finish(self, i: int) -> None:
    """Reassemble item ``i`` on the card and copy each mip to the host."""
    grid = tuple(-(-s // p) for s, p in zip(self._shapes[i], self.page))
    results = []
    nbytes = sum(o.numel() * o.element_size() for o in self._outs[i])
    with telemetry.stage("d2h"), transfer_span("d2h", nbytes, self.device):
      for pages, e in zip(self._outs[i], _ceil_chain(self._shapes[i], self.factors)):
        vol = from_pages(pages, grid)[:, : e[0], : e[1], : e[2]]
        r = vol.contiguous().cpu().numpy().view(self._work_dtype)
        r = r.transpose(3, 2, 1, 0).astype(self._orig_dtype, copy=False)
        results.append(r[..., 0] if self._squeeze[i] else r)
    self._results[i] = results
    self._grids[i] = self._outs[i] = None

  def result(self, i: int) -> List[np.ndarray]:
    """Per-mip outputs of a completed item, as ``pooling.downsample``
    returns them."""
    if i not in self._results:
      raise ValueError(f"item {i} is not complete")
    return self._results[i]

  def run(self) -> List[List[np.ndarray]]:
    """Run every round; returns the results of all items not shed."""
    while self.pending:
      self.run_round()
    return [self.result(i) for i in range(self.n_items) if i not in self._released]


def paged_pyramid(
  imgs: Sequence[np.ndarray],
  factor,
  num_mips: int = 1,
  method: str = "average",
  sparse: bool = False,
  page: Optional[Tuple[int, int, int]] = None,
) -> List[List[np.ndarray]]:
  """One-shot paged pyramid: ragged (x, y, z[, c]) cutouts -> per-item
  per-mip outputs, bit for bit those of solo ``pooling.downsample``."""
  return PagedPyramid(
    imgs, factor, num_mips, method=method, sparse=sparse, page=page
  ).run()


# ---------------------------------------------------------------------------
# paged CCL


def paged_ccl(
  imgs: Sequence[np.ndarray],
  connectivity: int = 6,
  page: Optional[Tuple[int, int, int]] = None,
) -> List[np.ndarray]:
  """Ragged CCL: (x, y, z) label volumes -> component volumes numbered
  exactly as ``connected_components`` numbers each alone.

  Every volume is zero-padded to page multiples and cut into pages on the
  card. A round's pages are cut into tiles and resolved by one
  ``tile_resolve`` launch; the page-local roots become volume-global flat
  indices; one ``_merge_tile_roots`` per item stitches the tile and page
  seams. Exact CCL on both routes and a renumbering that depends only on
  the partition give the same bytes."""
  from ..ops.ccl import (
    _ccl_tiled_roots, _dense_relabel, _merge_tile_roots, _roots_to_components,
    _tile_shape, neighbor_offsets,
  )

  neighbor_offsets(connectivity)  # validate before any device work
  dev = get_device()
  page = tuple(page or page_shape())
  if not ccl_page_compatible(page):
    raise ValueError(
      f"CCL tile {_tile_shape()} does not divide page {page}; use the "
      "solo path (see ccl_page_compatible)"
    )
  tile_eff = tuple(min(t, p) for t, p in zip(_tile_shape(), page))
  cap = page_round_cap()
  pz, py, px = page

  vols, grids, roots, entries = [], [], [], []
  for i, img in enumerate(imgs):
    if img.ndim != 3:
      raise ValueError("labels must be (x, y, z)")
    with telemetry.stage("dense_relabel"):
      zyx = np.ascontiguousarray(_dense_relabel(np.asarray(img)).transpose(2, 1, 0))
    with telemetry.stage("h2d"), transfer_span("h2d", zyx.nbytes, dev):
      padded = _padded(torch.from_numpy(zyx).to(dev), page)
      Zp, Yp, Xp = padded.shape
      if Zp * Yp * Xp > _BIG:
        raise ValueError(
          f"the page-padded volume ({Zp}, {Yp}, {Xp}) has more voxels than "
          "int32 flat indices can address; label smaller cutouts"
        )
      vols.append((zyx, (Zp, Yp, Xp)))
      grids.append(to_pages(padded, page))
      roots.append(torch.empty_like(grids[-1]))
      j = 0
      for oz in range(0, Zp, pz):
        for oy in range(0, Yp, py):
          for ox in range(0, Xp, px):
            entries.append((i, j, (oz, oy, ox), (Yp, Xp)))
            j += 1

  # page slack beside the real voxels (no filler pages)
  real = sum(v[0].nbytes for v in vols)
  LEDGER.record_pad_waste(len(entries) * pz * py * px * 4 - real, real)
  with telemetry.stage("kernel"):
    for r0 in range(0, len(entries), cap):
      todo = entries[r0 : r0 + cap]
      runs = _runs(todo)
      with execute_span("ccl.paged", len(todo) * pz * py * px, device=dev,
                        signature=(len(todo), page, connectivity)):
        pages = torch.cat([grids[i][j0:j1] for i, j0, j1 in runs])
        local = _ccl_tiled_roots(pages, connectivity, tile_eff)
        # page-local flat root -> volume-global flat root: without this,
        # roots of different pages of one volume collide in the merge
        meta = torch.tensor(
          [o + d for _, _, o, d in todo], dtype=torch.int32
        ).to(dev).view(-1, 5, 1, 1, 1)
        oz, oy, ox, Yp, Xp = meta.unbind(1)
        lz = torch.div(local, py * px, rounding_mode="floor")
        ly = torch.div(local, px, rounding_mode="floor") - lz * py
        lx = local - torch.div(local, px, rounding_mode="floor") * px
        g = ((oz + lz) * Yp + (oy + ly)) * Xp + (ox + lx)
        g = torch.where(local != _BIG, g, _BIG)
        r = 0
        for i, j0, j1 in runs:
          roots[i][j0:j1] = g[r : r + j1 - j0]
          r += j1 - j0
    sync(dev)

  results = []
  for i, (zyx, (Zp, Yp, Xp)) in enumerate(vols):
    Z, Y, X = zyx.shape
    grid = (Zp // pz, Yp // py, Xp // px)
    with telemetry.stage("d2h"), transfer_span("d2h", roots[i].numel() * 4, dev):
      vol_roots = from_pages(roots[i], grid).cpu().numpy()
    padded = np.zeros((Zp, Yp, Xp), np.int32)
    padded[:Z, :Y, :X] = zyx
    with telemetry.stage("tile_merge"):
      merged = _merge_tile_roots(vol_roots, padded, connectivity, tile_eff)
    with telemetry.stage("renumber"):
      results.append(_roots_to_components(merged[:Z, :Y, :X].transpose(2, 1, 0)))
  return results


# ---------------------------------------------------------------------------
# paged EDT (pages by shape)


def canonical_shape(shapes, page) -> Tuple[int, int, int]:
  """(z, y, x) of the fleet's common padded shape: each axis's maximum
  extent plus the two border voxels, rounded up to a page multiple."""
  return tuple(
    -(-(max(s[a] for s in shapes) + 2) // page[a]) * page[a] for a in range(3)
  )


def paged_edt(
  labels_list: Sequence[np.ndarray],
  anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
  page: Optional[Tuple[int, int, int]] = None,
) -> List[np.ndarray]:
  """Ragged EDT with ``black_border=True`` semantics: (x, y, z) label
  volumes -> float32 distance fields, each bit for bit ``edt(...,
  black_border=True)`` of that volume alone.

  Every item is zero-padded, one voxel of border before it, to the
  fleet's ``canonical_shape``, and the batch runs through the three
  launches of ``squared_edt``. The appended zeros lengthen the border's
  background run and add no label change, so every foreground voxel's
  run-scoped envelope, and its distance, are those of the solo path.
  Only ``black_border=True`` is invariant to that padding (an open border
  would see the pad as a new boundary), which is the skeleton forge's
  mode; other callers use ``edt_batch``."""
  from ..ops.edt import distance_field, host_labels

  if not labels_list:
    return []
  page = tuple(page or page_shape())
  labs = []
  for it in labels_list:
    it = np.asarray(it)
    if it.ndim != 3:
      raise ValueError("labels must be (x, y, z)")
    labs.append(np.ascontiguousarray(host_labels(it).transpose(2, 1, 0)))
  dtype = torch.int64 if any(l.dtype == np.int64 for l in labs) else torch.int32
  canon = canonical_shape([l.shape for l in labs], page)
  dev = get_device()
  itemsize = torch.empty(0, dtype=dtype).element_size()
  real = sum(l.size for l in labs) * itemsize
  LEDGER.record_pad_waste(len(labs) * int(np.prod(canon)) * itemsize - real, real)
  with telemetry.stage("h2d"), transfer_span("h2d", sum(l.nbytes for l in labs), dev):
    work = torch.zeros((len(labs),) + canon, dtype=dtype, device=dev)
    for k, l in enumerate(labs):
      Z, Y, X = l.shape
      work[k, 1 : Z + 1, 1 : Y + 1, 1 : X + 1] = torch.from_numpy(l).to(dev)
  with telemetry.stage("edt"):
    with execute_span("edt.sq_paged", work.numel(), work.numel() * (itemsize + 4), dev,
                      signature=(tuple(work.shape), str(dtype))):
      field = distance_field(work, anisotropy)
    del work
    sync(dev)
  outs = []
  with telemetry.stage("d2h"), transfer_span("d2h", 4 * sum(l.size for l in labs), dev):
    for k, l in enumerate(labs):
      Z, Y, X = l.shape
      f = field[k, 1 : Z + 1, 1 : Y + 1, 1 : X + 1].contiguous().cpu().numpy()
      outs.append(f.transpose(2, 1, 0))
  return outs


# ---------------------------------------------------------------------------
# pod entry: the paged pyramid over a global page batch


class PagedGlobalRunner:
  """The multi-host paged pyramid (the counterpart of
  ``ChunkExecutor.run_global``): ``page_pyramid`` over this rank's rows
  of already-sharded global page and extent batches, assembled by
  ``multihost.from_process_local`` from each host's ``page_partition``
  range. Callers read the outputs through ``.addressable_shards``; a rank
  addresses only its own pages, so no global gather happens here."""

  def __init__(self, factors, method: str = "average", sparse: bool = False,
               planes: int = 1, mesh=None):
    from . import multihost

    self.mesh = mesh if mesh is not None else multihost.pod_mesh()
    self.axis = self.mesh.axis_names[0]
    self.factors = tuple(tuple(int(v) for v in f) for f in factors)
    self.method = method
    self.sparse = sparse
    self.planes = int(planes)
    if self.planes not in (1, 2):
      raise ValueError("planes must be 1 or 2")
    self.name = f"pooling.paged_pyramid[{method}]"

  def __call__(self, pages, exts):
    """pages: a global (K, c, pz, py, px) batch (a (lo, hi) tuple of them,
    planes=2); exts: the global (K, 3) batch of valid extents (z, y, x).
    Returns the per-mip global batches (or (lo, hi) tuples of them)."""
    from . import multihost

    arrs = pages if isinstance(pages, tuple) else (pages,)
    if len(arrs) != self.planes:
      raise ValueError(f"expected {self.planes} plane(s), got {len(arrs)}")
    arrs = multihost.same_rows(arrs + (exts,))[:-1]
    xs = [a.data for a in arrs]
    with execute_span(self.name, sum(int(x.numel()) for x in xs),
                      sum(int(x.numel()) * x.element_size() for x in xs),
                      self.mesh.device):
      x = join_planes(*xs) if self.planes == 2 else xs[0]
      outs = page_pyramid(x, exts.data.to(torch.int64), self.factors,
                          self.method, self.sparse)
      if self.planes == 2:
        outs = [split_planes(o) for o in outs]
    sync(self.mesh.device)
    lead = arrs[0]
    if self.planes == 2:
      return tuple((lead.like(lo), lead.like(hi)) for lo, hi in outs)
    return tuple(lead.like(o) for o in outs)
