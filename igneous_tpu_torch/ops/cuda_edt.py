"""One axis pass of the multilabel anisotropic squared EDT: a CUDA kernel
and its plain PyTorch version.

Counterpart of ``igneous_tpu/ops/edt.py``'s device program
``_edt_sq_kernel`` (its ``_axis_pass``: ``_edge_term`` and
``_envelope_pass``), with the semantics of the JAX package's host path,
``igneous_tpu/native/csrc/edt.cpp``'s ``line_pass``, bit for bit. Along
each line of the pass, per run of equal labels [a, b]:

  * the edge term, in double: d = the distance to the nearest voxel of
    another label along the line (i - a + 1 leftwards when a > 0,
    b + 1 - i rightwards when b < n - 1), e = d*d*w^2, stored as float32
    (1e20 where the run spans the whole line);
  * unless the pass is the first, the Felzenszwalb-Huttenlocher lower
    envelope of the run's parabolas, in double: heights val/w^2 (values at
    or above 5e19 skipped), the stack reset at each run, and
    (h + (q - v)^2) * w^2 cast to float32 where it is less than the edge
    term.

Labels are compared by raw 32- or 64-bit equality, so uint64 ids travel
as int64 and need no renumbering.

``edt_pass(labels, val_in, val_out, axis, w, first)`` takes a contiguous
3-d labels tensor (int32 or int64), reads ``val_in`` (float32, the same
shape; not read when ``first``) and writes ``val_out`` along dimension
``axis``. The two value buffers must be distinct. The wrapper takes the
plain version only for a tensor that lies on the CPU; for a CUDA tensor
it launches a kernel of ``csrc/edt.cu`` or raises: the shared-memory
design where a block's run-start and stack bitmasks fit in
``SMEM_BUDGET`` bytes (``smem_bytes``), else the long-line kernel with
its stacks in device scratch (``scratch_bytes``), chosen from the shape
before the launch and never after a failure. ``LAUNCHES`` counts kernel launches, one per launch
and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

LAUNCHES = {"edt_pass": 0}

INF = float(np.float32(1e20))  # the float32 sentinel of an infinite distance
_SKIP = INF * 0.5  # heights at or above this are not pushed
_FAR = 1e30  # edge distance where the run reaches the line's end
# lines per chunk of the plain envelope: bounds its (slots, lines) stacks
# of 24 bytes a slot. On the card one chunk holds all 515^2 lines of a
# skeleton task's pass (about 20 GB with its other per-line arrays), so
# that the position loop's steps are launched once.
_PLAIN_LINES = {"cpu": 1 << 14, "cuda": 1 << 19}


def _lines(t: torch.Tensor, axis: int) -> torch.Tensor:
  """``t`` viewed as (lines, n) with the pass's axis last."""
  return t.movedim(axis, -1).reshape(-1, t.shape[axis])


def _edge_term(lab: torch.Tensor, w2: float) -> torch.Tensor:
  """(lines, n) labels -> float32 edge term, as ``line_pass`` computes it."""
  L, n = lab.shape
  dev = lab.device
  idx = torch.arange(n, dtype=torch.int64, device=dev).expand(L, n)
  chg = torch.zeros((L, n), dtype=torch.bool, device=dev)
  chg[:, 1:] = lab[:, 1:] != lab[:, :-1]
  # a = the start of i's run: the last change at or before i (0 if none)
  a = torch.cummax(torch.where(chg, idx, 0), dim=1).values
  # b + 1 = the first change after i (n if none)
  nxt = torch.full((L, n), n, dtype=torch.int64, device=dev)
  nxt[:, :-1] = torch.where(chg[:, 1:], idx[:, 1:], n)
  b1 = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
  dl = torch.where(a > 0, (idx - a + 1).to(torch.float64), _FAR)
  dr = torch.where(b1 < n, (b1 - idx).to(torch.float64), _FAR)
  d = torch.minimum(dl, dr)
  e = torch.where(d < 1e29, (d * d) * w2, INF)
  return torch.clamp(e, max=INF).to(torch.float32)


def _envelope(val: torch.Tensor, lab: torch.Tensor, edge: torch.Tensor, w2: float):
  """The same-run lower envelope of ``line_pass`` on (lines, n) float32
  values, vectorised over lines and looped over positions. Each run's
  stack takes its own region of the (slots, lines) stacks (with one free
  slot after the previous run's, so that run's 1e30 top sentinel stays),
  so that all runs are queried after the build. A run that pushed nothing
  leaves its two slots unwritten, so its query reads an infinite height
  and bound and keeps the edge term. Lines with nothing to do at a step
  write to the last slot, which nothing reads. Returns ``edge`` with the
  envelope cast to float32 where it is less."""
  L, n = val.shape
  dev = val.device
  S = 2 * n + 4
  dump = torch.full((1, L), S - 1, dtype=torch.int64, device=dev)
  vs = torch.zeros((S, L), dtype=torch.int64, device=dev)
  hs = torch.full((S, L), float("inf"), dtype=torch.float64, device=dev)
  zs = torch.full((S, L), float("inf"), dtype=torch.float64, device=dev)
  k = torch.full((1, L), -1, dtype=torch.int64, device=dev)
  base = torch.zeros((1, L), dtype=torch.int64, device=dev)
  bases = torch.empty((n, L), dtype=torch.int64, device=dev)
  chg = torch.ones((n, L), dtype=torch.bool, device=dev)
  chg[1:] = (lab[:, 1:] != lab[:, :-1]).T
  f = val.T.to(torch.float64)  # (n, lines)
  push = f < _SKIP
  # a true division: PyTorch's CUDA division by a Python scalar multiplies
  # by its reciprocal, which is not the correctly rounded quotient
  h_all = f / torch.full((), w2, dtype=torch.float64, device=dev)
  far = torch.full((1, L), _FAR, dtype=torch.float64, device=dev)
  for q in range(n):
    cq = chg[q : q + 1]
    base = torch.where(cq, torch.maximum(k, base) + 2, base)
    k = torch.where(cq, base - 1, k)
    bases[q] = base[0]
    fq = h_all[q : q + 1]
    fq_q2 = fq + float(q * q)
    pq = push[q : q + 1]
    s = -far
    active = pq & (k >= base)
    while bool(active.any()):
      kc = k.clamp(min=0)
      vk = vs.gather(0, kc)
      sa = (fq_q2 - (hs.gather(0, kc) + (vk * vk).to(torch.float64))) / (
        2 * (q - vk)
      ).to(torch.float64)
      s = torch.where(active, sa, s)
      pop = active & (sa <= zs.gather(0, kc))
      k = k - pop.to(torch.int64)
      active = pop & (k >= base)
    s = torch.where(k >= base, s, -far)
    at = torch.where(pq, k + 1, dump)
    vs.scatter_(0, at, torch.full_like(at, q))
    hs.scatter_(0, at, fq)
    zs.scatter_(0, at, s)
    zs.scatter_(0, torch.where(pq, k + 2, dump), far)
    k = torch.where(pq, k + 1, k)

  out = edge.T.contiguous()  # (n, lines)
  j = torch.zeros((1, L), dtype=torch.int64, device=dev)
  for q in range(n):
    j = torch.where(chg[q : q + 1], bases[q : q + 1], j)
    adv = zs.gather(0, j + 1) < q
    while bool(adv.any()):
      j = j + adv.to(torch.int64)
      adv = adv & (zs.gather(0, j + 1) < q)
    dq = (q - vs.gather(0, j)).to(torch.float64)
    env = ((hs.gather(0, j) + dq * dq) * w2)[0]
    better = env < out[q].to(torch.float64)
    out[q] = torch.where(better, env.to(torch.float32), out[q])
  return out.T


def edt_pass_plain(labels, val_in, val_out, axis: int, w: float, first: bool):
  """The plain PyTorch version of ``edt_pass``: the same arithmetic in the
  same order, on any device."""
  _check(labels, val_in, val_out, axis, first)
  w2 = float(w) * float(w)
  n = labels.shape[axis]
  lab = _lines(labels, axis)
  edge = _edge_term(lab, w2)
  if first:
    out = edge
  else:
    val = _lines(val_in, axis)
    chunk = _PLAIN_LINES[labels.device.type]
    out = torch.cat([
      _envelope(val[lo : lo + chunk], lab[lo : lo + chunk], edge[lo : lo + chunk], w2)
      for lo in range(0, lab.shape[0], chunk)
    ]) if lab.shape[0] else edge
  moved = list(labels.shape)
  moved.append(moved.pop(axis))
  val_out.copy_(out.reshape(moved).movedim(-1, axis))
  return val_out


def _check(labels, val_in, val_out, axis, first):
  if labels.dim() != 3 or labels.dtype not in (torch.int32, torch.int64):
    raise ValueError(f"labels must be a 3-d int32 or int64 tensor: {labels.dtype} {tuple(labels.shape)}")
  if axis not in (0, 1, 2):
    raise ValueError(f"axis must be 0, 1 or 2: {axis}")
  bufs = [val_out] if first else [val_in, val_out]
  for t in bufs:
    if t.dtype != torch.float32 or t.shape != labels.shape or t.device != labels.device:
      raise ValueError("the value buffers must be float32 tensors of the labels' shape and device")
  if not first and val_in.data_ptr() == val_out.data_ptr():
    raise ValueError("val_in and val_out must be distinct buffers")


# ---------------------------------------------------------------------------
# the CUDA kernels

SMEM_BUDGET = 232448  # shared memory one block may use on sm_90 (227 KB)
LINES_PER_BLOCK = 128  # the line kernel: a thread a line
ROW_WARPS = 4  # the edge-row kernel (first pass on the contiguous axis)


def _lib():
  lib = _build.load("edt")
  if not getattr(lib, "_configured", False):
    for fn in (lib.edt_pass_i32, lib.edt_pass_i64):
      fn.restype = ctypes.c_int
      fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
      ]
    lib.edt_pass_blocks_per_sm.restype = ctypes.c_int
    lib.edt_pass_blocks_per_sm.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int]
    for fn in (lib.edt_pass_long_i32, lib.edt_pass_long_i64):
      fn.restype = ctypes.c_int
      fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
      ]
    lib._configured = True
  return lib


def _pass_shape(shape, axis: int):
  """(lines, n, inner) of a pass along ``axis`` of a contiguous ``shape``."""
  n = int(shape[axis])
  lines = int(np.prod(shape)) // max(n, 1)
  return lines, n, int(np.prod(shape[axis + 1 :]))


def smem_bytes(n: int, inner: int, first: bool) -> int:
  """Dynamic shared memory of a block of the shared-memory design (the
  formula of ``csrc/edt.cu``'s ``smem_bytes``): the first pass along the
  contiguous axis keeps, per warp, the line's run starts and a carry a
  word (8 bytes per 32 positions); otherwise a block keeps its 128 lines'
  run starts and, after the first pass, their stacks, one bit a position
  each."""
  words = (n + 31) // 32
  if inner == 1 and first:
    return ROW_WARPS * 2 * words * 4
  return words * LINES_PER_BLOCK * 4 * (1 if first else 2)


def blocks_per_sm(n: int, inner: int, first: bool) -> int:
  """Resident blocks an SM holds of the shared-memory design's kernel for
  such a pass (the CUDA occupancy calculator; needs the library)."""
  return int(_lib().edt_pass_blocks_per_sm(n, inner, int(bool(first))))


def long_line(shape, axis: int, first: bool) -> bool:
  """Whether the pass takes the long-line kernel: its lines' bitmasks do
  not fit a block's shared memory (after the first pass, n above 7264)."""
  _, n, inner = _pass_shape(shape, axis)
  return smem_bytes(n, inner, first) > SMEM_BUDGET


def scratch_bytes(shape, axis: int, first: bool = False) -> int:
  """Device bytes of scratch the pass allocates: none on the
  shared-memory design; on the long-line kernel after the first pass,
  for each line, n int32 positions, n double heights and n + 1 double
  bounds."""
  if first or not long_line(shape, axis, first):
    return 0
  lines, n, _ = _pass_shape(shape, axis)
  return lines * (4 * n + 8 * n + 8 * (n + 1))


def edt_pass(labels, val_in, val_out, axis: int, w: float, first: bool):
  """One axis pass (see the module docstring); returns ``val_out``."""
  if labels.device.type == "cpu":
    return edt_pass_plain(labels, val_in, val_out, axis, w, first)
  if labels.device.type != "cuda":
    raise ValueError(f"edt_pass runs on cuda or cpu tensors, not {labels.device}")
  _check(labels, val_in, val_out, axis, first)
  if not labels.is_contiguous() or not val_out.is_contiguous() or not (
    first or val_in.is_contiguous()
  ):
    raise ValueError("edt_pass needs contiguous tensors")
  lines, n, inner = _pass_shape(labels.shape, axis)
  if lines == 0 or n == 0:
    return val_out
  dev = labels.device
  lib = _lib()
  i64 = labels.dtype == torch.int64
  src = val_out if first else val_in
  args = (lines, n, inner, float(w) * float(w), int(bool(first)))
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not long_line(labels.shape, axis, first):
      fn = lib.edt_pass_i64 if i64 else lib.edt_pass_i32
      rc = fn(labels.data_ptr(), src.data_ptr(), val_out.data_ptr(), *args, stream)
    else:
      size = 0 if first else lines * n
      vbuf = torch.empty(size, dtype=torch.int32, device=dev)
      hbuf = torch.empty(size, dtype=torch.float64, device=dev)
      zbuf = torch.empty(size + (0 if first else lines), dtype=torch.float64, device=dev)
      fn = lib.edt_pass_long_i64 if i64 else lib.edt_pass_long_i32
      rc = fn(labels.data_ptr(), src.data_ptr(), val_out.data_ptr(), vbuf.data_ptr(),
              hbuf.data_ptr(), zbuf.data_ptr(), *args, stream)
  if rc != 0:
    raise RuntimeError(f"edt_pass: CUDA error {rc} at launch")
  LAUNCHES["edt_pass"] += 1
  return val_out
