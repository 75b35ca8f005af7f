"""Patch engine: overlapping patch tiling of a halo'd cutout, batched
device apply, weighted overlap-blend, crop-to-core.

The port's own copy of ``igneous_tpu/infer/engine.py``. The model runs on
the device (``registry.InferenceModel.executor``); the tiling and the
blend stay numpy on the host, as in the JAX package, because the order
of the blend's float adds is the byte-determinism contract: the blended
output is identical bytes regardless of patch order, batch packing,
chunking, or pipelined vs serial execution. Enforced structurally:

  * patch positions are a pure function of (cutout shape, patch, stride),
    enumerated in one canonical order (x-major), and ACCUMULATED in that
    order: dispatch grouping never reorders the float adds;
  * dispatch groups are padded with zero patches to exactly
    ``batch_size``, and the model convolves one patch at a time
    (``registry``), so a patch's bits do not depend on which group or
    slot it rode in;
  * blend weights are NORMALIZED BEFORE the accumulation: each patch
    contributes ``out_p * (w_p / wsum)`` where ``wsum`` is the total
    weight coverage. Where a voxel is covered by a single patch,
    ``w_p / wsum == 1.0`` exactly (IEEE x/x), so the single-patch case
    degenerates to the raw model output bitwise: the blend-vs-whole
    identity the tests assert. ``(sum(out*w)) / wsum`` would NOT have
    this property in float32.

Blend weights are separable triangular ("tent") windows
``w[i] = min(i+1, L-i)``: strictly positive so wsum never divides by
zero and edge patches keep full authority over their exclusive voxels.

Counters (``telemetry``): ``infer.patches`` (real patches dispatched),
``infer.padded_slots`` (zero patches that filled the last group),
``infer.dispatches``. Stages: tile (the host's patch gather), the
executor's h2d, infer and d2h, and blend.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from .registry import InferenceModel


def patch_starts(length: int, patch: int, stride: int) -> List[int]:
  """Canonical start offsets covering [0, length) with patch-sized
  windows: a stride walk plus a final end-aligned patch. Requires
  length >= patch."""
  if length < patch:
    raise ValueError(f"length {length} < patch {patch}")
  starts = list(range(0, length - patch + 1, max(int(stride), 1)))
  if starts[-1] != length - patch:
    starts.append(length - patch)
  return starts


def _tent(length: int) -> np.ndarray:
  i = np.arange(length, dtype=np.float32)
  return np.minimum(i + 1.0, float(length) - i)


_WEIGHT_CACHE: Dict[tuple, np.ndarray] = {}
_WSUM_CACHE: Dict[tuple, np.ndarray] = {}
_CACHE_LOCK = threading.Lock()


def blend_weight(patch: Tuple[int, int, int]) -> np.ndarray:
  """(px, py, pz) float32 separable tent window, cached."""
  key = tuple(int(v) for v in patch)
  with _CACHE_LOCK:
    w = _WEIGHT_CACHE.get(key)
  if w is None:
    wx, wy, wz = (_tent(v) for v in key)
    w = wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
    w = np.ascontiguousarray(w, dtype=np.float32)
    with _CACHE_LOCK:
      _WEIGHT_CACHE[key] = w
  return w


def weight_sum(
  shape3: Tuple[int, int, int],
  patch: Tuple[int, int, int],
  stride: Tuple[int, int, int],
) -> np.ndarray:
  """Total blend-weight coverage of a cutout: a pure function of the
  tiling geometry, cached per (shape, patch, stride)."""
  key = (tuple(map(int, shape3)), tuple(map(int, patch)),
         tuple(map(int, stride)))
  with _CACHE_LOCK:
    wsum = _WSUM_CACHE.get(key)
  if wsum is None:
    w = blend_weight(patch)
    wsum = np.zeros(key[0], dtype=np.float32)
    axes = [patch_starts(key[0][a], key[1][a], key[2][a]) for a in range(3)]
    for sx, sy, sz in itertools.product(*axes):
      wsum[sx:sx + key[1][0], sy:sy + key[1][1], sz:sz + key[1][2]] += w
    with _CACHE_LOCK:
      _WSUM_CACHE[key] = wsum
  return wsum


def _to_device_layout(patch_xyzc: np.ndarray) -> np.ndarray:
  return np.ascontiguousarray(patch_xyzc.transpose(3, 2, 1, 0))  # (c,z,y,x)


def _from_device_layout(out_czyx: np.ndarray) -> np.ndarray:
  return np.asarray(out_czyx).transpose(3, 2, 1, 0)  # (x,y,z,c)


def infer_cutout(
  model: InferenceModel,
  image: np.ndarray,
  batch_size: int = 4,
) -> Tuple[np.ndarray, dict]:
  """Run ``model`` over ``image`` (x,y,z[,c]) by overlapping patches;
  returns ``(float32 (x,y,z,out_channels), stats)``.

  ``stats``: ``patches`` (real patches dispatched), ``padded_slots``
  (zero patches added to fill the last group), ``dispatches`` (device
  round-trips).
  """
  if image.ndim == 3:
    image = image[..., np.newaxis]
  spec = model.spec
  if image.shape[3] != spec.in_channels:
    raise ValueError(
      f"model {model.cloudpath} wants {spec.in_channels} channel(s), "
      f"cutout has {image.shape[3]}"
    )
  x = np.asarray(image, dtype=np.float32)
  orig3 = x.shape[:3]
  patch = tuple(int(v) for v in spec.patch_shape)
  # cutouts smaller than one patch pad up with background zeros; the
  # single resulting patch blends with weight exactly 1.0 (see module
  # docstring) so the pad-run-crop is bitwise the raw model apply
  pad = [max(patch[a] - orig3[a], 0) for a in range(3)]
  if any(pad):
    x = np.pad(x, [(0, pad[0]), (0, pad[1]), (0, pad[2]), (0, 0)])
  shape3 = x.shape[:3]
  stride = tuple(
    max(int(patch[a]) - int(spec.overlap[a]), 1) for a in range(3)
  )
  axes = [patch_starts(shape3[a], patch[a], stride[a]) for a in range(3)]
  positions = list(itertools.product(*axes))  # canonical x-major order

  executor = model.executor()
  dev_params = model.device_params()
  batch_size = max(int(batch_size), 1)

  outputs: List[Optional[np.ndarray]] = [None] * len(positions)
  dispatches = 0
  padded_slots = 0
  for g0 in range(0, len(positions), batch_size):
    group = positions[g0:g0 + batch_size]
    with telemetry.stage("tile"):
      stack = [
        _to_device_layout(x[sx:sx + patch[0], sy:sy + patch[1],
                            sz:sz + patch[2]])
        for sx, sy, sz in group
      ]
      # pad the group to the canonical batch: every dispatch has one shape
      fill = batch_size - len(stack)
      if fill:
        stack.extend(np.zeros_like(stack[0]) for _ in range(fill))
        padded_slots += fill
      batch = np.stack(stack)
    out = executor(batch, consts=dev_params)
    dispatches += 1
    for j in range(len(group)):
      outputs[g0 + j] = _from_device_layout(out[j])

  with telemetry.stage("blend"):
    out_c = int(spec.out_channels)
    acc = np.zeros(shape3 + (out_c,), dtype=np.float32)
    w = blend_weight(patch)
    wsum = weight_sum(shape3, patch, stride)
    # canonical accumulation order == canonical position order: the one
    # place float adds happen, so it is the one place order must be fixed
    for (sx, sy, sz), out_p in zip(positions, outputs):
      sl = (slice(sx, sx + patch[0]), slice(sy, sy + patch[1]),
            slice(sz, sz + patch[2]))
      ratio = w / wsum[sl]
      acc[sl] += out_p * ratio[..., None]
    acc = acc[:orig3[0], :orig3[1], :orig3[2]]
  stats = {
    "patches": len(positions),
    "padded_slots": padded_slots,
    "dispatches": dispatches,
  }
  for name, n in stats.items():
    telemetry.add(f"infer.{name}", n)
  return acc, stats


def apply_whole(model: InferenceModel, image: np.ndarray) -> np.ndarray:
  """Reference path: run the model ONCE on a whole (<= one patch) volume
  through the same executor: the bitwise ground truth the blend must
  reproduce when a cutout fits in a single patch."""
  if image.ndim == 3:
    image = image[..., np.newaxis]
  x = np.asarray(image, dtype=np.float32)
  orig3 = x.shape[:3]
  patch = tuple(int(v) for v in model.spec.patch_shape)
  if any(orig3[a] > patch[a] for a in range(3)):
    raise ValueError(f"volume {orig3} exceeds one patch {patch}")
  pad = [patch[a] - orig3[a] for a in range(3)]
  if any(pad):
    x = np.pad(x, [(0, pad[0]), (0, pad[1]), (0, pad[2]), (0, 0)])
  out = model.executor()(
    np.stack([_to_device_layout(x)]), consts=model.device_params()
  )
  return _from_device_layout(out[0])[:orig3[0], :orig3[1], :orig3[2]]
