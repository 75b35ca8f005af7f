"""Legacy-compatibility tasks kept importable.

The port's own copy of ``igneous_tpu/tasks/obsolete.py``:
``HyperSquareConsensusTask`` (an Eyewire consensus map applied to a
segmentation), ``WatershedRemapTask`` (a ``.npy`` remap table),
``MaskAffinitymapTask`` (affinities zeroed outside a mask) and
``LegacyInferenceTask`` (patch-wise inference with a registered model and
an overlap average). They exist so that pipelines written against these
task names keep deserializing and running; each writes the JAX package's
bytes.

The first three are label and mask arithmetic on the host
(``ops.remap``), as in the JAX package. ``register_inference_model``
keeps its contract of numpy in and numpy out: the callable decides where
it runs (a torch model moves each patch to the card itself).
"""

from __future__ import annotations

import io
import json
from typing import Callable, Dict, Sequence

import numpy as np

from ..lib import Bbox, Vec
from ..ops import remap as fastremap
from ..queues.registry import RegisteredTask
from ..storage import CloudFiles
from ..volume import Volume


class HyperSquareConsensusTask(RegisteredTask):
  """Apply an Eyewire-style consensus map (segment ids → consensus ids)
  stored as JSON {volume_id: {segid: consensus_id}}."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    consensus_map_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.consensus_map_path = consensus_map_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)

  def execute(self):
    src = Volume(self.src_path, mip=self.mip, bounded=False)
    dest = Volume(self.dest_path, mip=self.mip)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), src.bounds
    )
    if bounds.empty():
      return
    root, _, key = self.consensus_map_path.rpartition("/")
    data = CloudFiles(root).get(key)
    if data is None:
      raise FileNotFoundError(
        f"consensus map not found: {self.consensus_map_path}"
      )
    table: Dict[int, int] = {}
    for seg_map in json.loads(data.decode("utf8")).values():
      for segid, consensus in seg_map.items():
        table[int(segid)] = int(consensus)
    img = src.download(bounds)[..., 0]
    out = fastremap.remap(img, {**table, 0: 0}, preserve_missing_labels=True)
    dest.upload(bounds, out.astype(dest.dtype))


class WatershedRemapTask(RegisteredTask):
  """Apply a .npy remap array (index = watershed id, value = new id)."""

  def __init__(
    self,
    map_path: str,
    src_path: str,
    dest_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
  ):
    self.map_path = map_path
    self.src_path = src_path
    self.dest_path = dest_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)

  def execute(self):
    src = Volume(self.src_path, mip=self.mip, bounded=False)
    dest = Volume(self.dest_path, mip=self.mip)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), src.bounds
    )
    if bounds.empty():
      return
    pth = self.map_path
    if "://" in pth:
      proto_root, _, key = pth.rpartition("/")
      data = CloudFiles(proto_root).get(key)
      if data is None:
        raise FileNotFoundError(f"remap table not found: {pth}")
      table = np.load(io.BytesIO(data))
    else:
      table = np.load(pth)
    img = src.download(bounds)[..., 0]
    out = table[img.astype(np.int64)]
    dest.upload(bounds, out.astype(dest.dtype))


class MaskAffinitymapTask(RegisteredTask):
  """Zero affinity channels wherever the mask layer is zero."""

  def __init__(
    self,
    aff_path: str,
    mask_path: str,
    dest_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    mask_mip: int = 0,
  ):
    self.aff_path = aff_path
    self.mask_path = mask_path
    self.dest_path = dest_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.mask_mip = int(mask_mip)

  def execute(self):
    aff = Volume(self.aff_path, mip=self.mip, bounded=False)
    mask_vol = Volume(self.mask_path, mip=self.mask_mip, bounded=False)
    dest = Volume(self.dest_path, mip=self.mip)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), aff.bounds
    )
    if bounds.empty():
      return
    img = aff.download(bounds)
    mask_bounds = mask_vol.meta.bbox_to_mip(bounds, self.mip, self.mask_mip)
    mask = mask_vol.download(mask_bounds)[..., 0]
    if mask.shape != img.shape[:3]:  # differing mips: upsample by repetition
      reps = [int(np.ceil(a / b)) for a, b in zip(img.shape[:3], mask.shape)]
      mask = np.kron(mask, np.ones(reps, dtype=mask.dtype))[
        : img.shape[0], : img.shape[1], : img.shape[2]
      ]
    img[mask == 0] = 0
    dest.upload(bounds, img)


_INFERENCE_MODELS: Dict[str, Callable] = {}


def register_inference_model(name: str, fn: Callable):
  """fn(patch: np.ndarray[x,y,z,c_in]) -> np.ndarray[x,y,z,c_out], the
  patch-wise model of ``LegacyInferenceTask``; the callable decides where
  it runs."""
  _INFERENCE_MODELS[name] = fn


class LegacyInferenceTask(RegisteredTask):
  """Patch-wise model inference with an overlap average. Patches overlap
  by ``overlap`` voxels; each voxel is the mean of the patches that cover
  it."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    model_name: str,
    shape: Sequence[int],
    offset: Sequence[int],
    patch_size: Sequence[int] = (64, 64, 32),
    overlap: Sequence[int] = (8, 8, 4),
    mip: int = 0,
    fill_missing: bool = False,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.model_name = model_name
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.patch_size = Vec(*patch_size)
    self.overlap = Vec(*overlap)
    self.mip = int(mip)
    self.fill_missing = fill_missing

  def execute(self):
    if self.model_name not in _INFERENCE_MODELS:
      raise KeyError(
        f"No inference model {self.model_name!r}; call "
        "register_inference_model() in the worker before polling."
      )
    model = _INFERENCE_MODELS[self.model_name]
    src = Volume(self.src_path, mip=self.mip, bounded=False,
                 fill_missing=self.fill_missing)
    dest = Volume(self.dest_path, mip=self.mip)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), src.bounds
    )
    if bounds.empty():
      return
    img = src.download(bounds).astype(np.float32)

    ps = np.asarray(self.patch_size, dtype=np.int64)
    ov = np.asarray(self.overlap, dtype=np.int64)
    stride = np.maximum(ps - ov, 1)
    size = np.asarray(img.shape[:3], dtype=np.int64)

    out = None
    weight = np.zeros(img.shape[:3] + (1,), dtype=np.float32)
    starts = [
      np.unique(np.clip(np.arange(0, size[a], stride[a]), 0,
                        max(size[a] - ps[a], 0)))
      for a in range(3)
    ]
    for x0 in starts[0]:
      for y0 in starts[1]:
        for z0 in starts[2]:
          sl = tuple(
            slice(int(s), int(min(s + p, e)))
            for s, p, e in zip((x0, y0, z0), ps, size)
          )
          result = np.asarray(model(img[sl]), dtype=np.float32)
          if out is None:
            out = np.zeros(img.shape[:3] + (result.shape[3],), np.float32)
          out[sl[0], sl[1], sl[2], :] += result
          weight[sl] += 1.0
    out /= np.maximum(weight, 1e-6)
    dest.upload(bounds, out.astype(dest.dtype))


# ``tasks.inference.InferenceTask`` owns the ``InferenceTask`` wire name;
# this alias keeps the registered-callable flavour importable under its
# old name (it registers on the wire as LegacyInferenceTask).
InferenceTask = LegacyInferenceTask
