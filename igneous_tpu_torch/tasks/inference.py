"""InferenceTask: halo'd download -> the model on the device -> overlap
blend -> optional argmax/quantize -> Precomputed output.

The port's own copy of ``igneous_tpu/tasks/inference.py``. Each grid
task downloads its core cutout EXPANDED by a halo (reads past the volume
come back background-filled, ``Volume(bounded=False)``), runs the patch
engine (``infer.engine``) over it, crops the halo off and uploads only
the core, so adjacent tasks never write overlapping voxels and the write
set stays chunk-aligned for the staged pipeline's overlap rules.

Byte determinism rides the engine's canonical accumulation order and the
pipeline's invariant that compute stages run in task order on the
caller's thread in both pipelined and serial modes.

Stage timers (``telemetry``): download, the engine's tile, h2d, infer,
d2h and blend, postprocess, upload.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import telemetry
from ..lib import Bbox, Vec
from ..pipeline import SerialSink, StagePlan
from ..queues.registry import RegisteredTask
from ..volume import Volume
from .image import _NOOP_PLAN  # empty cutouts stage as no-ops

POSTPROCESS_MODES = ("none", "quantize", "argmax")


class InferenceTask(RegisteredTask):
  """Patch-wise conv-net inference over one grid cutout.

  ``model_path`` names a model saved by ``infer.registry.save_model``
  (model.json + params.npz); patch size and overlap come from the model
  spec, so the wire payload stays small and every worker tiles
  identically. ``halo`` voxels of extra context are downloaded on every
  face and cropped before upload.

  ``postprocess``: ``none`` (float32 channels), ``quantize`` (clip to
  [0,1], scale to uint8), ``argmax`` (uint8 channel argmax, a
  segmentation-style output).
  """

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    model_path: str,
    mip: int,
    shape: Sequence[int],
    offset: Sequence[int],
    halo: Sequence[int] = (0, 0, 0),
    fill_missing: bool = False,
    batch_size: int = 4,
    postprocess: str = "none",
    compress="gzip",
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.model_path = model_path
    self.mip = int(mip)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.halo = Vec(*halo)
    self.fill_missing = fill_missing
    self.batch_size = int(batch_size)
    self.postprocess = postprocess
    self.compress = compress
    if postprocess not in POSTPROCESS_MODES:
      raise ValueError(
        f"postprocess must be one of {POSTPROCESS_MODES}: {postprocess!r}"
      )

  def _volumes_and_bounds(self):
    # bounded=False: the halo pokes outside the volume at its edges and
    # reads background there (context decays to background; the core is
    # unaffected)
    src = Volume(
      self.src_path, mip=self.mip, bounded=False,
      fill_missing=self.fill_missing,
    )
    dest = Volume(self.dest_path, mip=self.mip)
    core = Bbox(self.offset, self.offset + self.shape)
    core = Bbox.intersection(core, src.bounds)
    core = Bbox.intersection(core, dest.bounds)
    return src, dest, core

  def execute(self):
    plan = self.stage_plan()
    plan.upload(plan.compute(plan.download()), SerialSink())

  def stage_plan(self):
    src, dest, core = self._volumes_and_bounds()
    if core.empty():
      return _NOOP_PLAN
    halo = Vec(*[int(v) for v in self.halo])
    halo_bounds = Bbox(core.minpt - halo, core.maxpt + halo)
    core_size = [int(v) for v in core.size3()]

    def download():
      with telemetry.stage("download"):
        return src.download(halo_bounds)

    def compute(image):
      from ..infer import engine as infer_engine
      from ..infer import registry as infer_registry

      model = infer_registry.load_model(self.model_path)
      out, _stats = infer_engine.infer_cutout(
        model, image, batch_size=self.batch_size,
      )
      with telemetry.stage("postprocess"):
        hx, hy, hz = (int(v) for v in halo)
        out = out[hx:hx + core_size[0], hy:hy + core_size[1],
                  hz:hz + core_size[2]]
        return self._postprocess(out, dest)

    def upload(out, sink):
      with telemetry.stage("upload"):
        dest.upload(core, out, compress=self.compress, sink=sink)

    halo_size = [int(v) for v in halo_bounds.size3()]
    nbytes = int(np.prod(halo_size)) * 4 * src.num_channels
    nbytes += int(np.prod(core_size)) * dest.dtype.itemsize * dest.num_channels
    return StagePlan(
      download, compute, upload,
      reads={(self.src_path, self.mip)},
      writes={(self.dest_path, self.mip)},
      nbytes_hint=nbytes,
      aligned_writes=self._writes_chunk_aligned(dest, core),
    )

  def _postprocess(self, out: np.ndarray, dest) -> np.ndarray:
    if self.postprocess == "quantize":
      out = (np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)
    elif self.postprocess == "argmax":
      out = np.argmax(out, axis=3).astype(np.uint8)[..., np.newaxis]
    return out.astype(dest.dtype, copy=False)

  def _writes_chunk_aligned(self, dest, core: Bbox) -> bool:
    """As TransferTask's proof: the single core write is aligned or
    clipped at the dataset bounds, so Volume.upload never
    read-modify-writes and proven-aligned plans may overlap in the staged
    pipeline."""
    if core.empty():
      return True
    expanded = core.expand_to_chunk_size(
      dest.meta.chunk_size(self.mip), dest.meta.voxel_offset(self.mip)
    )
    return Bbox.intersection(expanded, dest.meta.bounds(self.mip)) == core
