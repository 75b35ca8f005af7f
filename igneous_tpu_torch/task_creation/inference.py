"""create_inference_tasks: the grid factory of the InferenceTask family.

The port's own copy of ``igneous_tpu/task_creation/inference.py``:
destination info creation, halo-aware bounds, provenance, and the
chunk-aligned task grid, with the same payloads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..lib import Bbox, Vec
from ..meta import PrecomputedMetadata
from ..tasks.inference import POSTPROCESS_MODES, InferenceTask
from ..volume import Volume
from .common import GridTaskIterator, get_bounds
from .image import _provenance


def _default_task_shape(chunk: Sequence[int]) -> Vec:
  """Smallest chunk multiple at or above (256, 256, 64) per axis: a few
  dozen patches per task, large enough to amortize the halo re-download
  along task faces without blowing the pipeline's byte budget."""
  target = (256, 256, 64)
  return Vec(*[
    int(c) * max(1, -(-t // int(c))) for c, t in zip(chunk, target)
  ])


def create_inference_tasks(
  src_path: str,
  dest_path: str,
  model_path: str,
  mip: int = 0,
  shape: Optional[Sequence[int]] = None,
  halo: Optional[Sequence[int]] = None,
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
  fill_missing: bool = False,
  batch_size: int = 4,
  postprocess: str = "none",
  compress="gzip",
  chunk_size: Optional[Sequence[int]] = None,
):
  """Grid of InferenceTasks over ``src_path`` at ``mip``, writing model
  output to ``dest_path`` (created here if absent, mirroring the source
  scale structure through ``mip`` so mip indices line up; an existing
  destination's info wins).

  ``halo`` defaults to the model's blend overlap. Task shapes snap UP to
  destination chunk multiples and the grid walks the chunk-expanded
  bounds, so every core write is chunk-aligned or clipped at the dataset
  bounds.

  Output dtype/channels follow ``postprocess``: ``none`` -> float32 with
  the model's out_channels; ``quantize`` -> uint8 out_channels;
  ``argmax`` -> uint8 single channel (segmentation-style).
  """
  from ..infer.registry import load_model

  if postprocess not in POSTPROCESS_MODES:
    raise ValueError(
      f"postprocess must be one of {POSTPROCESS_MODES}: {postprocess!r}"
    )
  model = load_model(model_path)
  spec = model.spec
  src = Volume(src_path, mip=mip)
  if src.num_channels != spec.in_channels:
    raise ValueError(
      f"model {model_path} wants {spec.in_channels} channel(s); "
      f"{src_path} has {src.num_channels}"
    )
  if halo is None:
    halo = spec.overlap
  halo = Vec(*[int(v) for v in halo])

  if postprocess == "none":
    dtype, out_channels = "float32", spec.out_channels
  elif postprocess == "quantize":
    dtype, out_channels = "uint8", spec.out_channels
  else:  # argmax
    dtype, out_channels = "uint8", 1

  src_scale = src.meta.scale(mip)
  base_scale = src.meta.scale(0)
  dest_chunk = (
    list(chunk_size) if chunk_size else list(src_scale["chunk_sizes"][0])
  )
  dest_info = PrecomputedMetadata.create_info(
    num_channels=out_channels,
    layer_type="segmentation" if postprocess == "argmax" else "image",
    data_type=dtype,
    encoding="raw",
    resolution=base_scale["resolution"],
    voxel_offset=base_scale.get("voxel_offset", [0, 0, 0]),
    volume_size=base_scale["size"],
    chunk_size=dest_chunk,
  )
  try:
    dest = Volume(dest_path)  # an existing destination's info wins
  except FileNotFoundError:
    dest = Volume.create(dest_path, dest_info)
    for m in range(1, mip + 1):
      dest.meta.add_scale(
        np.asarray(src.meta.downsample_ratio(m)),
        chunk_size=dest_chunk,
        encoding="raw",
      )
    dest.commit_info()

  dchunk = dest.meta.chunk_size(mip)
  if shape is None:
    shape = _default_task_shape(dchunk)
  else:
    # snap UP to a chunk multiple: unaligned task shapes would shear the
    # grid off the chunk lattice and forfeit the aligned-writes proof
    shape = Vec(*[
      int(c) * max(1, -(-int(s) // int(c))) for s, c in zip(shape, dchunk)
    ])

  task_bounds = get_bounds(
    dest, bounds, mip, bounds_mip, chunk_size=dchunk
  )

  def make_task(shape_: Vec, offset: Vec):
    return InferenceTask(
      src_path=src_path,
      dest_path=dest_path,
      model_path=model_path,
      mip=mip,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      halo=halo.tolist(),
      fill_missing=fill_missing,
      batch_size=batch_size,
      postprocess=postprocess,
      compress=compress,
    )

  def finish():
    _provenance(dest, {
      "task": "InferenceTask",
      "src": src_path,
      "dest": dest_path,
      "model": model_path,
      "architecture": spec.architecture,
      "mip": mip,
      "shape": shape.tolist(),
      "halo": halo.tolist(),
      "patch_shape": list(spec.patch_shape),
      "overlap": list(spec.overlap),
      "postprocess": postprocess,
      "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)
