"""Neuroglancer Precomputed ``info`` metadata model.

The port's own copy of ``igneous_tpu/meta.py``: the same ``info`` and
``provenance`` files, so a layer written by either package reads in the
other. Trimmed to what the ported paths use.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Optional, Sequence

import numpy as np

from .lib import Bbox, Vec, ceil_div, jsonify
from .storage import CloudFiles

LAYER_TYPES = ("image", "segmentation")


def advertised_encoding(encoding: str) -> str:
  """Precomputed-info name for an encoding. The compresso codec writes
  its own container (magic ``cpsx``, ``compresso.py``), not the published
  compresso v3 bitstream, so info files advertise it as
  ``compresso-cpsx``: external readers fail loudly on the unknown
  encoding instead of mis-decoding it. The read path (``codecs.py``)
  accepts both names."""
  return "compresso-cpsx" if encoding == "compresso" else encoding


class PrecomputedMetadata:
  """Parsed ``info`` file + derived per-mip geometry."""

  def __init__(self, cloudpath: str, info: Optional[dict] = None):
    self.cloudpath = cloudpath.rstrip("/")
    self.cf = CloudFiles(self.cloudpath)
    self.info = info
    self.provenance: Optional[dict] = None
    if self.info is None:
      self.refresh_info()

  # -- info file lifecycle --------------------------------------------------

  @classmethod
  def create_info(
    cls,
    num_channels: int,
    layer_type: str,
    data_type: str,
    encoding: str,
    resolution: Sequence[int],
    voxel_offset: Sequence[int],
    volume_size: Sequence[int],
    chunk_size: Sequence[int] = (64, 64, 64),
    compressed_segmentation_block_size: Sequence[int] = (8, 8, 8),
  ) -> dict:
    if layer_type not in LAYER_TYPES:
      raise ValueError(f"layer_type must be one of {LAYER_TYPES}: {layer_type}")
    scale = {
      "key": "_".join(str(int(r)) for r in resolution),
      "size": [int(v) for v in volume_size],
      "resolution": [int(r) for r in resolution],
      "voxel_offset": [int(v) for v in voxel_offset],
      "chunk_sizes": [[int(c) for c in chunk_size]],
      "encoding": advertised_encoding(encoding),
    }
    if encoding == "compressed_segmentation":
      scale["compressed_segmentation_block_size"] = [
        int(v) for v in compressed_segmentation_block_size
      ]
    return {
      "type": layer_type,
      "data_type": data_type,
      "num_channels": int(num_channels),
      "scales": [scale],
    }

  def refresh_info(self) -> dict:
    info = self.cf.get_json("info")
    if info is None:
      raise FileNotFoundError(f"No info file at {self.cloudpath}/info")
    self.info = info
    return info

  def commit_info(self):
    self.cf.put_json("info", self.info)

  def refresh_provenance(self) -> dict:
    prov = self.cf.get_json("provenance")
    if prov is None:
      prov = {"description": "", "owners": [], "processing": [], "sources": []}
    self.provenance = prov
    return prov

  def commit_provenance(self):
    if self.provenance is not None:
      self.cf.put_json("provenance", self.provenance)

  def add_provenance_entry(self, method: dict, operator: str = ""):
    if self.provenance is None:
      self.refresh_provenance()
    self.provenance["processing"].append({
      "method": jsonify(method),
      "by": operator,
      "date": datetime.now(timezone.utc).strftime("%Y-%m-%d %H:%M %Z"),
    })

  # -- scale accessors ------------------------------------------------------

  @property
  def num_channels(self) -> int:
    return int(self.info["num_channels"])

  @property
  def layer_type(self) -> str:
    return self.info["type"]

  @property
  def data_type(self) -> str:
    return self.info["data_type"]

  @property
  def dtype(self) -> np.dtype:
    return np.dtype(self.data_type)

  @property
  def num_mips(self) -> int:
    return len(self.info["scales"])

  def scale(self, mip: int) -> dict:
    return self.info["scales"][mip]

  def key(self, mip: int) -> str:
    return self.scale(mip)["key"]

  def mip_from_key(self, key: str) -> int:
    for i, s in enumerate(self.info["scales"]):
      if s["key"] == key:
        return i
    raise KeyError(key)

  def mip_from_resolution(self, resolution) -> int:
    return self.mip_from_key("_".join(str(int(r)) for r in resolution))

  def resolution(self, mip: int) -> Vec:
    return Vec(*self.scale(mip)["resolution"])

  def chunk_size(self, mip: int) -> Vec:
    return Vec(*self.scale(mip)["chunk_sizes"][0])

  def voxel_offset(self, mip: int) -> Vec:
    return Vec(*self.scale(mip).get("voxel_offset", [0, 0, 0]))

  def volume_size(self, mip: int) -> Vec:
    return Vec(*self.scale(mip)["size"])

  def bounds(self, mip: int) -> Bbox:
    offset = self.voxel_offset(mip)
    return Bbox(offset, offset + self.volume_size(mip))

  def encoding(self, mip: int) -> str:
    return self.scale(mip)["encoding"]

  def set_encoding(self, mip: int, encoding: Optional[str],
                   encoding_level: Optional[int] = None,
                   encoding_effort: Optional[int] = None):
    """Set a scale's encoding and its quality knob: ``encoding_level`` is
    the jpeg quality or the png compression level, recorded in the scale
    so that uploads pick it up. ``encoding_effort`` (jpeg xl) is accepted
    and has no effect."""
    scale = self.scale(mip)
    if encoding is not None:
      scale["encoding"] = advertised_encoding(encoding)
      if encoding == "compressed_segmentation":
        scale.setdefault("compressed_segmentation_block_size", [8, 8, 8])
    if encoding_level is None:
      return
    encoding = encoding or scale["encoding"]
    if encoding == "jpeg":
      scale["jpeg_quality"] = int(encoding_level)
    elif encoding == "png":
      scale["png_level"] = int(encoding_level)
    elif encoding in ("jxl", "fpzip", "zfpc"):
      raise NotImplementedError(
        f"encoding {encoding!r} is not shipped (no offline oracle to "
        f"validate its bitstream against; see ROADMAP.md)"
      )

  def sharding(self, mip: int) -> Optional[dict]:
    return self.scale(mip).get("sharding")

  def is_sharded(self, mip: int) -> bool:
    return self.sharding(mip) is not None

  def cseg_block_size(self, mip: int) -> Vec:
    return Vec(*self.scale(mip).get("compressed_segmentation_block_size", [8, 8, 8]))

  def downsample_ratio(self, mip: int) -> Vec:
    return Vec(*(self.resolution(mip) // self.resolution(0)))

  # -- scale creation -------------------------------------------------------

  def add_scale(
    self,
    factor: Sequence[int],
    chunk_size: Optional[Sequence[int]] = None,
    encoding: Optional[str] = None,
    sharding: Optional[dict] = None,
  ) -> dict:
    """Add (or fetch) the scale at ``factor`` relative to mip 0:
    size = ceil(size0 / factor), voxel_offset = offset0 // factor.
    ``sharding`` (a sharding spec dict) is set on the scale, also on one
    that exists already."""
    factor = np.asarray(factor, dtype=np.int64)
    base = self.scale(0)
    resolution = np.asarray(base["resolution"], dtype=np.int64) * factor
    key = "_".join(str(int(r)) for r in resolution)
    for s in self.info["scales"]:
      if s["key"] == key:
        if sharding is not None:
          s["sharding"] = sharding
        return s

    if chunk_size is None:
      chunk_size = base["chunk_sizes"][0]
    new_scale = {
      "key": key,
      "size": [int(v) for v in ceil_div(np.asarray(base["size"]), factor)],
      "resolution": [int(r) for r in resolution],
      "voxel_offset": [
        int(v)
        for v in np.asarray(base.get("voxel_offset", [0, 0, 0]), dtype=np.int64)
        // factor
      ],
      "chunk_sizes": [[int(c) for c in chunk_size]],
      "encoding": advertised_encoding(encoding) if encoding
                  else base["encoding"],
    }
    if new_scale["encoding"] == "compressed_segmentation":
      new_scale["compressed_segmentation_block_size"] = list(
        base.get("compressed_segmentation_block_size", [8, 8, 8])
      )
    if sharding is not None:
      new_scale["sharding"] = sharding
    # keep scales sorted by total resolution volume (finest first)
    self.info["scales"].append(new_scale)
    self.info["scales"].sort(
      key=lambda s: int(np.prod(np.asarray(s["resolution"], dtype=np.int64)))
    )
    return new_scale

  # -- chunk naming and mip geometry ----------------------------------------

  def chunk_name(self, mip: int, bbox: Bbox) -> str:
    return f"{self.key(mip)}/{bbox.to_filename()}"

  def bbox_to_mip(self, bbox: Bbox, mip: int, to_mip: int) -> Bbox:
    if mip == to_mip:
      return bbox.clone()
    res_from = self.resolution(mip)
    res_to = self.resolution(to_mip)
    if np.all(res_to >= res_from):
      return bbox / (res_to // res_from)
    return bbox * (res_from // res_to)

  def __repr__(self):
    return f"PrecomputedMetadata({self.cloudpath!r}, mips={self.num_mips})"
