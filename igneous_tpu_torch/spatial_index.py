"""Spatial index: label → bounding box, stored per task grid cell.

The port's own copy of ``igneous_tpu/spatial_index.py`` without the sqlite
export. File format: one gzip JSON per grid cell at
``<prefix>/<bbox>.spatial`` mapping label → [minpt, maxpt] (physical
units), written by mesh forge tasks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from .lib import Bbox
from .storage import CloudFiles


class SpatialIndex:
  def __init__(self, cf: CloudFiles, prefix: str):
    self.cf = cf
    self.prefix = prefix.rstrip("/")

  def _key(self, bbox: Bbox) -> str:
    return f"{self.prefix}/{bbox.to_filename()}.spatial"

  def put(self, bbox: Bbox, label_bounds: Dict[int, Bbox]):
    doc = {
      str(label): [list(map(float, b.minpt)), list(map(float, b.maxpt))]
      for label, b in label_bounds.items()
    }
    self.cf.put_json(self._key(bbox), doc, compress="gzip")

  def index_files(self) -> List[str]:
    return [
      k for k in self.cf.list(self.prefix + "/") if k.endswith(".spatial")
    ]

  def query(self, bbox: Optional[Bbox] = None) -> Set[int]:
    """Labels whose stored bounds intersect ``bbox`` (all labels if None)."""
    out: Set[int] = set()
    for key in self.index_files():
      if bbox is not None:
        cell = Bbox.from_filename(key)
        if not Bbox.intersects(cell, bbox):
          continue
      doc = self.cf.get_json(key)
      if not doc:
        continue
      for label, (mn, mx) in doc.items():
        if bbox is None or Bbox.intersects(bbox, Bbox(mn, mx)):
          out.add(int(label))
    return out
