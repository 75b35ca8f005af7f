"""Spatial index: label → bounding box, stored per task grid cell.

The port's own copy of ``igneous_tpu/spatial_index.py``. File format: one
gzip JSON per grid cell at ``<prefix>/<bbox>.spatial`` mapping label →
[minpt, maxpt] (physical units), written by the mesh and skeleton forge
tasks and read by the sharded merges and their factories. ``to_sqlite``
materializes it into a sqlite table the factories can query instead
(labels as TEXT: uint64 ids at or above 2^63 overflow sqlite's INTEGER).
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional, Set

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

  def to_sqlite(
    self, db_path: str, progress: bool = False, allow_missing: bool = False,
  ) -> int:
    """Materialize the index into a sqlite db for fast repeated queries;
    returns the number of (label, cell) rows. ``allow_missing`` skips
    unreadable index cells instead of failing. ``progress`` prints a line
    to stderr every 1000 cells and at the end."""
    import sqlite3

    conn = sqlite3.connect(db_path)
    cur = conn.cursor()
    cur.execute("DROP TABLE IF EXISTS spatial_index")
    # labels are TEXT: uint64 segment ids >= 2^63 overflow sqlite INTEGER
    cur.execute(
      "CREATE TABLE spatial_index ("
      " label TEXT, cell TEXT,"
      " minx REAL, miny REAL, minz REAL,"
      " maxx REAL, maxy REAL, maxz REAL)"
    )
    n = 0
    keys = self.index_files()
    for i, key in enumerate(keys, start=1):
      doc = self.cf.get_json(key)
      if progress and (i % 1000 == 0 or i == len(keys)):
        print(f"spatial index cells: {i}/{len(keys)}", file=sys.stderr)
      if not doc:
        if doc is None and not allow_missing:
          conn.close()
          raise FileNotFoundError(
            f"unreadable spatial index cell {key!r} "
            "(pass allow_missing=True to skip)"
          )
        continue
      rows = [
        (str(int(label)), key, *map(float, mn), *map(float, mx))
        for label, (mn, mx) in doc.items()
      ]
      cur.executemany(
        "INSERT INTO spatial_index VALUES (?,?,?,?,?,?,?,?)", rows
      )
      n += len(rows)
    cur.execute("CREATE INDEX idx_label ON spatial_index(label)")
    cur.execute(
      "CREATE INDEX idx_bbox ON spatial_index(minx, miny, minz)"
    )
    conn.commit()
    conn.close()
    return n

  @staticmethod
  def query_sqlite(db_path: str, bbox: Optional[Bbox] = None) -> Set[int]:
    """Labels of a ``to_sqlite`` db whose bounds intersect ``bbox`` (all
    labels if None)."""
    import sqlite3

    conn = sqlite3.connect(db_path)
    cur = conn.cursor()
    if bbox is None:
      cur.execute("SELECT DISTINCT label FROM spatial_index")
    else:
      mn = [float(v) for v in bbox.minpt]
      mx = [float(v) for v in bbox.maxpt]
      cur.execute(
        "SELECT DISTINCT label FROM spatial_index WHERE "
        "minx < ? AND maxx > ? AND miny < ? AND maxy > ? "
        "AND minz < ? AND maxz > ?",
        (mx[0], mn[0], mx[1], mn[1], mx[2], mn[2]),
      )
    out = {int(r[0]) for r in cur.fetchall()}
    conn.close()
    return out

  def file_locations_per_label(
    self, labels: Optional[Iterable[int]] = None
  ) -> Dict[int, List[str]]:
    """label → the .spatial cell files that saw it (→ which .frags files
    hold its fragments)."""
    wanted = None if labels is None else set(int(l) for l in labels)
    out: Dict[int, List[str]] = {}
    for key in self.index_files():
      doc = self.cf.get_json(key)
      if not doc:
        continue
      for label in doc:
        label = int(label)
        if wanted is None or label in wanted:
          out.setdefault(label, []).append(key)
    return out
