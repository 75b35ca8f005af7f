"""Task factories of the port."""

from .ccl import (
  ccl_auto,
  clean_ccl_files,
  create_ccl_equivalence_tasks,
  create_ccl_face_tasks,
  create_ccl_relabel_tasks,
  create_relabeling,
)
from .image import create_downsampling_tasks
from .mesh import create_mesh_manifest_tasks, create_meshing_tasks
from .skeleton import create_skeletonizing_tasks, create_unsharded_skeleton_merge_tasks
