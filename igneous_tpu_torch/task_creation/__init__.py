"""Task factories of the port."""

from .ccl import (
  ccl_auto,
  clean_ccl_files,
  create_ccl_equivalence_tasks,
  create_ccl_face_tasks,
  create_ccl_relabel_tasks,
  create_relabeling,
)
from .image import (
  create_downsampling_tasks,
  create_transfer_tasks,
  create_voxel_counting_tasks,
)
from .inference import create_inference_tasks
from .mesh import create_mesh_manifest_tasks, create_meshing_tasks
from .skeleton import create_skeletonizing_tasks, create_unsharded_skeleton_merge_tasks
from ..tasks.stats import accumulate_voxel_counts, load_voxel_counts
