"""Task factories of the port."""

from .audit import (
  create_integrity_audit_tasks,
  downsample_provenance,
  downsample_repair_tasks,
  load_findings,
)
from .ccl import (
  ccl_auto,
  clean_ccl_files,
  create_ccl_equivalence_tasks,
  create_ccl_face_tasks,
  create_ccl_relabel_tasks,
  create_relabeling,
)
from .image import (
  compute_rois,
  create_blackout_tasks,
  create_clahe_tasks,
  create_contrast_normalization_tasks,
  create_deletion_tasks,
  create_downsampling_tasks,
  create_fixup_downsample_tasks,
  create_image_shard_downsample_tasks,
  create_image_shard_transfer_tasks,
  create_luminance_levels_tasks,
  create_quantize_tasks,
  create_quantized_affinity_info,
  create_reordering_tasks,
  create_spatial_index_tasks,
  create_touch_tasks,
  create_transfer_tasks,
  create_voxel_counting_tasks,
)
from .inference import create_inference_tasks
from .mesh import (
  configure_multires_info,
  create_graphene_meshing_tasks,
  create_mesh_deletion_tasks,
  create_mesh_manifest_tasks,
  create_mesh_transfer_tasks,
  create_meshing_tasks,
  create_sharded_multires_mesh_from_unsharded_tasks,
  create_sharded_multires_mesh_tasks,
  create_unsharded_multires_mesh_tasks,
)
from .skeleton import (
  create_sharded_from_unsharded_skeleton_merge_tasks,
  create_sharded_skeleton_merge_tasks,
  create_skeleton_deletion_tasks,
  create_skeleton_transfer_tasks,
  create_skeletonizing_tasks,
  create_unsharded_skeleton_merge_tasks,
)
from ..tasks.stats import accumulate_voxel_counts, load_voxel_counts
