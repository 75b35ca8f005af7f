"""The port's tasks; importing this package registers them."""

from .ccl import (
  CCLEquivalancesTask,
  CCLFacesTask,
  RelabelCCLTask,
  create_relabeling,
)
from .image import DownsampleTask, TransferTask, downsample_and_upload
from .mesh import MeshManifestFilesystemTask, MeshManifestPrefixTask, MeshTask
from .skeleton import SkeletonTask, UnshardedSkeletonMergeTask
