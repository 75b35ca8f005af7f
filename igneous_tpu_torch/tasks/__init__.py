"""The port's tasks; importing this package registers them."""

from ..queues.registry import FunctionTask, PrintTask, RegisteredTask

from .audit import IntegrityAuditTask
from .contrast import CLAHETask, ContrastNormalizationTask, LuminanceLevelsTask
from .ccl import (
  CCLEquivalancesTask,
  CCLFacesTask,
  RelabelCCLTask,
  create_relabeling,
)
from .image import (
  BlackoutTask,
  DeleteTask,
  DownsampleTask,
  QuantizeTask,
  TouchTask,
  TransferTask,
  downsample_and_upload,
)
from .image_sharded import ImageShardDownsampleTask, ImageShardTransferTask
from .inference import InferenceTask
from .mesh import (
  DeleteMeshFilesTask,
  GrapheneMeshTask,
  MeshManifestFilesystemTask,
  MeshManifestPrefixTask,
  MeshTask,
  TransferMeshFilesTask,
)
from .mesh_multires import (
  MultiResShardedFromUnshardedMeshMergeTask,
  MultiResShardedMeshMergeTask,
  MultiResUnshardedMeshMergeTask,
)
from .obsolete import (
  HyperSquareConsensusTask,
  LegacyInferenceTask,
  MaskAffinitymapTask,
  WatershedRemapTask,
  register_inference_model,
)
from .skeleton import (
  DeleteSkeletonFilesTask,
  ShardedFromUnshardedSkeletonMergeTask,
  ShardedSkeletonMergeTask,
  SkeletonTask,
  TransferSkeletonFilesTask,
  UnshardedSkeletonMergeTask,
)
from .stats import CountVoxelsTask, ReorderTask, SpatialIndexTask


class TouchFileTask(RegisteredTask):
  """Creates an empty file; used for queue smoke tests and liveness probes."""

  def __init__(self, path: str):
    self.path = path

  def execute(self):
    import os

    os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
    with open(self.path, "a"):
      pass


class FailTask(RegisteredTask):
  """Always raises; exercises lease recycling and dead letters."""

  def __init__(self, message: str = "intentional failure"):
    self.message = message

  def execute(self):
    raise RuntimeError(self.message)


class SleepTask(RegisteredTask):
  """Sleeps for a fixed duration: a task whose true cost is known."""

  def __init__(self, seconds: float = 0.05):
    self.seconds = seconds

  def execute(self):
    import time

    time.sleep(float(self.seconds))
