"""igneous_tpu_torch: the PyTorch/CUDA port of igneous_tpu.

It runs four of Igneous's paths on an NVIDIA GPU:
  - downsampling: create_downsampling_tasks → LocalTaskQueue →
    DownsampleTask → the 2x2x1 pooling pyramid (``csrc/pooling.cu``);
  - whole-image connected components: ccl_auto → the four passes
    CCLFacesTask, CCLEquivalancesTask, create_relabeling, RelabelCCLTask →
    ops.ccl.connected_components → the block-local tile resolve
    (``csrc/ccl.cu``);
  - meshing: create_meshing_tasks → LocalTaskQueue → MeshTask → marching
    cubes as torch ops on the device (``ops/mesh.py``), then
    create_mesh_manifest_tasks → MeshManifestPrefixTask; the host
    simplifies with ``csrc/simplify.cpp``;
  - skeletons: create_skeletonizing_tasks → LocalTaskQueue → SkeletonTask →
    the multilabel EDT (``csrc/edt.cu``) and the labels' boxes on the
    device, TEASAR tracing on the host (``csrc/fggraph.cpp``,
    ``csrc/dijkstra.cpp``), then create_unsharded_skeleton_merge_tasks →
    UnshardedSkeletonMergeTask.
It imports torch, numpy, scipy and the standard library, never jax or
igneous_tpu, and reads and writes the same Precomputed layers, scratch
files, meshes and task payloads.

The device defaults to CUDA; ``set_device("cpu")`` or
``IGNEOUS_TORCH_DEVICE=cpu`` asks for the CPU, where the kernels' plain
PyTorch versions run.
"""

from .device import get_device, set_device
from .lib import Bbox, Vec
from .storage import CloudFiles
from .volume import Volume

__version__ = "0.1.0"
