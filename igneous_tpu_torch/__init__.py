"""igneous_tpu_torch: the PyTorch/CUDA port of igneous_tpu.

It runs these of Igneous's paths on an NVIDIA GPU:
  - downsampling: create_downsampling_tasks → LocalTaskQueue →
    DownsampleTask → the 2x2x1 pooling pyramid (``csrc/pooling.cu``);
  - transfers: create_transfer_tasks → LocalTaskQueue → TransferTask,
    which rechunks, re-encodes and translates a layer and builds its
    pyramid with the same kernels;
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
    UnshardedSkeletonMergeTask;
  - morphology and the voxel-count census: ``ops.morphology`` (dilate and
    erode on the device, the hole fill on the host) behind the forges'
    ``fill_holes``, and create_voxel_counting_tasks → CountVoxelsTask →
    accumulate_voxel_counts behind their ``dust_global``;
  - conv-net inference: create_inference_tasks → LocalTaskQueue →
    InferenceTask → the model (``infer.registry``, cuDNN convolutions with
    TF32 off) over overlapping patches, blended on the host
    (``infer.engine``).
Every path reads and writes the raw, compressed_segmentation
(``csrc/cseg.cpp`` on the host), compresso, jpeg and png chunk encodings.
It imports torch, numpy, scipy, PIL (for jpeg and png only) and the
standard library, never jax or igneous_tpu, and reads and writes the same
Precomputed layers, scratch files, meshes and task payloads.

The device defaults to CUDA; ``set_device("cpu")`` or
``IGNEOUS_TORCH_DEVICE=cpu`` asks for the CPU, where the kernels' plain
PyTorch versions run.
"""

from .device import get_device, set_device
from .lib import Bbox, Vec
from .storage import CloudFiles
from .volume import Volume

__version__ = "0.1.0"
