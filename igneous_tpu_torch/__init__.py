"""igneous_tpu_torch: the PyTorch/CUDA port of igneous_tpu.

It runs Igneous's downsample path (create_downsampling_tasks →
LocalTaskQueue → DownsampleTask → the 2x2x1 pooling pyramid) on an NVIDIA
GPU, with hand-written CUDA kernels for the pooling pyramid. It imports
torch, numpy and the standard library, never jax or igneous_tpu, and
reads and writes the same Precomputed layers and task payloads.

The device defaults to CUDA; ``set_device("cpu")`` or
``IGNEOUS_TORCH_DEVICE=cpu`` asks for the CPU, where the kernels' plain
PyTorch versions run.
"""

from .device import get_device, set_device
from .lib import Bbox, Vec
from .storage import CloudFiles
from .volume import Volume

__version__ = "0.1.0"
