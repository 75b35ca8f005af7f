"""Batched and paged execution on the port's device: K same-shape
cutouts per launch (``executor``), ragged cutouts in fixed pages
(``paged``), and the runners that walk a layer's grid with them
(``batch_runner``)."""

from .batch_runner import batched_ccl_faces, batched_downsample, batched_skeleton_forge
from .executor import BatchKernelExecutor, ChunkExecutor, cached_chunk_executor
