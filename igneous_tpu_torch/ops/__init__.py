"""The port's device operations: the downsample pyramid (``pooling``,
kernels in ``cuda_pooling``), block connected components (``ccl``,
kernel in ``cuda_ccl``) and isosurface extraction (``mesh``), with host
label remapping (``remap``)."""

from .ccl import connected_components, dust
