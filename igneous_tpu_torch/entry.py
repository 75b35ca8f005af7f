"""The port's flagship device program as one step: ``entry()``.

Counterpart of the repository's ``__graft_entry__.entry``: the 4-level
average pyramid a DownsampleTask runs on a 256x256x64 uint8 cutout,
factors (2, 2, 1) three times then (2, 2, 2). On the port's device the
2x2x1 run is one ``pyramid2x2x1`` launch and the last level the plain
pyramid (``ops.pooling.device_pyramid``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import get_device
from .ops.pooling import device_pyramid

FACTORS = ((2, 2, 1), (2, 2, 1), (2, 2, 1), (2, 2, 2))


def entry():
  """(fn, example_args): the step and its seeded (c, z, y, x) uint8
  cutout; ``fn(x)`` returns the tuple of four mips as tensors on the
  port's device."""

  def step(x):
    x = torch.as_tensor(x, device=get_device())
    return tuple(device_pyramid(x.contiguous(), FACTORS, "average", False))

  x = np.random.default_rng(0).integers(
    0, 255, size=(1, 64, 256, 256)
  ).astype(np.uint8)
  return step, (x,)
