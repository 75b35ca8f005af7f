"""Device policy: where the port's tensors live.

The device is resolved once, on first use: ``set_device()`` when the caller
named one, else ``IGNEOUS_TORCH_DEVICE``, else ``cuda``. Without CUDA, a
request that did not name the CPU raises instead of quietly running there.
Task payloads carry no device field, so payloads written by the JAX package
run unchanged.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

ENV = "IGNEOUS_TORCH_DEVICE"

_DEVICE: Optional[torch.device] = None


def _resolve(name: str) -> torch.device:
  dev = torch.device(name)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
      "igneous_tpu_torch runs on CUDA by default and no CUDA device is "
      f"available; ask for the CPU explicitly with set_device('cpu') or "
      f"{ENV}=cpu"
    )
  if dev.type not in ("cuda", "cpu"):
    raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
  return dev


def set_device(name) -> torch.device:
  """Pin the port to ``name`` ('cuda', 'cuda:N' or 'cpu') for this process."""
  global _DEVICE
  _DEVICE = _resolve(str(name))
  return _DEVICE


def reset_device() -> None:
  """Forget the resolved device; the next ``get_device()`` resolves anew."""
  global _DEVICE
  _DEVICE = None


def get_device() -> torch.device:
  global _DEVICE
  if _DEVICE is None:
    _DEVICE = _resolve(os.environ.get(ENV, "").strip() or "cuda")
  return _DEVICE
