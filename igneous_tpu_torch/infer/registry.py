"""Model registry and loader: named conv-net architectures as torch
modules, with parameters stored as Precomputed-style objects.

The port's own copy of ``igneous_tpu/infer/registry.py``. A model lives
at a cloudpath (any ported storage backend) as two objects, the same
files the JAX package writes and reads:

  model.json   ModelSpec: architecture name, channel widths, patch
               geometry, overlap
  params.npz   flat {param_name: float32 array} dict (np.savez)

The JAX package's architectures are pure ``apply(params, x)`` functions;
here each is an ``nn.Module`` built from the spec, and ``load_params``
maps the flat ``{"layer{i}/w", "layer{i}/b"}`` dict onto its parameters.
``InferenceModel.executor()`` is a ``parallel.executor.BatchKernelExecutor``
whose kernel runs the module with the parameters staged on the device
once (``put_consts``) and passed in by ``torch.func.functional_call``.

Every convolution runs under ``torch.backends.cudnn.flags(enabled=True,
benchmark=False, deterministic=True, allow_tf32=False)``: cuDNN would
otherwise round float32 inputs to TF32 on the card, and pick its
algorithm by timing. A dispatch's patches are convolved one at a time,
each as a batch of one, so every convolution of a model has one shape
and a patch's output bits do not depend on the dispatch it rode in
(cuDNN chooses its algorithm by shape).
"""

from __future__ import annotations

import io
import json
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..storage import CloudFiles

MODEL_SPEC_KEY = "model.json"
MODEL_PARAMS_KEY = "params.npz"


@dataclass(frozen=True)
class ModelSpec:
  """Wire description of a registered model (model.json)."""

  architecture: str
  in_channels: int
  out_channels: int
  patch_shape: Tuple[int, int, int]       # (x, y, z) voxels per patch
  overlap: Tuple[int, int, int] = (0, 0, 0)  # (x, y, z) blend overlap
  hidden: Tuple[int, ...] = ()            # conv stack widths (convnet3d)
  metadata: dict = field(default_factory=dict)

  def to_dict(self) -> dict:
    return {
      "architecture": self.architecture,
      "in_channels": int(self.in_channels),
      "out_channels": int(self.out_channels),
      "patch_shape": [int(v) for v in self.patch_shape],
      "overlap": [int(v) for v in self.overlap],
      "hidden": [int(v) for v in self.hidden],
      "metadata": dict(self.metadata),
    }

  @classmethod
  def from_dict(cls, d: dict) -> "ModelSpec":
    return cls(
      architecture=d["architecture"],
      in_channels=int(d["in_channels"]),
      out_channels=int(d["out_channels"]),
      patch_shape=tuple(int(v) for v in d["patch_shape"]),
      overlap=tuple(int(v) for v in d.get("overlap", (0, 0, 0))),
      hidden=tuple(int(v) for v in d.get("hidden", ())),
      metadata=dict(d.get("metadata", {})),
    )


# -- architectures ----------------------------------------------------------

ARCHITECTURES: Dict[str, Callable[[ModelSpec], nn.Module]] = {}


def register_architecture(name: str):
  def deco(builder):
    ARCHITECTURES[name] = builder
    return builder
  return deco


class Identity(nn.Module):
  """Pass-through (float32 cast only). The engine's byte-determinism and
  blend identity contracts are provable against it because the device
  output IS the input: any other byte came from the engine."""

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return x.float()


class ConvNet3d(nn.Module):
  """Plain 3x3x3 conv stack with ReLU between layers (none after the
  last): widths ``in -> hidden... -> out``, padding 1 so the output
  geometry equals the patch's, on (N, c, z, y, x) float32. The JAX
  package's ``conv_general_dilated`` is a cross-correlation, as
  ``nn.Conv3d`` is, so its weights carry over unflipped."""

  def __init__(self, widths):
    super().__init__()
    self.layers = nn.ModuleList(
      nn.Conv3d(c_in, c_out, 3, padding=1)
      for c_in, c_out in zip(widths[:-1], widths[1:])
    )

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = x.float()
    for i, conv in enumerate(self.layers):
      h = conv(h)
      if i < len(self.layers) - 1:
        h = torch.relu(h)
    return h


@register_architecture("identity")
def _identity(spec: ModelSpec) -> nn.Module:
  if spec.out_channels != spec.in_channels:
    raise ValueError("identity requires out_channels == in_channels")
  return Identity()


@register_architecture("convnet3d")
def _convnet3d(spec: ModelSpec) -> nn.Module:
  """Parameters: ``layer{i}/w`` with shape (c_out, c_in, 3, 3, 3) and
  ``layer{i}/b`` with shape (c_out,)."""
  return ConvNet3d((spec.in_channels,) + tuple(spec.hidden) + (spec.out_channels,))


_PARAM = re.compile(r"layer(\d+)/([wb])")


def state_names(params: Dict[str, np.ndarray]) -> Dict[str, str]:
  """{flat name: module parameter name}: ``layer{i}/w`` is
  ``layers.{i}.weight`` and ``layer{i}/b`` is ``layers.{i}.bias``."""
  names = {}
  for key in params:
    m = _PARAM.fullmatch(key)
    if m is None:
      raise KeyError(f"parameter {key!r} is not of the form layer<i>/w or layer<i>/b")
    names[key] = f"layers.{m.group(1)}.{'weight' if m.group(2) == 'w' else 'bias'}"
  return names


def load_params(module: nn.Module, params: Dict[str, np.ndarray]) -> nn.Module:
  """Copy the flat ``{"layer{i}/w", "layer{i}/b"}`` numpy dict into
  ``module``'s parameters; every parameter must be given, with its
  shape."""
  names = state_names(params)
  module.load_state_dict(
    {names[k]: torch.from_numpy(np.asarray(v, dtype=np.float32)) for k, v in params.items()},
    strict=True,
  )
  return module


def init_params(spec: ModelSpec, seed: int = 0) -> Dict[str, np.ndarray]:
  """Deterministic He-style float32 init for the named architecture: the
  JAX package's draws from ``np.random.default_rng(seed)``, so the same
  seed gives the same bytes in both packages."""
  rng = np.random.default_rng(seed)
  if spec.architecture == "identity":
    return {}
  if spec.architecture == "convnet3d":
    widths = (spec.in_channels,) + tuple(spec.hidden) + (spec.out_channels,)
    params = {}
    for i in range(len(widths) - 1):
      c_in, c_out = widths[i], widths[i + 1]
      fan_in = c_in * 27
      params[f"layer{i}/w"] = (
        rng.standard_normal((c_out, c_in, 3, 3, 3)) * np.sqrt(2.0 / fan_in)
      ).astype(np.float32)
      params[f"layer{i}/b"] = np.zeros(c_out, dtype=np.float32)
    return params
  raise KeyError(f"no init rule for architecture {spec.architecture!r}")


# -- persistence ------------------------------------------------------------

def _builder(architecture: str):
  builder = ARCHITECTURES.get(architecture)
  if builder is None:
    raise KeyError(
      f"unknown architecture {architecture!r}; "
      f"registered: {sorted(ARCHITECTURES)}"
    )
  return builder


def save_model(
  cloudpath: str, spec: ModelSpec, params: Dict[str, np.ndarray]
) -> None:
  """Write model.json + params.npz under ``cloudpath``."""
  _builder(spec.architecture)
  cf = CloudFiles(cloudpath)
  cf.put(MODEL_SPEC_KEY, json.dumps(spec.to_dict()).encode("utf8"))
  buf = io.BytesIO()
  np.savez(buf, **{k: np.asarray(v) for k, v in params.items()})
  cf.put(MODEL_PARAMS_KEY, buf.getvalue())
  # a new model at a previously-seen path must not serve stale weights
  with _CACHE_LOCK:
    _MODEL_CACHE.pop(cloudpath.rstrip("/"), None)


def conv_flags():
  """cuDNN on, deterministic, no autotuning, no TF32: every convolution of
  the port runs inside this."""
  return torch.backends.cudnn.flags(
    enabled=True, benchmark=False, deterministic=True, allow_tf32=False
  )


class InferenceModel:
  """A loaded (spec, params, module) triple bound to its cloudpath.

  Executors are cached per device so repeated tasks in one worker share
  the parameters staged there (``device_params``)."""

  def __init__(self, cloudpath: str, spec: ModelSpec,
               params: Dict[str, np.ndarray]):
    self.cloudpath = cloudpath
    self.spec = spec
    self.params = params
    self.module = load_params(_builder(spec.architecture)(spec), params).eval()
    self._names = state_names(params)
    self._lock = threading.Lock()
    self._executors = {}  # guarded-by: self._lock

  @property
  def kernel_name(self) -> str:
    return f"infer.{self.spec.architecture}"

  def apply(self, consts, batch: torch.Tensor) -> torch.Tensor:
    """(K, c_in, z, y, x) on the device -> (K, c_out, z, y, x) float32,
    with ``consts`` the device parameters (by module parameter name); one
    patch per convolution."""
    with torch.inference_mode(), conv_flags():
      return torch.cat([
        torch.func.functional_call(self.module, consts, (batch[k:k + 1],))
        for k in range(batch.shape[0])
      ])

  def executor(self):
    from ..device import get_device
    from ..parallel.executor import BatchKernelExecutor

    key = str(get_device())
    with self._lock:
      if key not in self._executors:
        self._executors[key] = BatchKernelExecutor(self.apply, stage="infer")
      return self._executors[key]

  def device_params(self):
    """Params staged on the device, h2d paid once per model."""
    return self.executor().put_consts(
      self.cloudpath, {self._names[k]: v for k, v in self.params.items()}
    )


_MODEL_CACHE: Dict[str, InferenceModel] = {}
_CACHE_LOCK = threading.Lock()


def load_model(cloudpath: str) -> InferenceModel:
  """Load (and process-wide cache) the model at ``cloudpath``."""
  key = cloudpath.rstrip("/")
  with _CACHE_LOCK:
    cached = _MODEL_CACHE.get(key)
  if cached is not None:
    return cached
  cf = CloudFiles(cloudpath)
  raw = cf.get(MODEL_SPEC_KEY)
  if raw is None:
    raise FileNotFoundError(f"no {MODEL_SPEC_KEY} at {cloudpath}")
  spec = ModelSpec.from_dict(json.loads(raw.decode("utf8")))
  blob = cf.get(MODEL_PARAMS_KEY)
  if blob is None:
    raise FileNotFoundError(f"no {MODEL_PARAMS_KEY} at {cloudpath}")
  with np.load(io.BytesIO(blob)) as npz:
    params = {k: np.asarray(npz[k]) for k in npz.files}
  model = InferenceModel(key, spec, params)
  with _CACHE_LOCK:
    _MODEL_CACHE[key] = model
  return model


def clear_model_cache() -> None:
  with _CACHE_LOCK:
    _MODEL_CACHE.clear()
