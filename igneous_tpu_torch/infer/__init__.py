"""Conv-net inference: model registry and loader, patch engine, blend
machinery (the port's copy of ``igneous_tpu/infer``). The task family
lives in ``tasks/inference.py`` and ``task_creation/inference.py``."""

from .registry import (
  ARCHITECTURES,
  InferenceModel,
  ModelSpec,
  clear_model_cache,
  init_params,
  load_model,
  load_params,
  register_architecture,
  save_model,
)
from .engine import (
  apply_whole,
  blend_weight,
  infer_cutout,
  patch_starts,
  weight_sum,
)
