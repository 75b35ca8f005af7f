"""Task registry + JSON wire format, with the port's own registry.

A task crosses process boundaries as ``{"class": ..., "params": {...}}``,
the wire format of ``igneous_tpu/queues/registry.py``. ``RegisteredTask``
subclasses record their constructor's bound arguments at instantiation,
so ``__init__`` signatures ARE the wire schema.

The port keeps its own ``TASK_REGISTRY``, so a process that loads both
packages keeps both sets of classes. ``deserialize`` maps a payload's class
name into this registry and never imports the ``module`` the payload
names: a payload serialized by the JAX package runs here unchanged. The
``trace`` field such payloads carry is observability metadata and is
ignored.
"""

from __future__ import annotations

import functools
import inspect
import json
from typing import Dict, Union

from ..lib import jsonify

TASK_REGISTRY: Dict[str, type] = {}


class RegisteredTask:
  """Base for serializable work units. Subclass and implement execute()."""

  def __init_subclass__(cls, **kw):
    super().__init_subclass__(**kw)
    TASK_REGISTRY[cls.__name__] = cls
    orig_init = cls.__init__

    @functools.wraps(orig_init)
    def wrapped_init(self, *args, **kwargs):
      # only the outermost constructor (the instantiated class) records
      # params; super().__init__ chains must not overwrite them
      if not hasattr(self, "_params"):
        bound = inspect.signature(orig_init).bind(self, *args, **kwargs)
        bound.apply_defaults()
        params = dict(bound.arguments)
        params.pop("self", None)
        self._params = jsonify(params)
      orig_init(self, *args, **kwargs)

    cls.__init__ = wrapped_init

  def execute(self):
    raise NotImplementedError

  def payload(self) -> dict:
    return {
      "class": type(self).__name__,
      "module": type(self).__module__,
      "params": self._params,
    }

  def to_json(self) -> str:
    return json.dumps(self.payload())

  def __repr__(self):
    args = ", ".join(f"{k}={v!r}" for k, v in self._params.items())
    return f"{type(self).__name__}({args})"


def serialize(task) -> str:
  """Task object | payload dict | JSON string → JSON string."""
  if isinstance(task, RegisteredTask):
    return task.to_json()
  if isinstance(task, dict):
    return json.dumps(jsonify(task))
  if isinstance(task, str):
    return task
  raise TypeError(f"Cannot serialize task: {task!r}")


def deserialize(payload: Union[str, bytes, dict]) -> RegisteredTask:
  if isinstance(payload, (str, bytes)):
    payload = json.loads(payload)
  if "class" not in payload:
    raise KeyError(
      "only RegisteredTask payloads ({'class': ..., 'params': ...}) are "
      "ported; @queueable function payloads are not"
    )
  name = payload["class"]
  if name not in TASK_REGISTRY:
    import igneous_tpu_torch.tasks  # noqa: F401  (registers the port's tasks)
  if name not in TASK_REGISTRY:
    raise KeyError(
      f"Task class {name!r} is not ported to igneous_tpu_torch. "
      f"Ported: {sorted(TASK_REGISTRY)}"
    )
  return TASK_REGISTRY[name](**payload.get("params", {}))

