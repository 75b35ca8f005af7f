"""Task registry + JSON wire format, with the port's own registry.

A task crosses process boundaries as JSON, in the two forms of
``igneous_tpu/queues/registry.py``:

  {"class": "DownsampleTask", "params": {...}}                 RegisteredTask
  {"fn": "DeleteMeshFilesTask", "args": [...], "kwargs": {...}}  @queueable

``RegisteredTask`` subclasses record their constructor's bound arguments
at instantiation, so ``__init__`` signatures ARE the wire schema. A
``@queueable`` function goes into a queue as ``functools.partial(fn,
*args, **kwargs)`` and runs as a ``FunctionTask``.

The port keeps its own ``TASK_REGISTRY`` and ``FN_REGISTRY``, so a process
that loads both packages keeps both sets. ``deserialize`` maps a payload's
class or function name into these registries and never imports the
``module`` the payload names: a payload serialized by the JAX package runs
here unchanged, and the port's payloads run there.

Every task mints its trace identity at construction
(``observability.trace.mint``, none when ``IGNEOUS_TRACE_SAMPLE=0``) and
carries it in the payload's ``trace`` field; ``deserialize`` puts the
wire's identity back on the task, so a trace minted by either package
survives every hop through a worker of either package.
"""

from __future__ import annotations

import functools
import inspect
import json
from typing import Callable, Dict, Union

from ..lib import jsonify
from ..observability import trace

TASK_REGISTRY: Dict[str, type] = {}
FN_REGISTRY: Dict[str, Callable] = {}


def _with_trace(task, out: dict) -> dict:
  tinfo = getattr(task, "_trace", None)
  if tinfo:
    # exec_span_id is per-delivery state, never part of the wire trace
    out["trace"] = {k: v for k, v in tinfo.items() if k != "exec_span_id"}
  return out


def _reenter_trace(task, payload: dict):
  """Put the payload's trace identity back on a deserialized task (its
  constructor minted a fresh one; the wire's wins, so redeliveries and
  hops between workers stay one trace)."""
  tinfo = payload.get("trace")
  if tinfo and isinstance(tinfo, dict) and tinfo.get("trace_id"):
    task._trace = dict(tinfo)
  return task


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
        self._trace = trace.mint()
      orig_init(self, *args, **kwargs)

    cls.__init__ = wrapped_init

  def execute(self):
    raise NotImplementedError

  def payload(self) -> dict:
    return _with_trace(self, {
      "class": type(self).__name__,
      "module": type(self).__module__,
      "params": self._params,
    })

  def to_json(self) -> str:
    return json.dumps(self.payload())

  def __repr__(self):
    args = ", ".join(f"{k}={v!r}" for k, v in self._params.items())
    return f"{type(self).__name__}({args})"


def queueable(fn: Callable) -> Callable:
  """Register a function as a queueable task target.

  Insert ``functools.partial(fn, *args, **kwargs)`` into a queue; it
  serializes by function name + arguments.
  """
  FN_REGISTRY[fn.__name__] = fn
  fn._queueable = True
  return fn


class FunctionTask(RegisteredTask):
  """Adapter that executes a @queueable function payload."""

  def __init__(self, fn_name: str, args: list, kwargs: dict):
    self.fn_name = fn_name
    self.args = args or []
    self.kwargs = kwargs or {}

  def payload(self) -> dict:
    return _with_trace(self, {
      "fn": self.fn_name,
      "args": jsonify(list(self.args)),
      "kwargs": jsonify(dict(self.kwargs)),
    })

  def execute(self):
    if self.fn_name not in FN_REGISTRY:
      import igneous_tpu_torch.tasks  # noqa: F401  (registers the port's functions)
    if self.fn_name not in FN_REGISTRY:
      raise KeyError(
        f"Function {self.fn_name!r} is not @queueable-registered. "
        f"Known: {sorted(FN_REGISTRY)}"
      )
    return FN_REGISTRY[self.fn_name](*self.args, **self.kwargs)


def serialize(task) -> str:
  """Task object | partial of a @queueable function | payload dict | JSON
  string → JSON string."""
  if isinstance(task, RegisteredTask):
    return task.to_json()
  if isinstance(task, functools.partial):
    fn = task.func
    if not getattr(fn, "_queueable", False):
      raise ValueError(f"{fn} is not @queueable")
    return FunctionTask(fn.__name__, list(task.args), dict(task.keywords)).to_json()
  if isinstance(task, dict):
    return json.dumps(jsonify(task))
  if isinstance(task, str):
    return task
  raise TypeError(f"Cannot serialize task: {task!r}")


def deserialize(payload: Union[str, bytes, dict]) -> RegisteredTask:
  if isinstance(payload, (str, bytes)):
    payload = json.loads(payload)
  if "fn" in payload:
    return _reenter_trace(
      FunctionTask(payload["fn"], payload.get("args"), payload.get("kwargs")),
      payload,
    )
  name = payload["class"]
  if name not in TASK_REGISTRY:
    import igneous_tpu_torch.tasks  # noqa: F401  (registers the port's tasks)
  if name not in TASK_REGISTRY:
    raise KeyError(
      f"Task class {name!r} is not ported to igneous_tpu_torch. "
      f"Ported: {sorted(TASK_REGISTRY)}"
    )
  return _reenter_trace(TASK_REGISTRY[name](**payload.get("params", {})), payload)



class PrintTask(RegisteredTask):
  """Debug and smoke-test task: prints its text."""

  def __init__(self, txt: str = ""):
    self.txt = txt

  def execute(self):
    print(self.txt or "PrintTask")
    return self.txt
