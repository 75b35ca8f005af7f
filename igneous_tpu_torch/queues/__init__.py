"""Task queues for the port: the JSON task wire format and local execution."""

from .registry import TASK_REGISTRY, RegisteredTask, deserialize, serialize
from .local import LocalTaskQueue
