"""Dynamic companion of lint pass IGN3 (``IGNEOUS_RACE_CHECK=1``).

The port's copy of ``igneous_tpu/analysis/racecheck.py``.

:func:`guard` wraps a ``guarded-by``-annotated structure in a proxy
that asserts the owning lock is actually held on every MUTATING
operation. Reads are deliberately not asserted — the static pass and
the runtime checker share one policy (benign racy reads are
tolerated; racy writes are bugs), so the chaos soak running with the
checker on cannot produce false alarms from gauge reads.

Off by default: ``guard()`` returns the object untouched unless the
knob is set, so production paths carry zero overhead. The port's soak
(``igneous_tpu_torch/tools/chaos_soak.py``) sets ``IGNEOUS_RACE_CHECK=1``
for itself and its workers, so an unlocked write under its storms dies
loudly with the attribute name and lock.
"""

from __future__ import annotations

from typing import Any

from . import knobs

_MUTATORS = (
  "append", "appendleft", "extend", "insert", "remove", "pop",
  "popleft", "popitem", "clear", "update", "setdefault", "add",
  "discard", "move_to_end", "sort", "reverse",
)


def enabled() -> bool:
  return knobs.get_bool("IGNEOUS_RACE_CHECK")


def _lock_held(lock: Any) -> bool:
  probe = getattr(lock, "_is_owned", None)  # RLock ownership
  if probe is not None:
    try:
      return bool(probe())
    except Exception:
      pass
  probe = getattr(lock, "locked", None)  # plain Lock: held by someone
  if probe is not None:
    try:
      return bool(probe())
    except Exception:
      pass
  return True  # unknown lock type: never false-alarm


class GuardedProxy:
  """Duck-typed wrapper asserting lock ownership on mutations."""

  __slots__ = ("_rc_target", "_rc_lock", "_rc_name")

  def __init__(self, target: Any, lock: Any, name: str):
    object.__setattr__(self, "_rc_target", target)
    object.__setattr__(self, "_rc_lock", lock)
    object.__setattr__(self, "_rc_name", name)

  def _rc_assert(self, op: str) -> None:
    if not _lock_held(self._rc_lock):
      raise AssertionError(
        f"race check: {op} on {self._rc_name} without its guarded-by "
        f"lock held (IGNEOUS_RACE_CHECK=1)"
      )

  def __getattr__(self, attr: str) -> Any:
    value = getattr(self._rc_target, attr)
    if attr in _MUTATORS and callable(value):
      def _checked(*args, **kwargs):
        self._rc_assert(f".{attr}()")
        return value(*args, **kwargs)
      return _checked
    return value

  def __setitem__(self, key, val):
    self._rc_assert("__setitem__")
    self._rc_target[key] = val

  def __delitem__(self, key):
    self._rc_assert("__delitem__")
    del self._rc_target[key]

  def __getitem__(self, key):
    return self._rc_target[key]

  def __contains__(self, key):
    return key in self._rc_target

  def __iter__(self):
    return iter(self._rc_target)

  def __len__(self):
    return len(self._rc_target)

  def __bool__(self):
    return bool(self._rc_target)

  def __repr__(self):  # pragma: no cover - debugging aid
    return f"GuardedProxy({self._rc_name}, {self._rc_target!r})"


def guard(target: Any, lock: Any, name: str) -> Any:
  """Wrap ``target`` when the race checker is on; no-op otherwise."""
  if not enabled():
    return target
  return GuardedProxy(target, lock, name)
