"""Source and file discovery of the port's lint.

The port's copy of ``igneous_tpu/analysis/discovery.py``: one walker and
one noise policy (``__pycache__``, ``.pyc``, VCS and cache directories
never reach a finding or a soak's byte map). The scope is the port's own
sources: the ``igneous_tpu_torch`` package and ``chip_smoke.py``.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

NOISE_DIRS = frozenset({
  "__pycache__", ".git", ".pytest_cache", ".mypy_cache",
  ".ruff_cache", ".eggs", "node_modules", ".ipynb_checkpoints",
})
NOISE_SUFFIXES = (".pyc", ".pyo", ".pyd")

# lint scope: the port's package and its chip script
LINT_ROOTS = ("igneous_tpu_torch",)
LINT_ROOT_FILES = ("chip_smoke.py",)


def walk_files(root: str,
               suffixes: Optional[Sequence[str]] = None) -> Iterator[str]:
  """Deterministic (sorted) file walk under ``root`` with the shared
  noise policy applied. ``suffixes`` optionally restricts by ending."""
  for dirpath, dirnames, filenames in os.walk(root):
    dirnames[:] = sorted(
      d for d in dirnames
      if d not in NOISE_DIRS and not d.endswith(".egg-info")
    )
    for fname in sorted(filenames):
      if fname.endswith(NOISE_SUFFIXES):
        continue
      if suffixes and not fname.endswith(tuple(suffixes)):
        continue
      yield os.path.join(dirpath, fname)


def iter_source_files(repo_root: str) -> Iterator[str]:
  """Every Python source file the port's lint analyzes, in a walk order
  stable across hosts. tests/ are out of scope: they set env knobs and
  embed checker fixture snippets."""
  for sub in LINT_ROOTS:
    base = os.path.join(repo_root, sub)
    if os.path.isdir(base):
      yield from walk_files(base, suffixes=(".py",))
  for fname in LINT_ROOT_FILES:
    path = os.path.join(repo_root, fname)
    if os.path.isfile(path):
      yield path
