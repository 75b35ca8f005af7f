"""Pass IGN4 — determinism lint for the seeded subsystems.

The port's copy of ``igneous_tpu/analysis/determinism.py``. Scope: the
port's modules whose same-seed reproducibility is part of their contract
(the simulator's results and journal bytes, the paged pyramid's bytes):
``observability/sim.py``, ``observability/replay.py`` and
``parallel/paged.py``. Codes:

IGN401  wall-clock reads: ``time.time()``, ``datetime.now()/utcnow()/
        today()``. Simulated time comes from the event loop; wall
        time anywhere in these files breaks same-seed identity.
IGN402  unseeded randomness: module-level ``random.<fn>()`` or
        ``np.random.<fn>()``. Seeded instances
        (``random.Random(seed)``) are the sanctioned pattern.
IGN403  nondeterministic iteration order: ``for … in set(…)``,
        unsorted ``os.listdir``/``glob.glob``/``Path.iterdir``.
IGN404  wall-clock default parameter (``def f(t=time.time())``) —
        frozen at import, different per process.
"""

from __future__ import annotations

import ast
from typing import List

from .findings import Context, Finding, filter_suppressed

PASS_ID = "determinism"

SCOPE_FILES = (
  "igneous_tpu_torch/observability/sim.py",
  "igneous_tpu_torch/observability/replay.py",
  "igneous_tpu_torch/parallel/paged.py",
)
_WALL_CLOCK = frozenset({
  "time.time", "datetime.now", "datetime.utcnow", "datetime.today",
  "datetime.datetime.now", "datetime.datetime.utcnow",
})
_SEEDED_CTORS = frozenset({"Random", "SystemRandom", "default_rng"})
_LISTING_FNS = frozenset({"os.listdir", "glob.glob", "os.scandir"})


def _dotted(node: ast.AST) -> str:
  parts = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
  return ".".join(reversed(parts))


def _check_call(src, node: ast.Call, found: List[Finding],
                in_defaults: bool):
  d = _dotted(node.func)
  tail = d.split(".")[-1]
  if d in _WALL_CLOCK:
    code = "IGN404" if in_defaults else "IGN401"
    msg = (
      f"{d}() as a default parameter value — frozen at import time"
      if in_defaults else
      f"{d}() in a seeded-determinism module — same-seed reruns "
      f"must not observe wall clock"
    )
    found.append(Finding(
      code, src.rel, node.lineno, msg, f"wall-clock:{node.lineno}"))
  elif (d.startswith("random.") or d.startswith("np.random.")
        or d.startswith("numpy.random.")) and \
      tail not in _SEEDED_CTORS:
    found.append(Finding(
      "IGN402", src.rel, node.lineno,
      f"{d}() uses the global (unseeded) RNG — use a "
      f"random.Random(seed) instance threaded from the config",
      f"unseeded:{node.lineno}",
    ))


def run(ctx: Context, files) -> List[Finding]:
  out: List[Finding] = []
  for abspath in files:
    src = ctx.source(abspath)
    if src.tree is None:
      continue
    if not src.rel.endswith(SCOPE_FILES):
      continue
    found: List[Finding] = []
    default_nodes = set()
    for node in ast.walk(src.tree):
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for dflt in node.args.defaults + node.args.kw_defaults:
          if dflt is not None:
            for sub in ast.walk(dflt):
              default_nodes.add(id(sub))
    for node in ast.walk(src.tree):
      if isinstance(node, ast.Call):
        _check_call(src, node, found, id(node) in default_nodes)
      elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
        it = node.iter
        line = getattr(node, "lineno", it.lineno)
        if isinstance(it, ast.Call):
          d = _dotted(it.func)
          if d == "set":
            found.append(Finding(
              "IGN403", src.rel, line,
              "iterating a set — order is hash-dependent; sort or "
              "keep a list/dict",
              f"set-iter:{line}",
            ))
          elif d in _LISTING_FNS or d.endswith(".iterdir"):
            found.append(Finding(
              "IGN403", src.rel, line,
              f"iterating {d}() unsorted — directory order is "
              f"filesystem-dependent; wrap in sorted()",
              f"listing-iter:{line}",
            ))
    out.extend(filter_suppressed(src, found))
  return out
