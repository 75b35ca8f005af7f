"""Pass IGN1 — the knob registry is the only env-knob surface.

The port's copy of ``igneous_tpu/analysis/env_knobs.py``, checking the
port's sources against the port's registry (:mod:`.knobs`).

IGN101  raw read of an ``IGNEOUS_*`` env var outside the registry
        (``os.environ.get``/``os.getenv``/``environ[...]`` in load
        position). Writes (``environ[...] = ``, ``.setdefault``,
        ``.pop``) stay legal: the CLI and the soak pin knobs for child
        processes and A/B runs, and that is configuration *authorship*,
        not a scattered default.
IGN102  an ``IGNEOUS_*`` string literal passed to any call but absent
        from the registry — catches both new knobs that skipped
        registration and typos that would silently no-op at runtime.
IGN104  registry accessor called with a call-site default
        (``knobs.get_float(name, 0.5)``) — defaults live in the
        registry ONLY; a second argument would reintroduce the
        per-site-default drift this pass exists to kill.
IGN105  env read through a VARIABLE name (``os.environ.get(SOME_ENV)``)
        outside the registry. A literal-only checker goes blind the
        moment someone writes ``_env_float(NAME_CONST)`` — exactly the
        helper pattern this suite was built to retire — so indirect
        reads are flagged wholesale; route them through the registry
        (non-IGNEOUS variables too: name the knob, or read it in
        ``knobs.py`` where the surface is audited).

The README cross-check (IGN103) lives in the runner: it diffs the
committed knob table against :func:`knobs.knobs_markdown`.
"""

from __future__ import annotations

import ast
import re
from typing import List

from . import knobs
from .findings import Context, Finding, filter_suppressed

PASS_ID = "env-knobs"

_KNOB_RE = re.compile(r"^IGNEOUS_[A-Z0-9_]+$")
_ACCESSORS = frozenset({
  "raw", "get_str", "get_int", "get_float", "get_bool", "opt_float",
})
# the one module allowed to touch os.environ for IGNEOUS_* names
_REGISTRY_FILE = "igneous_tpu_torch/analysis/knobs.py"


def _dotted(node: ast.AST) -> str:
  parts = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
  return ".".join(reversed(parts))


def _knob_name(node: ast.AST) -> str:
  """The IGNEOUS_* name a node statically mentions, if any."""
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    if _KNOB_RE.match(node.value):
      return node.value
  return ""


def _is_environ(node: ast.AST) -> bool:
  d = _dotted(node)
  return d in ("os.environ", "environ")


def run(ctx: Context, files) -> List[Finding]:
  out: List[Finding] = []
  for abspath in files:
    src = ctx.source(abspath)
    if src.tree is None:
      continue
    found: List[Finding] = []
    is_registry = src.rel == _REGISTRY_FILE
    for node in ast.walk(src.tree):
      # --- reads via calls -------------------------------------------
      if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        first = _knob_name(node.args[0]) if node.args else ""
        read_call = (
          fn in ("os.getenv", "os.environ.get", "environ.get")
        )
        if read_call and first and not is_registry:
          found.append(Finding(
            "IGN101", src.rel, node.lineno,
            f"raw env read of {first}: use igneous_tpu_torch.analysis."
            f"knobs accessors (registry is the only env surface)",
            f"read:{first}",
          ))
        elif (read_call and node.args and not is_registry
              and not isinstance(node.args[0], ast.Constant)):
          found.append(Finding(
            "IGN105", src.rel, node.lineno,
            "env read through a variable name — invisible to the "
            "literal knob checks; read it via the registry accessors "
            "(or inside knobs.py where the surface is audited)",
            f"indirect-read:{node.lineno}",
          ))
        # accessor misuse: call-site default smuggled back in
        if fn.split(".")[-1] in _ACCESSORS and (
            fn.startswith("knobs.") or "analysis" in fn):
          if len(node.args) > 1 or node.keywords:
            found.append(Finding(
              "IGN104", src.rel, node.lineno,
              f"{fn}() takes the knob name only — defaults live in "
              f"the registry, not at call sites",
              f"default:{first or fn}",
            ))
        # unregistered literal mentioned in any call
        for arg in list(node.args) + [k.value for k in node.keywords]:
          name = _knob_name(arg)
          if name and name not in knobs.KNOBS:
            found.append(Finding(
              "IGN102", src.rel, arg.lineno,
              f"{name} is not declared in the knob registry "
              f"(igneous_tpu_torch/analysis/knobs.py)",
              f"unregistered:{name}",
            ))
      # --- reads via subscripts --------------------------------------
      elif isinstance(node, ast.Subscript):
        if (isinstance(node.ctx, ast.Load) and _is_environ(node.value)
            and not is_registry):
          name = _knob_name(node.slice)
          if name:
            found.append(Finding(
              "IGN101", src.rel, node.lineno,
              f"raw env read of {name}: use igneous_tpu_torch.analysis."
              f"knobs accessors",
              f"read:{name}",
            ))
          elif not isinstance(node.slice, ast.Constant):
            found.append(Finding(
              "IGN105", src.rel, node.lineno,
              "env read through a variable subscript — invisible to "
              "the literal knob checks; read it via the registry "
              "accessors",
              f"indirect-read:{node.lineno}",
            ))
    out.extend(filter_suppressed(src, found))
  return out
