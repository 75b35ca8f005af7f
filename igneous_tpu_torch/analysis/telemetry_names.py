"""Pass IGN5 — telemetry-name grammar and prom-exposition collisions.

The port's copy of ``igneous_tpu/analysis/telemetry_names.py``, over the
port's sources and its own subsystem vocabulary.

Every metric/span name in the codebase follows
``subsystem.noun[.verb][.unit]`` (lowercase ``[a-z0-9_]`` segments,
f-string placeholders allowed after the first segment); ``stage()``
labels are single tokens. The subsystem vocabulary is closed — adding
a subsystem is a deliberate one-line edit here, not a typo.

Collisions are checked against the *prom exposition* families that
the port's ``observability/prom.py`` derives (counter ``igneous_<name>_total``,
histogram ``igneous_<name>_seconds``, gauge ``igneous_<name>``, with
non-alnum sanitized to ``_``): two distinct (kind, name) pairs that
map to one family would silently merge series and corrupt the
exposition — e.g. counter ``x`` vs gauge ``x_total``, or names
differing only by a sanitized character.

IGN501  name violates the grammar / unknown subsystem
IGN502  cross-type prom family collision
IGN503  non-literal name where a literal or f-string is required
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from .findings import Context, Finding, filter_suppressed

PASS_ID = "telemetry"

# the JAX package's vocabulary (mixed fleets merge one another's
# journals and expositions) plus the port's mesh, skeleton and graphene
# tallies
SUBSYSTEMS = frozenset({
  "autoscale", "campaign", "chaos", "chunk_cache", "device", "dlq",
  "drain", "fleet", "graphene", "health", "infer", "integrity",
  "journal", "mesh", "metrics", "pipeline", "queue", "retries",
  "rollup", "serve", "sim", "skeleton", "slo", "speculation", "steal",
  "storage", "tasks", "transfer", "worker", "zombie",
})

# the telemetry implementation itself forwards caller-supplied names
# (observe -> record_span etc.); scanning it would flag every
# forwarding call as dynamic. Real names are checked at call sites.
_IMPL_FILES = (
  "igneous_tpu_torch/observability/metrics.py",
  "igneous_tpu_torch/observability/trace.py",
  "igneous_tpu_torch/telemetry.py",
)

# telemetry entry point -> metric kind
KIND_OF = {
  "incr": "counter",
  "observe": "hist",
  "observe_quiet": "hist",
  "gauge_set": "gauge",
  "gauge_max": "gauge",
  "span": "span",
  "maybe_span": "span",
  "record_span": "span",
  "stage": "stage",
}
_SEG_RE = re.compile(r"^[a-z0-9_]+$")
_PLACEHOLDER = "\x00"


def _sanitize(name: str) -> str:
  return re.sub(r"[^a-zA-Z0-9_]", "_", name)


def family(kind: str, name: str) -> Optional[str]:
  """The prom exposition family this metric lands in (None for
  span/stage, which never reach /metrics)."""
  if kind == "counter":
    return f"igneous_{_sanitize(name)}_total"
  if kind == "hist":
    return f"igneous_{_sanitize(name)}_seconds"
  if kind == "gauge":
    return f"igneous_{_sanitize(name)}"
  return None


def _literal_name(node: ast.AST) -> Optional[str]:
  """Literal or f-string first argument, placeholders normalized."""
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    return node.value
  if isinstance(node, ast.JoinedStr):
    parts = []
    for val in node.values:
      if isinstance(val, ast.Constant):
        parts.append(str(val.value))
      else:
        parts.append(_PLACEHOLDER)
    return "".join(parts)
  return None


def _grammar_error(kind: str, name: str) -> Optional[str]:
  segments = name.split(".")
  if kind == "stage":
    if len(segments) != 1 or not _SEG_RE.match(segments[0]):
      return "stage labels are single [a-z0-9_]+ tokens"
    return None
  if len(segments) < 2:
    return "expected subsystem.noun[.verb] (at least two segments)"
  first = segments[0]
  if _PLACEHOLDER in first or not _SEG_RE.match(first):
    return "first segment must be a literal subsystem token"
  if first not in SUBSYSTEMS:
    return (
      f"unknown subsystem {first!r} — register it in "
      f"analysis/telemetry_names.py SUBSYSTEMS"
    )
  for seg in segments[1:]:
    bare = seg.replace(_PLACEHOLDER, "")
    if seg != _PLACEHOLDER and bare and not _SEG_RE.match(bare):
      return f"segment {seg.replace(_PLACEHOLDER, '{…}')!r} has " \
             f"characters outside [a-z0-9_]"
    if not bare and seg != _PLACEHOLDER:
      return "empty segment"
  return None


def _call_kind(node: ast.Call) -> Optional[str]:
  fn = node.func
  name = None
  if isinstance(fn, ast.Name):
    name = fn.id
  elif isinstance(fn, ast.Attribute):
    base = fn.value
    base_name = base.id if isinstance(base, ast.Name) else \
      base.attr if isinstance(base, ast.Attribute) else ""
    if base_name in ("telemetry", "metrics", "tele"):
      name = fn.attr
  return KIND_OF.get(name) if name else None


def collect(ctx: Context, files):
  """Every (kind, normalized name, site) telemetry call in scope."""
  sites: List[Tuple[str, str, object]] = []
  bad: List[Tuple[object, Finding]] = []
  for abspath in files:
    src = ctx.source(abspath)
    if src.tree is None or src.rel in _IMPL_FILES:
      continue
    for node in ast.walk(src.tree):
      if not isinstance(node, ast.Call):
        continue
      kind = _call_kind(node)
      if kind is None or not node.args:
        continue
      name = _literal_name(node.args[0])
      if name is None:
        # dynamic name: allowed only when a variable carries a name
        # built from literals elsewhere — too rare to chase; flag it
        bad.append((src, Finding(
          "IGN503", src.rel, node.lineno,
          f"{kind} name is not a literal/f-string — the grammar and "
          f"collision checks cannot see it",
          f"dynamic:{node.lineno}",
        )))
        continue
      sites.append((kind, name, (src, node.lineno)))
  return sites, bad


def run(ctx: Context, files) -> List[Finding]:
  sites, bad = collect(ctx, files)
  per_file: Dict[str, List[Finding]] = {}
  srcs = {}

  def _add(src, finding: Finding):
    srcs[src.rel] = src
    per_file.setdefault(src.rel, []).append(finding)

  for src, finding in bad:
    _add(src, finding)

  families: Dict[str, Tuple[str, str, object]] = {}
  for kind, name, (src, lineno) in sites:
    err = _grammar_error(kind, name)
    display = name.replace(_PLACEHOLDER, "{…}")
    if err:
      _add(src, Finding(
        "IGN501", src.rel, lineno,
        f"telemetry name {display!r}: {err}",
        f"grammar:{display}",
      ))
      continue
    if _PLACEHOLDER in name:
      continue  # family unknowable statically
    fam = family(kind, name)
    if fam is None:
      continue
    prev = families.get(fam)
    if prev is None:
      families[fam] = (kind, name, (src, lineno))
    elif (prev[0], prev[1]) != (kind, name):
      pkind, pname, (psrc, plineno) = prev
      _add(src, Finding(
        "IGN502", src.rel, lineno,
        f"{kind} {name!r} and {pkind} {pname!r} "
        f"({psrc.rel}:{plineno}) both expose prom family {fam!r} — "
        f"series would merge and corrupt the exposition",
        f"collision:{fam}",
      ))
  out: List[Finding] = []
  for rel, findings in sorted(per_file.items()):
    out.extend(filter_suppressed(srcs[rel], findings))
  return out
