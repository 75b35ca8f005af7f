"""Pass IGN3 — static lock discipline via ``guarded-by`` annotations.

The port's copy of ``igneous_tpu/analysis/locks.py``, unchanged in its
rules.

Convention: in ``__init__``, a shared mutable attribute carries a
trailing comment naming the lock that guards it::

    self._entries = OrderedDict()   # guarded-by: self._lock

The checker then walks every method of that class and flags WRITES to
the annotated attribute — assignment, augmented assignment, ``del``,
subscript stores, or calls of known mutating methods (``append``,
``pop``, ``update``, ``move_to_end``, …) — that are not lexically
inside a ``with <lock>:`` block. Plain reads are exempt: the project's
lock policy tolerates benign racy reads (gauges, len checks) and the
dynamic companion (:mod:`.racecheck`, ``IGNEOUS_RACE_CHECK=1``)
asserts the same write-side policy at runtime under the port's soak.

Method-level exemptions: ``__init__`` (single-threaded by
construction), methods whose name ends ``_locked`` (documented
caller-holds-lock contract), and bodies containing a
``# holds: <lock>`` comment.

Condition aliases: ``self._not_full = threading.Condition(self._lock)``
makes ``with self._not_full:`` acquire ``self._lock`` — the checker
reads those constructions out of ``__init__`` so either name counts as
holding the underlying lock.

IGN301  guarded write outside the named lock
IGN302  malformed annotation (no ``self.<attr>`` assignment on the
        annotated line)
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from .findings import Context, Finding, SourceFile, filter_suppressed

PASS_ID = "locks"

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_][\w.]*)")
_ATTR_ASSIGN_RE = re.compile(r"self\.(\w+)\s*(?::[^=]+)?=")

MUTATORS = frozenset({
  "append", "appendleft", "extend", "insert", "remove", "pop",
  "popleft", "popitem", "clear", "update", "setdefault", "add",
  "discard", "move_to_end", "sort", "reverse", "write", "flush",
})


def _dotted(node: ast.AST) -> str:
  parts = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
  return ".".join(reversed(parts))


def _collect_guards(src: SourceFile,
                    cls: ast.ClassDef) -> Dict[str, str]:
  """attr name -> lock expression, from annotated lines in the class."""
  guards: Dict[str, str] = {}
  first = cls.lineno
  last = max(
    (n.end_lineno for n in ast.walk(cls)
     if getattr(n, "end_lineno", None) is not None),
    default=cls.lineno,
  )
  for lineno in range(first, min(last, len(src.lines)) + 1):
    line = src.lines[lineno - 1]
    m = _GUARD_RE.search(line)
    if not m:
      continue
    attr = _ATTR_ASSIGN_RE.search(line)
    if attr:
      guards[attr.group(1)] = m.group(1)
  return guards


def _collect_aliases(cls: ast.ClassDef) -> Dict[str, str]:
  """Condition-over-lock aliases: ``self._not_full =
  threading.Condition(self._lock)`` means holding ``self._not_full``
  holds ``self._lock``."""
  aliases: Dict[str, str] = {}
  for node in ast.walk(cls):
    if not (isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and _dotted(node.value.func).endswith("Condition")
            and node.value.args):
      continue
    lock = _dotted(node.value.args[0])
    if not lock:
      continue
    for target in node.targets:
      name = _dotted(target)
      if name:
        aliases[name] = lock
  return aliases


def _holds_locks(src: SourceFile, fn: ast.AST) -> List[str]:
  out = []
  end = getattr(fn, "end_lineno", fn.lineno)
  for lineno in range(fn.lineno, min(end, len(src.lines)) + 1):
    m = _HOLDS_RE.search(src.lines[lineno - 1])
    if m:
      out.append(m.group(1))
  return out


class _MethodWalker(ast.NodeVisitor):
  def __init__(self, src: SourceFile, guards: Dict[str, str],
               held: List[str], aliases: Optional[Dict[str, str]] = None):
    self.src = src
    self.guards = guards
    self.aliases = aliases or {}
    self.held = list(held)
    self.found: List[Finding] = []

  def _self_attr(self, node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"):
      return node.attr
    return None

  def _flag(self, attr: str, lineno: int, what: str):
    lock = self.guards[attr]
    if lock in self.held:
      return
    self.found.append(Finding(
      "IGN301", self.src.rel, lineno,
      f"{what} of self.{attr} (guarded-by: {lock}) outside "
      f"`with {lock}:`",
      f"unguarded:{attr}:{lineno}",
    ))

  def visit_With(self, node):
    added = []
    for item in node.items:
      expr = _dotted(item.context_expr)
      if not expr and isinstance(item.context_expr, ast.Call):
        expr = _dotted(item.context_expr.func)
      if expr:
        added.append(expr)
        self.held.append(expr)
        alias = self.aliases.get(expr)
        if alias:
          added.append(alias)
          self.held.append(alias)
    self.generic_visit(node)
    for _ in added:
      self.held.pop()

  # nested defs get their own lexical lock scope; don't inherit ours
  def visit_FunctionDef(self, node):
    inner = _MethodWalker(self.src, self.guards, [], self.aliases)
    for stmt in node.body:
      inner.visit(stmt)
    self.found.extend(inner.found)

  visit_AsyncFunctionDef = visit_FunctionDef

  def _check_target(self, target: ast.AST):
    attr = self._self_attr(target)
    if attr and attr in self.guards:
      self._flag(attr, target.lineno, "write")
    if isinstance(target, ast.Subscript):
      attr = self._self_attr(target.value)
      if attr and attr in self.guards:
        self._flag(attr, target.lineno, "subscript store")
    if isinstance(target, (ast.Tuple, ast.List)):
      for elt in target.elts:
        self._check_target(elt)

  def visit_Assign(self, node):
    for t in node.targets:
      self._check_target(t)
    self.generic_visit(node)

  def visit_AugAssign(self, node):
    self._check_target(node.target)
    self.generic_visit(node)

  def visit_AnnAssign(self, node):
    if node.value is not None:
      self._check_target(node.target)
    self.generic_visit(node)

  def visit_Delete(self, node):
    for t in node.targets:
      self._check_target(t)
    self.generic_visit(node)

  def visit_Call(self, node):
    if isinstance(node.func, ast.Attribute):
      attr = self._self_attr(node.func.value)
      if (attr and attr in self.guards
          and node.func.attr in MUTATORS):
        self._flag(attr, node.lineno, f".{node.func.attr}()")
    self.generic_visit(node)


def run(ctx: Context, files) -> List[Finding]:
  out: List[Finding] = []
  for abspath in files:
    src = ctx.source(abspath)
    if src.tree is None or "guarded-by:" not in src.text:
      continue
    found: List[Finding] = []
    for node in ast.walk(src.tree):
      if not isinstance(node, ast.ClassDef):
        continue
      guards = _collect_guards(src, node)
      if not guards:
        continue
      aliases = _collect_aliases(node)
      for lock in set(guards.values()):
        if not lock.startswith("self."):
          # module-global locks are fine; attribute locks must exist
          continue
      for item in node.body:
        if not isinstance(item, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
          continue
        if item.name == "__init__" or item.name.endswith("_locked"):
          continue
        held = _holds_locks(src, item)
        walker = _MethodWalker(src, guards, held, aliases)
        for stmt in item.body:
          walker.visit(stmt)
        found.extend(walker.found)
    # malformed annotations anywhere in the file
    for lineno, line in enumerate(src.lines, start=1):
      if _GUARD_RE.search(line) and not _ATTR_ASSIGN_RE.search(line):
        found.append(Finding(
          "IGN302", src.rel, lineno,
          "guarded-by annotation must sit on a `self.<attr> = ...` "
          "assignment line",
          f"malformed:{lineno}",
        ))
    out.extend(filter_suppressed(src, found))
  return out
