"""Pass IGN2 — recompile hazards in device code.

The port's counterpart of ``igneous_tpu/analysis/recompile.py``. Scope:
the port's ``ops/``, ``parallel/`` and ``infer/``. The port runs eagerly
and its kernels are hand-built libraries, so the JAX pass's jit has no
target here; what can still compile per call is a PyTorch compiler built
in the wrong place. Codes:

IGN201  ``torch.compile``, ``torch.jit.script`` or ``torch.jit.trace``
        called inside a function body. Module level (or a decorator)
        compiles once; one built per call compiles per call. Exempt when
        the result lands in a subscript cache slot
        (``self._fns[sig] = torch.compile(fn)``) or the enclosing
        function is ``functools.lru_cache``/``cache``-decorated.
IGN202  the same inside a ``for``/``while`` loop: the per-iteration
        variant of IGN201, with no cache exemption.

The JAX pass's IGN203 (host syncs inside a jit body) and IGN204 (shapes
from traced parameters) have no counterpart: eager PyTorch traces no
body, so neither hazard exists (ROADMAP §3).
"""

from __future__ import annotations

import ast
from typing import List

from .findings import Context, Finding, filter_suppressed

PASS_ID = "recompile"

SCOPE_DIRS = (
  "igneous_tpu_torch/ops/", "igneous_tpu_torch/parallel/",
  "igneous_tpu_torch/infer/",
)
_COMPILERS = frozenset({
  "torch.compile", "torch.jit.script", "torch.jit.trace",
})
_CACHE_DECOS = frozenset({"lru_cache", "cache"})


def _dotted(node: ast.AST) -> str:
  parts = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
  return ".".join(reversed(parts))


def _is_compile_call(node: ast.Call) -> bool:
  if _dotted(node.func) in _COMPILERS:
    return True
  # partial(torch.compile, mode=...) / functools.partial(...)
  if _dotted(node.func).endswith("partial") and node.args:
    return _dotted(node.args[0]) in _COMPILERS
  return False


def _has_cache_deco(fn: ast.AST) -> bool:
  for deco in getattr(fn, "decorator_list", []):
    d = deco.func if isinstance(deco, ast.Call) else deco
    if _dotted(d).split(".")[-1] in _CACHE_DECOS:
      return True
  return False


class _Walker(ast.NodeVisitor):
  def __init__(self, src):
    self.src = src
    self.found: List[Finding] = []
    self.fn_stack: List[ast.AST] = []
    self.loop_depth = 0

  def _visit_fn(self, node):
    # decorators and parameter defaults evaluate in the ENCLOSING
    # scope — visit them before pushing this function
    for deco in node.decorator_list:
      self.visit(deco)
    for dflt in node.args.defaults + node.args.kw_defaults:
      if dflt is not None:
        self.visit(dflt)
    self.fn_stack.append(node)
    outer_loops, self.loop_depth = self.loop_depth, 0
    for stmt in node.body:
      self.visit(stmt)
    self.loop_depth = outer_loops
    self.fn_stack.pop()

  visit_FunctionDef = _visit_fn
  visit_AsyncFunctionDef = _visit_fn

  def _visit_loop(self, node):
    self.loop_depth += 1
    self.generic_visit(node)
    self.loop_depth -= 1

  visit_For = _visit_loop
  visit_While = _visit_loop
  visit_AsyncFor = _visit_loop

  def visit_Assign(self, node):
    if (isinstance(node.value, ast.Call) and _is_compile_call(node.value)
        and self.fn_stack and not self.loop_depth):
      # cache-slot assignment: self._fns[sig] = torch.compile(fn)
      if all(isinstance(t, ast.Subscript) for t in node.targets):
        for t in node.targets:
          self.generic_visit(t)
        return
    self.generic_visit(node)

  def visit_Call(self, node):
    if _is_compile_call(node):
      fn_name = getattr(self.fn_stack[-1], "name", "?") \
        if self.fn_stack else ""
      what = _dotted(node.func)
      if self.loop_depth and self.fn_stack:
        self.found.append(Finding(
          "IGN202", self.src.rel, node.lineno,
          f"{what} called inside a loop in {fn_name}() — compiles "
          f"every iteration; build once at module level",
          f"compile-in-loop:{fn_name}",
        ))
      elif self.fn_stack and not _has_cache_deco(self.fn_stack[-1]):
        self.found.append(Finding(
          "IGN201", self.src.rel, node.lineno,
          f"{what} called inside {fn_name}() — a fresh compile per "
          f"call; hoist to module level or cache by signature",
          f"compile-in-function:{fn_name}",
        ))
    self.generic_visit(node)


def run(ctx: Context, files) -> List[Finding]:
  out: List[Finding] = []
  for abspath in files:
    src = ctx.source(abspath)
    if src.tree is None:
      continue
    if not any(s in src.rel for s in SCOPE_DIRS):
      continue
    w = _Walker(src)
    w.visit(src.tree)
    out.extend(filter_suppressed(src, w.found))
  return out
