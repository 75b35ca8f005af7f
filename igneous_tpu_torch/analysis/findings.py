"""Finding model, per-line suppressions, and the checked-in baseline.

The port's copy of ``igneous_tpu/analysis/findings.py``. A finding's
*fingerprint* is line-number-free (``CODE path key``) so unrelated edits
above a baselined site don't churn the baseline file. Inline suppression
is a trailing ``# lint: allow=IGN201 reason`` on the offending line (the
reason is mandatory by convention, reviewed like any comment). The
baseline (``igneous_tpu_torch/analysis/lint_baseline.json``) is for
deliberate deferrals only, and stays empty for the env-knob (IGN1) and
telemetry-grammar (IGN5) passes.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow=([A-Z0-9,]+)")


@dataclass(frozen=True)
class Finding:
  code: str      # e.g. "IGN101"
  path: str      # repo-relative, forward slashes
  line: int      # 1-based
  message: str
  key: str       # stable identity within the file (knob/attr/name)

  @property
  def fingerprint(self) -> str:
    return f"{self.code} {self.path} {self.key}"

  def render(self) -> str:
    return f"{self.path}:{self.line}: {self.code} {self.message}"


class SourceFile:
  """Parsed source + the per-line suppression map, cached per path."""

  def __init__(self, abspath: str, relpath: str):
    self.abspath = abspath
    self.rel = relpath.replace(os.sep, "/")
    with open(abspath, "r", encoding="utf-8") as f:
      self.text = f.read()
    self.lines = self.text.splitlines()
    self.tree: Optional[ast.AST] = None
    self.parse_error: Optional[str] = None
    try:
      self.tree = ast.parse(self.text, filename=self.rel)
    except SyntaxError as exc:  # pragma: no cover - repo always parses
      self.parse_error = str(exc)
    self._allow: Dict[int, set] = {}
    for idx, line in enumerate(self.lines, start=1):
      m = _ALLOW_RE.search(line)
      if m:
        self._allow[idx] = set(m.group(1).split(","))

  def suppressed(self, line: int, code: str) -> bool:
    for probe in (line, line - 1):
      codes = self._allow.get(probe)
      if codes and (code in codes or "ALL" in codes):
        return True
    return False


class Context:
  """Shared state handed to every pass: repo root + parsed-file cache."""

  def __init__(self, root: str):
    self.root = os.path.abspath(root)
    self._cache: Dict[str, SourceFile] = {}

  def source(self, abspath: str) -> SourceFile:
    sf = self._cache.get(abspath)
    if sf is None:
      rel = os.path.relpath(abspath, self.root)
      sf = SourceFile(abspath, rel)
      self._cache[abspath] = sf
    return sf


def filter_suppressed(src: SourceFile,
                      findings: Sequence[Finding]) -> List[Finding]:
  return [f for f in findings if not src.suppressed(f.line, f.code)]


def load_baseline(path: str) -> List[str]:
  if not os.path.exists(path):
    return []
  with open(path, "r", encoding="utf-8") as f:
    data = json.load(f)
  return list(data.get("entries", []))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
  entries = sorted({f.fingerprint for f in findings})
  with open(path, "w", encoding="utf-8") as f:
    json.dump({"version": 1, "entries": entries}, f, indent=2)
    f.write("\n")


def split_baselined(findings: Sequence[Finding], baseline: Sequence[str]):
  """(new, baselined) — matching is by fingerprint, not line."""
  known = set(baseline)
  new = [f for f in findings if f.fingerprint not in known]
  old = [f for f in findings if f.fingerprint in known]
  return new, old
