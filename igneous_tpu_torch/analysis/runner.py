"""The port's lint: run its passes, diff its baseline, report.

The port's copy of ``igneous_tpu/analysis/runner.py``. Also home of
IGN103, the README<->registry cross-check: the port's knob table between
its own markers must equal :func:`knobs.knobs_markdown` byte for byte
(regenerate with ``python -m igneous_tpu_torch lint --knobs-md
--write``). The JAX package's table, between the JAX markers, is the JAX
lint's.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

from . import determinism, env_knobs, knobs, locks, recompile
from . import telemetry_names
from .discovery import iter_source_files
from .findings import (
  Context, Finding, load_baseline, split_baselined, write_baseline,
)

PASSES = (
  env_knobs, recompile, locks, determinism, telemetry_names,
)
PASS_IDS = tuple(p.PASS_ID for p in PASSES)
DEFAULT_BASELINE = os.path.join("igneous_tpu_torch", "analysis", "lint_baseline.json")
# these passes may never carry baseline entries
NO_BASELINE_PASSES = {"IGN1": "env-knobs", "IGN5": "telemetry"}


def readme_check(root: str) -> List[Finding]:
  path = os.path.join(root, "README.md")
  if not os.path.exists(path):
    return []
  with open(path, "r", encoding="utf-8") as f:
    text = f.read()
  expected = knobs.knobs_markdown()
  start = text.find(knobs.BEGIN_MARK)
  end = text.find(knobs.END_MARK)
  if start < 0 or end < 0:
    return [Finding(
      "IGN103", "README.md", 1,
      "port knob-table markers missing — add them, then run "
      "`python -m igneous_tpu_torch lint --knobs-md --write`",
      "knob-table:markers",
    )]
  actual = text[start:end + len(knobs.END_MARK)] + "\n"
  if actual != expected:
    line = text[:start].count("\n") + 1
    return [Finding(
      "IGN103", "README.md", line,
      "port knob table drifted from the registry — regenerate with "
      "`python -m igneous_tpu_torch lint --knobs-md --write`",
      "knob-table:drift",
    )]
  return []


def run_passes(root: str,
               select: Optional[Sequence[str]] = None) -> List[Finding]:
  ctx = Context(root)
  files = list(iter_source_files(ctx.root))
  out: List[Finding] = []
  for p in PASSES:
    if select and p.PASS_ID not in select:
      continue
    out.extend(p.run(ctx, files))
  if not select or "env-knobs" in select:
    out.extend(readme_check(ctx.root))
  out.sort(key=lambda f: (f.path, f.line, f.code))
  return out


def update_readme(root: str) -> bool:
  """Rewrite the README block in place; True when it changed."""
  path = os.path.join(root, "README.md")
  with open(path, "r", encoding="utf-8") as f:
    text = f.read()
  expected = knobs.knobs_markdown()
  start = text.find(knobs.BEGIN_MARK)
  end = text.find(knobs.END_MARK)
  if start < 0 or end < 0:
    raise SystemExit(
      "README.md has no port knob-table markers; add the begin/end "
      "marker comments where the table should live"
    )
  new = text[:start] + expected.rstrip("\n") + \
      text[end + len(knobs.END_MARK):]
  if new == text:
    return False
  with open(path, "w", encoding="utf-8") as f:
    f.write(new)
  return True


def main(root: str, *, knobs_md: bool = False, write: bool = False,
         baseline_path: Optional[str] = None,
         update_baseline: bool = False,
         select: Optional[Sequence[str]] = None,
         as_json: bool = False, echo=print) -> int:
  if knobs_md:
    if write:
      changed = update_readme(root)
      echo("README.md knob table " +
           ("updated" if changed else "already current"))
      return 0
    echo(knobs.knobs_markdown().rstrip("\n"))
    return 0

  findings = run_passes(root, select=select)
  bpath = os.path.join(root, baseline_path or DEFAULT_BASELINE)
  if update_baseline:
    blocked = [
      f for f in findings
      if any(f.code.startswith(pfx) for pfx in NO_BASELINE_PASSES)
    ]
    if blocked:
      for f in blocked:
        echo(f.render())
      echo(
        f"refusing to baseline {len(blocked)} finding(s) from the "
        f"env-knobs/telemetry passes — fix these (their baseline stays "
        f"at zero)"
      )
      return 2
    write_baseline(bpath, findings)
    echo(f"baseline written: {len(findings)} entries -> {bpath}")
    return 0

  baseline = load_baseline(bpath)
  new, old = split_baselined(findings, baseline)
  stale = set(baseline) - {f.fingerprint for f in findings}
  if as_json:
    echo(json.dumps({
      "findings": [f.__dict__ for f in new],
      "baselined": len(old),
      "stale_baseline": sorted(stale),
    }, indent=2))
  else:
    for f in new:
      echo(f.render())
    if stale:
      for fp in sorted(stale):
        echo(f"stale baseline entry (fixed? remove it): {fp}")
    summary = (
      f"igneous_tpu_torch lint: {len(new)} finding(s), {len(old)} baselined, "
      f"{len(stale)} stale baseline entr(ies)"
    )
    echo(summary)
  return 1 if (new or stale) else 0


def add_arguments(ap) -> None:
  """The lint's options (the JAX CLI's) on an argparse parser."""
  ap.add_argument("--root", default=".", help="repo root")
  ap.add_argument("--knobs-md", action="store_true",
                  help="print the generated README knob table")
  ap.add_argument("--write", action="store_true",
                  help="with --knobs-md: rewrite README.md in place")
  ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                  help="baseline file (repo-relative)")
  ap.add_argument("--update-baseline", action="store_true",
                  help="accept current findings as the new baseline "
                       "(env-knobs/telemetry passes refuse)")
  ap.add_argument("--select", action="append", choices=PASS_IDS,
                  help="run only these passes (repeatable)")
  ap.add_argument("--json", action="store_true", dest="as_json")


def run_args(args) -> int:
  """Run the lint with the options :func:`add_arguments` parsed."""
  return main(
    args.root, knobs_md=args.knobs_md, write=args.write,
    baseline_path=args.baseline,
    update_baseline=args.update_baseline,
    select=args.select, as_json=args.as_json,
  )
