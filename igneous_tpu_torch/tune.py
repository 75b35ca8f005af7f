"""Tuned kernel knobs per device kind, and the sweep that finds them: the
port's counterpart of ``igneous_tpu/tune.py``.

``python -m igneous_tpu_torch tune`` sweeps candidate values of the port's
performance knobs on seeded workloads, holds every candidate's output
byte for byte against the default's (the knobs cannot change an output;
a difference is a kernel fault and fails the sweep), and writes the
winners, each faster than the default, as ``tuned/<device_kind>.json``.

The knobs: ``IGNEOUS_CCL_TILE`` (the tile of ``tile_resolve``),
``IGNEOUS_PAGE_SHAPE`` and ``IGNEOUS_PAGE_BATCH`` (the page packer's page
and pages a round). The JAX package also sweeps ``IGNEOUS_EDT_LINE_BLOCK``;
the port's EDT has no such knob (its kernel sizes its blocks from the
line length).

Resolution, everywhere the knobs are read (``ops.ccl._tile_shape``,
``parallel.paged.page_shape`` and ``page_round_cap``)::

    the environment  >  tuned/<device_kind>.json  >  the default

The tuned file's root is ``IGNEOUS_TUNE_CONFIG`` when set, else
``IGNEOUS_COMPILE_CACHE`` (beside the library store). ``device_kind`` is
``torch.cuda.get_device_name(0)`` with every run of characters other than
letters, digits, ``.``, ``_`` and ``-`` made one ``_`` (an H100 SXM is
``NVIDIA_H100_80GB_HBM3``) on the card, and ``cpu`` where the port runs
on the CPU.
"""

from __future__ import annotations

import json
import re
import time
from typing import Callable, Dict, List, Optional

import torch

from .analysis import knobs

CONFIG_ENV = "IGNEOUS_TUNE_CONFIG"
TUNED_PREFIX = "tuned/"
TUNABLE = ("IGNEOUS_CCL_TILE", "IGNEOUS_PAGE_SHAPE", "IGNEOUS_PAGE_BATCH")
_DEFAULT_REPEATS = 2


def device_kind() -> str:
  """The card's name, sanitised for a file name; ``cpu`` on the CPU."""
  from .device import get_device

  if get_device().type != "cuda":
    return "cpu"
  name = torch.cuda.get_device_name(0)
  return re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("_") or "unknown"


def config_root() -> Optional[str]:
  return ((knobs.get_str(CONFIG_ENV) or "").strip()
          or (knobs.get_str("IGNEOUS_COMPILE_CACHE") or "").strip() or None)


# (root, device kind) -> the tuned config or None: read once, since the
# knobs are resolved on hot paths (every page_shape() call)
_CONFIG: Dict[tuple, Optional[dict]] = {}


def tuned_config() -> Optional[dict]:
  """The active ``tuned/<device_kind>.json``; None when no root is set,
  the file is absent, or it does not parse (a bad tuned file never takes
  a worker down: the defaults stand)."""
  root = config_root()
  if not root:
    return None
  key = (root, device_kind())
  if key not in _CONFIG:
    from .storage import CloudFiles

    try:
      cfg = CloudFiles(root).get_json(f"{TUNED_PREFIX}{key[1]}.json")
    except (OSError, ValueError):
      cfg = None
    if not (isinstance(cfg, dict) and isinstance(cfg.get("knobs"), dict)):
      cfg = None
    _CONFIG[key] = cfg
  return _CONFIG[key]


def reset_cache() -> None:
  """Forget the tuned configs read so far."""
  _CONFIG.clear()


def resolve(name: str) -> Optional[str]:
  """The string value of a tunable knob: the environment's, else the
  tuned file's, else None (the caller applies its default). Callers keep
  their own parsing and errors."""
  val = (knobs.raw(name) or "").strip()
  if val:
    return val
  cfg = tuned_config()
  if cfg:
    tuned = cfg["knobs"].get(name)
    if tuned is not None:
      return str(tuned)
  return None


# ---------------------------------------------------------------------------
# the sweep


def candidates(backend: str) -> Dict[str, List[str]]:
  """Candidate values per knob; "" is the default, swept first: the
  byte-identity reference and the time a winner must beat. On the card
  the CCL tiles are the default, the other tiles with a kernel instance
  of their own (``cuda_ccl.FIXED_TILES``) and two that take the instance
  with runtime extents, all within one block's shared memory."""
  from .ops import cuda_ccl

  if backend == "cuda":
    fixed = [t for t in cuda_ccl.FIXED_TILES if t != (16, 16, 32)]
    tiles = fixed + [(16, 16, 64), (8, 8, 32)]
  else:
    tiles = [(4, 8, 8), (4, 8, 16), (8, 16, 16)]
  if not all(cuda_ccl.fits_shared_memory(t) for t in tiles):
    raise ValueError(f"a CCL tile candidate exceeds a block's shared memory: {tiles}")
  return {
    "IGNEOUS_CCL_TILE": [""] + [",".join(str(v) for v in t) for t in tiles],
    "IGNEOUS_PAGE_SHAPE": ["", "16,16,16", "64,64,64"],
    "IGNEOUS_PAGE_BATCH": ["", "16", "64"],
  }


def _workloads(size: int) -> Dict[str, Callable[[], bytes]]:
  """One seeded workload per knob, each returning its output bytes and
  reading the knob through its real resolution path."""
  import numpy as np

  rng = np.random.default_rng(19)
  s = max(int(size), 16)
  ccl_batch = rng.integers(0, 5, (2, s, s, s)).astype(np.int32)

  def run_ccl() -> bytes:
    from .ops import ccl

    outs = ccl.connected_components_batch(ccl_batch, 6, executor=ccl._batch_executor(6))
    return b"".join(np.asarray(o).tobytes() for o in outs)

  ragged = [
    rng.integers(0, 255, (s, s - 7, s // 2 + 1)).astype(np.uint8),
    rng.integers(0, 255, (s // 2, s // 2, s // 2)).astype(np.uint8),
    rng.integers(0, 255, (s - 5, s // 3, 9)).astype(np.uint8),
  ]

  def run_paged() -> bytes:
    from .parallel import paged

    results = paged.paged_pyramid(ragged, (2, 2, 1), num_mips=2)
    return b"".join(np.asarray(m).tobytes() for mips in results for m in mips)

  return {
    "IGNEOUS_CCL_TILE": run_ccl,
    "IGNEOUS_PAGE_SHAPE": run_paged,
    "IGNEOUS_PAGE_BATCH": run_paged,
  }


class _env_pin:
  """Set one knob ("" unsets it) for a candidate's runs, and restore it."""

  def __init__(self, name: str, value: str):
    self.name, self.value = name, value

  def __enter__(self):
    self.prev = knobs.raw(self.name)
    if self.value:
      knobs.set_env(self.name, self.value)
    else:
      knobs.del_env(self.name)

  def __exit__(self, *exc):
    if self.prev is None:
      knobs.del_env(self.name)
    else:
      knobs.set_env(self.name, self.prev)


def run(
  out: Optional[str] = None,
  budget_sec: Optional[float] = None,
  repeats: Optional[int] = None,
  size: int = 48,
  only: Optional[List[str]] = None,
  strict: bool = True,
  log: Callable[[str], None] = lambda _msg: None,
) -> dict:
  """Sweep the knobs' candidates on this device kind and write the
  winners.

  Per candidate: pin the knob, run the workload once (builds and warm-up
  land there), then time ``repeats`` runs (best of; default
  ``IGNEOUS_TUNE_REPEATS`` or 2). Every output must equal the default's
  byte for byte; with ``strict`` a difference raises. ``budget_sec``
  (default ``IGNEOUS_TUNE_BUDGET_SEC``, unset: none) bounds the sweep:
  candidates after the deadline are recorded as skipped and the defaults
  stand. Returns the tuned config, also written to
  ``<out or config root>/tuned/<device_kind>.json`` where a root is
  known (and then read back by ``resolve`` in this process)."""
  from .device import get_device

  backend = get_device().type
  if repeats is None:
    repeats = int(knobs.raw("IGNEOUS_TUNE_REPEATS") or _DEFAULT_REPEATS)
  repeats = max(int(repeats), 1)
  if budget_sec is None and knobs.raw("IGNEOUS_TUNE_BUDGET_SEC"):
    budget_sec = float(knobs.raw("IGNEOUS_TUNE_BUDGET_SEC"))
  deadline = time.monotonic() + float(budget_sec) if budget_sec else None
  cand = candidates(backend)
  work = _workloads(size)
  names = [n for n in TUNABLE if not only or n in only]

  winners: Dict[str, str] = {}
  measurements: Dict[str, list] = {}
  default_total = best_total = 0.0
  for name in names:
    fn = work[name]
    rows = []
    ref_bytes = None
    for value in cand[name]:
      if deadline is not None and time.monotonic() > deadline and value != "":
        rows.append({"value": value, "skipped": "budget exhausted"})
        continue
      try:
        with _env_pin(name, value):
          got = fn()
          best = None
          for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
      except ValueError as exc:
        # a candidate the geometry refuses (a page the factors do not
        # divide) is a skip: the checks are doing their job
        rows.append({"value": value, "skipped": str(exc)})
        continue
      if value == "":
        ref_bytes = got
      identical = ref_bytes is not None and got == ref_bytes
      if not identical and strict:
        raise AssertionError(
          f"{name}={value!r} output differs from the default's: tunables "
          "must be byte-identical; refusing to tune"
        )
      rows.append({"value": value, "seconds": best, "identical": identical})
      log(f"{name}={value or '<default>'}: {best:.6f}s"
          f"{'' if identical else ' (NOT byte-identical!)'}")
    measurements[name] = rows
    default_row = next((r for r in rows if r["value"] == "" and "seconds" in r), None)
    if default_row is None:
      continue
    timed = [r for r in rows if r.get("identical")]
    winner = min(timed, key=lambda r: r["seconds"])
    default_total += default_row["seconds"]
    best_total += min(winner["seconds"], default_row["seconds"])
    if winner["value"] and winner["seconds"] < default_row["seconds"]:
      winners[name] = winner["value"]
      log(f"{name}: tuned -> {winner['value']} "
          f"({default_row['seconds']:.6f}s -> {winner['seconds']:.6f}s)")

  config = {
    "version": 1,
    "device_kind": device_kind(),
    "backend": backend,
    "torch": str(torch.__version__),
    "created": time.time(),
    "knobs": winners,
    "measurements": measurements,
    "default_s": default_total,
    "best_s": best_total,
    "tune_best_vs_default_ratio": best_total / default_total if default_total else None,
  }
  root = out or config_root()
  if root:
    from .storage import CloudFiles

    CloudFiles(root).put(f"{TUNED_PREFIX}{device_kind()}.json",
                         json.dumps(config, sort_keys=True))
    config["written_to"] = f"{root}/{TUNED_PREFIX}{device_kind()}.json"
    reset_cache()
  return config
