"""The port's static analysis and knob registry against the JAX package's.

Every fixture case of ``tests/test_analysis.py`` runs through both
packages' passes, the fixture written under ``igneous_tpu/`` for the JAX
pass and under ``igneous_tpu_torch/`` for the port's: the findings'
codes, lines and keys are equal. For ``recompile`` the fixtures are
translated (``jax.jit`` becomes ``torch.compile``, the JAX pass's
``jit-in-`` keys the port's ``compile-in-``), and the JAX pass's IGN203
and IGN204 (host syncs and traced shapes in a jit body) have no
counterpart. The registry: every knob the two packages share has the JAX
package's type and default, and the accessors give the JAX accessors'
values on unset, set and malformed values; every site moved onto the
registry gives what its former reader gave. The tree: ``python -m
igneous_tpu_torch lint`` exits 0 with an empty baseline, its
``--knobs-md`` is the README's port block, and the JAX package's lint and
README check stay green. The race checker raises on an unlocked write.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from igneous_tpu.analysis import (
  determinism as jax_determinism,
  env_knobs as jax_env_knobs,
  findings as jax_findings,
  knobs as jax_knobs,
  locks as jax_locks,
  recompile as jax_recompile,
  runner as jax_runner,
  telemetry_names as jax_telemetry_names,
)
from igneous_tpu_torch import device
from igneous_tpu_torch.analysis import (
  determinism,
  discovery,
  env_knobs,
  findings,
  knobs,
  locks,
  racecheck,
  recompile,
  runner,
  telemetry_names,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PASSES = {
  "env-knobs": (jax_env_knobs, env_knobs),
  "recompile": (jax_recompile, recompile),
  "locks": (jax_locks, locks),
  "determinism": (jax_determinism, determinism),
  "telemetry": (jax_telemetry_names, telemetry_names),
}

_LOCKS_FIXTURE = """\
  import threading

  class Cache:
    def __init__(self):
      self._lock = threading.Lock()
      self._not_full = threading.Condition(self._lock)
      self._items = []     # guarded-by: self._lock
      self._bytes = 0      # guarded-by: self._lock

    def good(self, x):
      with self._lock:
        self._items.append(x)
        self._bytes += 1

    def good_condition_alias(self):
      with self._not_full:
        self._bytes -= 1

    def _drain_locked(self):
      self._items.clear()

    def good_holds(self):
      # holds: self._lock
      self._items.pop()

    def bad_write(self):
      self._bytes = 0

    def bad_mutator(self, x):
      self._items.append(x)
"""

# (pass, path under igneous_tpu/, source): the fixture cases of
# tests/test_analysis.py
FIXTURES = [
  ("env-knobs", "igneous_tpu/mod.py", """\
    import os
    from igneous_tpu.analysis import knobs

    NAME = "IGNEOUS_PIPELINE"

    def f():
      a = os.environ.get("IGNEOUS_PIPELINE")        # IGN101
      b = os.environ["IGNEOUS_CHUNK_CACHE"]         # IGN101
      c = os.getenv(NAME)                           # IGN105
      d = os.environ[NAME]                          # IGN105
      e = register("IGNEOUS_TOTALLY_FAKE_KNOB")     # IGN102
      g = knobs.get_float("IGNEOUS_CHUNK_CACHE_MB", 1.0)  # IGN104
      return a, b, c, d, e, g
  """),
  ("env-knobs", "igneous_tpu/mod.py", """\
    import os
    from igneous_tpu.analysis import knobs

    def f(env):
      os.environ["IGNEOUS_PIPELINE"] = "off"
      os.environ.setdefault("IGNEOUS_PIPELINE", "off")
      os.environ.pop("IGNEOUS_PIPELINE", None)
      env["IGNEOUS_PIPELINE"] = "off"
      a = knobs.get_str("IGNEOUS_PIPELINE")
      b = knobs.get_bool("IGNEOUS_RACE_CHECK")
      c = knobs.raw("IGNEOUS_PAGE_SHAPE")
      d = os.environ.get("HOME")
      return a, b, c, d
  """),
  ("env-knobs", "igneous_tpu/analysis/knobs.py", """\
    import os

    def raw(name):
      return os.environ.get(name)

    def get_str():
      return os.environ.get("IGNEOUS_PIPELINE")
  """),
  ("env-knobs", "igneous_tpu/mod.py", """\
    import os

    a = os.environ.get("IGNEOUS_PIPELINE")  # lint: allow=IGN101 pinned
    # lint: allow=IGN101 preceding-line form
    b = os.environ.get("IGNEOUS_CHUNK_CACHE")
    c = os.environ.get("IGNEOUS_JOURNAL")  # lint: allow=ALL wildcard

    d = os.environ.get("IGNEOUS_SIM_SEED")  # lint: allow=IGN105 wrong code
  """),
  ("recompile", "igneous_tpu/ops/mod.py", """\
    from functools import partial
    import jax
    import jax.numpy as jnp

    def per_call(x, fn):
      g = jax.jit(fn)                     # IGN201
      return g(x)

    def per_iter(xs, fn):
      out = []
      for x in xs:
        g = jax.jit(fn)                   # IGN202
        out.append(g(x))
      return out

    @jax.jit
    def syncs(x):
      y = x.sum().item()                  # IGN203
      z = float(x.mean())                 # IGN203
      return y + z

    @partial(jax.jit, static_argnames=("n",))
    def shapes(x, n, m):
      return jnp.zeros((n, 3)) + jnp.zeros((m, 3))   # IGN204 (m only)
  """),
  ("recompile", "igneous_tpu/parallel/mod.py", """\
    import functools
    from functools import partial
    import jax
    import jax.numpy as jnp

    module_level = jax.jit(lambda x: x + 1)

    @functools.lru_cache(maxsize=None)
    def cached_builder(key, fn):
      return jax.jit(fn)

    class PagedRunner:
      def _compile(self, sig, fn):
        self._fns[sig] = jax.jit(fn)      # signature-cache slot
        return self._fns[sig]

    @partial(jax.jit, static_argnames=("n",))
    def static_shapes(x, n):
      a = jnp.zeros((n, 3))               # n is static
      b = jnp.zeros(x.shape)              # attribute chain: static ints
      return a + b

    def host_side(x):
      return float(x)                     # no jit decorator: no IGN203
  """),
  ("recompile", "igneous_tpu/other/mod.py", """\
    import jax

    def per_call(x, fn):
      return jax.jit(fn)(x)
  """),
  ("locks", "igneous_tpu/mod.py", _LOCKS_FIXTURE),
  ("locks", "igneous_tpu/mod.py", """\
    import threading

    class C:
      def __init__(self):
        self._lock = threading.Lock()
        count = 0  # guarded-by: self._lock
  """),
  ("locks", "igneous_tpu/mod.py", """\
    import threading

    class C:
      def __init__(self):
        self._lock = threading.Lock()
        self._items = []  # guarded-by: self._lock

      def spawn(self):
        with self._lock:
          def worker():
            self._items.append(1)
          return worker
  """),
  ("determinism", "igneous_tpu/observability/sim.py", """\
    import glob
    import os
    import random
    import time
    from datetime import datetime

    def tick():
      return time.time()                        # IGN401

    def stamp():
      return datetime.now()                     # IGN401

    def pick(items):
      return random.choice(items)               # IGN402

    def scan(path, items):
      for f in os.listdir(path):                # IGN403
        pass
      for x in set(items):                      # IGN403
        pass

    def late(t=time.time()):                    # IGN404
      return t
  """),
  ("determinism", "igneous_tpu/observability/replay.py", """\
    import os
    import random

    def seeded(seed, items, path):
      rng = random.Random(seed)                 # sanctioned ctor
      rng.shuffle(items)                        # instance call: fine
      for f in sorted(os.listdir(path)):        # sorted listing: fine
        pass
      return rng.random()
  """),
  ("determinism", "igneous_tpu/mod.py", """\
    import time

    def tick():
      return time.time()
  """),
  ("telemetry", "igneous_tpu/mod.py", """\
    from igneous_tpu import telemetry

    def f(name, kind):
      telemetry.incr("bogus.thing")             # IGN501 unknown subsystem
      telemetry.span(f"{kind}.run")             # IGN501 dynamic subsystem
      telemetry.stage("two words")              # IGN501 stage grammar
      telemetry.incr(name)                      # IGN503 non-literal
      telemetry.gauge_set("pipeline.depth_total", 1)
      telemetry.incr("pipeline.depth")          # IGN502 family collision
  """),
  ("telemetry", "igneous_tpu/mod.py", """\
    from igneous_tpu import telemetry

    def f(kind, sec):
      telemetry.incr("tasks.done")
      telemetry.observe("queue.lease.seconds", sec)
      telemetry.incr(f"tasks.{kind}.done")      # placeholder after subsys
      telemetry.gauge_set("pipeline.depth", 2)
      telemetry.span("device.execute")
      telemetry.stage("encode")
  """),
  ("telemetry", "igneous_tpu/telemetry.py", """\
    def incr(name, n=1):
      record(name, n)

    def forward(name):
      incr(name)
  """),
]


def _run(pass_mod, findings_mod, root, rel, source):
  path = os.path.join(root, rel)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    f.write(textwrap.dedent(source))
  return pass_mod.run(findings_mod.Context(root), [path])


def _port_source(pass_name: str, source: str) -> str:
  if pass_name == "recompile":
    source = source.replace("jax.jit", "torch.compile").replace(
      "import jax\n", "import torch\n")
  return source


def _port_key(pass_name: str, key: str) -> str:
  if pass_name == "recompile":
    return key.replace("jit-in-", "compile-in-")
  return key


@pytest.mark.parametrize("case", range(len(FIXTURES)))
def test_fixture_findings_equal_the_reference(case, tmp_path):
  pass_name, rel, source = FIXTURES[case]
  jax_pass, port_pass = PASSES[pass_name]
  got = _run(port_pass, findings, str(tmp_path / "port"),
             "igneous_tpu_torch/" + rel[len("igneous_tpu/"):],
             _port_source(pass_name, source))
  exp = _run(jax_pass, jax_findings, str(tmp_path / "jax"), rel, source)
  if pass_name == "recompile":  # no traced bodies in eager PyTorch
    exp = [f for f in exp if f.code not in ("IGN203", "IGN204")]
  assert [(f.code, f.line, f.key) for f in got] == [
    (f.code, f.line, _port_key(pass_name, f.key)) for f in exp]


def test_recompile_finds_every_torch_compiler(tmp_path):
  found = _run(recompile, findings, str(tmp_path), "igneous_tpu_torch/infer/mod.py", """\
    import functools
    import torch

    scripted = torch.jit.script(lambda x: x)

    def per_call(model, x):
      return torch.jit.trace(model, x)

    def per_iter(models):
      return [torch.jit.script(m) for m in models]

    def per_loop(models):
      out = []
      for m in models:
        out.append(torch.compile(m))
      return out

    @functools.cache
    def cached(model):
      return torch.compile(model)
  """)
  assert [(f.code, f.key) for f in found] == [
    ("IGN201", "compile-in-function:per_call"),
    ("IGN201", "compile-in-function:per_iter"),
    ("IGN202", "compile-in-loop:per_loop"),
  ]


# -- the knob registry ------------------------------------------------------------


def test_shared_knobs_have_the_reference_type_and_default():
  shared = [n for n in knobs.KNOBS if n in jax_knobs.KNOBS]
  assert set(knobs.KNOBS) - set(shared) == {"IGNEOUS_TORCH_DEVICE"}
  for name in shared:
    a, b = knobs.KNOBS[name], jax_knobs.KNOBS[name]
    assert (a.type, a.default, a.section) == (b.type, b.default, b.section), name


def test_every_knob_the_port_mentions_is_registered():
  """Every ``IGNEOUS_*`` name in the port's sources and chip_smoke.py is
  a registered knob (docstrings name two the port does not read, and the
  serving tier's docs name its knob families by prefix)."""
  names = set()
  for path in discovery.iter_source_files(REPO):
    names |= set(re.findall(r"IGNEOUS_[A-Z0-9_]*[A-Z0-9]", open(path).read()))
  unread = {"IGNEOUS_EDT_BACKEND", "IGNEOUS_EDT_LINE_BLOCK", "IGNEOUS_SERVE",
            "IGNEOUS_SERVE_FLEET", "IGNEOUS_SERVE_QOS"}
  assert names - unread == set(knobs.KNOBS)


VALUES = [None, "", "0", "1", "7", "2.5", "-3", "1e3", "junk", "off", "No", "yes", " 4 "]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_accessors_parse_as_the_reference(value, monkeypatch):
  for name in knobs.KNOBS:
    if name == "IGNEOUS_TORCH_DEVICE":
      continue
    if value is None:
      monkeypatch.delenv(name, raising=False)
    else:
      monkeypatch.setenv(name, value)
    for get in ("raw", "get_str", "get_int", "get_float", "opt_float", "get_bool"):
      kind = knobs.KNOBS[name].type
      if get in ("get_int", "get_float") and kind in ("str", "shape"):
        continue  # a number accessor on a string knob's text default
      assert getattr(knobs, get)(name) == getattr(jax_knobs, get)(name), (name, get, value)


def test_unregistered_knob_raises():
  with pytest.raises(KeyError, match="unregistered knob"):
    knobs.get_str("IGNEOUS_NOT_A_KNOB")


def test_registered_writes(monkeypatch):
  monkeypatch.delenv("IGNEOUS_STEAL", raising=False)
  knobs.set_env("IGNEOUS_STEAL", 1)
  assert os.environ["IGNEOUS_STEAL"] == "1"
  knobs.del_env("IGNEOUS_STEAL")
  assert "IGNEOUS_STEAL" not in os.environ
  with pytest.raises(KeyError):
    knobs.set_env("IGNEOUS_NOT_A_KNOB", "1")


# -- the sites moved onto the registry, against their former readers --------------

_FALSE = ("0", "off", "false", "no")


def old_env_number(name, default, cast):
  """The reader the moved sites used before (``secrets.env_number``)."""
  val = os.environ.get(name, "")
  if val != "":
    try:
      return cast(float(val))
    except ValueError:
      pass
  return default


def old_env_flag(name, default):
  """The former ``secrets.env_flag``."""
  val = os.environ.get(name, "")
  if val == "":
    return default
  return val.strip().lower() not in _FALSE


def _old_chunk_cache_budget():
  try:
    mb = float(os.environ.get("IGNEOUS_CHUNK_CACHE_MB", "") or 0)
  except ValueError:
    mb = 0.0
  if mb:
    return max(int(mb * 1e6), 1)
  from igneous_tpu_torch.pipeline import config

  return max(config.memory_budget_bytes() // 8, 1)


def _old_scratch_compression():
  from igneous_tpu_torch.storage import COMPRESSION_EXTS, zstandard

  val = os.environ.get("IGNEOUS_SCRATCH_COMPRESS", "").strip().lower()
  if not val:
    return "gzip"
  if val in ("none", "raw", "0", "off"):
    return None
  if val == "zstd":
    return "gzip" if zstandard is None else "zstd"
  if val == "gzip" or (val.startswith("gzip-") and val in COMPRESSION_EXTS):
    return val
  raise ValueError(val)


def _old_pipeline_enabled(default):
  val = os.environ.get("IGNEOUS_PIPELINE", "").strip().lower()
  if val in ("1", "on", "true", "yes"):
    return True
  if val in _FALSE:
    return False
  return bool(default)


def _old_use_threads():
  from igneous_tpu_torch.pipeline import config

  val = os.environ.get("IGNEOUS_PIPELINE_THREADS", "").strip().lower()
  if val in ("1", "on", "true", "yes"):
    return True
  if val in _FALSE:
    return False
  return config._cores() > 1


def _old_threads(name, fallback):
  env = old_env_number(name, None, int)
  return max(env, 1) if env else fallback


def _old_memory_budget():
  mb = old_env_number("IGNEOUS_PIPELINE_MEM_MB", None, float)
  if mb:
    return max(int(mb * 1e6), 1)
  return int(3.5e9)


def _old_tune_config_root():
  return (os.environ.get("IGNEOUS_TUNE_CONFIG", "").strip()
          or os.environ.get("IGNEOUS_COMPILE_CACHE", "").strip() or None)


def _old_device():
  return os.environ.get("IGNEOUS_TORCH_DEVICE", "").strip() or "cuda"


def _sites():
  from igneous_tpu_torch import chunk_cache, integrity, retry, secrets, storage
  from igneous_tpu_torch import storage_gcs, storage_s3, tune
  from igneous_tpu_torch.lifecycle import PreemptionWatcher, StopFlag
  from igneous_tpu_torch.pipeline import config
  from igneous_tpu_torch.queues import filequeue
  from igneous_tpu_torch.tasks import image

  def watcher():
    w = PreemptionWatcher(StopFlag())
    return (w.sentinel, w.metadata_url, w.interval)

  def old_watcher():
    return (os.environ.get("IGNEOUS_PREEMPT_SENTINEL") or None,
            os.environ.get("IGNEOUS_PREEMPT_URL") or None,
            old_env_number("IGNEOUS_PREEMPT_POLL_SEC", 1.0, float))

  def policy():
    p = retry.RetryPolicy.from_env()
    return (p.attempts, p.base_s, p.cap_s, p.budget_s)

  def old_policy():
    return (old_env_number("IGNEOUS_RETRY_ATTEMPTS", 6, int),
            old_env_number("IGNEOUS_RETRY_BASE_S", 0.25, float),
            old_env_number("IGNEOUS_RETRY_CAP_S", 30.0, float),
            old_env_number("IGNEOUS_RETRY_BUDGET_S", 120.0, float))

  return {
    "IGNEOUS_CHUNK_CACHE": (chunk_cache.enabled, lambda: os.environ.get(
      "IGNEOUS_CHUNK_CACHE", "").strip().lower() not in _FALSE),
    "IGNEOUS_CHUNK_CACHE_MB": (chunk_cache.budget_bytes, _old_chunk_cache_budget),
    "IGNEOUS_SCRATCH_COMPRESS": (storage.scratch_compression, _old_scratch_compression),
    "IGNEOUS_TRANSFER_PASSTHROUGH": (image._passthrough_enabled, lambda: old_env_flag(
      "IGNEOUS_TRANSFER_PASSTHROUGH", True)),
    "IGNEOUS_TUNE_CONFIG": (tune.config_root, _old_tune_config_root),
    "IGNEOUS_COMPILE_CACHE": (tune.config_root, _old_tune_config_root),
    "IGNEOUS_TORCH_DEVICE": (lambda: (knobs.get_str(device.ENV) or "").strip() or "cuda",
                             _old_device),
    "IGNEOUS_PREEMPT_SENTINEL": (watcher, old_watcher),
    "IGNEOUS_PREEMPT_URL": (watcher, old_watcher),
    "IGNEOUS_PREEMPT_POLL_SEC": (watcher, old_watcher),
    "IGNEOUS_PIPELINE": (lambda: (config.enabled(True), config.enabled(False)),
                         lambda: (_old_pipeline_enabled(True), _old_pipeline_enabled(False))),
    "IGNEOUS_PIPELINE_THREADS": (config.use_threads, _old_use_threads),
    "IGNEOUS_PIPELINE_MEM_MB": (config.memory_budget_bytes, _old_memory_budget),
    "IGNEOUS_PIPELINE_PREFETCH": (config.prefetch_depth, lambda: max(
      2 if old_env_number("IGNEOUS_PIPELINE_PREFETCH", None, int) is None
      else old_env_number("IGNEOUS_PIPELINE_PREFETCH", None, int), 1)),
    "IGNEOUS_PIPELINE_IO_THREADS": (config.io_threads, lambda: _old_threads(
      "IGNEOUS_PIPELINE_IO_THREADS", min(8, config._cores() * 2))),
    "IGNEOUS_PIPELINE_ENCODE_THREADS": (config.encode_threads, lambda: _old_threads(
      "IGNEOUS_PIPELINE_ENCODE_THREADS", min(8, max(config._cores(), 1)))),
    "IGNEOUS_S3_MULTIPART_THRESHOLD": (storage_s3._multipart_threshold, lambda: old_env_number(
      "IGNEOUS_S3_MULTIPART_THRESHOLD", 64 * 1024 * 1024, int)),
    "IGNEOUS_S3_MULTIPART_CHUNK": (storage_s3._multipart_chunk, lambda: old_env_number(
      "IGNEOUS_S3_MULTIPART_CHUNK", 32 * 1024 * 1024, int)),
    "IGNEOUS_GCS_RESUMABLE_THRESHOLD": (storage_gcs._resumable_threshold, lambda: old_env_number(
      "IGNEOUS_GCS_RESUMABLE_THRESHOLD", 8 * 1024 * 1024, int)),
    "IGNEOUS_GCS_UPLOAD_CHUNK": (storage_gcs._upload_chunk, lambda: old_env_number(
      "IGNEOUS_GCS_UPLOAD_CHUNK", 8 * 1024 * 1024, int)),
    "IGNEOUS_INTEGRITY": (integrity.enabled, lambda: old_env_flag("IGNEOUS_INTEGRITY", True)),
    "IGNEOUS_INTEGRITY_BATCH": (lambda: knobs.get_int("IGNEOUS_INTEGRITY_BATCH"),
                                lambda: old_env_number("IGNEOUS_INTEGRITY_BATCH", 256, int)),
    "IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE": (
      lambda: knobs.get_bool("IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE"),
      lambda: old_env_flag("IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE", False)),
    "IGNEOUS_QUEUE_SEG_TASKS": (lambda: knobs.get_int("IGNEOUS_QUEUE_SEG_TASKS"),
                                lambda: old_env_number("IGNEOUS_QUEUE_SEG_TASKS",
                                                       filequeue.DEFAULT_SEG_TASKS, int)),
    "IGNEOUS_QUEUE_SHARDS": (lambda: knobs.get_int("IGNEOUS_QUEUE_SHARDS"),
                             lambda: old_env_number("IGNEOUS_QUEUE_SHARDS",
                                                    filequeue.DEFAULT_QUEUE_SHARDS, int)),
    "IGNEOUS_QUEUE_RECYCLE_SEC": (lambda: knobs.get_float("IGNEOUS_QUEUE_RECYCLE_SEC"),
                                  lambda: old_env_number("IGNEOUS_QUEUE_RECYCLE_SEC",
                                                         filequeue.DEFAULT_RECYCLE_SEC, float)),
    "IGNEOUS_RETRY_ATTEMPTS": (policy, old_policy),
    "IGNEOUS_RETRY_BASE_S": (policy, old_policy),
    "IGNEOUS_RETRY_CAP_S": (policy, old_policy),
    "IGNEOUS_RETRY_BUDGET_S": (policy, old_policy),
    "IGNEOUS_HEARTBEAT_SEC": (secrets.heartbeat_seconds, lambda: old_env_number(
      "IGNEOUS_HEARTBEAT_SEC", None, float)),
    "IGNEOUS_TPU_SECRETS": (secrets.secrets_dir, lambda: os.environ.get(
      "IGNEOUS_TPU_SECRETS") or os.path.expanduser("~/.cloudfiles/secrets")),
    "IGNEOUS_TUNE_REPEATS": (lambda: int(knobs.raw("IGNEOUS_TUNE_REPEATS") or 2),
                             lambda: int(os.environ.get("IGNEOUS_TUNE_REPEATS") or 2)),
    "IGNEOUS_TUNE_BUDGET_SEC": (
      lambda: float(knobs.raw("IGNEOUS_TUNE_BUDGET_SEC")) if knobs.raw(
        "IGNEOUS_TUNE_BUDGET_SEC") else None,
      lambda: float(os.environ["IGNEOUS_TUNE_BUDGET_SEC"]) if os.environ.get(
        "IGNEOUS_TUNE_BUDGET_SEC") else None),
  }


SITE_VALUES = [None, "", "0", "1", "3", "2.5", "junk", "off", "on", "yes", "gzip-3", "none",
               "zstd", " cpu ", "file:///tmp/x"]


def _outcome(fn):
  try:
    return ("ok", fn())
  except (ValueError, TypeError) as exc:
    return (type(exc).__name__, None)


@pytest.mark.parametrize("name", sorted(_sites()))
def test_moved_site_keeps_its_default_and_parse(name, monkeypatch):
  new, old = _sites()[name]
  for value in SITE_VALUES:
    if value is None:
      monkeypatch.delenv(name, raising=False)
    else:
      monkeypatch.setenv(name, value)
    assert _outcome(new) == _outcome(old), (name, value)


# -- the tree -------------------------------------------------------------------


def test_port_lint_is_green_on_the_tree():
  proc = subprocess.run([sys.executable, "-m", "igneous_tpu_torch", "lint"], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, PYTHONPATH=REPO))
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert proc.stdout.strip().splitlines()[-1] == (
    "igneous_tpu_torch lint: 0 finding(s), 0 baselined, 0 stale baseline entr(ies)")


def test_port_baseline_is_empty_and_env_telemetry_clean():
  with open(os.path.join(REPO, runner.DEFAULT_BASELINE)) as f:
    assert json.load(f)["entries"] == []
  found = runner.run_passes(REPO, select=("env-knobs", "telemetry"))
  assert found == []


def test_knobs_md_is_the_readme_block(capsys):
  from igneous_tpu_torch.cli import main

  assert main(["lint", "--knobs-md"]) == 0
  out = capsys.readouterr().out
  assert out == knobs.knobs_markdown()
  text = open(os.path.join(REPO, "README.md")).read()
  start, end = text.index(knobs.BEGIN_MARK), text.index(knobs.END_MARK)
  assert text[start:end + len(knobs.END_MARK)] + "\n" == out
  assert runner.readme_check(REPO) == []


def test_port_markers_leave_the_reference_table_alone():
  for mark in (jax_knobs.BEGIN_MARK, jax_knobs.END_MARK):
    assert mark not in knobs.BEGIN_MARK and mark not in knobs.END_MARK
  assert jax_runner.readme_check(REPO) == []


def test_port_readme_drift_detected(tmp_path):
  md = knobs.knobs_markdown()
  (tmp_path / "README.md").write_text("# x\n\n" + md.replace("| str |", "| int |", 1))
  assert [f.code for f in runner.readme_check(str(tmp_path))] == ["IGN103"]
  (tmp_path / "README.md").write_text("# no markers\n")
  assert [f.code for f in runner.readme_check(str(tmp_path))] == ["IGN103"]


def test_scope_is_the_port_and_its_chip_script():
  files = [os.path.relpath(p, REPO) for p in discovery.iter_source_files(REPO)]
  assert "chip_smoke.py" in files
  assert os.path.join("igneous_tpu_torch", "analysis", "knobs.py") in files
  assert all(f == "chip_smoke.py" or f.startswith("igneous_tpu_torch" + os.sep)
             for f in files)


def test_update_baseline_refuses_env_and_telemetry(tmp_path):
  path = tmp_path / "igneous_tpu_torch" / "mod.py"
  path.parent.mkdir(parents=True)
  path.write_text('import os\n\nFLAG = os.environ.get("IGNEOUS_PIPELINE")\n')
  (tmp_path / "igneous_tpu_torch" / "analysis").mkdir()
  assert runner.main(str(tmp_path), update_baseline=True, echo=lambda *_: None) == 2
  assert not (tmp_path / runner.DEFAULT_BASELINE).exists()


def test_baseline_lifecycle(tmp_path):
  path = tmp_path / "igneous_tpu_torch" / "ops" / "hot.py"
  path.parent.mkdir(parents=True)
  path.write_text("import torch\n\ndef per_call(m, x):\n  return torch.compile(m)(x)\n")
  (tmp_path / "igneous_tpu_torch" / "analysis").mkdir()
  quiet = lambda *_: None  # noqa: E731
  assert runner.main(str(tmp_path), echo=quiet) == 1
  assert runner.main(str(tmp_path), update_baseline=True, echo=quiet) == 0
  with open(tmp_path / runner.DEFAULT_BASELINE) as f:
    assert json.load(f)["entries"] == [
      "IGN201 igneous_tpu_torch/ops/hot.py compile-in-function:per_call"]
  assert runner.main(str(tmp_path), echo=quiet) == 0
  path.write_text("HOT = None\n")
  assert runner.main(str(tmp_path), echo=quiet) == 1  # a stale entry


# -- the race checker -------------------------------------------------------------


def test_guard_raises_on_an_unlocked_write(monkeypatch):
  monkeypatch.setenv("IGNEOUS_RACE_CHECK", "1")
  lock = threading.Lock()
  p = racecheck.guard({}, lock, "Cache._entries")
  assert isinstance(p, racecheck.GuardedProxy)
  with lock:
    p["a"] = 1
    p.update(b=2)
    del p["b"]
  assert p["a"] == 1 and len(p) == 1 and "a" in p and list(p) == ["a"]
  with pytest.raises(AssertionError, match="Cache._entries"):
    p["c"] = 3
  with pytest.raises(AssertionError, match="race check"):
    p.update(c=3)
  monkeypatch.delenv("IGNEOUS_RACE_CHECK")
  d = {}
  assert racecheck.guard(d, lock, "x") is d


def test_guarded_structures_of_the_port_work_under_the_checker(monkeypatch):
  from igneous_tpu_torch.chunk_cache import ChunkDecodeCache
  from igneous_tpu_torch.queues.heartbeat import LeaseHeartbeat

  monkeypatch.setenv("IGNEOUS_RACE_CHECK", "1")
  cache = ChunkDecodeCache(budget=3 * 64)
  assert isinstance(cache._entries, racecheck.GuardedProxy)
  keys = [cache.make_key("file://x", 0, (i,), bytes([i])) for i in range(5)]
  for i, key in enumerate(keys):
    cache.put(key, np.full(64, i, np.uint8))
  assert cache.get(keys[0]) is None and cache.get(keys[-1]) is not None
  cache.invalidate("file://x")
  assert len(cache) == 0
  with pytest.raises(AssertionError, match="ChunkDecodeCache._entries"):
    cache._entries["k"] = 1
  hb = LeaseHeartbeat(object(), lease_seconds=30, interval=0)
  assert isinstance(hb.lost, racecheck.GuardedProxy)
  key = hb.track("lease-1")
  assert hb.current(key) == "lease-1"
  with pytest.raises(AssertionError, match="LeaseHeartbeat.lost"):
    hb.lost.add("x")
