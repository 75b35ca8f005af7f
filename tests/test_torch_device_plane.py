"""The port's device plane on the CPU: the device ledger and the tuner.

Ledger: the hand kernels' execute spans count what runs (on the CPU the
plain versions' calls; on the card, ``LAUNCHES``) through a batched
downsample and a batched CCL, and ``dispatches`` counts outermost spans;
the inference engine's pad-waste bytes equal the JAX package's ledger on
the same task; busy seconds are the union of the spans (nested spans and
two threads count a moment once); memory sampling is a no-op without a
card; the span code never synchronises the device.

Journal and profile: the ledger's ``{"kind": "device"}`` journal record
(only when it changed), its ``igneous_device_*`` gauges, the device spans
of the trace (under the active task, else on the worker trace, none when
the task is unsampled), a profile request published by either package
and served once by the port's CPU capture (``torch.profiler``, a Chrome
trace), a second capture refused while one runs, and ``fleet devices``
naming the card where the record names it (byte for byte the JAX
package's table where it does not).

Tuner: resolution is the environment, then ``tuned/<device_kind>.json``,
then the default, with ``IGNEOUS_TUNE_CONFIG`` before
``IGNEOUS_COMPILE_CACHE`` as the root and a bad tuned file ignored (as the
JAX package's ``tests/test_compile_cache.py`` holds its own); a tiny CPU
sweep is byte-identical for every candidate and writes
``tuned/cpu.json``; the command line refuses a pinned knob.
"""

import ast
import json
import os
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.infer import registry as jax_registry
from igneous_tpu.observability import device as jax_device
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu_torch import device, telemetry, tune
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.infer import registry
from igneous_tpu_torch.observability import device as ledger_mod
from igneous_tpu_torch.observability import journal as journal_mod
from igneous_tpu_torch.observability import prom, trace
from igneous_tpu_torch.observability.device import LEDGER, execute_span, transfer_span
from igneous_tpu_torch.ops import ccl, cuda_ccl, cuda_pooling
from igneous_tpu_torch.parallel import batch_runner, paged
from igneous_tpu_torch.queues import LocalTaskQueue

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for knob in (*tune.TUNABLE, tune.CONFIG_ENV, "IGNEOUS_COMPILE_CACHE",
               "IGNEOUS_PIPELINE", "IGNEOUS_TUNE_REPEATS", "IGNEOUS_TUNE_BUDGET_SEC"):
    monkeypatch.delenv(knob, raising=False)
  device.reset_device()
  tune.reset_cache()
  ledger_mod.reset()
  telemetry.reset_all()
  trace.reset()
  yield
  device.reset_device()
  tune.reset_cache()


def _count_calls(monkeypatch, module, name, counts):
  """Count the calls of ``module.name`` in ``counts[name]``."""
  orig = getattr(module, name)

  def counted(*a, **kw):
    counts[name] = counts.get(name, 0) + 1
    return orig(*a, **kw)

  monkeypatch.setattr(module, name, counted)


# ---------------------------------------------------------------------------
# counts


def test_batched_downsample_executes_equal_the_plain_calls(tmp_path, monkeypatch):
  """Every dispatch (a batch, a page round) is one outermost span; the
  kernels' spans count each plain call of their wrapper."""
  counts = {}
  inside = threading.local()
  orig_pyr, orig_pool = cuda_pooling.pyramid2x2x1_plain, cuda_pooling.pool2x2x1_plain

  def pyr(*a, **kw):
    counts["pyramid2x2x1"] = counts.get("pyramid2x2x1", 0) + 1
    inside.n = 1
    try:
      return orig_pyr(*a, **kw)
    finally:
      inside.n = 0

  def pool(*a, **kw):
    if not getattr(inside, "n", 0):
      counts["pool2x2x1"] = counts.get("pool2x2x1", 0) + 1
    return orig_pool(*a, **kw)

  monkeypatch.setattr(cuda_pooling, "pyramid2x2x1_plain", pyr)
  monkeypatch.setattr(cuda_pooling, "pool2x2x1_plain", pool)
  launches = dict(cuda_pooling.LAUNCHES)
  rng = np.random.default_rng(5)
  data = np.asfortranarray(rng.integers(0, 255, (151, 133, 21)).astype(np.uint8))
  JaxVolume.from_numpy(data, f"file://{tmp_path}", resolution=(8, 8, 40), chunk_size=(16, 16, 16))
  stats = batch_runner.batched_downsample(f"file://{tmp_path}", num_mips=3, shape=(64, 64, 16),
                                          batch_size=3)
  assert stats["batched_cutouts"] > 0 and stats["paged_cutouts"] > 0
  snap = LEDGER.snapshot()
  k = snap["kernels"]
  assert counts["pyramid2x2x1"] > 0 and counts["pool2x2x1"] > 0
  assert k["pyramid2x2x1"]["executes"] == counts["pyramid2x2x1"]
  assert k["pool2x2x1"]["executes"] == counts["pool2x2x1"]
  assert cuda_pooling.LAUNCHES == launches  # no kernel on the CPU
  assert snap["dispatches"] == stats["dispatches"]
  assert (k["pooling.pyramid[average]"]["executes"]
          + k["pooling.paged_pyramid[average]"]["executes"]) == stats["dispatches"]
  assert snap["h2d_bytes"] >= data.nbytes and snap["d2h_bytes"] > 0
  assert snap["fastpath"] == {"batched": stats["batched_cutouts"] + stats["paged_cutouts"],
                              "host": 0}
  # the page packer's slack, with no filler pages
  assert snap["real_bytes"] > 0 and 0 < snap["pad_waste_ratio"] < 8
  assert telemetry.gauges_snapshot()["device.pad_waste_ratio"] == snap["pad_waste_ratio"]
  assert snap["busy_s"] <= snap["wall_s"]


def test_batched_ccl_executes_equal_the_plain_calls(tmp_path, monkeypatch):
  counts = {}
  _count_calls(monkeypatch, cuda_ccl, "tile_resolve_plain", counts)
  rng = np.random.default_rng(7)
  data = np.asfortranarray(rng.integers(0, 255, (70, 60, 40)).astype(np.uint8))
  JaxVolume.from_numpy(data, f"file://{tmp_path}", resolution=(8, 8, 40),
                       chunk_size=(16, 16, 16), layer_type="segmentation")
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "8")
  stats = batch_runner.batched_ccl_faces(f"file://{tmp_path}", shape=(32, 32, 32),
                                         threshold_gte=120, batch_size=4)
  snap = LEDGER.snapshot()
  rounds = snap["kernels"]["ccl.paged"]["executes"]
  assert rounds > stats["dispatches"] > 0  # several page rounds a group
  assert snap["kernels"]["tile_resolve"]["executes"] == counts["tile_resolve_plain"] == rounds
  assert snap["dispatches"] == rounds
  assert snap["fastpath"]["batched"] == stats["batched_cutouts"]


def test_solo_ccl_and_downsample_spans(monkeypatch):
  """The solo paths: one outermost span a call, the copies around it."""
  counts = {}
  _count_calls(monkeypatch, cuda_ccl, "tile_resolve_plain", counts)
  lab = np.random.default_rng(1).integers(0, 3, (20, 17, 9)).astype(np.uint32)
  ccl.connected_components(lab)
  from igneous_tpu_torch.ops import pooling

  pooling.downsample(lab.astype(np.uint8), (2, 2, 1), 2)
  snap = LEDGER.snapshot()
  assert snap["dispatches"] == 2
  assert snap["kernels"]["ccl.tiled"]["executes"] == 1
  assert snap["kernels"]["tile_resolve"]["executes"] == counts["tile_resolve_plain"] == 1
  assert snap["kernels"]["pooling.pyramid[average]"]["executes"] == 1
  assert snap["kernels"]["pyramid2x2x1"]["executes"] == 1
  assert snap["h2d_bytes"] == lab.nbytes + lab.size
  assert snap["distinct_signatures"] >= 4
  assert snap["devices"].keys() == {"cpu"}


# ---------------------------------------------------------------------------
# pad waste


def _infer_model(path):
  spec = jax_registry.ModelSpec("convnet3d", 1, 2, patch_shape=(32, 32, 16),
                                overlap=(8, 8, 4), hidden=(3,))
  jax_registry.save_model(path, spec, jax_registry.init_params(spec, seed=7))
  return path


@pytest.mark.parametrize("batch_size", [4, 7])
def test_inference_pad_bytes_equal_the_reference(tmp_path, monkeypatch, batch_size):
  """One 48x48x16 task: 18 patches, the last group filled with zero
  patches; the port's ledger counts the filler and real bytes the JAX
  package's engine records. (The JAX package's executor also records its
  rounding of each dispatch up to a power-of-two multiple of its mesh, a
  padding the port does not do: ROADMAP.md, recorded deviations. Only the
  engine's records are summed on its side.)"""
  model = _infer_model(f"file://{tmp_path}/m")
  data = np.random.default_rng(0).integers(0, 255, (48, 48, 16, 1)).astype(np.uint8)
  for who in ("jax", "port"):
    JaxVolume.from_numpy(data, f"file://{tmp_path}/{who}", chunk_size=(16, 16, 16),
                         layer_type="image")
  jax_device.reset()
  engine_records = []
  record = jax_device.LEDGER.record_pad_waste

  def from_the_engine(padded_bytes=0, real_bytes=0):
    if sys._getframe(1).f_globals["__name__"] == "igneous_tpu.infer.engine":
      engine_records.append((padded_bytes, real_bytes))
    return record(padded_bytes=padded_bytes, real_bytes=real_bytes)

  monkeypatch.setattr(jax_device.LEDGER, "record_pad_waste", from_the_engine)
  jax_registry.clear_model_cache()
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_inference_tasks(
    f"file://{tmp_path}/jax", f"file://{tmp_path}/jax_out", model, shape=(48, 48, 16),
    batch_size=batch_size))
  registry.clear_model_cache()
  LocalTaskQueue().insert(tc.create_inference_tasks(
    f"file://{tmp_path}/port", f"file://{tmp_path}/port_out", model, shape=(48, 48, 16),
    batch_size=batch_size))
  snap = LEDGER.snapshot()
  ref = tuple(map(sum, zip(*engine_records)))
  assert len(engine_records) == 1 and ref[0] > 0
  assert (snap["pad_bytes"], snap["real_bytes"]) == ref
  dispatches = -(-18 // batch_size)
  assert snap["kernels"]["infer.convnet3d"]["executes"] == dispatches
  assert snap["dispatches"] == dispatches


# ---------------------------------------------------------------------------
# busy seconds


def test_busy_seconds_are_the_union_of_intervals():
  """Overlapping, nested and disjoint intervals on one device; another
  device's intervals do not add to it."""
  LEDGER.record_execute("a", 2.0, device="cpu", interval=(1.0, 3.0))
  LEDGER.record_execute("b", 1.0, device="cpu", interval=(1.5, 2.5), dispatch=False)
  LEDGER.record_execute("c", 2.0, device="cpu", interval=(2.0, 4.0))
  LEDGER.record_transfer("h2d", 10, 0.5, device="cpu", interval=(3.5, 4.5))
  LEDGER.record_execute("d", 1.0, device="cpu", interval=(6.0, 7.0))
  LEDGER.record_execute("e", 2.5, device="other", interval=(0.0, 2.5))
  assert LEDGER.busy_seconds() == pytest.approx(3.5 + 1.0)
  snap = LEDGER.snapshot()
  assert snap["devices"] == {"cpu": pytest.approx(4.5), "other": pytest.approx(2.5)}
  assert snap["dispatches"] == 4
  assert snap["kernels"]["b"]["execute_s"] == 1.0 and snap["h2d_bytes"] == 10


def test_many_intervals_merge_to_their_union():
  for i in range(3 * 4096 + 5):
    LEDGER.record_execute("k", 0.5, device="cpu", interval=(i * 1.0, i * 1.0 + 0.5))
    LEDGER.record_execute("k", 0.5, device="cpu", interval=(i * 1.0 + 0.25, i * 1.0 + 0.75))
  assert LEDGER.busy_seconds() == pytest.approx((3 * 4096 + 5) * 0.75)


def test_nested_spans_and_two_threads_count_a_moment_once():
  with execute_span("outer", device="cpu"):
    with execute_span("inner", device="cpu"):
      time.sleep(0.05)
    time.sleep(0.02)
  snap = LEDGER.snapshot()
  assert snap["dispatches"] == 1
  outer = snap["kernels"]["outer"]["execute_s"]
  assert snap["kernels"]["inner"]["execute_s"] < outer
  assert snap["busy_s"] == pytest.approx(outer)

  ledger_mod.reset()
  barrier = threading.Barrier(2)

  def work():
    barrier.wait()
    with execute_span("thread", device="cpu"):
      time.sleep(0.1)

  t0 = time.perf_counter()
  threads = [threading.Thread(target=work) for _ in range(2)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=30)
  wall = time.perf_counter() - t0
  assert not any(t.is_alive() for t in threads)
  snap = LEDGER.snapshot()
  total = snap["kernels"]["thread"]["execute_s"]
  assert snap["dispatches"] == 2 and total >= 0.2
  assert 0.1 <= snap["busy_s"] <= wall < total


def test_a_span_that_raises_records_nothing():
  with pytest.raises(RuntimeError):
    with execute_span("k", device="cpu"):
      raise RuntimeError("launch refused")
  assert LEDGER.snapshot() is None
  with execute_span("k", device="cpu"):
    pass
  assert LEDGER.snapshot()["dispatches"] == 1


def test_transfer_direction_is_checked():
  with pytest.raises(ValueError, match="h2d or d2h"):
    transfer_span("sideways", 1, "cpu")


# ---------------------------------------------------------------------------
# memory, builds, and no synchronisation


def test_hbm_gauges_noop_gracefully_on_cpu():
  assert LEDGER.sample_hbm() == {}
  assert not any(k.startswith("device.hbm") for k in telemetry.gauges_snapshot())
  LEDGER.record_execute("k", 0.1, device="cpu")
  assert "hbm" not in LEDGER.snapshot()


def test_builds_are_the_recompiles():
  LEDGER.note_signature("k", ((4, 4), "int32"))
  assert not LEDGER.note_signature("k", ((4, 4), "int32"))
  assert LEDGER.note_signature("k", ((4, 8), "int32"))
  LEDGER.record_compile("cseg", 1.5)
  snap = LEDGER.snapshot()
  assert snap["recompiles"] == 1 and snap["distinct_signatures"] == 2
  assert snap["kernels"]["cseg"]["compiles"] == 1
  assert telemetry.counters_snapshot()["device.recompiles"] == 1


def test_compile_span_charges_a_build():
  with ledger_mod.compile_span("pooling"):
    time.sleep(0.01)
  snap = LEDGER.snapshot()
  assert snap["recompiles"] == 1 and snap["kernels"]["pooling"]["compile_s"] >= 0.01
  assert telemetry.snapshot()["device.compile.s"]["count"] == 1


def test_spans_never_synchronise_the_device():
  """No ``torch.cuda.synchronize`` in the ledger's source: a span waits on
  its own events (``Event.synchronize``) only at read time."""
  src = (REPO / "igneous_tpu_torch" / "observability" / "device.py").read_text()
  for node in ast.walk(ast.parse(src)):
    if isinstance(node, ast.Attribute) and node.attr == "synchronize":
      assert not (isinstance(node.value, ast.Attribute) and node.value.attr == "cuda"), \
        ast.unparse(node)


# ---------------------------------------------------------------------------
# tuned knobs


def _write_tuned(root, knobs_dict):
  path = os.path.join(root[len("file://"):], tune.TUNED_PREFIX, f"{tune.device_kind()}.json")
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    json.dump({"version": 1, "knobs": knobs_dict}, f)
  tune.reset_cache()


def test_tuned_config_applies_and_env_wins(tmp_path, monkeypatch):
  root = f"file://{tmp_path}/cc"
  monkeypatch.setenv("IGNEOUS_COMPILE_CACHE", root)
  assert tune.device_kind() == "cpu"
  _write_tuned(root, {"IGNEOUS_CCL_TILE": "4,8,8", "IGNEOUS_PAGE_SHAPE": "16,16,16",
                      "IGNEOUS_PAGE_BATCH": "5"})
  assert tune.resolve("IGNEOUS_CCL_TILE") == "4,8,8"
  assert ccl._tile_shape() == (4, 8, 8)
  assert paged.page_shape() == (16, 16, 16)
  assert paged.page_round_cap() == 8
  monkeypatch.setenv("IGNEOUS_CCL_TILE", "2,2,2")
  assert tune.resolve("IGNEOUS_CCL_TILE") == "2,2,2"
  assert ccl._tile_shape() == (2, 2, 2)


def test_tune_config_root_precedence(tmp_path, monkeypatch):
  """IGNEOUS_TUNE_CONFIG outranks IGNEOUS_COMPILE_CACHE as config root."""
  cache, other = f"file://{tmp_path}/cc", f"file://{tmp_path}/tuned_only"
  monkeypatch.setenv("IGNEOUS_COMPILE_CACHE", cache)
  monkeypatch.setenv(tune.CONFIG_ENV, other)
  _write_tuned(cache, {"IGNEOUS_PAGE_BATCH": "7"})
  _write_tuned(other, {"IGNEOUS_PAGE_BATCH": "9"})
  assert tune.resolve("IGNEOUS_PAGE_BATCH") == "9"
  monkeypatch.delenv(tune.CONFIG_ENV)
  tune.reset_cache()
  assert tune.resolve("IGNEOUS_PAGE_BATCH") == "7"


@pytest.mark.parametrize("content", ["{not json", '{"knobs": 3}', "[1, 2]"])
def test_bad_tuned_config_is_ignored(tmp_path, monkeypatch, content):
  root = f"file://{tmp_path}/cc"
  monkeypatch.setenv("IGNEOUS_COMPILE_CACHE", root)
  path = tmp_path / "cc" / "tuned" / "cpu.json"
  path.parent.mkdir(parents=True)
  path.write_text(content)
  assert tune.tuned_config() is None
  assert tune.resolve("IGNEOUS_PAGE_BATCH") is None
  assert paged.page_round_cap() == 32


def test_unresolved_tunable_falls_to_its_default():
  assert tune.config_root() is None
  assert tune.resolve("IGNEOUS_CCL_TILE") is None
  assert ccl._tile_shape() == ccl._DEFAULT_TILE_CPU
  assert paged.page_shape() == paged._DEFAULT_PAGE
  assert paged.page_round_cap() == paged._DEFAULT_PAGE_BATCH


def test_tiny_sweep_is_byte_identical_and_writes_the_cpu_file(tmp_path, monkeypatch):
  root = f"file://{tmp_path}/cc"
  monkeypatch.setenv(tune.CONFIG_ENV, root)
  lines = []
  config = tune.run(size=16, repeats=1, log=lines.append)
  written = json.loads((tmp_path / "cc" / "tuned" / "cpu.json").read_text())
  assert written["knobs"] == config["knobs"] and written["device_kind"] == "cpu"
  for name in tune.TUNABLE:
    rows = config["measurements"][name]
    assert [r["value"] for r in rows] == tune.candidates("cpu")[name]
    assert all(r["identical"] for r in rows)
    default = rows[0]["seconds"]
    if name in config["knobs"]:
      win = next(r for r in rows if r["value"] == config["knobs"][name])
      assert win["seconds"] < default
      assert tune.resolve(name) == config["knobs"][name]
    else:
      assert tune.resolve(name) is None
  assert any("<default>" in line for line in lines)


def test_sweep_fails_on_a_candidate_that_changes_the_bytes(monkeypatch):
  real = tune._workloads

  def broken(size):
    work = real(size)
    work["IGNEOUS_PAGE_BATCH"] = lambda: os.environ.get("IGNEOUS_PAGE_BATCH", "").encode()
    return work

  monkeypatch.setattr(tune, "_workloads", broken)
  with pytest.raises(AssertionError, match="byte-identical"):
    tune.run(size=16, repeats=1, only=["IGNEOUS_PAGE_BATCH"])


def test_budget_skips_the_candidates_after_the_deadline():
  config = tune.run(size=16, repeats=1, budget_sec=1e-9, only=["IGNEOUS_PAGE_SHAPE"])
  rows = config["measurements"]["IGNEOUS_PAGE_SHAPE"]
  assert "seconds" in rows[0]
  assert all(r.get("skipped") == "budget exhausted" for r in rows[1:])
  assert config["knobs"] == {} and "written_to" not in config


def test_cli_tune_writes_the_file_and_refuses_a_pinned_knob(tmp_path, monkeypatch, capsys):
  out = f"file://{tmp_path}/cc"
  assert cli_main(["tune", "--size", "16", "--repeats", "1", "--knob", "IGNEOUS_PAGE_BATCH",
                   "--out", out, "--json"]) == 0
  printed = capsys.readouterr().out
  config = json.loads(printed[printed.index("{\n"):])
  assert list(config["measurements"]) == ["IGNEOUS_PAGE_BATCH"]
  assert (tmp_path / "cc" / "tuned" / "cpu.json").exists()
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "16")
  with pytest.raises(SystemExit):
    cli_main(["tune", "--knob", "IGNEOUS_PAGE_BATCH"])
  assert "refusing to tune" in capsys.readouterr().err
  with pytest.raises(SystemExit):
    cli_main(["tune", "--knob", "IGNEOUS_EDT_LINE_BLOCK"])


# ---------------------------------------------------------------------------
# the journal, the gauges, the trace and the profiler


def test_journal_records_only_when_the_ledger_changed():
  assert ledger_mod.journal_records() == []
  with execute_span("pyramid2x2x1", 64, 128, device="cpu"):
    pass
  recs = ledger_mod.journal_records()
  assert len(recs) == 1 and recs[0]["kind"] == "device"
  assert recs[0]["kernels"]["pyramid2x2x1"]["executes"] == 1
  assert ledger_mod.journal_records() == []  # nothing new since
  assert "igneous_device_busy_ratio" in prom.render()
  assert 0.0 < telemetry.gauges_snapshot()["device.busy_ratio"] <= 1.0
  # the registry's device timers carry no span of their own
  assert telemetry.snapshot()["device.execute.s"]["count"] == 1


def test_installed_ledger_rides_the_journal_flush(tmp_path):
  j = journal_mod.Journal(f"file://{tmp_path}/j", worker_id="w-dev", flush_interval=3600)
  journal_mod.set_active(j)
  try:
    ledger_mod.install()
    ledger_mod.install()  # idempotent
    with execute_span("edt_pass", 8, 8, device="cpu"):
      pass
    assert j.flush(event="round")
    assert not j.flush()  # nothing new: no segment
  finally:
    journal_mod.set_active(None)
  from igneous_tpu_torch.observability import fleet

  recs = fleet.load(f"file://{tmp_path}/j")
  ledgers = ledger_mod.device_ledgers(recs)
  assert list(ledgers) == ["w-dev"] and ledgers["w-dev"]["dispatches"] == 1
  spans = [r for r in recs if r.get("name") == "device.execute"]
  assert [(r["kernel"], r["device"], r["trace"]) for r in spans] == [
    ("edt_pass", "cpu", trace.worker_trace_id())]


def test_device_spans_nest_under_the_active_task(monkeypatch):
  trace.reset()
  ctx = trace.SpanContext("a" * 16, "task-root", True)
  with trace.activate(ctx):
    with execute_span("pooling.pyramid[average]", 64, 64, device="cpu"):
      with execute_span("pyramid2x2x1", 64, 64, device="cpu"):
        pass
    with transfer_span("d2h", 32, "cpu"):
      pass
    with trace.activate(trace.SpanContext("b" * 16, "other", False)):
      with execute_span("unsampled", 1, 1, device="cpu"):
        pass
  with ledger_mod.compile_span("pooling"):
    pass
  spans = trace.drain_spans()
  got = [(s["name"], s.get("kernel"), s["trace"], s["parent"]) for s in spans]
  assert got == [
    ("device.execute", "pyramid2x2x1", "a" * 16, "task-root"),
    ("device.execute", "pooling.pyramid[average]", "a" * 16, "task-root"),
    ("device.d2h", None, "a" * 16, "task-root"),
    ("device.compile", "pooling", trace.worker_trace_id(), None),
  ]
  assert spans[2]["bytes"] == 32 and spans[0]["devices"] == 1
  monkeypatch.setenv("IGNEOUS_TRACE_SAMPLE", "0")
  with execute_span("k", device="cpu"):
    pass
  assert trace.drain_spans() == []


@pytest.mark.parametrize("mip_from", [None, 2])
def test_downsample_auto_mip_from_labels_the_walk(mip_from):
  """``mip_from`` names the fused walk's execute span and puts
  ``mip_from`` and ``mip_to`` on it, as the JAX package's
  ``pooling.fused_pyramid`` does; the ledger counts it and no byte moves."""
  from igneous_tpu.ops import pooling as jax_pooling
  from igneous_tpu_torch.ops import pooling

  img = np.asfortranarray(np.random.default_rng(3).integers(
    0, 255, (37, 29, 6)).astype(np.uint8))
  factors = [(2, 2, 1), (2, 2, 1), (2, 2, 2)]
  LEDGER.reset()
  trace.reset()
  with trace.activate(trace.SpanContext("c" * 16, "synth", True)):
    outs = pooling.downsample_auto(img, factors, 3, method="average", mip_from=mip_from)
  want = jax_pooling.downsample_auto(img, factors, 3, method="average", mip_from=mip_from)
  assert all(np.array_equal(o, w) and o.dtype == w.dtype for o, w in zip(outs, want))
  name = "pooling.pyramid[average]" if mip_from is None else "pooling.fused_pyramid[average]"
  assert LEDGER.snapshot()["kernels"][name]["executes"] == 1
  walk = [s for s in trace.drain_spans() if s.get("kernel") == name]
  assert len(walk) == 1 and walk[0]["parent"] == "synth"
  if mip_from is None:
    assert "mip_from" not in walk[0] and "mip_to" not in walk[0]
  else:
    assert (walk[0]["mip_from"], walk[0]["mip_to"]) == (2, 5)


def _wait_capture(seconds=60.0):
  deadline = time.monotonic() + seconds
  while ledger_mod._PROFILE_STATE["active"] and time.monotonic() < deadline:
    time.sleep(0.05)
  assert not ledger_mod._PROFILE_STATE["active"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_profile_request_is_served_once_by_the_cpu_capture(writer, tmp_path):
  path = f"file://{tmp_path}/j"
  mod = jax_device if writer == "jax" else ledger_mod
  req = mod.write_profile_request(path, duration_sec=0.05, workers=["w-a"])
  assert ledger_mod.read_profile_request(path)["id"] == req["id"]
  other = journal_mod.Journal(path, worker_id="w-b")
  assert not ledger_mod.poll_profile_trigger(other)  # not named
  j = journal_mod.Journal(path, worker_id="w-a")
  assert ledger_mod.poll_profile_trigger(j)
  _wait_capture()
  assert not ledger_mod.poll_profile_trigger(j)  # served
  keys = ledger_mod.list_profiles(path)
  assert keys == jax_device.list_profiles(path) == [f"profiles/w-a-{req['id']}/trace.json"]
  doc = json.loads((tmp_path / "j" / keys[0]).read_bytes())
  assert isinstance(doc["traceEvents"], list)
  assert telemetry.counters_snapshot()["device.profile.captures"] == 1


def test_second_capture_is_refused_while_one_runs(tmp_path):
  assert ledger_mod.start_capture(0.3, logdir=str(tmp_path))
  try:
    assert not ledger_mod.start_capture(0.01, logdir=str(tmp_path))
  finally:
    _wait_capture()
  assert os.path.exists(tmp_path / "local-manual" / "trace.json")


def test_every_nth_dispatch_samples_a_capture(tmp_path, monkeypatch):
  monkeypatch.setattr(ledger_mod, "_SAMPLE_COUNT", [0])
  monkeypatch.setenv("IGNEOUS_PROFILE_EVERY", "2")
  monkeypatch.setenv("IGNEOUS_PROFILE_SEC", "0.05")
  for _ in range(3):  # no directory: inert
    with execute_span("k", device="cpu"):
      pass
  assert ledger_mod._SAMPLE_COUNT == [0]
  monkeypatch.setenv("IGNEOUS_PROFILE_DIR", str(tmp_path))
  for _ in range(3):
    with execute_span("outer", device="cpu"):
      with execute_span("inner", device="cpu"):  # not a dispatch
        pass
  _wait_capture()
  assert ledger_mod._SAMPLE_COUNT == [3]
  assert os.listdir(tmp_path) == ["local-sample-2"]
  assert os.path.exists(tmp_path / "local-sample-2" / "trace.json")


def test_render_devices_names_the_card_where_the_record_does():
  rec = {"kind": "device", "worker": "w0", "ts": 5.0, "busy_ratio": 0.04,
         "dispatches": 3, "recompiles": 1, "devices": {"cuda:0": 0.2},
         "kernels": {"pyramid2x2x1": {"executes": 3, "execute_s": 0.002,
                                      "vox_per_sec": 1e10, "compiles": 1}},
         "hbm": {"cuda:0": {"peak_bytes_in_use": 2 << 30, "bytes_limit": 80 << 30}}}
  plain = ledger_mod.device_ledgers([rec])
  assert ledger_mod.render_devices(plain) == jax_device.render_devices(plain)
  named = ledger_mod.device_ledgers([dict(rec, kinds={"cuda:0": "NVIDIA H100 80GB HBM3"})])
  lines = ledger_mod.render_devices(named)
  assert "cards: cuda:0 NVIDIA H100 80GB HBM3" in lines
  assert [l for l in lines if not l.startswith("cards:")] == jax_device.render_devices(plain)
  assert ledger_mod.fleet_summary(named) == jax_device.fleet_summary(plain)

