"""The port's observability plane against the JAX package's.

Tolerance: exact. Pure functions run on the same seeded records
(``torch_journal_records``) in both packages and their results are
compared byte for byte: ``encode_segment`` with and without compression,
``fleet.status|slowest_tasks|worker_rates|trace_records|render_trace``,
``rollup.compact``'s segments (its clock pinned in both), the Perfetto
export, ``prom.render`` for one metrics state, and the device plane's
``device_ledgers|render_devices|fleet_summary|report_json``. Where workers
wrote the journals, their own times and ids differ: ``ts``, ``dur``,
``span``, ``trace``, ``parent``, ``worker``, ``segment`` and
``exec_span_id`` are removed and the rest (span names, parent-child
trees, attributes, task counts) compared exactly. ``device.*`` spans are
the port's alone on the CPU (the JAX package pools on its native host
path there): they are held to nest under their task and left out of the
tree comparison.
"""

import json
import os
import time
import types
import urllib.request

import numpy as np
import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
import torch_journal_records as seeded
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.observability import device as jax_device
from igneous_tpu.observability import fleet as jax_fleet
from igneous_tpu.observability import journal as jax_journal
from igneous_tpu.observability import metrics as jax_metrics
from igneous_tpu.observability import perfetto as jax_perfetto
from igneous_tpu.observability import prom as jax_prom
from igneous_tpu.observability import rollup as jax_rollup
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu.queues import FileQueue as JaxFileQueue
from igneous_tpu.queues import LocalTaskQueue as JaxLocalTaskQueue
from igneous_tpu.tasks import TouchFileTask as JaxTouchFileTask
from igneous_tpu_torch import device, lifecycle, telemetry
from igneous_tpu_torch import task_creation as port_tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.observability import device as port_device
from igneous_tpu_torch.observability import fleet as port_fleet
from igneous_tpu_torch.observability import journal as port_journal
from igneous_tpu_torch.observability import metrics as port_metrics
from igneous_tpu_torch.observability import perfetto as port_perfetto
from igneous_tpu_torch.observability import prom as port_prom
from igneous_tpu_torch.observability import rollup as port_rollup
from igneous_tpu_torch.observability import trace as port_trace
from igneous_tpu_torch.parallel.lease_batcher import poll_batched
from igneous_tpu_torch.queues import FileQueue, LocalTaskQueue
from igneous_tpu_torch.queues.registry import deserialize
from igneous_tpu_torch.tasks import TouchFileTask

STRIP = ("ts", "dur", "span", "trace", "parent", "worker", "segment", "exec_span_id")
BOTH = {
  "jax": (jax_fleet, jax_journal, jax_rollup, jax_perfetto, jax_device),
  "port": (port_fleet, port_journal, port_rollup, port_perfetto, port_device),
}


def _clean():
  for metrics, trace, journal, prom, dev in (
    (jax_metrics, jax_trace, jax_journal, jax_prom, jax_device),
    (port_metrics, port_trace, port_journal, port_prom, port_device),
  ):
    metrics.reset_all()
    trace.reset()
    journal.set_active(None)
    journal.disarm_last_will(flush=False)
    prom.stop_http_server()
    dev.reset()


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # set, then deleted: the CLIs' --journal and --metrics-port write the
  # environment, which the teardown puts back
  for name in ("IGNEOUS_JOURNAL", "IGNEOUS_TRACE_SAMPLE", "IGNEOUS_JOURNAL_COMPRESS",
               "IGNEOUS_METRICS_PORT", "QUEUE_URL"):
    monkeypatch.setenv(name, "")
    monkeypatch.delenv(name)
  device.reset_device()
  _clean()
  yield
  _clean()
  device.reset_device()


def _dumps(obj) -> str:
  return json.dumps(obj, sort_keys=True)


def _tree(spans) -> list:
  """Each span but the device plane's, without its times and ids, beside
  its parent's name."""
  by = {s["span"]: s for s in spans}
  out = []
  for s in spans:
    if s["name"].startswith("device."):
      continue
    parent = by.get(s.get("parent"))
    attrs = {k: v for k, v in s.items() if k not in STRIP and k != "kind"}
    out.append(_dumps([attrs, parent["name"] if parent else None]))
  return sorted(out)


def _image(path: str, shape=(128, 128, 16)) -> None:
  data = np.random.default_rng(7).integers(0, 255, shape).astype(np.uint8)
  JaxVolume.from_numpy(data, f"file://{path}", resolution=(8, 8, 40), chunk_size=(64, 64, 16))


def _jax_cli(args) -> object:
  res = CliRunner().invoke(jax_cli, [str(a) for a in args], catch_exceptions=False)
  return res


def _port_cli(args, capsys):
  rc = cli_main([str(a) for a in args])
  return rc, capsys.readouterr().out


# -- pure functions on seeded records -------------------------------------------


@pytest.mark.parametrize("compress", ["0", "1"])
def test_encode_segment_byte_for_byte(compress, monkeypatch):
  monkeypatch.setenv("IGNEOUS_JOURNAL_COMPRESS", compress)
  data = ("\n".join(json.dumps(r) for r in seeded.records(1)) + "\n").encode()
  enc = port_journal.encode_segment(data)
  assert enc == jax_journal.encode_segment(data)
  assert (enc != data) == (compress == "1")
  assert port_journal.decode_segment(jax_journal.encode_segment(data)) == data
  assert jax_journal.decode_segment(enc) == data


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_functions_byte_for_byte(seed):
  recs = seeded.records(seed)
  got = {}
  for who, (fleet, *_rest) in BOTH.items():
    spans = fleet.trace_records(recs, f"{seed}t10")
    got[who] = _dumps([
      fleet.status(recs), fleet.slowest_tasks(recs, n=5), spans,
      fleet.render_trace(spans), fleet.render_trace(fleet.trace_records(recs, f"{seed}t15")),
      fleet.worker_rates(recs), fleet.worker_rates(recs, window_sec=200.0, now=seeded.NOW),
      list(fleet.iter_task_spans(recs)),
    ])
  assert got["port"] == got["jax"]
  st = json.loads(got["port"])[0]
  assert st["tasks"] == 18 and st["tasks_failed"] == 1 and st["dlq_promoted"] == 1


def test_journal_read_side_and_throughput_byte_for_byte(tmp_path):
  recs = seeded.records(2, now=time.time())
  seeded.write_segments(str(tmp_path / "j"), recs)
  path = f"file://{tmp_path}/j"
  got = {}
  for who, (fleet, journal, *_rest) in BOTH.items():
    got[who] = _dumps([journal.list_segments(path), list(journal.read_records(path)),
                       fleet.load_effective(path), fleet.journal_throughput(path)])
  assert got["port"] == got["jax"]
  assert len(json.loads(got["port"])[0]) == 3


def test_rollup_compact_segments_byte_for_byte(tmp_path, monkeypatch):
  recs = seeded.records(3)
  stats = {}
  for who, (fleet, journal, rollup, *_rest) in BOTH.items():
    monkeypatch.setattr(rollup, "time", types.SimpleNamespace(time=lambda: seeded.NOW))
    monkeypatch.setattr(rollup, "_SEQ", [0])
    seeded.write_segments(str(tmp_path / who), recs)
    path = f"file://{tmp_path}/{who}"
    raw = fleet.status(fleet.load(path))
    res = rollup.compact(path, actor="compactor-test", window=60.0, samples_cap=4)
    assert res["segments_compacted"] == 3
    eff = fleet.load_effective(path)
    stats[who] = (res, raw, fleet.status(eff), fleet.slowest_tasks(eff, 5),
                  rollup.gc(path, retain=0, now=seeded.NOW + 10))
  assert _dumps(stats["port"]) == _dumps(stats["jax"])
  key = stats["port"][0]["rollup_key"]
  assert (tmp_path / "port" / key).read_bytes() == (tmp_path / "jax" / key).read_bytes()
  # each package reads the other's compaction
  assert port_fleet.load_effective(f"file://{tmp_path}/jax") == \
    jax_fleet.load_effective(f"file://{tmp_path}/jax")
  assert stats["port"][2]["tasks"] == stats["port"][1]["tasks"] == 18


@pytest.mark.parametrize("trace_id", [None, "0t21"])
def test_perfetto_chrome_trace_byte_for_byte(trace_id, tmp_path):
  recs = seeded.records(0)
  port = port_perfetto.chrome_trace(recs, trace_id=trace_id)
  assert _dumps(port) == _dumps(jax_perfetto.chrome_trace(recs, trace_id=trace_id))
  names = {e["args"]["name"] for e in port["traceEvents"] if e["ph"] == "M"}
  assert "device cuda:0" in names
  n = port_perfetto.dump(recs, str(tmp_path / "t.json"), trace_id=trace_id)
  assert n == len(json.load(open(tmp_path / "t.json"))["traceEvents"])


def test_prom_render_byte_for_byte():
  durs = np.random.default_rng(4).exponential(0.3, 40)
  for metrics in (port_metrics, jax_metrics):
    metrics.incr("tasks.failed", 2)
    metrics.incr("dlq.promoted")
    metrics.incr("journal.segments", 0)
    for d in durs:
      metrics.observe_quiet("pipeline.download.s", float(d))
    metrics.observe_quiet("device.execute.s", 0.0004)
    metrics.gauge_set("device.busy_ratio", 0.0312)
    metrics.gauge_max("pipeline.download.bytes", 3.5e8)
    metrics.gauge_set("worker.up", 1.0)
  assert port_prom.render() == jax_prom.render()
  assert port_metrics.histogram_quantile("pipeline.download.s", 0.5) == \
    jax_metrics.histogram_quantile("pipeline.download.s", 0.5)


def test_metrics_server_binds_port_zero_and_serves_render():
  port_metrics.incr("tasks.failed", 3)
  bound = port_prom.start_http_server(0)
  try:
    assert bound and port_prom.start_http_server(0) == bound  # one a process
    with urllib.request.urlopen(f"http://127.0.0.1:{bound}/metrics", timeout=10) as r:
      body = r.read().decode()
      assert r.headers["Content-Type"] == port_prom.CONTENT_TYPE
  finally:
    port_prom.stop_http_server()
  assert "igneous_tasks_failed_total 3" in body
  assert body == port_prom.render()


@pytest.mark.parametrize("seed", [0, 5])
def test_device_read_side_byte_for_byte(seed):
  recs = seeded.records(seed)
  got = {}
  for who, (*_rest, dev) in BOTH.items():
    ledgers = dev.device_ledgers(recs)
    got[who] = [_dumps(ledgers), dev.render_devices(ledgers), _dumps(dev.fleet_summary(ledgers)),
                dev.report_json(ledgers), dev.render_devices({})]
  assert got["port"] == got["jax"]
  assert len(json.loads(got["port"][0])) == 3


def test_telemetry_shim_records_into_the_one_registry():
  telemetry.incr("chunk_cache.hits", 2)
  ctx = port_trace.SpanContext("t" * 16, "root", True)
  with port_trace.activate(ctx), port_metrics.task_timing() as st:
    with telemetry.stage("download"):
      pass
    telemetry.observe("pipeline.download.s", 0.25)
  assert port_metrics.counters_snapshot()["chunk_cache.hits"] == 2 == telemetry.counters_snapshot()[
    "chunk_cache.hits"]
  snap = telemetry.snapshot()
  assert snap["download"]["count"] == 1 and snap["pipeline.download.s"]["seconds"] == 0.25
  assert set(st.summary()) == {"download"}
  # a stage records no span (the JAX package's stage records none); observe does
  spans = port_trace.drain_spans()
  assert [s["name"] for s in spans] == ["pipeline.download.s"]
  assert spans[0]["parent"] == "root" and spans[0]["trace"] == "t" * 16
  telemetry.reset_all()
  assert telemetry.counters_snapshot() == {} and telemetry.snapshot() == {}


def test_trace_identity_in_payloads(monkeypatch):
  jax_task = JaxTouchFileTask("/nonexistent/a")
  port_task = TouchFileTask("/nonexistent/a")
  for task in (jax_task, port_task):
    tinfo = json.loads(task.to_json())["trace"]
    assert set(tinfo) == {"trace_id", "ts"} and len(tinfo["trace_id"]) == 16
  # a JAX-minted identity survives deserialization in the port, and back
  back = deserialize(jax_task.to_json())
  assert back._trace == jax_task._trace
  assert json.loads(back.to_json())["trace"] == json.loads(jax_task.to_json())["trace"]
  monkeypatch.setenv("IGNEOUS_TRACE_SAMPLE", "0")
  for cls in (JaxTouchFileTask, TouchFileTask):
    assert "trace" not in json.loads(cls("/nonexistent/b").to_json())
  assert port_trace.mint() is None and jax_trace.mint() is None


# -- journals written by workers --------------------------------------------------


def _downsample_queue(root, who, capsys, n_mips=1):
  layer, spec = root / f"{who}_layer", f"fq://{root}/{who}_q"
  _image(str(layer))
  args = ["image", "downsample", f"file://{layer}", "--num-mips", n_mips, "--queue", spec]
  if who == "jax":
    assert _jax_cli(args).exit_code == 0
  else:
    assert _port_cli(args, capsys)[0] == 0
  return spec


def test_journals_written_by_each_worker_read_across(tmp_path, capsys):
  """Each package's ``execute`` journals an fq:// queue by default (no
  option given); each package's fleet functions read both journals alike,
  with the same task counts; ``queue status --eta`` prints the same lines
  through both CLIs on each queue."""
  specs = {who: _downsample_queue(tmp_path, who, capsys) for who in ("jax", "port")}
  res = _jax_cli(["execute", specs["jax"], "-x", "-q"])
  assert res.exit_code == 0, res.output
  _clean()
  rc, _ = _port_cli(["execute", specs["port"], "-x", "-q"], capsys)
  assert rc == 0 and port_journal.get_active() is None  # the run's journal ended with it
  ntasks = JaxFileQueue(specs["jax"]).completed
  assert ntasks == FileQueue(specs["port"]).completed == 1
  for who, spec in specs.items():
    path = f"file://{spec[5:]}/journal"
    assert jax_journal.list_segments(path) == port_journal.list_segments(path) != []
    st = {pkg: fleet.status(fleet.load(path)) for pkg, (fleet, *_r) in BOTH.items()}
    assert _dumps(st["port"]) == _dumps(st["jax"])
    assert st["port"]["tasks"] == ntasks and st["port"]["tasks_failed"] == 0
    events = {r.get("event") for r in port_fleet.load(path) if r.get("kind") == "counters"}
    assert "poll_exit" in events and "exit" in events
    out_jax = _jax_cli(["queue", "status", spec, "--eta"]).output
    rc, out_port = _port_cli(["queue", "status", spec, "--eta"], capsys)
    assert rc == 0 and out_port == out_jax and "(journal)" in out_port
  # the port's worker journals its device ledger; the JAX package's host
  # pooling on the CPU records none
  assert port_device.device_ledgers(port_fleet.load(f"file://{specs['port'][5:]}/journal"))


def test_execute_journal_option_and_sampled_eta(tmp_path, capsys, monkeypatch):
  spec = f"fq://{tmp_path}/q"
  q = FileQueue(spec)
  q.insert([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(3)])
  rc, _ = _port_cli(["execute", spec, "-x", "-q", "--journal", f"file://{tmp_path}/jr"], capsys)
  assert rc == 0
  assert not os.path.exists(f"{tmp_path}/q/journal")
  # the JAX package's worker with the same option (another journal: in
  # one process both workers' segments would take the same names)
  jspec = f"fq://{tmp_path}/jq"
  JaxFileQueue(jspec).insert([JaxTouchFileTask(str(tmp_path / f"j{i}")) for i in range(2)])
  res = _jax_cli(["execute", jspec, "-x", "-q", "--journal", f"file://{tmp_path}/jr2"])
  assert res.exit_code == 0 and not os.path.exists(f"{tmp_path}/jq/journal")
  _clean()
  for fleet, *_r in BOTH.values():
    assert fleet.status(fleet.load(f"file://{tmp_path}/jr"))["tasks"] == 3
    assert fleet.status(fleet.load(f"file://{tmp_path}/jr2"))["tasks"] == 2
  # no journal segments where it looks: two live samples instead
  monkeypatch.delenv("IGNEOUS_JOURNAL")  # --journal set it for spawned workers
  other = f"fq://{tmp_path}/q2"
  FileQueue(other).insert([TouchFileTask(str(tmp_path / "u"))])
  rc, out = _port_cli(["queue", "status", other, "--eta", "--sample-sec", "0"], capsys)
  assert rc == 0 and out == _jax_cli(["queue", "status", other, "--eta", "--sample-sec", "0"]).output
  assert "tasks/sec: 0.0 (sampled)" in out and "eta_sec: None" in out


@pytest.mark.parametrize("route", ["local", "fq"])
def test_downsample_trace_tree_matches(route, tmp_path, capsys):
  """One ``DownsampleTask``'s trace: the same span names, attributes and
  parent-child tree in both packages; on fq:// the task is the JAX
  package's payload, and its trace id is the one the port's worker
  journals."""
  trees, spans_of = {}, {}
  layer = tmp_path / "layer"  # both write the same bytes into one layer
  _image(str(layer))
  for who in ("jax", "port"):
    tc = jax_tc if who == "jax" else port_tc
    task = list(tc.create_downsampling_tasks(f"file://{layer}", mip=0, num_mips=1))[0]
    if route == "local":
      (jax_trace if who == "jax" else port_trace).reset()
      (JaxLocalTaskQueue if who == "jax" else LocalTaskQueue)(parallel=1).insert([task])
      spans = (jax_trace if who == "jax" else port_trace).drain_spans()
    else:
      jtask = list(jax_tc.create_downsampling_tasks(f"file://{layer}", mip=0, num_mips=1))[0]
      spec = f"fq://{tmp_path}/{who}_q"
      JaxFileQueue(spec).insert([jtask])
      if who == "jax":
        assert _jax_cli(["execute", spec, "-x", "-q"]).exit_code == 0
      else:
        assert _port_cli(["execute", spec, "-x", "-q"], capsys)[0] == 0
      _clean()
      spans = [r for r in port_fleet.load(f"file://{tmp_path}/{who}_q/journal")
               if r.get("kind") == "span"]
      task_span = next(s for s in spans if s["name"] == "task")
      assert task_span["trace"] == jtask._trace["trace_id"]
      assert {s["trace"] for s in spans if s["name"] != "lease.round"} == {task_span["trace"]}
    trees[who], spans_of[who] = _tree(spans), spans
  assert trees["port"] == trees["jax"]
  names = {json.loads(t)[0]["name"] for t in trees["port"]}
  assert names >= {"task", "storage.put"} | (
    {"pipeline.compute.s"} if route == "local" else {"queue.wait", "storage.get"})
  # the port's device spans nest under its task's execution
  port_spans = spans_of["port"]
  root = next(s for s in port_spans if s["name"] == "task")["span"]
  dev = [s for s in port_spans if s["name"].startswith("device.")]
  assert {s.get("kernel") for s in dev} >= {"pyramid2x2x1"}
  assert {s["parent"] for s in dev} == {root}


def test_poll_loop_flushes_on_drain_and_exit(tmp_path):
  q = FileQueue(f"fq://{tmp_path}/q")
  q.insert([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(4)])
  j = port_journal.Journal(f"file://{tmp_path}/q/journal", worker_id="w-test",
                           flush_interval=3600)
  port_journal.set_active(j)
  flag = lifecycle.StopFlag()
  done = []

  def stop_fn(executed, empty):
    # a drain request after two tasks: the task leased in this turn
    # finishes, and the journal, marked dirty, flushes at the next turn
    if executed == 2 and not flag.is_set():
      flag.set("test")
    done.append(executed)
    return empty

  executed = q.poll(lease_seconds=60, stop_fn=stop_fn, drain_flag=flag)
  assert executed == 3 and port_metrics.gauges_snapshot()["worker.draining"] == 1.0
  recs = port_fleet.load(f"file://{tmp_path}/q/journal")
  events = [r["event"] for r in recs if r["kind"] == "counters"]
  assert events == ["interval", "drain"]  # the drain request's flush, then the loop's end
  tasks = [r for r in recs if r.get("name") == "task"]
  assert len(tasks) == 3 and {t["queue"] for t in tasks} == {"FileQueue"}
  assert all(t["attempt"] == 1 for t in tasks)


def test_lease_batcher_journals_rounds(tmp_path):
  q = FileQueue(f"fq://{tmp_path}/q")
  q.insert([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(5)])
  # interval 0: every round boundary flushes
  port_journal.set_active(port_journal.Journal(f"file://{tmp_path}/q/journal",
                                               worker_id="w-batch", flush_interval=0))
  executed, stats = poll_batched(q, batch_size=2, lease_seconds=60,
                                 stop_fn=lambda executed, empty: empty)
  assert executed == 5
  recs = port_fleet.load(f"file://{tmp_path}/q/journal")
  rounds = [r for r in recs if r.get("name") == "lease.round"]
  assert len(rounds) == stats["rounds"] == 3
  assert sum(r["executed"] for r in rounds) == 5
  assert {r["trace"] for r in rounds} == {port_trace.worker_trace_id()}
  # the rounds this loop leased itself (the rest were pre-leased beside a round)
  assert 1 <= sum(r["members"] for r in recs if r.get("name") == "lease.acquire") <= 5
  assert [r.get("mode") for r in recs if r.get("name") == "task"] == ["batch-solo"] * 5
  assert [r["event"] for r in recs if r["kind"] == "counters"] == ["round"] * 3


def test_last_will_fires_once_into_the_journal(tmp_path, capsys):
  j = port_journal.Journal(f"file://{tmp_path}/j", worker_id="w-will")
  port_journal.set_active(j)
  port_journal.install_last_will({"queue": "fq://x"})
  port_metrics.incr("tasks.failed")
  port_journal.fire_last_will("crash", {"queue": "fq://x"})
  port_journal.fire_last_will("crash", {"queue": "fq://x"})  # once a run
  line = json.loads(capsys.readouterr().out.strip())
  assert line["event"] == "crash" and line["counters"]["tasks.failed"] == 1
  recs = port_fleet.load(f"file://{tmp_path}/j")
  assert [r["event"] for r in recs] == ["crash"]


def test_profile_capture_and_ls_through_both_clis(tmp_path, capsys):
  """A request published by the JAX package's ``profile capture`` starts
  the port worker's capture (the CPU's torch.profiler); both CLIs list
  the uploaded Chrome trace; the port's ``--local`` capture runs in the
  caller."""
  path = f"file://{tmp_path}/j"
  res = _jax_cli(["profile", "capture", "--journal", path, "--duration", "0.2"])
  assert res.exit_code == 0 and "published capture request" in res.output
  j = port_journal.Journal(path, worker_id="w-prof")
  assert port_device.poll_profile_trigger(j)
  assert not port_device.start_capture(0.1, journal=j)  # one capture at a time
  deadline = time.monotonic() + 60
  while port_device._PROFILE_STATE["active"] and time.monotonic() < deadline:
    time.sleep(0.05)
  assert not port_device._PROFILE_STATE["active"]
  assert not port_device.poll_profile_trigger(j)  # served once
  rc, out = _port_cli(["profile", "ls", "--journal", path], capsys)
  assert rc == 0 and out == _jax_cli(["profile", "ls", "--journal", path]).output
  keys = out.split()
  assert len(keys) == 1 and keys[0].startswith("profiles/w-prof-") and keys[0].endswith(
    "/trace.json")
  doc = json.loads((tmp_path / "j" / keys[0]).read_bytes())
  assert doc["traceEvents"]
  assert any(r.get("name") == "device.profile" for r in port_fleet.load(path))
  rc, out = _port_cli(["profile", "capture", "--journal", f"file://{tmp_path}/j2", "--local",
                       "--duration", "0.05"], capsys)
  assert rc == 0 and out.split() == ["profiles/" + out.split()[0].split("/", 1)[1]]
  rc, out = _port_cli(["profile", "ls", "--journal", f"file://{tmp_path}/j3"], capsys)
  assert rc == 0 and out == "no profile artifacts\n"


def test_device_trace_is_inert_unless_a_directory_is_given(tmp_path, monkeypatch):
  with port_metrics.device_trace():
    pass
  assert not list(tmp_path.iterdir())
  monkeypatch.setenv("IGNEOUS_PROFILE_DIR", str(tmp_path))
  with port_metrics.device_trace():
    sum(range(1000))
  (worker,) = list(tmp_path.iterdir())
  (path,) = list(worker.iterdir())
  assert worker.name.endswith(f"-{os.getpid()}") and path.suffix == ".json"
  assert "traceEvents" in json.loads(path.read_text())

