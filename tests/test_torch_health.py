"""The port's health engine, fleet commands and straggler flags against the
JAX package's.

Tolerance: exact. ``HealthEngine`` reports at a fixed ``now`` on the same
seeded records (``torch_journal_records``), ``check_lines``,
``render_dashboard``, ``health_events``, ``compute_desired`` and
``HealthConfig.from_env`` are compared byte for byte. The ``fleet``
commands run through both CLIs on two copies of one seeded journal and
print the same lines; where a command writes (``check``'s flags and
events, ``compact``'s rollup), the written records are compared after
``ts`` and the rollup's file name (a clock and a process id) are removed.
"""

import json
import os
import time
import types

import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
import torch_journal_records as seeded
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.observability import autoscale as jax_autoscale
from igneous_tpu.observability import health as jax_health
from igneous_tpu.observability import journal as jax_journal
from igneous_tpu.observability import metrics as jax_metrics
from igneous_tpu.observability import prom as jax_prom
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu_torch import device
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.observability import autoscale as port_autoscale
from igneous_tpu_torch.observability import fleet as port_fleet
from igneous_tpu_torch.observability import health as port_health
from igneous_tpu_torch.observability import journal as port_journal
from igneous_tpu_torch.observability import metrics as port_metrics
from igneous_tpu_torch.observability import prom as port_prom
from igneous_tpu_torch.observability import trace as port_trace
from igneous_tpu_torch.parallel.lease_batcher import LeaseBatcher
from igneous_tpu_torch.queues import FileQueue
from igneous_tpu_torch.tasks import TouchFileTask

HEALTH = {"jax": jax_health, "port": port_health}

# (config overrides, queue stats, minutes after the records' NOW): a quiet
# fleet; a backlog (device idle, stalled journals, straggler); tight
# ceilings (recompile storm, memory high water, DLQ and retry rates, SLO)
SCENARIOS = [
  ({}, None, 0.0),
  ({}, {"backlog": 40, "leased": 3, "completed": 18, "dlq": 1, "stale_leases": 0}, 0.0),
  ({"stall_sec": 60.0}, {"backlog": 400}, 5.0),
  ({"recompiles_per_min_max": 1.0, "hbm_highwater_frac": 0.5, "dlq_rate_max": 0.01,
    "retry_rate_max": 0.1, "slo_p95_ms": 200.0, "straggler_ratio": 1.5,
    "device_idle_ratio": 0.5, "min_workers": 2, "max_workers": 6}, {"backlog": 9000}, 1.0),
]


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for name in ("IGNEOUS_JOURNAL", "IGNEOUS_METRICS_TEXTFILE", "QUEUE_URL"):
    monkeypatch.setenv(name, "")
    monkeypatch.delenv(name)
  device.reset_device()
  for metrics, trace, journal in ((jax_metrics, jax_trace, jax_journal),
                                  (port_metrics, port_trace, port_journal)):
    metrics.reset_all()
    trace.reset()
    journal.set_active(None)
  yield
  for metrics, trace, journal in ((jax_metrics, jax_trace, jax_journal),
                                  (port_metrics, port_trace, port_journal)):
    metrics.reset_all()
    trace.reset()
    journal.set_active(None)
  device.reset_device()


def _jax_cli(args):
  return CliRunner().invoke(jax_cli, [str(a) for a in args], catch_exceptions=False)


def _port_cli(args, capsys):
  rc = cli_main([str(a) for a in args])
  return rc, capsys.readouterr().out


@pytest.mark.parametrize("scenario", range(len(SCENARIOS)))
def test_health_report_byte_for_byte(scenario, monkeypatch):
  overrides, queue_stats, minutes = SCENARIOS[scenario]
  recs = seeded.records(scenario)
  now = seeded.NOW + 60.0 * minutes
  got = {}
  for who, health in HEALTH.items():
    base = dict(window_sec=600.0, straggler_ratio=3.0, straggler_min_tasks=3,
                stall_sec=120.0, forget_sec=3600.0, horizon_sec=600.0)
    base.update(overrides)
    report = health.HealthEngine(health.HealthConfig(**base)).evaluate(
      recs, queue_stats, now=now)
    got[who] = [health.report_json(report), health.check_lines(report),
                health.render_dashboard(report, queue_stats),
                json.dumps(health.health_events(report))]
  assert got["port"] == got["jax"]
  report = json.loads(got["port"][0])
  # the seeded fleet: w2 straggles with near-full memory, w1 dead-letters
  assert not report["healthy"] and report["devices"]["workers"] == 3
  assert "w2" in report["flagged_workers"]
  if scenario == 3:
    kinds = {a["kind"] for a in report["anomalies"]}
    assert {"recompile_storm", "hbm_high_water", "device_idle"} <= kinds


def test_health_gauges_render_byte_for_byte():
  recs = seeded.records(1)
  for who, (health, metrics, prom) in {"jax": (jax_health, jax_metrics, jax_prom),
                                       "port": (port_health, port_metrics, port_prom)}.items():
    report = health.HealthEngine(health.HealthConfig()).evaluate(
      recs, {"backlog": 12}, now=seeded.NOW)
    health.publish_gauges(report)
  assert port_prom.render() == jax_prom.render()
  assert "igneous_fleet_desired_workers" in port_prom.render()


def test_health_config_and_autoscale_policy_from_env(monkeypatch):
  env = {"IGNEOUS_HEALTH_WINDOW_SEC": "300", "IGNEOUS_HEALTH_STRAGGLER_MIN_TASKS": "5.7",
         "IGNEOUS_HEALTH_DEVICE_IDLE_RATIO": "0.2", "IGNEOUS_SLO_P95_MS": "250",
         "IGNEOUS_HEALTH_RECOMPILES_PER_MIN": "junk", "IGNEOUS_AUTOSCALE_MAX": "12",
         "IGNEOUS_AUTOSCALE_HYSTERESIS": "0.5", "IGNEOUS_AUTOSCALE_STEP_MAX": "3"}
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  import dataclasses

  for kw in ({}, {"window_sec": 90.0, "horizon_sec": 30.0}):
    assert dataclasses.asdict(port_health.HealthConfig.from_env(**kw)) == \
      dataclasses.asdict(jax_health.HealthConfig.from_env(**kw))
  assert dataclasses.asdict(port_autoscale.AutoscalePolicy.from_env()) == \
    dataclasses.asdict(jax_autoscale.AutoscalePolicy.from_env())
  pol = {"jax": jax_autoscale.AutoscalePolicy(min_workers=0, max_workers=20, hysteresis=0.25),
         "port": port_autoscale.AutoscalePolicy(min_workers=0, max_workers=20, hysteresis=0.25)}
  grid = [(b, r, c) for b in (0, 1, 50, 10_000) for r in (0.0, 0.01, 0.5, 3.0)
          for c in (0, 1, 4, 30)]
  assert [port_autoscale.compute_desired(*g, pol["port"]) for g in grid] == \
    [jax_autoscale.compute_desired(*g, pol["jax"]) for g in grid]


def _journal_pair(tmp_path, seed=0, now=None):
  now = time.time() if now is None else now
  recs = seeded.records(seed, now=now)
  for who in ("jax", "port"):
    seeded.write_segments(str(tmp_path / who / "journal"), recs)
  return {who: f"file://{tmp_path}/{who}/journal" for who in ("jax", "port")}


def test_fleet_read_commands_through_both_clis(tmp_path, capsys):
  paths = _journal_pair(tmp_path, seed=4, now=seeded.NOW)
  for args in (["status"], ["status", "--json"], ["top", "-n", "4"], ["devices"],
               ["devices", "--json"], ["trace", "4t21"]):
    out = {}
    for who, path in paths.items():
      if who == "jax":
        res = _jax_cli(["fleet", *args, "--journal", path])
        out[who] = (res.exit_code, res.output)
      else:
        out[who] = _port_cli(["fleet", *args, "--journal", path], capsys)
    assert out["port"] == out["jax"], args
    assert out["port"][0] == 0 and out["port"][1]
  # a trace with no spans, an empty journal: the JAX CLI's errors, exit 1
  rc = cli_main(["fleet", "trace", "nope", "--journal", paths["port"]])
  assert rc == 1 and "no spans recorded for trace nope" in capsys.readouterr().err
  rc = cli_main(["fleet", "status", "--journal", f"file://{tmp_path}/empty"])
  assert rc == 1 and "no journal segments under" in capsys.readouterr().err
  assert _jax_cli(["fleet", "status", "--journal", f"file://{tmp_path}/empty"]).exit_code == 1
  with pytest.raises(SystemExit) as e:  # no location at all: a usage error
    cli_main(["fleet", "status"])
  assert e.value.code == 2


def test_fleet_trace_writes_the_perfetto_export(tmp_path, capsys):
  paths = _journal_pair(tmp_path, seed=4, now=seeded.NOW)
  out = {}
  for who, path in paths.items():
    dest = tmp_path / f"{who}.json"
    args = ["fleet", "trace", "4t05", "--journal", path, "-o", dest]
    if who == "jax":
      out[who] = _jax_cli(args).output
    else:
      out[who] = _port_cli(args, capsys)[1]
    out[who] = out[who].replace(str(dest), "OUT")
  assert out["port"] == out["jax"]
  assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_fleet_compact_gc_then_status_through_both_clis(tmp_path, capsys, monkeypatch):
  paths = _journal_pair(tmp_path, seed=6, now=seeded.NOW)
  from igneous_tpu.observability import rollup as jax_rollup
  from igneous_tpu_torch.observability import rollup as port_rollup

  status = {}
  for who, path in paths.items():
    rollup = jax_rollup if who == "jax" else port_rollup
    monkeypatch.setattr(rollup, "time", types.SimpleNamespace(time=lambda: seeded.NOW))
    monkeypatch.setattr(rollup, "_SEQ", [0])
    run = (lambda a: (lambda r: (r.exit_code, r.output))(_jax_cli(a))) if who == "jax" \
      else (lambda a: _port_cli(a, capsys))
    before = run(["fleet", "status", "--journal", path])
    compacted = run(["fleet", "compact", "--journal", path, "--min-segments", "1"])
    after = run(["fleet", "status", "--journal", path])
    gc = run(["fleet", "gc", "--journal", path, "--retain-sec", "0"])
    res = json.loads(compacted[1])
    assert before == after and res["segments_compacted"] == 3
    status[who] = (after, res["windows"], gc, res["rollup_key"].split("-")[-1])
  assert status["port"] == status["jax"]
  assert json.loads(status["port"][2][1])["deleted"] == 3  # every raw segment was covered


def test_fleet_check_through_both_clis(tmp_path, capsys):
  """A backlogged queue and a seeded journal with a straggler: exit 2
  from both CLIs, the same lines, the same flags file and health events
  (written into each journal), the fleet gauges in the textfile."""
  paths = _journal_pair(tmp_path, seed=1)
  out, flags, events, textfile = {}, {}, {}, {}
  for who, path in paths.items():
    spec = f"fq://{tmp_path}/{who}"
    FileQueue(spec).insert([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(30)])
    tf = tmp_path / f"{who}.prom"
    args = ["fleet", "check", "-q", spec, "--textfile", tf]
    if who == "jax":
      res = CliRunner().invoke(jax_cli, [str(a) for a in args])
      out[who] = (res.exit_code, res.output)
    else:
      out[who] = _port_cli(args, capsys)
    flag = json.loads((tmp_path / who / "journal" / "health" / "flags.json").read_bytes())
    flag.pop("ts")
    flags[who] = flag
    recs = [r for r in port_fleet.load(path) if str(r.get("name", "")).startswith("health.")]
    events[who] = sorted(json.dumps({k: v for k, v in r.items() if k not in ("ts", "segment")},
                                    sort_keys=True) for r in recs)
    textfile[who] = [l for l in tf.read_text().splitlines() if "fleet_" in l or "slo_" in l]
  assert out["port"][0] == out["jax"][0] == 2
  # the lines carry the report's ages, which move between the two runs
  assert [l.split()[0] for l in out["port"][1].splitlines()] == \
    [l.split()[0] for l in out["jax"][1].splitlines()]
  assert flags["port"] == flags["jax"] and flags["port"]["stragglers"]
  assert events["port"] == events["jax"] and events["port"]
  assert textfile["port"] == textfile["jax"] and textfile["port"]
  # each package reads the other's flags
  assert port_health.flagged_workers(paths["jax"]) == jax_health.flagged_workers(paths["port"])


def test_fleet_check_json_and_watch(tmp_path, capsys):
  paths = _journal_pair(tmp_path, seed=0)
  rc, out = _port_cli(["fleet", "check", "--journal", paths["port"], "--json",
                       "--no-emit-events", "--no-flags", "--out", tmp_path / "rep.json"], capsys)
  report = json.loads(out)
  assert rc == (0 if report["healthy"] else 2)
  assert json.loads((tmp_path / "rep.json").read_text()) == report
  assert not os.path.exists(tmp_path / "port" / "journal" / "health")
  rc, out = _port_cli(["fleet", "watch", "--journal", paths["port"], "--once", "--json"], capsys)
  frame = json.loads(out)
  assert rc == 0 and frame["error"] is None and frame["report"]["workers"]
  rc, out = _port_cli(["fleet", "watch", "--journal", f"file://{tmp_path}/none",
                       "--iterations", "1", "--no-clear"], capsys)
  assert rc == 0 and out.startswith("fleet watch: no journal segments under")


@pytest.mark.parametrize("flagged", [False, True])
def test_flagged_worker_stops_preleasing(flagged, tmp_path):
  """``fleet check``'s flags name this worker: it runs the rounds it
  holds but pre-leases none (the JAX package wrote the flags)."""
  spec = f"fq://{tmp_path}/q"
  q = FileQueue(spec)
  q.insert([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(6)])
  path = f"file://{tmp_path}/q/journal"
  j = port_journal.Journal(path, worker_id="w-slow", flush_interval=3600)
  port_journal.set_active(j)
  jax_health.write_flags(path, {
    "ts": time.time(), "flagged_workers": ["w-slow"] if flagged else ["w-other"],
    "autoscale": {"desired_workers": 2},
  })
  batcher = LeaseBatcher(q, batch_size=2, lease_seconds=60)
  executed = batcher.poll(stop_fn=lambda executed, empty: empty)
  assert executed == 6 and q.completed == 6
  st = batcher.stats
  if flagged:
    assert st["prefetched_rounds"] == 0 and st["straggler_prefetch_skips"] >= 1
  else:
    assert st["prefetched_rounds"] >= 1 and st["straggler_prefetch_skips"] == 0


def test_flagged_worker_surrenders_its_prelease(tmp_path):
  spec = f"fq://{tmp_path}/q"
  q = FileQueue(spec)
  q.insert([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(4)])
  path = f"file://{tmp_path}/q/journal"
  port_journal.set_active(port_journal.Journal(path, worker_id="w-late", flush_interval=3600))
  batcher = LeaseBatcher(q, batch_size=2, lease_seconds=60)
  calls = {"n": 0}

  def flagged_after_first():
    calls["n"] += 1
    return calls["n"] > 1  # round 1 pre-leases round 2; then the flag lands

  batcher._straggler_flagged = flagged_after_first
  executed = batcher.poll(stop_fn=lambda executed, empty: empty)
  assert executed == 4 and q.completed == 4
  assert batcher.stats["straggler_surrenders"] == 1 and batcher.stats["released"] == 2
