"""The port's workload miner, fleet simulator and autoscale controller
against the JAX package's.

The simulator is pure Python with one seeded ``random.Random``, a (time,
seq) event heap and counter ids: for the same seed, model and config the
port's ``simulate`` gives the JAX one's results dict and emitted journal
bytes exactly (survival on and off, every chaos mode, a virtual policy
loop), ``mine_journal`` of one journal gives an equal ``to_dict()`` and
``what_if`` equal rows. The JAX package's own cases of ``tests/test_sim.py``
(``WorkloadModel``, the simulator, the policy, the actuators with a fake
``Popen``, the controller) run on both packages, each package's outcome
equal to the other's; ``fleet simulate`` prints what the JAX CLI prints
and ``fleet autoscale`` writes the same target.
"""

import hashlib
import json
import pathlib
import random
import subprocess
import sys
import time
import types

import pytest
from click.testing import CliRunner

import igneous_tpu.telemetry as jax_telemetry
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.observability import autoscale as jax_autoscale
from igneous_tpu.observability import fleet as jax_fleet
from igneous_tpu.observability import health as jax_health
from igneous_tpu.observability import journal as jax_journal
from igneous_tpu.observability import replay as jax_replay
from igneous_tpu.observability import rollup as jax_rollup
from igneous_tpu.observability import sim as jax_sim
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu.queues import FileQueue as JaxFileQueue
from igneous_tpu.storage import CloudFiles as JaxCloudFiles
from igneous_tpu.tasks import TouchFileTask as JaxTouchFileTask
from igneous_tpu_torch import device, telemetry
from igneous_tpu_torch.cli import main as port_cli
from igneous_tpu_torch.observability import (
  autoscale, fleet, health, journal, replay, rollup, sim, trace,
)
from igneous_tpu_torch.queues import FileQueue
from igneous_tpu_torch.storage import CloudFiles

PKG = {
  "jax": types.SimpleNamespace(
    autoscale=jax_autoscale, fleet=jax_fleet, health=jax_health, journal=jax_journal,
    replay=jax_replay, rollup=jax_rollup, sim=jax_sim, telemetry=jax_telemetry,
    trace=jax_trace, FileQueue=JaxFileQueue, CloudFiles=JaxCloudFiles,
  ),
  "port": types.SimpleNamespace(
    autoscale=autoscale, fleet=fleet, health=health, journal=journal,
    replay=replay, rollup=rollup, sim=sim, telemetry=telemetry,
    trace=trace, FileQueue=FileQueue, CloudFiles=CloudFiles,
  ),
}


def _reset():
  for P in PKG.values():
    P.telemetry.reset_all()
    P.trace.reset()
    P.journal.set_active(None)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for name in ("IGNEOUS_JOURNAL", "QUEUE_URL", "SQS_URL", "IGNEOUS_JOURNAL_COMPRESS"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  _reset()
  yield
  _reset()
  device.reset_device()


def _task_span(worker, trace_id, ts, dur, task="DemoTask", attempt=1, error=None):
  rec = {
    "kind": "span", "worker": worker, "trace": trace_id,
    "span": f"s-{trace_id}-{attempt}", "parent": None, "name": "task",
    "ts": ts, "dur": dur, "task": task, "attempt": attempt,
  }
  if error:
    rec["error"] = error
  return rec


def _demo_records(n=60, fail_every=0, workers=("w0", "w1")):
  recs = []
  for i in range(n):
    w = workers[i % len(workers)]
    recs.append(_task_span(w, f"t{i}", 100.0 + i, 0.5 + (i % 10) * 0.05))
    if fail_every and i % fail_every == 0:
      recs.append(_task_span(w, f"t{i}", 100.0 + i, 0.1, attempt=2, error="boom"))
    recs.append({
      "kind": "span", "worker": w, "trace": f"r{i}", "span": f"l{i}",
      "parent": None, "name": "lease.acquire", "ts": 100.0 + i,
      "dur": 0.02, "members": 1, "range_sizes": [1 + i % 3],
    })
  return recs


def _put_journal(path, records, name="w0-000000.jsonl"):
  lines = [json.dumps(r) for r in records]
  CloudFiles(path).put(name, ("\n".join(lines) + "\n").encode("utf8"), compress=None)


def _files(root: pathlib.Path) -> dict:
  return {str(f.relative_to(root)): f.read_bytes()
          for f in sorted(root.rglob("*")) if f.is_file()}


def _both(case, tmp_path=None):
  got = {}
  for who in ("jax", "port"):
    _reset()
    args = (PKG[who],) if tmp_path is None else (PKG[who], tmp_path / who)
    got[who] = case(*args)
  assert got["port"] == got["jax"]
  return got["port"]


# ---------------------------------------------------------------------------
# the simulator: results and journal bytes


SIM_CONFIGS = {
  "plain": dict(workers=3, seed=11, tasks=100, batch_size=2),
  "range_lease": dict(workers=4, seed=2, tasks=120, batch_size=4, range_lease=1),
  "survival": dict(workers=3, seed=11, tasks=48, batch_size=4, lease_sec=10.0,
                   range_lease=1, speculate=1, steal=1, steal_min_held_sec=1.0,
                   speculate_interval_sec=2.0, worker_arrivals=[0.0, 1.5, 4.0]),
  "preempt": dict(workers=2, seed=3, tasks=60, batch_size=4,
                  chaos=dict(preempt=1, preempt_at=2.0)),
  "kill": dict(workers=2, seed=5, tasks=60, batch_size=4, lease_sec=5.0,
               chaos=dict(kill=1, kill_at=1.0)),
  "stall": dict(workers=2, seed=7, tasks=40, batch_size=4, lease_sec=5.0,
                chaos=dict(stall=1)),
  "stragglers": dict(workers=4, seed=9, tasks=80, batch_size=2,
                     chaos=dict(stragglers=2, straggler_factor=3.0)),
  "survival_chaos": dict(workers=3, seed=11, tasks=24, batch_size=4, lease_sec=10.0,
                         range_lease=1, speculate=1, steal=1, steal_min_held_sec=1.0,
                         speculate_interval_sec=2.0, worker_arrivals=[0.0, 1.5, 4.0],
                         chaos=dict(stall=1, kill=1, kill_at=2.0)),
  "autoscale": dict(workers=1, seed=2, tasks=400, batch_size=2, autoscale=True,
                    autoscale_interval_sec=5.0, cost_per_worker_hour=2.5,
                    policy=dict(min_workers=1, max_workers=6, horizon_sec=20.0,
                                cooldown_sec=5.0)),
  "failures": dict(workers=2, seed=1, tasks=30, max_deliveries=3, fail_scale=3.0),
}


def _config(P, spec):
  kw = dict(spec)
  if "chaos" in kw:
    kw["chaos"] = P.sim.ChaosSpec(**kw["chaos"])
  if "policy" in kw:
    kw["policy"] = P.autoscale.AutoscalePolicy(**kw["policy"])
  return P.sim.SimConfig(**kw)


@pytest.mark.parametrize("name", sorted(SIM_CONFIGS))
def test_simulate_results_and_journal_bytes_as_the_reference(name, tmp_path):
  def case(P, root):
    model = P.replay.WorkloadModel.mine(_demo_records(fail_every=7))
    res = P.sim.simulate(model, _config(P, SIM_CONFIGS[name]),
                         journal_path=f"file://{root}/simj")
    res["journal_path"] = None
    return res, _files(root / "simj")

  res, files = _both(case, tmp_path)
  assert res["completed_all"] and files
  spec = res["speculation"]
  assert spec["won"] + spec["fenced"] == spec["issued"]
  if name == "survival_chaos":
    assert spec["issued"] >= 1
  if name == "autoscale":
    assert res["autoscale"]["ups"] >= 1 and res["autoscale"]["downs"] >= 1


def test_mine_journal_and_what_if_as_the_reference(tmp_path):
  path = f"file://{tmp_path}/j"
  _put_journal(path, _demo_records(n=40, fail_every=5, workers=("w0", "w1", "w2")))

  def case(P):
    model = P.replay.mine_journal(path)
    base = P.sim.SimConfig(workers=2, seed=4, batch_size=2)
    rows = P.sim.what_if(model, base, [1, 3, 8])
    return model.to_dict(), rows

  model, rows = _both(case)
  assert model["task_types"]["DemoTask"]["failures"] == 8
  assert [r["workers"] for r in rows] == [1, 3, 8]


def test_a_model_saved_by_either_package_loads_in_the_other(tmp_path):
  for saver, loader in (("jax", "port"), ("port", "jax")):
    S, L = PKG[saver], PKG[loader]
    m = S.replay.WorkloadModel.mine(_demo_records())
    m.save(f"file://{tmp_path}/{saver}")
    back = L.replay.WorkloadModel.load(f"file://{tmp_path}/{saver}")
    assert back.to_dict() == m.to_dict()


# ---------------------------------------------------------------------------
# the JAX package's own cases, on both packages


def mine_durations_exclude_errors(P):
  m = P.replay.WorkloadModel.mine(_demo_records(n=40, fail_every=4))
  st = m.task_types["DemoTask"]
  assert (st["failures"], st["count"], len(st["durs"]), st["max_attempt"]) == (10, 50, 40, 2)
  assert 0.19 < m.fail_prob("DemoTask") < 0.21
  return m.to_dict()


def round_overhead_and_bytes_attribution(P):
  recs = _demo_records(n=10) + [{
    "kind": "span", "worker": "w0", "trace": "t3", "span": "b1", "parent": None,
    "name": "device.h2d", "ts": 103.5, "dur": 0.01, "bytes": 4096,
  }]
  m = P.replay.WorkloadModel.mine(recs)
  assert m.round_overhead["count"] == 10
  assert m.task_types["DemoTask"]["bytes_per_task"] == pytest.approx(409.6)
  return m.to_dict(), m.sample_round_overhead(random.Random(0))


def worker_speed_spread(P):
  recs = []
  for i in range(20):
    recs.append(_task_span("fast", f"f{i}", 100 + i, 1.0))
    recs.append(_task_span("slow", f"s{i}", 100 + i, 3.0))
  m = P.replay.WorkloadModel.mine(recs)
  assert m.worker_speeds[-1] / m.worker_speeds[0] == pytest.approx(3.0, rel=0.01)
  return m.worker_speeds


def roundtrip_and_version_guard(P):
  m = P.replay.WorkloadModel.mine(_demo_records())
  m2 = P.replay.WorkloadModel.from_dict(json.loads(json.dumps(m.to_dict())))
  assert m2.task_types == m.task_types and m2.worker_speeds == m.worker_speeds
  with pytest.raises(ValueError):
    P.replay.WorkloadModel.from_dict({"version": P.replay.MODEL_VERSION + 1})
  return m2.to_dict()


def mine_from_rollups_matches_raw(P, root):
  path = f"file://{root}/journal"
  _put_journal(path, _demo_records(n=30, workers=("w0",)))
  raw_model = P.replay.mine_journal(path)
  P.rollup.compact(path, min_segments=1)
  rolled = P.replay.mine_journal(path)
  assert rolled.task_types["DemoTask"]["durs"] == raw_model.task_types["DemoTask"]["durs"]
  return raw_model.to_dict()


def completes_campaign(P):
  res = P.sim.FleetSimulator(P.replay.WorkloadModel.mine(_demo_records()),
                             P.sim.SimConfig(workers=4, seed=0, tasks=80)).run()
  assert res["completed_all"] and res["completed"] == 80
  return res


def dlq_after_max_deliveries(P):
  recs = [_task_span("w0", f"t{i}", 100 + i, 0.2, error="boom") for i in range(10)]
  res = P.sim.FleetSimulator(P.replay.WorkloadModel.mine(recs), P.sim.SimConfig(
    workers=2, seed=1, tasks=12, max_deliveries=3)).run()
  assert res["dlq"] >= 8 and res["completed"] + res["dlq"] == 12
  assert res["failed_deliveries"] >= res["dlq"] * 3 and res["completed_all"]
  return res


def preempt_drains_gracefully(P, root):
  cfg = P.sim.SimConfig(workers=2, seed=3, tasks=60, batch_size=4)
  cfg.chaos = P.sim.ChaosSpec(preempt=1, preempt_at=2.0)
  s = P.sim.FleetSimulator(P.replay.WorkloadModel.mine(_demo_records()), cfg)
  res = s.run()
  assert len([w for w in s.workers.values() if w.exit_event == "drain"]) == 1
  s.write_journal(f"file://{root}/j")
  events = [r.get("event") for r in P.journal.read_records(f"file://{root}/j")
            if r.get("kind") == "counters"]
  assert "drain" in events
  return res, events


def stall_holds_then_recycles(P):
  cfg = P.sim.SimConfig(workers=2, seed=7, tasks=40, batch_size=4, lease_sec=5.0)
  cfg.chaos = P.sim.ChaosSpec(stall=1)
  s = P.sim.FleetSimulator(P.replay.WorkloadModel.mine(_demo_records()), cfg)
  res = s.run()
  stalled = [w for w in s.workers.values() if w.stalled]
  assert res["lease_recycles"] >= 1 and len(stalled) == 1
  assert stalled[0].exit_event is None
  return res


def emitted_journal_is_first_class(P, root):
  s = P.sim.FleetSimulator(P.replay.WorkloadModel.mine(_demo_records()),
                           P.sim.SimConfig(workers=3, seed=4, tasks=50, batch_size=2))
  res = s.run()
  path = f"file://{root}/simj"
  s.write_journal(path)
  records = P.fleet.load_effective(path)
  st = P.fleet.status(records)
  assert st["tasks"] == 50 and len(st["workers"]) == 4
  report = P.health.HealthEngine().evaluate(records, {"backlog": 0}, now=res["makespan_sec"])
  assert report["autoscale"]["per_worker_tasks_per_sec"] > 0
  assert P.replay.mine_journal(path).total_tasks() == 50
  return st, report["autoscale"]


def tasks_scaling_keeps_mix(P):
  recs = [_task_span("w0", f"a{i}", 100 + i, 0.5, task="A") for i in range(30)]
  recs += [_task_span("w0", f"b{i}", 200 + i, 0.5, task="B") for i in range(10)]
  s = P.sim.FleetSimulator(P.replay.WorkloadModel.mine(recs),
                           P.sim.SimConfig(workers=1, seed=0, tasks=20))
  res = s.run()
  assert sum(1 for t in s.tasks if t["type"] == "A") == 15
  return res, [t["type"] for t in s.tasks]


def config_from_env(P):
  cfg = P.sim.SimConfig.from_env(seed=3)
  assert (cfg.workers, cfg.fail_scale, cfg.seed) == (9, 2.5, 3)
  pol = P.autoscale.AutoscalePolicy.from_env(max_workers=50)
  assert (pol.min_workers, pol.max_workers, pol.step_max) == (2, 50, 5)
  return [(f, getattr(cfg, f)) for f in ("workers", "fail_scale", "seed", "batch_size",
                                         "lease_sec", "range_lease", "speculate", "steal")]


def compute_desired_formula(P):
  pol = P.autoscale.AutoscalePolicy(min_workers=1, max_workers=10, horizon_sec=100.0,
                                    hysteresis=0.2)
  cd = P.autoscale.compute_desired
  out = [cd(500, 1.0, 1, pol), cd(0, 1.0, 7, pol), cd(50, 0.0, 4, pol),
         cd(10**6, 1.0, 1, pol), cd(500, 1.1, 5, pol)]
  assert [d for d, _ in out] == [5, 1, 4, 10, 5]
  assert (out[0][1], out[4][1]) == (False, True)
  zero = P.autoscale.AutoscalePolicy(min_workers=0, max_workers=5)
  assert cd(100, 0.0, 0, zero)[0] == 1 and cd(0, 0.0, 0, zero)[0] == 0
  return out


def policy_loop_cooldown_and_step(P):
  loop = P.autoscale.PolicyLoop(P.autoscale.AutoscalePolicy(
    min_workers=1, max_workers=100, horizon_sec=10.0, cooldown_sec=60.0, step_max=3))
  d = [loop.decide(1000, 1.0, 1, now=0.0), loop.decide(1000, 1.0, 4, now=30.0),
       loop.decide(1000, 1.0, 4, now=61.0), loop.decide(0, 1.0, 7, now=200.0)]
  assert [(x["reason"], x["target"]) for x in d[:3]] == [
    ("scale_up", 4), ("cooldown", 4), ("scale_up", 7)]
  return d


def matches_health_engine_report(P, root):
  path = f"file://{root}/j"
  now = 1_700_000_000.0
  _put_journal(path, [{"kind": "counters", "worker": "w0", "ts": now, "event": "interval",
                       "counters": {}, "timers": {}, "gauges": {}}]
               + [_task_span("w0", f"t{i}", now - 60 + i, 1.0) for i in range(20)])
  report = P.health.HealthEngine(P.health.HealthConfig(
    horizon_sec=10.0, min_workers=1, max_workers=100,
  )).evaluate(P.fleet.load_effective(path), {"backlog": 500}, now=now)
  rate = report["autoscale"]["per_worker_tasks_per_sec"]
  expected, _ = P.autoscale.compute_desired(500, rate, 1, P.autoscale.AutoscalePolicy(
    min_workers=1, max_workers=100, horizon_sec=10.0))
  assert report["autoscale"]["desired_workers"] == expected
  return expected, rate


class _FakeProc:
  def __init__(self):
    self.signals = []
    self.rc = None

  def poll(self):
    return self.rc

  def send_signal(self, sig):
    self.signals.append(sig)
    self.rc = 83  # the graceful-drain exit code

  def wait(self, timeout=None):
    return self.rc

  def kill(self):
    self.rc = -9


def local_pool_spawn_and_drain(P):
  act = P.autoscale.LocalPoolActuator("fq:///nowhere")
  act._spawn = lambda: _FakeProc()
  act.scale_to(3)
  assert act.current() == 3
  act.scale_to(1)
  assert len([p for p in act.procs if p.signals]) == 2
  assert act.current() == 1
  assert act.stats["drained"] == 2 and act.stats["exits"].get("83") == 2
  return act.stats


def textfile_and_command_actuators(P, root):
  target = root / "scale" / "desired.json"
  act = P.autoscale.TextfileActuator(str(target))
  act.scale_to(7)
  assert json.loads(target.read_text())["desired_workers"] == 7 and act.current() == 7
  assert not list(target.parent.glob("*.tmp.*"))
  with pytest.raises(ValueError):
    P.autoscale.CommandActuator("kubectl scale --replicas=3")
  out = root / "n.txt"
  cmd = P.autoscale.CommandActuator(f"sh -c 'echo {{n}} > {out}'")
  cmd.scale_to(4)
  assert out.read_text().strip() == "4" and cmd.current() == 4
  with pytest.raises(RuntimeError):
    P.autoscale.CommandActuator("false {n}").scale_to(2)
  return sorted(json.loads(target.read_text())), out.read_text()


def controller_scales_up_then_down_and_journals(P, root):
  class Dummy(P.autoscale.Actuator):
    name = "dummy"

    def __init__(self):
      self.n = 0

    def current(self):
      return self.n

    def scale_to(self, n):
      self.n = n

  qdir = root / "q"
  fq = P.FileQueue(str(qdir))
  fq.insert([JaxTouchFileTask(path=str(root / f"touch{i}")).to_json() for i in range(300)])
  jpath = f"file://{qdir}/journal"
  now = 1_700_000_000.0
  _put_journal(jpath, [{"kind": "counters", "worker": "w0", "ts": now, "event": "interval",
                        "counters": {}, "timers": {}, "gauges": {}}]
               + [_task_span("w0", f"t{i}", now - 45 + i, 1.0) for i in range(30)])
  act = Dummy()
  ctrl = P.autoscale.AutoscaleController(jpath, fq, act, policy=P.autoscale.AutoscalePolicy(
    min_workers=0, max_workers=8, horizon_sec=30.0, cooldown_sec=0.0), interval_sec=0.0)
  d1 = ctrl.step(now=now)
  up = act.n
  fq.purge()
  d2 = ctrl.step(now=now + 60)
  assert (d1["reason"], d2["reason"], act.n) == ("scale_up", "scale_down", 0) and up > 0
  recs = list(P.journal.read_records(jpath))
  actions = [r for r in recs if r.get("name") == "autoscale.action"]
  assert len(actions) == 2
  last = [r for r in recs if r.get("kind") == "counters"
          and str(r.get("worker", "")).startswith("autoscale-")][-1]["counters"]
  assert last.get("autoscale.scale_up") == 1 and last.get("autoscale.scale_down") == 1
  report = P.health.HealthEngine().evaluate(
    P.fleet.load_effective(jpath), {"backlog": 5}, now=now + 120)
  assert not any(s["worker"].startswith("autoscale-") for s in report["stragglers"])
  strip = ("worker", "span", "trace")
  return up, [{k: v for k, v in a.items() if k not in strip} for a in actions]


CASES = [
  mine_durations_exclude_errors, round_overhead_and_bytes_attribution, worker_speed_spread,
  roundtrip_and_version_guard, completes_campaign, dlq_after_max_deliveries,
  stall_holds_then_recycles, tasks_scaling_keeps_mix, compute_desired_formula,
  policy_loop_cooldown_and_step, local_pool_spawn_and_drain,
]
FILE_CASES = [
  mine_from_rollups_matches_raw, preempt_drains_gracefully, emitted_journal_is_first_class,
  matches_health_engine_report, textfile_and_command_actuators,
  controller_scales_up_then_down_and_journals,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_as_the_reference(case):
  _both(case)


@pytest.mark.parametrize("case", FILE_CASES, ids=[c.__name__ for c in FILE_CASES])
def test_file_case_as_the_reference(case, tmp_path):
  _both(case, tmp_path)


def test_config_from_env_as_the_reference(monkeypatch):
  monkeypatch.setenv("IGNEOUS_SIM_WORKERS", "9")
  monkeypatch.setenv("IGNEOUS_SIM_FAIL_SCALE", "2.5")
  monkeypatch.setenv("IGNEOUS_AUTOSCALE_MIN", "2")
  monkeypatch.setenv("IGNEOUS_AUTOSCALE_STEP_MAX", "5")
  _both(config_from_env)


@pytest.mark.parametrize("name,value", [
  ("IGNEOUS_SIM_BATCH", "3.7"), ("IGNEOUS_SIM_LEASE_SEC", "nope"),
  ("IGNEOUS_STEAL", "off"), ("IGNEOUS_STEAL", "yes"), ("IGNEOUS_CAMPAIGN_SPECULATE", "0"),
  ("IGNEOUS_STEAL_FRACTION", "0.25"), ("IGNEOUS_SPECULATE_MAX_TWINS", ""),
  ("IGNEOUS_CAMPAIGN_MAX_WALL_SEC", "12"), ("IGNEOUS_AUTOSCALE_INTERVAL_SEC", "bad"),
])
def test_knobs_parse_as_the_reference(name, value, monkeypatch):
  from igneous_tpu.analysis import knobs as jax_knobs
  from igneous_tpu_torch.analysis import knobs

  monkeypatch.setenv(name, value)
  kind = knobs.KNOBS[name].type
  get = {"int": "get_int", "float": "get_float", "bool": "get_bool", "str": "get_str"}[kind]
  assert getattr(knobs, get)(name) == getattr(jax_knobs, get)(name)
  assert kind == jax_knobs._lookup(name).type


def test_every_campaign_knob_has_the_reference_default():
  from igneous_tpu.analysis import knobs as jax_knobs
  from igneous_tpu_torch.analysis import knobs

  names = [n for n in knobs.KNOBS
           if n.startswith(("IGNEOUS_SPECULATE_", "IGNEOUS_STEAL", "IGNEOUS_CAMPAIGN_",
                            "IGNEOUS_SIM_", "IGNEOUS_AUTOSCALE_"))]
  assert set(names) == {k.name for k in jax_knobs._REGISTRY.values()
                        if k.section in ("campaign survival", "simulator", "autoscale")}
  for name in names:
    knob = jax_knobs._lookup(name)
    assert (knobs.KNOBS[name].type, knobs.KNOBS[name].default) == (knob.type, knob.default), name


def test_local_pool_spawns_the_port_worker(monkeypatch):
  """The port's pool starts ``python -m igneous_tpu_torch execute`` with the
  worker args and the environment the caller gave, never the JAX package."""
  calls = []

  class Popen:
    def __init__(self, cmd, env=None):
      calls.append((cmd, env))

    def poll(self):
      return None

  monkeypatch.setattr(subprocess, "Popen", Popen)
  act = autoscale.LocalPoolActuator("fq://./q", worker_args=["--batch", "4"],
                                    env={"IGNEOUS_STEAL": "1"})
  act.scale_to(2)
  assert [c for c, _ in calls] == [
    [sys.executable, "-m", "igneous_tpu_torch", "execute", "fq://./q", "--batch", "4"]] * 2
  assert all(env["IGNEOUS_STEAL"] == "1" for _, env in calls)


def test_a_draining_worker_is_signalled_once():
  """Every scale-down tick sees a draining worker still running; it gets
  its SIGTERM once (a second, after its handlers are gone, would kill
  it), and `drained` counts it once."""

  class Slow(_FakeProc):
    def send_signal(self, sig):
      self.signals.append(sig)  # drains slowly: still running

  act = autoscale.LocalPoolActuator("fq:///nowhere")
  act._spawn = Slow
  act.scale_to(2)
  for _ in range(3):
    act.scale_to(0)
  assert [len(p.signals) for p in act.procs] == [1, 1]
  assert act.stats["drained"] == 2 and act.current() == 2
  for p in act.procs:
    p.rc = 83
  assert act.current() == 0 and act.stats["exits"] == {"83": 2}


# ---------------------------------------------------------------------------
# the CLI


def _jax(args):
  res = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
  assert res.exit_code == 0, res.output
  return res.output


def _port(args, capsys):
  capsys.readouterr()
  assert port_cli(args) == 0
  return capsys.readouterr().out


@pytest.mark.parametrize("extra", [
  [], ["--json"], ["--speculate", "--steal", "--batch-size", "4"],
  ["--policy", "auto", "--min-workers", "1", "--max-workers", "5", "--cooldown-sec", "5",
   "--horizon-sec", "20", "--what-if", "1,4", "--cost-per-worker-hour", "3"],
  ["--chaos", "preempt=1,kill=1,stragglers=1,stall=1", "--tasks", "40"],
], ids=["plain", "json", "survival", "autoscale", "chaos"])
def test_fleet_simulate_prints_the_reference_output(extra, tmp_path, capsys):
  path = f"file://{tmp_path}/j"
  _put_journal(path, _demo_records(n=30, fail_every=6, workers=("w0", "w1")))
  outs, trees = {}, {}
  for who, run in (("jax", lambda a: _jax(a)), ("port", lambda a: _port(a, capsys))):
    emit = f"file://{tmp_path}/sim-{who}"
    out = run(["fleet", "simulate", "--journal", path, "--workers", "2", "--seed", "6",
               "--emit-journal", emit, "--save-model", str(tmp_path / f"model-{who}.json"),
               *extra])
    outs[who] = out.replace(emit, "EMIT")
    trees[who] = _files(tmp_path / f"sim-{who}")
    assert (tmp_path / f"model-{who}.json").read_bytes()
  assert outs["port"] == outs["jax"]
  assert trees["port"] == trees["jax"]
  assert (tmp_path / "model-port.json").read_bytes() == (tmp_path / "model-jax.json").read_bytes()
  # the emitted journal reads in the port's fleet status
  assert port_cli(["fleet", "status", "--journal", f"file://{tmp_path}/sim-port"]) == 0


def test_fleet_autoscale_writes_the_reference_target(tmp_path, capsys):
  targets = {}
  for who in ("jax", "port"):
    qdir = tmp_path / who / "q"
    PKG[who].FileQueue(str(qdir)).insert(
      [JaxTouchFileTask(path=str(tmp_path / f"t{i}")).to_json() for i in range(10)])
    _put_journal(f"file://{qdir}/journal", _demo_records(n=20, workers=("w0",)))
    args = ["fleet", "autoscale", "-q", f"fq://{qdir}", "--actuator", "textfile",
            "--target-file", str(tmp_path / who / "desired.json"),
            "--min-workers", "0", "--iterations", "1", "--interval", "0", "--json"]
    if who == "jax":
      res = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
      assert res.exit_code == 0, res.output
      out, err = res.stdout, res.stderr
    else:
      capsys.readouterr()
      assert port_cli(args) == 0
      got = capsys.readouterr()
      out, err = got.out, got.err
    assert "policy validated in simulation" in err
    decision, summary = [json.loads(line) for line in out.strip().splitlines()]
    decision.pop("ts")
    target = json.loads((tmp_path / who / "desired.json").read_text())
    target.pop("ts")
    targets[who] = (decision, summary, target, err)
  assert targets["port"] == targets["jax"]
  assert targets["port"][2]["desired_workers"] >= 1
