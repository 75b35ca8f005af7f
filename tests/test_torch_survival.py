"""Campaign survival in the port against the JAX package's.

Straggler speculation (``spec/``) and work stealing (``steal/``) keep their
state in the queue directory's sidecars, which both packages read and
write alike. (a) One script of queue operations (lease, speculate, twin
ack first or holder ack first, interleaved acks, a twin split, a meta
clobber, a steal claim serviced by the holder's renewal, claim expiry and
recycle, ``_survival_gc``) runs on each package's ``FileQueue`` in twin
directories with ``uuid4`` and the lease pick made deterministic; the
trees (``ts``, ``leased_at`` and lease deadlines normalised), the
counters and the speculation tallies are equal after every step. (b) A
JAX holder with a port thief, and a port holder speculated on by the JAX
package, on one queue directory: tallies exact and ``won + fenced ==
issued``. (c) The JAX package's own survival cases run on both packages,
each package's outcome equal to the other's.
"""

import json
import os
import pathlib
import random
import re
import threading
import time
import types
import uuid

import pytest

import igneous_tpu.telemetry as jax_telemetry
from igneous_tpu.observability import campaign as jax_campaign
from igneous_tpu.observability import fleet as jax_fleet
from igneous_tpu.observability import journal as jax_journal
from igneous_tpu.observability import metrics as jax_metrics
from igneous_tpu.observability import replay as jax_replay
from igneous_tpu.observability import sim as jax_sim
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu.queues import FileQueue as JaxFileQueue
from igneous_tpu.queues import PrintTask as JaxPrintTask
from igneous_tpu.queues import filequeue as jax_filequeue
from igneous_tpu_torch import device, telemetry
from igneous_tpu_torch.observability import campaign, fleet, journal, metrics, replay, sim, trace
from igneous_tpu_torch.queues import FileQueue, PrintTask
from igneous_tpu_torch.queues import filequeue as port_filequeue

PKG = {
  "jax": types.SimpleNamespace(
    FileQueue=JaxFileQueue, PrintTask=JaxPrintTask, telemetry=jax_telemetry,
    metrics=jax_metrics, trace=jax_trace, journal=jax_journal, fleet=jax_fleet,
    replay=jax_replay, sim=jax_sim, campaign=jax_campaign,
    SEG_PREFIX=jax_filequeue.SEG_PREFIX,
  ),
  "port": types.SimpleNamespace(
    FileQueue=FileQueue, PrintTask=PrintTask, telemetry=telemetry,
    metrics=metrics, trace=trace, journal=journal, fleet=fleet,
    replay=replay, sim=sim, campaign=campaign,
    SEG_PREFIX=port_filequeue.SEG_PREFIX,
  ),
}


def _reset_observability():
  for P in PKG.values():
    P.telemetry.reset_all()
    P.metrics.reset_all()
    P.trace.reset()
    P.journal.set_active(None)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # race tests need fresh leases and eager survival paths, not throttles
  monkeypatch.setenv("IGNEOUS_QUEUE_RECYCLE_SEC", "0")
  monkeypatch.setenv("IGNEOUS_SPECULATE_MIN_HELD_SEC", "0")
  monkeypatch.setenv("IGNEOUS_STEAL_MIN_HELD_SEC", "0")
  for name in ("IGNEOUS_QUEUE_SHARDS", "IGNEOUS_QUEUE_SEG_TASKS", "IGNEOUS_STEAL_CLAIM_TTL_SEC"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  _reset_observability()
  yield
  _reset_observability()
  device.reset_device()


def make_queue(P, root, n=8, worker_id="holder", name="q"):
  q = P.FileQueue(f"fq://{root}/{name}", worker_id=worker_id)
  if n:
    q.insert_batch([P.PrintTask(f"t{i}") for i in range(n)])
  return q


def view(P, q, worker_id):
  return P.FileQueue(f"fq://{q.path}", worker_id=worker_id)


def settle():
  """Let a lease age past the millisecond its ``leased_at`` is rounded
  to: the JAX package reads a lease taken this millisecond as held for a
  negative time and skips it even at a threshold of 0 (the port clamps,
  ``test_a_lease_just_taken_counts_as_held``)."""
  time.sleep(0.002)


def speculate(P, q, holders):
  settle()
  return view(P, q, "speculator").speculate_flagged(set(holders))


def _survival_counters(P) -> dict:
  return {k: v for k, v in P.telemetry.counters_snapshot().items()
          if k.startswith(("speculation.", "steal.", "zombie."))
          and k != "speculation.wasted_ms"}


def _outcome(P, q) -> dict:
  return {
    "completed": q.completed, "won": q.speculation_won,
    "fenced": q.speculation_fenced, "empty": q.is_empty(),
    "leased": sorted(os.listdir(q.lease_dir)), "counters": _survival_counters(P),
  }


# ---------------------------------------------------------------------------
# (c) the JAX package's own cases, on both packages


def holder_first_then_twin_acks_are_fenced(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  twin_q = view(P, q, "twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  assert len(twin) == 8
  assert all(q.ack_batch([t for _x, t in held]))
  assert q.completed == 8
  twin_q.ack_batch([t for _x, t in twin])
  assert q.completed == 8
  assert q.is_empty() and os.listdir(q.lease_dir) == []
  assert q.speculation_fenced == 8 and q.speculation_won == 0
  assert P.telemetry.counters_snapshot().get("speculation.issued") == 8
  assert P.telemetry.counters_snapshot().get("speculation.duplicate_ack") == 8
  return _outcome(P, q)


def twin_first_wins_and_holder_is_fenced(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  twin_q = view(P, q, "twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  twin_q.ack_batch([t for _x, t in twin])
  assert q.completed == 8
  q.ack_batch([t for _x, t in held])
  assert q.completed == 8
  assert q.speculation_won == 8 and q.speculation_fenced == 0
  assert q.is_empty() and os.listdir(q.lease_dir) == []
  return _outcome(P, q)


def interleaved_acks_split_the_ledger(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  twin_q = view(P, q, "twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  q.ack_batch([t for _x, t in held[:4]])
  twin_q.ack_batch([t for _x, t in twin])
  q.ack_batch([t for _x, t in held[4:]])
  assert q.completed == 8
  assert q.speculation_won == 4 and q.speculation_fenced == 4
  return _outcome(P, q)


def concurrent_holder_and_twin_acks_stay_exact(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  twin_q = view(P, q, "twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  barrier = threading.Barrier(2)

  def ack_all(queue, got):
    barrier.wait()
    for _t, tok in got:
      queue.delete(tok)

  threads = [threading.Thread(target=ack_all, args=(q, held)),
             threading.Thread(target=ack_all, args=(twin_q, twin))]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  assert q.completed == 8
  assert q.speculation_won + q.speculation_fenced == 8
  assert q.is_empty() and os.listdir(q.lease_dir) == []
  # which side wins each index is the race's: only the sums are the same
  return {"completed": q.completed, "resolved": q.speculation_won + q.speculation_fenced}


def twin_split_keeps_pair_membership(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  twin_q = view(P, q, "twin")
  part = twin_q.lease_batch(60, max_tasks=3)
  assert len(part) == 3
  assert [n for n in os.listdir(q.spec_dir) if n.startswith("side_")]
  assert all(q.ack_batch([t for _x, t in held]))
  assert q.completed == 8
  q._survival_gc(time.time())
  assert any(n.startswith("pair_") for n in os.listdir(q.spec_dir))
  twin_q.ack_batch([t for _x, t in part])
  rest_q = view(P, q, "rest")
  assert rest_q.lease_batch(60, max_tasks=8) == []
  assert P.telemetry.counters_snapshot().get("speculation.deduped") == 5
  assert q.completed == 8 and q.speculation_fenced == 8
  assert q.is_empty() and os.listdir(q.lease_dir) == []
  q._survival_gc(time.time())
  assert os.listdir(q.spec_dir) == []
  return _outcome(P, q)


def meta_clobber_heals_through_pair_file(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  key = f"{P.SEG_PREFIX}{held[0][1].parent.segid}"
  meta = q._read_meta(key)
  assert meta.get("spec")
  meta.pop("spec")
  q._write_meta(key, meta)
  twin_q = view(P, q, "twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  twin_q.ack_batch([t for _x, t in twin])
  assert q.completed == 8
  q.ack_batch([t for _x, t in held])
  assert q.completed == 8 and q.speculation_won == 8
  return _outcome(P, q)


def claim_vs_holder_partial_ack(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  toks = [tok for _t, tok in held]
  for tok in toks[:2]:
    tok.mark_started()
  thief_q = view(P, q, "thief")
  settle()
  assert thief_q.steal_claim() == toks[0].parent.segid
  assert all(q.ack_batch(toks[:2]))
  q.renew(toks[2], 60)
  counters = P.telemetry.counters_snapshot()
  assert counters.get("steal.granted") == 1 and counters.get("steal.tasks") == 3
  assert not os.listdir(q.steal_dir)
  stolen = thief_q.lease_batch(60, max_tasks=8)
  assert len(stolen) == 3
  thief_q.ack_batch([t for _x, t in stolen])
  assert all(q.ack_batch(toks[2:5]))
  assert q.completed == 8
  assert q.is_empty() and os.listdir(q.lease_dir) == []
  return dict(_outcome(P, q), stolen=sorted(t.index for _x, t in stolen))


def claim_vs_expiry_recycle(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(seconds=0.05, max_tasks=8)
  thief_q = view(P, q, "thief")
  settle()
  assert thief_q.steal_claim() is not None
  time.sleep(0.12)
  os.environ["IGNEOUS_STEAL_CLAIM_TTL_SEC"] = "0"
  try:
    fresh_q = view(P, q, "second")
    fresh = fresh_q.lease_batch(60, max_tasks=8)
  finally:
    del os.environ["IGNEOUS_STEAL_CLAIM_TTL_SEC"]
  assert len(fresh) == 8
  assert not os.listdir(q.steal_dir)
  assert P.telemetry.counters_snapshot().get("steal.expired_claims", 0) >= 1
  assert q.ack_batch([t for _x, t in held]) == [False] * 8
  fresh_q.ack_batch([t for _x, t in fresh])
  assert q.completed == 8
  assert q.is_empty() and os.listdir(q.lease_dir) == []
  return _outcome(P, q)


def tallies_survive_without_worker_journals(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  twin_q = view(P, q, "twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  twin_q.ack_batch([t for _x, t in twin[:5]])
  q.ack_batch([t for _x, t in held])
  twin_q.ack_batch([t for _x, t in twin[5:]])
  assert (q.speculation_won, q.speculation_fenced) == (5, 3)
  return _outcome(P, q)


def campaign_runner_tops_up_lost_counters(P, root):
  q = make_queue(P, root)
  held = q.lease_batch(60, max_tasks=8)
  assert speculate(P, q, ["holder"]) == 8
  twin_q = view(P, q, "twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  twin_q.ack_batch([t for _x, t in twin])
  q.ack_batch([t for _x, t in held])
  assert q.speculation_won == 8
  P.telemetry.reset_all()
  P.metrics.reset_all()
  jpath = os.path.join(root, "journal")
  runner = P.campaign.CampaignRunner(jpath, q, actuator=object(), tick_sec=1.0,
                                     speculate=False)
  topped = runner._reconcile_ledger()
  assert topped == {"speculation.won": 8}
  got = P.fleet.status(P.fleet.load_effective(jpath))["counters"]
  assert got.get("speculation.won") == 8
  return {"topped": topped, "won": got.get("speculation.won")}


QUEUE_CASES = [
  holder_first_then_twin_acks_are_fenced, twin_first_wins_and_holder_is_fenced,
  interleaved_acks_split_the_ledger, concurrent_holder_and_twin_acks_stay_exact,
  twin_split_keeps_pair_membership, meta_clobber_heals_through_pair_file,
  claim_vs_holder_partial_ack, claim_vs_expiry_recycle,
  tallies_survive_without_worker_journals, campaign_runner_tops_up_lost_counters,
]


@pytest.mark.parametrize("case", QUEUE_CASES, ids=[c.__name__ for c in QUEUE_CASES])
def test_survival_case_as_the_reference(case, tmp_path):
  got = {}
  for who in ("jax", "port"):
    _reset_observability()
    got[who] = case(PKG[who], tmp_path / who)
  assert got["port"] == got["jax"]


def _mixed_records():
  recs = []
  for i in range(12):
    recs.append({
      "kind": "span", "worker": "downsampler", "trace": f"d{i}",
      "span": f"sd{i}", "parent": None, "name": "task",
      "ts": 100.0 + i, "dur": 0.01, "task": "DownsampleTask", "attempt": 1,
    })
    recs.append({
      "kind": "span", "worker": "sleeper", "trace": f"s{i}",
      "span": f"ss{i}", "parent": None, "name": "task",
      "ts": 100.0 + i, "dur": 0.6, "task": "SleepTask", "attempt": 1,
    })
  return recs


def worker_speeds_are_type_normalized(P):
  m = P.replay.WorkloadModel.mine(_mixed_records())
  assert len(m.worker_speeds) == 2
  assert all(s == pytest.approx(1.0) for s in m.worker_speeds)
  return m.to_dict()


def clip_outliers_drops_fault_inflated_durs(P):
  recs = _mixed_records() + [{
    "kind": "span", "worker": "sleeper", "trace": "frozen", "span": "sf",
    "parent": None, "name": "task", "ts": 120.0, "dur": 9.7,
    "task": "SleepTask", "attempt": 1,
  }]
  m = P.replay.WorkloadModel.mine(recs)
  assert max(m.task_types["SleepTask"]["durs"]) == pytest.approx(9.7)
  assert m.clip_outliers() == 1
  assert max(m.task_types["SleepTask"]["durs"]) < 1.0
  assert m.clip_outliers() == 0
  return m.to_dict()


def worker_arrivals_replay_observed_trajectory(P):
  m = P.replay.WorkloadModel.mine(_mixed_records())
  cfg = P.sim.SimConfig(workers=3, seed=5, tasks=12, batch_size=4, lease_sec=30.0,
                        range_lease=1, worker_arrivals=[0.0, 6.0, 6.0])
  out = P.sim.FleetSimulator(m, cfg).run()
  assert out["completed_all"] and out["peak_workers"] <= 3
  assert out["makespan_sec"] > 1.0
  return out


def same_seed_bit_identical_with_survival_on(P):
  m = P.replay.WorkloadModel.mine(_mixed_records())
  cfg = dict(workers=3, seed=11, tasks=24, batch_size=4, lease_sec=10.0,
             range_lease=1, speculate=1, steal=1, steal_min_held_sec=1.0,
             speculate_interval_sec=2.0, worker_arrivals=[0.0, 1.5, 4.0],
             chaos=P.sim.ChaosSpec(stall=1, kill=1, kill_at=2.0))
  a = P.sim.FleetSimulator(m, P.sim.SimConfig(**cfg)).run()
  b = P.sim.FleetSimulator(m, P.sim.SimConfig(**cfg)).run()
  assert a == b
  assert a["speculation"]["issued"] >= 1
  assert a["speculation"]["won"] + a["speculation"]["fenced"] == a["speculation"]["issued"]
  return a


SIM_CASES = [
  worker_speeds_are_type_normalized, clip_outliers_drops_fault_inflated_durs,
  worker_arrivals_replay_observed_trajectory, same_seed_bit_identical_with_survival_on,
]


@pytest.mark.parametrize("case", SIM_CASES, ids=[c.__name__ for c in SIM_CASES])
def test_sim_survival_model_as_the_reference(case):
  assert case(PKG["port"]) == case(PKG["jax"])


# ---------------------------------------------------------------------------
# (a) the sidecars step by step


@pytest.fixture
def deterministic(monkeypatch):
  """``uuid4`` from a counter (``reset()`` restarts it) and the lease pick
  always the first name of the window."""
  state = {"n": 0}

  def uuid4():
    state["n"] += 1
    return uuid.UUID(int=state["n"])

  for module in (jax_filequeue, port_filequeue):
    monkeypatch.setattr(module, "uuid", types.SimpleNamespace(uuid4=uuid4))
  monkeypatch.setattr(random, "randrange", lambda n: 0)
  return lambda: state.update(n=0)


_LEASE_NAME = re.compile(r"^\d+\.\d{3}--")


def _tree(root: pathlib.Path) -> dict:
  """Every file of a queue directory, lease deadlines in names and the
  times in meta, pair and claim files normalised."""
  out = {}
  for p in sorted(root.rglob("*")):
    if not p.is_file():
      continue
    parts = str(p.relative_to(root)).split("/")
    parts[-1] = _LEASE_NAME.sub("T--", parts[-1])
    data = p.read_bytes()
    if parts[0] in ("meta", "spec", "steal") and data[:1] == b"{":
      rec = json.loads(data)
      for key in ("leased_at", "ts"):
        rec.pop(key, None)
      for f in rec.get("failures", []):
        f.pop("time", None)
      data = json.dumps(rec, sort_keys=True).encode()
    out["/".join(parts)] = data
  return out


def _sidecar_script(who, root, payloads, reset_ids, monkeypatch):
  P = PKG[who]
  _reset_observability()
  reset_ids()
  monkeypatch.setenv("IGNEOUS_QUEUE_SHARDS", "1")
  qdir = root / "q"
  holder = P.FileQueue(f"fq://{qdir}", worker_id="holder", max_deliveries=3)
  twin_q = P.FileQueue(f"fq://{qdir}", worker_id="twin")
  speculator = P.FileQueue(f"fq://{qdir}", worker_id="speculator")
  thief = P.FileQueue(f"fq://{qdir}", worker_id="thief")
  obs = []

  def snap(step, extra=None):
    obs.append((step, {
      "tree": _tree(qdir), "counters": _survival_counters(P), "extra": extra,
      "tallies": [holder.completed, holder.speculation_won, holder.speculation_fenced],
    }))

  holder.insert_batch(payloads[:12], total=12)
  snap("insert segment A")
  held = holder.lease_batch(60, max_tasks=12)
  snap("holder leases segment A", len(held))
  snap("range_leases", sorted((r["count"], r["holder"], r["spec"])
                              for r in speculator.range_leases()))
  settle()
  snap("speculate the holder", speculator.speculate_flagged({"holder"}))
  twin_part = twin_q.lease_batch(60, max_tasks=5)
  snap("twin leases 5 (a split)", len(twin_part))
  snap("twin acks 3 first", twin_q.ack_batch([t for _x, t in twin_part[:3]]))
  snap("holder acks 6", holder.ack_batch([t for _x, t in held[:6]]))
  key = f"{P.SEG_PREFIX}{held[0][1].parent.segid}"
  meta = holder._read_meta(key)
  meta.pop("spec", None)
  holder._write_meta(key, meta)
  snap("meta clobbered")
  twin_rest = twin_q.lease_batch(60, max_tasks=7)
  snap("twin leases the rest", len(twin_rest))
  snap("twin acks the rest", twin_q.ack_batch([t for _x, t in twin_rest]))
  snap("holder acks the rest", holder.ack_batch([t for _x, t in held[6:]]))
  snap("twin acks its split", twin_q.ack_batch([t for _x, t in twin_part[3:]]))
  holder._survival_gc(time.time())
  snap("survival gc")
  holder.insert_batch(payloads[12:], total=12)
  snap("insert segment B")
  seg_b = holder.lease_batch(60, max_tasks=12)
  for _x, tok in seg_b[:2]:
    tok.mark_started()
  snap("holder leases segment B, starts 2", len(seg_b))
  settle()
  snap("steal claim", thief.steal_claim() is not None)
  snap("holder renews: the claim is serviced", holder.renew(seg_b[2][1], 60) is seg_b[2][1])
  stolen = thief.lease_batch(60, max_tasks=12)
  snap("thief leases the tail", sorted(t.index for _x, t in stolen))
  snap("thief acks", thief.ack_batch([t for _x, t in stolen]))
  snap("second claim", thief.steal_claim() is not None)
  monkeypatch.setenv("IGNEOUS_STEAL_CLAIM_TTL_SEC", "0")
  time.sleep(0.01)
  holder._recycle_expired(force=True)
  monkeypatch.delenv("IGNEOUS_STEAL_CLAIM_TTL_SEC")
  snap("claim expired by the recycle pass")
  kept = set(seg_b[0][1].parent.entries)
  snap("holder acks what it kept",
       holder.ack_batch([t for _x, t in seg_b if t.index in kept]))
  holder._survival_gc(time.time())
  snap("final gc")
  return obs


def test_sidecars_step_by_step_as_the_reference(tmp_path, deterministic, monkeypatch):
  # JAX-serialized payloads, one set for both (the port runs them as they are)
  payloads = [JaxPrintTask(f"t{i}").to_json() for i in range(24)]
  runs = {who: _sidecar_script(who, tmp_path / who, payloads, deterministic, monkeypatch)
          for who in ("jax", "port")}
  assert [s for s, _ in runs["port"]] == [s for s, _ in runs["jax"]]
  for (step, got), (_, want) in zip(runs["port"], runs["jax"]):
    for key in want:
      assert got[key] == want[key], (step, key)
  steps = dict(runs["port"])
  assert steps["speculate the holder"]["extra"] == 12
  assert any(k.startswith("spec/side_") for k in steps["twin leases 5 (a split)"]["tree"])
  assert steps["final gc"]["tallies"][0] == 24
  won, fenced = steps["final gc"]["tallies"][1:]
  assert won + fenced == 12
  assert steps["thief leases the tail"]["extra"]
  assert not any(k.startswith("steal/") for k in steps["final gc"]["tree"])
  assert not any(k.startswith("spec/") for k in steps["final gc"]["tree"])


# ---------------------------------------------------------------------------
# (b) both packages on one queue directory


@pytest.mark.parametrize("holder_pkg,thief_pkg", [("jax", "port"), ("port", "jax")])
def test_a_thief_claims_the_other_packages_range(tmp_path, holder_pkg, thief_pkg):
  H, T = PKG[holder_pkg], PKG[thief_pkg]
  q = make_queue(H, tmp_path, n=8)
  held = q.lease_batch(60, max_tasks=8)
  toks = [tok for _t, tok in held]
  toks[0].mark_started()
  thief = T.FileQueue(f"fq://{q.path}", worker_id="thief")
  settle()
  assert thief.steal_claim() == toks[0].parent.segid
  q.renew(toks[0], 60)  # the holder's renewal grants half the unstarted 7
  stolen = thief.lease_batch(60, max_tasks=8)
  assert sorted(t.index for _x, t in stolen) == [5, 6, 7]
  assert all(thief.ack_batch([t for _x, t in stolen]))
  assert all(q.ack_batch(toks[:5]))
  assert (q.completed, thief.completed) == (8, 8)
  assert q.is_empty() and os.listdir(q.lease_dir) == []


@pytest.mark.parametrize("holder_pkg,spec_pkg", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("first", ["twin", "holder"])
def test_a_speculator_twins_the_other_packages_lease(tmp_path, holder_pkg, spec_pkg,
                                                         first):
  H, D = PKG[holder_pkg], PKG[spec_pkg]
  q = make_queue(H, tmp_path, n=8)
  held = q.lease_batch(60, max_tasks=8)
  speculator = D.FileQueue(f"fq://{q.path}", worker_id="speculator")
  settle()
  issued = speculator.speculate_flagged({"holder"})
  assert issued == 8
  twin_q = D.FileQueue(f"fq://{q.path}", worker_id="twin")
  twin = twin_q.lease_batch(60, max_tasks=8)
  order = [(twin_q, twin), (q, held)] if first == "twin" else [(q, held), (twin_q, twin)]
  for queue, got in order:
    queue.ack_batch([t for _x, t in got[:4]])
  for queue, got in order:
    queue.ack_batch([t for _x, t in got[4:]])
  assert q.completed == 8
  assert q.speculation_won + q.speculation_fenced == issued
  assert q.speculation_won == (8 if first == "twin" else 0)
  assert q.is_empty() and os.listdir(q.lease_dir) == []
  for who in (q, speculator):
    who._survival_gc(time.time())
  assert os.listdir(q.spec_dir) == []


def test_a_lease_just_taken_counts_as_held(tmp_path, monkeypatch):
  """At a threshold of 0 the port twins and claims a lease taken in this
  very millisecond (its rounded ``leased_at`` may lie ahead of now)."""
  P = PKG["port"]
  q = make_queue(P, tmp_path, n=8)
  q.lease_batch(60, max_tasks=8)
  meta_key = next(n for n in os.listdir(q.meta_dir) if n.startswith(P.SEG_PREFIX))
  meta = q._read_meta(meta_key)
  meta["leased_at"] = round(time.time() + 0.0004, 3)  # rounded up, as it can be
  q._write_meta(meta_key, meta)
  assert view(P, q, "thief").steal_claim() is not None
  assert speculate(P, q, ["holder"]) == 8
