"""The port's soak scenarios at their smallest grids, each asserting its
report (every check of the JAX soak's scenario is inside the port's
function, which raises ``SoakFailure`` when one does not hold), with the
race checker on as the soak runs it and the workers on the CPU.

The storm scenarios' clean layer (the reference bytes the preemption and
hostile storms are held to) equals, file for file and byte for byte, the
JAX soak's ``run_pipeline`` layer on the same seed: ``tools/chaos_soak.py``
is loaded by path and run as it is.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from igneous_tpu import task_creation as jax_tc
from igneous_tpu import telemetry as jax_telemetry
from igneous_tpu_torch import device, lifecycle, telemetry
from igneous_tpu_torch.tools import chaos_soak

from test_torch_integrity import flush_local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_RACE_CHECK", "1")
  for name in ("IGNEOUS_PIPELINE", "IGNEOUS_INTEGRITY", "IGNEOUS_CHUNK_CACHE",
               "IGNEOUS_JOURNAL", "IGNEOUS_QUEUE_SHARDS"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  flush_local()
  telemetry.reset_all()
  jax_telemetry.reset_all()
  yield
  device.reset_device()


def _jax_soak():
  spec = importlib.util.spec_from_file_location(
    "jax_chaos_soak", os.path.join(REPO, "tools", "chaos_soak.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def test_storm_clean_layer_is_the_reference_soak_layer(tmp_path):
  jax_soak = _jax_soak()
  img = chaos_soak.storm_image(SEED)

  def jax_storm_tasks(path):  # the JAX soak's storm grid (its storm_tasks)
    return list(jax_tc.create_downsampling_tasks(
      path, mip=0, num_mips=1, memory_target=int(6e5), compress="gzip"))

  with jax_soak.pipeline_disabled():
    _, jax_layer = jax_soak.run_pipeline(str(tmp_path / "jax"), img, tag="jax",
                                         task_fn=jax_storm_tasks)
  with chaos_soak.serial_pipeline():
    n, port_layer = chaos_soak.run_pipeline(str(tmp_path / "port"), img, tag="port",
                                            task_fn=chaos_soak.grid_tasks)
  assert n == len(jax_storm_tasks(f"file://{tmp_path}/jax/layer")) == 18
  assert sorted(port_layer) == sorted(jax_layer)
  assert all(port_layer[k] == jax_layer[k] for k in jax_layer)


def test_corruption_scenario(tmp_path):
  img = np.random.default_rng(SEED).integers(0, 255, (64, 64, 32)).astype(np.uint8)
  report = chaos_soak.run_corruption_scenario(str(tmp_path), img, SEED)
  assert report["healed_byte_identical"] is True
  assert report["faults_injected"] >= 1
  assert report["findings"] == report["faults_injected"]
  assert report["torn_writes"] + report["bit_flips"] == report["faults_injected"]
  assert report["repair_tasks"] >= 1 and report["objects_compared"] > 0


def test_preemption_scenario(tmp_path):
  trace = tmp_path / "storm.json"
  report = chaos_soak.run_preemption_storm(str(tmp_path), SEED, trace_out=str(trace))
  assert report["tasks"] == report["completions_tally"] == 18
  assert report["worker_exit_codes"][0] in (lifecycle.EXIT_PREEMPTED, 0)
  assert report["zombie_delete_fenced"] >= 1
  assert report["byte_identical"] is True
  assert report["journal_workers"] and report["fleet_tasks_merged"] >= 1
  assert report["journal_drain_batches"] >= 1 or report["worker_exit_codes"][0] == 0
  events = json.loads(trace.read_text())
  assert events  # the merged journal's Perfetto trace


def test_stall_scenario(tmp_path):
  health = tmp_path / "health.json"
  report = chaos_soak.run_stall_health_scenario(str(tmp_path), SEED, health_out=str(health))
  assert report["stalled_worker"] in report["flagged"]
  assert report["desired_workers"] > report["current_workers"]
  assert report["backlog_at_check"] > 0
  assert report["rollup_status_matches_raw"] is True
  written = json.loads(health.read_text())
  assert report["stalled_worker"] in {s["worker"] for s in written["stragglers"]}


# The forecast's ±20% depends on the host's load. On a quiet 8-core host,
# 12 runs (seeds 1-8, seed 7 four times: 0.86-1.16) gave 3 outside it
# (1.23-1.34, seeds 3, 5, 8); in 10 runs at -n 6 (six storms at once), 7
# landed at 1.21-1.77 of the live makespan, every other check holding in
# all 10. The JAX soak's own hostile scenario, on the same host, missed it
# in 3 of 3 runs (ratios 1.62, 2.01 and 139276.82).
@pytest.mark.slow
def test_hostile_scenario(tmp_path):
  report = chaos_soak.run_hostile_scenario(str(tmp_path), SEED)
  assert report["tasks"] == report["completions_tally"] == 48
  assert report["dlq"] == 0 and report["byte_identical"] is True
  assert report["storm"]["stalled"] == report["storm"]["killed"] == 1
  spec = report["speculation"]
  assert spec["issued"] > 0 and spec["won"] + spec["fenced"] == spec["issued"]
  assert 0.8 <= report["forecast"]["ratio"] <= 1.2


def test_main_runs_a_scenario_and_restores_the_knobs(tmp_path, capsys, monkeypatch):
  monkeypatch.delenv("IGNEOUS_RACE_CHECK")
  out = tmp_path / "report.json"
  assert chaos_soak.main(["--scenario", "stall", "--seed", str(SEED), "--pipeline",
                          "--report-out", str(out),
                          "--health-out", str(tmp_path / "h.json")]) == 0
  report = json.loads(capsys.readouterr().out)
  assert report == json.loads(out.read_text())
  assert report["scenario"] == "stall" and report["stall"]["rollup_status_matches_raw"]
  for name in ("IGNEOUS_RACE_CHECK", "IGNEOUS_PIPELINE", "IGNEOUS_PIPELINE_THREADS"):
    assert name not in os.environ, name


def test_every_scenario_is_offered():
  assert chaos_soak.SCENARIOS == ("faults", "preemption", "stall", "corruption", "hostile")
  with pytest.raises(SystemExit):
    chaos_soak.main(["--scenario", "nope"])
