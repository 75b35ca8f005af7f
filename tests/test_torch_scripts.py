"""The port's scripts and its serve knobs against the JAX package's.

``validate_provenance`` gives the JAX script's report (and its printed
lines and exit code) on a root of layers written by both packages, with
missing, malformed and incomplete provenance among them; ``remap2npy``
writes the JAX script's ``.npy`` bytes (skipped only where h5py is
absent). Every ``IGNEOUS_SERVE_*`` knob of the JAX registry, and the
serve fill's verification knobs, are in the port's registry with the same
type and default, and ``ServeConfig.from_env`` reads them as the JAX
package's does.
"""

import json
import sys

import numpy as np
import pytest

from igneous_tpu import Volume as JaxVolume
from igneous_tpu.analysis import knobs as jax_knobs
from igneous_tpu.scripts import remap2npy as jax_remap2npy
from igneous_tpu.scripts import validate_provenance as jax_validate
from igneous_tpu.serve import ServeConfig as JaxServeConfig
from igneous_tpu_torch import Volume, device
from igneous_tpu_torch.analysis import knobs
from igneous_tpu_torch.scripts import remap2npy, validate_provenance
from igneous_tpu_torch.serve import ServeConfig


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


def _bucket(tmp_path):
  """A root with layers of both packages, and broken provenance."""
  data = np.zeros((16, 16, 8), np.uint8)
  JaxVolume.from_numpy(data, f"file://{tmp_path}/jax_layer", chunk_size=(8, 8, 8))
  Volume.from_numpy(data, f"file://{tmp_path}/port_layer", chunk_size=(8, 8, 8))
  Volume.from_numpy(data, f"file://{tmp_path}/nested/deep", chunk_size=(8, 8, 8))
  for name, prov in (("missing", None), ("garbled", b"{not json"),
                     ("partial", json.dumps({"owners": [], "processing": [{"by": "x"}]}).encode())):
    Volume.from_numpy(data, f"file://{tmp_path}/{name}", chunk_size=(8, 8, 8))
    target = tmp_path / name / "provenance"
    if prov is None:
      target.unlink()
    else:
      target.write_bytes(prov)
  (tmp_path / "jax_layer" / "mesh").mkdir()
  (tmp_path / "jax_layer" / "mesh" / "info").write_text(json.dumps({"@type": "neuroglancer_legacy_mesh"}))
  return f"file://{tmp_path}"


def test_validate_provenance_reports_as_jax(tmp_path, monkeypatch, capsys):
  root = _bucket(tmp_path)
  report = validate_provenance.validate_provenance(root)
  assert report == jax_validate.validate_provenance(root)
  assert sorted(report) == ["garbled", "missing", "partial"]
  assert report["partial"] == ["missing key 'description'", "missing key 'sources'",
                               "processing[0] lacks 'method'"]
  outs = {}
  for side, mod in (("port", validate_provenance), ("jax", jax_validate)):
    monkeypatch.setattr(sys, "argv", ["validate_provenance", root])
    with pytest.raises(SystemExit) as e:
      mod.main()
    outs[side] = (e.value.code, capsys.readouterr().out)
  assert outs["port"] == outs["jax"] and outs["port"][0] == 1


def test_validate_provenance_all_valid(tmp_path, monkeypatch, capsys):
  data = np.zeros((8, 8, 8), np.uint8)
  Volume.from_numpy(data, f"file://{tmp_path}/only", chunk_size=(8, 8, 8))
  monkeypatch.setattr(sys, "argv", ["validate_provenance", f"file://{tmp_path}"])
  validate_provenance.main()
  assert capsys.readouterr().out == "all provenance files valid\n"


def test_remap2npy_writes_the_jax_bytes(tmp_path, capsys):
  h5py = pytest.importorskip("h5py")
  table = np.random.default_rng(3).integers(0, 2**40, (2, 500)).astype(np.uint64)
  outs = {}
  for side, mod in (("port", remap2npy), ("jax", jax_remap2npy)):
    (tmp_path / side).mkdir()
    path = tmp_path / side / "remap.h5"
    with h5py.File(path, "w") as f:
      f.create_dataset("other", data=np.arange(4))
      f.create_dataset("main", data=table)
    assert mod.main([str(path)]) == 0
    outs[side] = ((tmp_path / side / "remap.npy").read_bytes(),
                  capsys.readouterr().out.replace(f"/{side}/", "/"))
  assert outs["port"] == outs["jax"]
  assert np.array_equal(np.load(tmp_path / "port" / "remap.npy"), table)


def test_remap2npy_without_arguments_prints_usage(capsys):
  assert remap2npy.main([]) == 2
  assert "Usage:" in capsys.readouterr().err


def test_serve_knobs_match_the_jax_registry():
  names = sorted(n for n in jax_knobs._REGISTRY if n.startswith("IGNEOUS_SERVE_")) + [
    "IGNEOUS_INTEGRITY_SERVE_VERIFY", "IGNEOUS_INTEGRITY_SSD_VERIFY"]
  assert len(names) > 25
  for name in names:
    knob = jax_knobs._REGISTRY[name]
    assert (knobs.KNOBS[name].type, knobs.KNOBS[name].default) == (knob.type, knob.default), name


@pytest.mark.parametrize("env", [
  {},
  {"IGNEOUS_SERVE_RAM_MB": "12.5", "IGNEOUS_SERVE_SSD_DIR": "/tmp/x", "IGNEOUS_SERVE_SYNTH_MIPS": "off",
   "IGNEOUS_SERVE_WRITEBACK": "1", "IGNEOUS_SERVE_IO_THREADS": "3", "IGNEOUS_SERVE_DRAIN_SEC": "x"},
])
def test_serve_config_from_env_as_jax(env, monkeypatch):
  for name in list(knobs.KNOBS):
    if name.startswith("IGNEOUS_SERVE_"):
      monkeypatch.delenv(name, raising=False)
  for name, val in env.items():
    monkeypatch.setenv(name, val)
  assert vars(ServeConfig.from_env()) == vars(JaxServeConfig.from_env())
  assert vars(ServeConfig.from_env(ram_mb=1.0, synth_mips=None)) == vars(
    JaxServeConfig.from_env(ram_mb=1.0, synth_mips=None))
