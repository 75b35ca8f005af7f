"""The port's inference family against the JAX package's.

The model registry (a model saved by either package loads in the other,
``model.json`` byte for byte), the patch engine's contracts (blend vs the
whole-volume apply, the partition of unity, byte determinism across patch
order, batch size, serial and pipelined execution, halo clamping at every
face, the empty cutout) and the whole InferenceTask path
(create_inference_tasks -> LocalTaskQueue -> InferenceTask and ``image
infer``) on the same layers in both packages.

Tolerances: with the ``identity`` architecture every output voxel is a
function of the engine alone (tiling, blend, halo, crop, postprocess), so
the port's files equal the JAX package's byte for byte. With
``convnet3d`` the convolutions of the two packages round differently (XLA
on the CPU against PyTorch's), so the float outputs are held with
``np.testing.assert_allclose(rtol=1e-5, atol=1e-5)`` on float32 inputs in
[0, 1), and an argmax only where its top two channels differ by more
than 1e-4.
"""

import json
import pathlib
import random

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.infer import registry as jax_registry
from igneous_tpu.infer.engine import infer_cutout as jax_infer_cutout
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu_torch import Volume, device, telemetry
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.infer import (
  ModelSpec,
  apply_whole,
  infer_cutout,
  init_params,
  load_model,
  load_params,
  save_model,
)
from igneous_tpu_torch.infer import registry
from igneous_tpu_torch.lib import Bbox
from igneous_tpu_torch.pipeline import run_tasks_pipelined
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.tasks import InferenceTask

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for knob in ("IGNEOUS_PIPELINE", "IGNEOUS_PIPELINE_THREADS", "IGNEOUS_PIPELINE_PREFETCH"):
    monkeypatch.delenv(knob, raising=False)
  device.reset_device()
  registry.clear_model_cache()
  jax_registry.clear_model_cache()
  yield
  device.reset_device()
  registry.clear_model_cache()
  jax_registry.clear_model_cache()


def _spec(arch="convnet3d", in_channels=1, out_channels=2, **kw):
  if arch == "identity":
    out_channels = in_channels
  return {
    "architecture": arch, "in_channels": in_channels, "out_channels": out_channels,
    "patch_shape": (32, 32, 16), "overlap": (8, 8, 4),
    "hidden": (3,) if arch == "convnet3d" else (), **kw,
  }


def _model(path, arch="convnet3d", seed=7, **kw):
  """Save the model with the JAX package (its init, its writer)."""
  spec = jax_registry.ModelSpec(**_spec(arch, **kw))
  jax_registry.save_model(path, spec, jax_registry.init_params(spec, seed=seed))
  return path


def _files(root: pathlib.Path):
  return {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(root.rglob("*")) if p.is_file() and p.name != "provenance"
  }


def _sources(tmp_path, data, chunk=(32, 32, 16)):
  paths = {}
  for who in ("jax", "port"):
    paths[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{paths[who]}/src", chunk_size=chunk,
                         layer_type="image")
  return paths


def image(shape=(96, 80, 40), channels=1, seed=0):
  rng = np.random.default_rng(seed)
  return rng.integers(0, 255, shape + (channels,)).astype(np.uint8)


def normalized(shape=(96, 80, 40), seed=0):
  """A float32 image in [0, 1), the scale a trained net takes."""
  return np.random.default_rng(seed).random(shape + (1,), dtype=np.float32)


# -- registry ---------------------------------------------------------------

def test_model_saved_by_the_reference_loads_in_the_port(tmp_path):
  spec = jax_registry.ModelSpec(
    "convnet3d", in_channels=2, out_channels=3, patch_shape=(16, 16, 8),
    overlap=(4, 4, 2), hidden=(4, 5), metadata={"trained_on": "fixture"},
  )
  params = jax_registry.init_params(spec, seed=11)
  path = f"file://{tmp_path}/model"
  jax_registry.save_model(path, spec, params)
  model = load_model(path)
  assert model.spec == ModelSpec(**{k: getattr(spec, k) for k in spec.to_dict()})
  assert set(model.params) == set(params)
  for k in params:
    assert model.params[k].dtype == np.float32
    assert np.array_equal(model.params[k], params[k])
  state = model.module.state_dict()
  assert np.array_equal(state["layers.1.weight"].numpy(), params["layer1/w"])
  assert np.array_equal(state["layers.2.bias"].numpy(), params["layer2/b"])
  rng = np.random.default_rng(0)
  img = rng.random((10, 12, 6, 2)).astype(np.float32)
  out = apply_whole(model, img)
  assert out.shape == (10, 12, 6, 3) and out.dtype == np.float32
  ref = jax_infer_cutout(jax_registry.load_model(path), img)[0]
  np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_model_saved_by_the_port_loads_in_the_reference(tmp_path):
  spec = ModelSpec("convnet3d", 1, 2, (16, 16, 8), overlap=(4, 4, 2), hidden=(3,))
  params = init_params(spec, seed=5)
  jax_params = jax_registry.init_params(
    jax_registry.ModelSpec("convnet3d", 1, 2, (16, 16, 8), overlap=(4, 4, 2), hidden=(3,)),
    seed=5,
  )
  assert set(params) == set(jax_params)
  for k in params:  # the same draws, so the same bytes
    assert params[k].tobytes() == jax_params[k].tobytes()
  port_path, jax_path = f"file://{tmp_path}/port", f"file://{tmp_path}/jax"
  save_model(port_path, spec, params)
  jax_registry.save_model(jax_path, jax_registry.ModelSpec(**spec.to_dict()), jax_params)
  assert (tmp_path / "port" / "model.json").read_bytes() == (tmp_path / "jax" / "model.json").read_bytes()
  ref = jax_registry.load_model(port_path)
  assert ref.spec.to_dict() == spec.to_dict()
  for k in params:
    assert np.array_equal(ref.params[k], params[k])


def test_model_cache_is_invalidated_by_a_save(tmp_path):
  spec = ModelSpec("convnet3d", 1, 1, (8, 8, 8), hidden=(2,))
  path = f"file://{tmp_path}/model"
  save_model(path, spec, init_params(spec, seed=1))
  model = load_model(path)
  assert load_model(path) is model
  save_model(path, spec, init_params(spec, seed=2))
  model2 = load_model(path)
  assert model2 is not model
  assert not np.array_equal(model2.params["layer0/w"], model.params["layer0/w"])


def test_unknown_architecture_is_refused(tmp_path):
  with pytest.raises(KeyError, match="unknown architecture"):
    save_model(f"file://{tmp_path}/bad", ModelSpec("no_such_net", 1, 1, (8, 8, 8)), {})
  with pytest.raises(KeyError):
    jax_registry.save_model(f"file://{tmp_path}/bad",
                            jax_registry.ModelSpec("no_such_net", 1, 1, (8, 8, 8)), {})
  (tmp_path / "odd").mkdir()
  (tmp_path / "odd" / "model.json").write_text(json.dumps(
    ModelSpec("no_such_net", 1, 1, (8, 8, 8)).to_dict()))
  np.savez(tmp_path / "odd" / "params.npz")
  with pytest.raises(KeyError, match="unknown architecture"):
    load_model(f"file://{tmp_path}/odd")
  with pytest.raises(ValueError, match="identity"):
    save_model(f"file://{tmp_path}/id", ModelSpec("identity", 1, 2, (8, 8, 8)), {})
    load_model(f"file://{tmp_path}/id")


def test_load_params_maps_the_flat_names_strictly():
  module = registry.ConvNet3d((1, 2, 3))
  params = init_params(ModelSpec("convnet3d", 1, 3, (8, 8, 8), hidden=(2,)), seed=3)
  load_params(module, params)
  assert np.array_equal(module.layers[0].weight.detach().numpy(), params["layer0/w"])
  with pytest.raises(KeyError, match="layer<i>"):
    load_params(module, {"conv0/w": params["layer0/w"]})
  with pytest.raises(RuntimeError):
    load_params(module, {"layer0/w": params["layer0/w"]})  # a missing parameter


# -- engine -----------------------------------------------------------------

def test_blend_vs_whole_volume_identity(tmp_path):
  """A cutout smaller than one patch blends to EXACTLY the raw model
  output, at every batch size (the normalize-first contract)."""
  model = load_model(_model(f"file://{tmp_path}/m", in_channels=2))
  img = np.random.default_rng(1).random((20, 24, 12, 2)).astype(np.float32)
  whole = apply_whole(model, img)
  for batch_size in (1, 4):
    out, stats = infer_cutout(model, img, batch_size=batch_size)
    assert stats["patches"] == 1
    assert np.array_equal(out, whole)
  ref = jax_infer_cutout(jax_registry.load_model(f"file://{tmp_path}/m"), img)[0]
  np.testing.assert_allclose(whole, ref, rtol=RTOL, atol=ATOL)


def test_blend_weights_partition_of_unity(tmp_path):
  path = _model(f"file://{tmp_path}/ident", "identity", patch_shape=(16, 16, 8),
                overlap=(4, 4, 2))
  model = load_model(path)
  img = np.random.default_rng(2).random((30, 20, 10, 1)).astype(np.float32)
  out, stats = infer_cutout(model, img, batch_size=3)
  assert stats["patches"] > 1
  assert np.allclose(out, img, atol=1e-5)
  ref, ref_stats = jax_infer_cutout(jax_registry.load_model(path), img, batch_size=3)
  assert stats == ref_stats
  assert np.array_equal(out, ref)


def test_engine_counts_patches_padding_and_dispatches(tmp_path):
  """One 48x48x16 task with the default halo (8, 8, 4): a 64x64x24
  cutout, 3*3*2 = 18 patches at stride 24x24x12, 5 dispatches of 4, 2
  zero-padded slots."""
  path = _model(f"file://{tmp_path}/m")
  Volume.from_numpy(image((48, 48, 16)), f"file://{tmp_path}/src",
                    chunk_size=(16, 16, 16), layer_type="image")
  telemetry.reset()
  LocalTaskQueue().insert(tc.create_inference_tasks(
    f"file://{tmp_path}/src", f"file://{tmp_path}/out", path,
    shape=(48, 48, 16), batch_size=4))
  counts = telemetry.counters()
  assert counts["infer.patches"] == 18
  assert counts["infer.padded_slots"] == 2
  assert counts["infer.dispatches"] == 5
  stages = telemetry.snapshot()
  for name in ("download", "tile", "h2d", "infer", "d2h", "blend", "postprocess", "upload"):
    assert stages[name]["count"] >= 1, name


def test_parameters_are_staged_once_per_model(tmp_path):
  model = load_model(_model(f"file://{tmp_path}/m"))
  first = model.device_params()
  assert model.device_params() is first
  assert model.executor() is model.executor()
  assert set(first) == {"layers.0.weight", "layers.0.bias", "layers.1.weight", "layers.1.bias"}


# -- byte determinism -------------------------------------------------------

def test_byte_determinism_across_packing_order_and_pipeline(tmp_path, monkeypatch):
  model_path = _model(f"file://{tmp_path}/detnet")
  Volume.from_numpy(image((96, 96, 48)), f"file://{tmp_path}/src",
                    chunk_size=(32, 32, 16), layer_type="image")
  monkeypatch.setenv("IGNEOUS_PIPELINE_THREADS", "1")
  monkeypatch.setenv("IGNEOUS_PIPELINE_PREFETCH", "3")

  def make(dest, batch_size=4):
    return list(tc.create_inference_tasks(
      f"file://{tmp_path}/src", f"file://{tmp_path}/{dest}", model_path,
      shape=(64, 64, 32), batch_size=batch_size,
    ))

  monkeypatch.setenv("IGNEOUS_PIPELINE", "off")
  LocalTaskQueue().insert(make("serial"))
  monkeypatch.delenv("IGNEOUS_PIPELINE")
  LocalTaskQueue().insert(make("queue"))
  run_tasks_pipelined(make("pipe"))
  shuffled = make("shuffled")
  random.Random(0).shuffle(shuffled)
  run_tasks_pipelined(shuffled)
  run_tasks_pipelined(make("b7", batch_size=7))

  ref = _files(tmp_path / "serial")
  assert len(ref) > 4
  for variant in ("queue", "pipe", "shuffled", "b7"):
    got = _files(tmp_path / variant)
    assert set(ref) == set(got), variant
    assert [k for k in ref if ref[k] != got[k]] == [], variant


# -- halo clamping ----------------------------------------------------------

def test_unbounded_volume_reads_background_past_every_face(tmp_path):
  """Volume(bounded=False) against the JAX package's on boxes that poke
  out of each face, both corners and the whole volume, and one box
  entirely outside; the bounded volume still raises."""
  data = image((40, 36, 20), channels=2, seed=4)
  paths = _sources(tmp_path, data, chunk=(16, 16, 8))
  ref = JaxVolume(f"file://{paths['jax']}/src", bounded=False, background_color=7)
  got = Volume(f"file://{paths['port']}/src", bounded=False, background_color=7)
  boxes = []
  for axis in range(3):
    for side in (0, 1):
      lo, hi = [4, 4, 4], [20, 20, 12]
      if side:
        lo[axis], hi[axis] = data.shape[axis] - 5, data.shape[axis] + 6
      else:
        lo[axis], hi[axis] = -6, 5
      boxes.append((lo, hi))
  boxes += [((-3, -3, -3), (43, 39, 23)), ((-8, -8, -8), (1, 1, 1)),
            ((50, 0, 0), (60, 10, 10)), ((0, 0, 0), (40, 36, 20))]
  for lo, hi in boxes:
    out = got.download(Bbox(lo, hi))
    assert np.array_equal(out, ref.download(JaxBbox(lo, hi))), (lo, hi)
  with pytest.raises(Exception, match="not contained"):
    Volume(f"file://{paths['port']}/src").download(Bbox((-1, 0, 0), (4, 4, 4)))


def test_halo_clamps_at_volume_edges(tmp_path):
  """An edge task's halo pokes outside the volume on every face; the task
  output equals inference over the source zero-padded by the halo,
  bitwise."""
  model_path = _model(f"file://{tmp_path}/halonet")
  model = load_model(model_path)
  halo = (8, 8, 4)
  data = image((64, 64, 32), seed=5)
  Volume.from_numpy(data, f"file://{tmp_path}/src", chunk_size=(32, 32, 16),
                    layer_type="image")
  tasks = list(tc.create_inference_tasks(
    f"file://{tmp_path}/src", f"file://{tmp_path}/out", model_path,
    shape=(64, 64, 32), halo=halo, batch_size=4,
  ))
  assert len(tasks) == 1  # one task whose halo crosses every face
  LocalTaskQueue().insert(tasks)
  padded = np.pad(data, [(halo[0],) * 2, (halo[1],) * 2, (halo[2],) * 2, (0, 0)])
  ref, _ = infer_cutout(model, padded, batch_size=4)
  ref = ref[halo[0]:halo[0] + 64, halo[1]:halo[1] + 64, halo[2]:halo[2] + 32]
  out = Volume(f"file://{tmp_path}/out").download(Bbox((0, 0, 0), (64, 64, 32)))
  assert np.array_equal(out, ref)


def test_empty_cutout_is_noop(tmp_path):
  model_path = _model(f"file://{tmp_path}/noop")
  Volume.from_numpy(image((32, 32, 16)), f"file://{tmp_path}/src",
                    chunk_size=(32, 32, 16), layer_type="image")
  task = list(tc.create_inference_tasks(
    f"file://{tmp_path}/src", f"file://{tmp_path}/out", model_path, shape=(32, 32, 16),
  ))[0]
  before = _files(tmp_path / "out")
  task.offset = type(task.offset)(1024, 1024, 1024)  # beyond the bounds
  task.execute()
  assert _files(tmp_path / "out") == before


# -- the task path against the JAX package ----------------------------------

def _run_both(tmp_path, data, model_path, chunk=(32, 32, 16), bounds=None, **kw):
  """Both packages' campaigns on copies of one source; ``bounds`` a
  (min, max) pair."""
  paths = _sources(tmp_path, data, chunk)
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_inference_tasks(
    f"file://{paths['jax']}/src", f"file://{paths['jax']}/out", model_path,
    bounds=JaxBbox(*bounds) if bounds else None, **kw))
  LocalTaskQueue().insert(tc.create_inference_tasks(
    f"file://{paths['port']}/src", f"file://{paths['port']}/out", model_path,
    bounds=Bbox(*bounds) if bounds else None, **kw))
  return paths


IDENTITY_CASES = {
  "none": dict(shape=(64, 64, 32)),
  "quantize": dict(shape=(48, 40, 16), postprocess="quantize", batch_size=3),
  "argmax_2ch": dict(shape=(64, 48, 32), postprocess="argmax", channels=2),
  "halo_0_chunk_16": dict(shape=(32, 32, 16), halo=(0, 0, 0), chunk_size=(16, 16, 16)),
  "bounds": dict(bounds=((10, 20, 4), (70, 60, 30)), shape=(32, 32, 16)),
}


@pytest.mark.parametrize("case", sorted(IDENTITY_CASES))
def test_identity_task_output_equals_reference_byte_for_byte(case, tmp_path):
  kw = dict(IDENTITY_CASES[case])
  channels = kw.pop("channels", 1)
  data = image(channels=channels, seed=6)
  if kw.get("postprocess") == "quantize":
    data = (data // 200).astype(np.uint8)  # 0 and 1: quantize keeps both ends
  model_path = _model(f"file://{tmp_path}/ident", "identity", in_channels=channels)
  paths = _run_both(tmp_path, data, model_path, **kw)
  ref, got = _files(paths["jax"] / "out"), _files(paths["port"] / "out")
  assert len(got) > 2
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []


def test_convnet_task_output_within_tolerance(tmp_path):
  model_path = _model(f"file://{tmp_path}/net")
  paths = _run_both(tmp_path, normalized(seed=7), model_path, shape=(64, 64, 32))
  ref = JaxVolume(f"file://{paths['jax']}/out")
  got = Volume(f"file://{paths['port']}/out")
  assert got.info == ref.info
  out = got.download(got.bounds)
  exp = ref.download(ref.bounds)
  assert out.dtype == np.float32 and out.shape == (96, 80, 40, 2)
  assert np.isfinite(out).all()
  np.testing.assert_allclose(out, exp, rtol=RTOL, atol=ATOL)


def test_convnet_argmax_differs_only_at_ties(tmp_path):
  model_path = _model(f"file://{tmp_path}/net", seed=8)
  data = normalized(seed=8)
  paths = _run_both(tmp_path, data, model_path, shape=(64, 64, 32), postprocess="argmax")
  got = Volume(f"file://{paths['port']}/out")
  out = got.download(got.bounds)[..., 0]
  exp = JaxVolume(f"file://{paths['jax']}/out").download(JaxBbox((0, 0, 0), data.shape[:3]))[..., 0]
  assert got.info["type"] == "segmentation" and out.dtype == np.uint8
  floats = _run_both(tmp_path / "f", data, model_path, shape=(64, 64, 32))
  raw = Volume(f"file://{floats['port']}/out").download(got.bounds)
  margin = np.abs(raw[..., 0] - raw[..., 1])
  differ = out != exp
  assert not differ[margin > 1e-4].any()
  assert differ.mean() < 1e-3


def test_cli_infer_matches_reference(tmp_path):
  model_path = _model(f"file://{tmp_path}/ident", "identity")
  paths = _sources(tmp_path, image(seed=9))
  args = ["--model", model_path, "--shape", "64,64,32", "--batch-size", "3",
          "--postprocess", "quantize", "--xrange", "0,64", "--chunk-size", "32,32,8"]
  res = CliRunner().invoke(jax_cli, ["image", "infer", f"file://{paths['jax']}/src",
                                     f"file://{paths['jax']}/out", *args])
  assert res.exit_code == 0, res.output
  assert cli_main(["image", "infer", f"file://{paths['port']}/src",
                   f"file://{paths['port']}/out", *args]) == 0
  ref, got = _files(paths["jax"] / "out"), _files(paths["port"] / "out")
  assert len(got) > 4 and got == ref
  prov = [
    json.loads((paths[w] / "out" / "provenance").read_text().replace(str(paths[w]), "ROOT"))
    ["processing"][-1]["method"]
    for w in ("jax", "port")
  ]
  assert prov[0] == prov[1] and prov[0]["task"] == "InferenceTask"


def test_reference_payload_runs_in_the_port(tmp_path):
  model_path = _model(f"file://{tmp_path}/net")
  paths = _sources(tmp_path, normalized(seed=10))
  for who in ("jax", "port"):  # writes the destinations' infos
    jax_tc.create_inference_tasks(f"file://{paths[who]}/src", f"file://{paths[who]}/out",
                                  model_path, shape=(64, 64, 32))
  tasks = list(jax_tc.create_inference_tasks(
    f"file://{paths['jax']}/src", f"file://{paths['jax']}/out", model_path, shape=(64, 64, 32)))
  for task in tasks:
    ported = deserialize(jax_serialize(task).replace(str(paths["jax"]), str(paths["port"])))
    assert type(ported) is InferenceTask
    ported.execute()
  JaxQueue(parallel=1, progress=False).insert(tasks)
  out = Volume(f"file://{paths['port']}/out")
  exp = JaxVolume(f"file://{paths['jax']}/out")
  np.testing.assert_allclose(out.download(out.bounds), exp.download(exp.bounds),
                             rtol=RTOL, atol=ATOL)


def test_inference_without_cuda_raises_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
  import torch

  model_path = _model(f"file://{tmp_path}/net")
  Volume.from_numpy(image((32, 32, 16)), f"file://{tmp_path}/src",
                    chunk_size=(32, 32, 16), layer_type="image")
  tasks = list(tc.create_inference_tasks(
    f"file://{tmp_path}/src", f"file://{tmp_path}/out", model_path))
  monkeypatch.delenv(device.ENV)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  device.reset_device()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tasks[0].execute()
  assert not any(k.startswith("32_") or "-" in k for k in _files(tmp_path / "out"))
