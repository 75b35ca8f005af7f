"""The port's ``@queueable`` functions, maintenance commands, ``design``,
``license`` and legacy tasks against the JAX package.

``FunctionTask`` payloads (``{"fn", "args", "kwargs"}``) written by
either package run in the other through fq://, and serialize to the same
wire text; ``mesh rm|xfer|clean`` and ``skeleton rm|xfer|clean`` leave
the same files; ``design ds-memory|ds-shape|bounds`` and ``license``
print the JAX CLI's text; ``HyperSquareConsensusTask``,
``WatershedRemapTask``, ``MaskAffinitymapTask`` and
``LegacyInferenceTask`` (the same numpy callable registered in both)
write the same chunks. Exact everywhere.
"""

import functools
import io
import json
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu import tasks as jax_tasks
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.queues import FileQueue as JaxFileQueue
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import deserialize as jax_deserialize
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu_torch import CloudFiles, device, tasks
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import FileQueue, LocalTaskQueue, deserialize, serialize

from test_torch_frags import _copy, _cpu, _run_both, _same
from test_torch_integrity import flush_local, layer_tree
from test_torch_mesh_tasks import TASK, voronoi
from test_torch_mesh_tasks import _layers as _mesh_layers
from test_torch_skeleton_tasks import FORGE, MERGE, tubes
from test_torch_skeleton_tasks import _layers as _skel_layers


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  _cpu(monkeypatch)
  yield
  device.reset_device()


def _listing(root):
  """The files of a layer but its integrity sidecars (whose names carry a
  process id; ``layer_tree`` compares their records)."""
  return sorted(
    str(p.relative_to(root)) for p in root.rglob("*")
    if p.is_file() and p.relative_to(root).parts[0] != "integrity"
  )


@pytest.fixture(scope="module")
def forged(tmp_path_factory):
  """Both packages' merged mesh and skeleton layers."""
  root = tmp_path_factory.mktemp("forged")
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    _cpu(mp)
    out["mesh"] = paths = _mesh_layers(root / "mesh", voronoi())
    _run_both(paths, jax_tc.create_meshing_tasks, tc.create_meshing_tasks, shape=TASK)
    _run_both(paths, jax_tc.create_mesh_manifest_tasks, tc.create_mesh_manifest_tasks)
    out["skeleton"] = paths = _skel_layers(root / "skel", tubes())
    _run_both(paths, jax_tc.create_skeletonizing_tasks, tc.create_skeletonizing_tasks,
              shape=(32, 24, 24), **FORGE)
    _run_both(paths, jax_tc.create_unsharded_skeleton_merge_tasks,
              tc.create_unsharded_skeleton_merge_tasks, **MERGE)
    flush_local()
  device.reset_device()
  return out


# -- @queueable function payloads ----------------------------------------------


def _wire(payload: str) -> dict:
  doc = json.loads(payload)
  doc.pop("trace", None)
  return doc


FUNCTIONS = ["DeleteMeshFilesTask", "TransferMeshFilesTask",
             "DeleteSkeletonFilesTask", "TransferSkeletonFilesTask"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_payloads_serialize_as_the_reference(name):
  args = ("file:///a", "file:///b", "dir", "7") if "Transfer" in name else (
    "file:///a", "dir", "7")
  got = serialize(functools.partial(getattr(tasks, name), *args))
  ref = jax_serialize(functools.partial(getattr(jax_tasks, name), *args))
  assert _wire(got) == _wire(ref) == {"fn": name, "args": list(args), "kwargs": {}}
  # keyword arguments ride in "kwargs"
  kw = functools.partial(getattr(tasks, name), *args[:-1], prefix="7")
  assert _wire(serialize(kw))["kwargs"] == {"prefix": "7"}
  assert type(deserialize(ref)).__name__ == "FunctionTask"
  assert _wire(serialize(deserialize(ref))) == _wire(ref)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_function_payloads_run_across_packages_on_fq(writer, forged, tmp_path, capsys):
  """Deletion payloads of one package leased and run by the other's
  worker: the same files are left as the JAX package leaves on its own."""
  paths = _copy(forged["mesh"], tmp_path)
  q = f"fq://{tmp_path}/q"
  layer = paths["port"] if writer == "jax" else paths["jax"]
  factory = jax_tc if writer == "jax" else tc
  queue = (JaxFileQueue if writer == "jax" else FileQueue)(q)
  queue.insert(list(factory.create_mesh_deletion_tasks(f"file://{layer}")))
  if writer == "jax":
    assert cli_main(["execute", q, "-x", "-q"]) == 0
  else:
    res = CliRunner().invoke(jax_cli, ["execute", q, "-x", "-q"])
    assert res.exit_code == 0, res.output
  ref = paths["jax"] if writer == "jax" else paths["port"]
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_mesh_deletion_tasks(f"file://{ref}"))
  flush_local()
  assert _listing(layer) == _listing(ref)
  assert [p for p in _listing(layer) if p.startswith("mesh_mip_0_err_40/")] == [
    "mesh_mip_0_err_40/info"]


def test_registries_match_the_reference():
  from igneous_tpu.queues.registry import FN_REGISTRY as JAX_FN, TASK_REGISTRY as JAX_TASKS
  from igneous_tpu_torch.queues.registry import FN_REGISTRY, TASK_REGISTRY

  # the packages' own classes and functions: other test modules register
  # their own into either registry when they are collected
  def own(registry, prefix):
    return sorted(n for n, obj in registry.items() if obj.__module__.startswith(prefix))

  jax, port = own(JAX_TASKS, "igneous_tpu."), own(TASK_REGISTRY, "igneous_tpu_torch.")
  assert jax == port and "FunctionTask" in port and "GrapheneMeshTask" in port
  assert own(FN_REGISTRY, "igneous_tpu_torch.") == own(JAX_FN, "igneous_tpu.") == sorted(FUNCTIONS)


def test_unregistered_function_raises_as_the_reference():
  payload = {"fn": "delete_mesh_files", "args": [], "kwargs": {}}
  for load in (deserialize, jax_deserialize):
    with pytest.raises(KeyError, match="is not @queueable-registered"):
      load(payload).execute()
  for ser, fn in ((serialize, np.sum), (jax_serialize, np.sum)):
    with pytest.raises(ValueError, match="not @queueable"):
      ser(functools.partial(fn, 1))


# -- mesh and skeleton maintenance ---------------------------------------------


COMMANDS = {
  "mesh_rm": ("mesh", lambda p, d: ["mesh", "rm", f"file://{p}", "--magnitude", "2"]),
  "mesh_clean": ("mesh", lambda p, d: ["mesh", "clean", f"file://{p}"]),
  "mesh_xfer": ("mesh", lambda p, d: ["mesh", "xfer", f"file://{p}", f"file://{d}"]),
  "skeleton_rm": ("skeleton", lambda p, d: ["skeleton", "rm", f"file://{p}"]),
  "skeleton_clean": ("skeleton", lambda p, d: ["skeleton", "clean", f"file://{p}",
                                               "--skel-dir", "skeletons_mip_0"]),
  "skeleton_xfer": ("skeleton", lambda p, d: ["skeleton", "xfer", f"file://{p}",
                                              f"file://{d}", "--magnitude", "2"]),
}


@pytest.mark.parametrize("case", sorted(COMMANDS))
def test_maintenance_commands_match_reference(case, forged, tmp_path, capsys):
  kind, args_of = COMMANDS[case]
  paths = _copy(forged[kind], tmp_path)
  dests = {who: tmp_path / f"dest_{who}" for who in paths}
  for who, path in paths.items():
    shutil.copytree(path, dests[who], ignore=shutil.ignore_patterns("mesh*", "skel*"))
  res = CliRunner().invoke(jax_cli, args_of(paths["jax"], dests["jax"]))
  assert res.exit_code == 0, res.output
  assert cli_main(args_of(paths["port"], dests["port"])) == 0
  if "clean" in case:  # the others print the JAX queue's progress bar
    assert capsys.readouterr().out == res.output
  flush_local()
  for which in (paths, dests):
    assert _listing(which["port"]) == _listing(which["jax"])
    got = {k: v for k, v in layer_tree(which["port"]).items() if k != "integrity"}
    ref = {k: v for k, v in layer_tree(which["jax"]).items() if k != "integrity"}
    assert got == ref
    assert got == ref
  def index_dir(root):
    return [p for p in _listing(root) if p.startswith(("mesh_mip", "skeletons_mip"))]

  before, after = index_dir(forged[kind]["port"]), index_dir(paths["port"])
  if "xfer" in case:
    # the decimal prefixes copy every fragment and manifest; not the info,
    # and the skeleton prefixes (1-9) not the .spatial cells (0-...)
    copied = index_dir(dests["port"])
    assert after == before and set(copied) <= set(before) and len(copied) > 10
    assert all(p.endswith("/info") or p.split("/")[-1].startswith("0")
               for p in set(before) - set(copied))
  else:
    assert 0 < len(after) < len(before) / 2
  if "clean" in case:
    assert not any(p.endswith((".spatial.gz", ".sk.gz")) or p.count(":") == 2 for p in after)


def test_queued_rm_and_xfer_run_in_the_worker(forged, tmp_path):
  paths = _copy(forged["skeleton"], tmp_path)
  q = f"fq://{tmp_path}/q"
  assert cli_main(["skeleton", "xfer", f"file://{paths['port']}",
                   f"file://{tmp_path}/copy", "--queue", q]) == 0
  assert cli_main(["execute", q, "-x", "-q", "--batch", "4"]) == 0  # solo members
  assert cli_main(["skeleton", "rm", f"file://{paths['port']}", "--queue", q]) == 0
  assert cli_main(["execute", q, "-x", "-q"]) == 0
  flush_local()
  copy = [p for p in _listing(tmp_path / "copy") if p.startswith("skeletons_mip_0/")]
  src = [p for p in _listing(forged["skeleton"]["port"]) if p.startswith("skeletons_mip_0/")]
  left = [p for p in _listing(paths["port"]) if p.startswith("skeletons_mip_0/")]
  # label prefixes 1-9: the info and the .spatial cells (0-...) stay
  kept = [p for p in src if p.endswith("/info") or p.split("/")[-1].startswith("0")]
  assert copy == [p for p in src if p not in kept] and left == kept


# -- design and license ----------------------------------------------------------


DESIGN = {
  "ds_memory": ["ds-memory", "{path}"],
  "ds_memory_verbose": ["ds-memory", "{path}", "--verbose", "--memory", "50000000",
                        "--factor", "2,2,2"],
  "ds_memory_max_mips": ["ds-memory", "{path}", "--max-mips", "2", "--memory", "1000000"],
  "ds_shape": ["ds-shape", "{path}", "--memory", "20000000"],
  "ds_shape_num_mips": ["ds-shape", "{path}", "--num-mips", "1", "--mip", "0"],
  "bounds": ["bounds", "{path}"],
  "bounds_no_chunks": ["bounds", "{path}"],
}


@pytest.mark.parametrize("case", sorted(DESIGN) + ["license"])
def test_design_and_license_print_the_reference_text(case, tmp_path, capsys):
  path = tmp_path / "layer"
  JaxVolume.from_numpy(np.zeros((100, 70, 20, 2), np.uint16), f"file://{path}",
                       resolution=(4, 4, 40), chunk_size=(32, 32, 16))
  if case == "bounds_no_chunks":
    shutil.rmtree(path / "4_4_40")
  args = ["license"] if case == "license" else ["design", *(
    a.format(path=f"file://{path}") for a in DESIGN[case])]
  res = CliRunner().invoke(jax_cli, args)
  assert res.exit_code == 0, res.output
  assert cli_main(args) == 0
  out = capsys.readouterr().out
  assert out == res.output and out.strip()


# -- legacy tasks ----------------------------------------------------------------


def _image_layers(tmp_path, data, dest_dtype, chunk=(16, 16, 8), **kw):
  src = tmp_path / "src"
  JaxVolume.from_numpy(data, f"file://{src}", resolution=(8, 8, 40), chunk_size=chunk, **kw)
  dests = {}
  for who in ("jax", "port"):
    dests[who] = tmp_path / who
    JaxVolume.from_numpy(np.zeros(data.shape, dest_dtype), f"file://{dests[who]}",
                         resolution=(8, 8, 40), chunk_size=chunk,
                         layer_type=kw.get("layer_type"))
  return src, dests


def _payload_both(name, params):
  """The same payload through both packages' deserialize and execute."""
  payload = json.dumps({"class": name, "params": params["jax"]})
  jax_deserialize(payload).execute()
  deserialize(json.dumps({"class": name, "params": params["port"]})).execute()


def _per(dests, **fixed):
  return {who: {**fixed, "dest_path": f"file://{d}"} for who, d in dests.items()}


def test_hyper_square_consensus_task_matches_reference(tmp_path):
  data = voronoi()
  src, dests = _image_layers(tmp_path, data, np.uint64, layer_type="segmentation")
  ids = np.unique(data)[1:].tolist()
  doc = {"vol1": {str(i): 2**40 + k % 3 for k, i in enumerate(ids[:6])},
         "vol2": {str(i): 5 for i in ids[6:9]}}
  CloudFiles(f"file://{tmp_path}").put("consensus.json", json.dumps(doc))
  for offset in ((0, 0, 0), (32, 32, 0)):
    _payload_both("HyperSquareConsensusTask", _per(
      dests, src_path=f"file://{src}", consensus_map_path=f"file://{tmp_path}/consensus.json",
      shape=[32, 32, 24], offset=list(offset)))
  _same(dests)


@pytest.mark.parametrize("where", ["local", "cloud"])
def test_watershed_remap_task_matches_reference(where, tmp_path):
  data = np.asfortranarray(np.random.default_rng(2).integers(0, 50, (40, 36, 16)).astype(np.uint32))
  src, dests = _image_layers(tmp_path, data, np.uint32, layer_type="segmentation")
  table = (np.arange(50, dtype=np.uint32) * 7919) % 1000
  buf = io.BytesIO()
  np.save(buf, table)
  (tmp_path / "map.npy").write_bytes(buf.getvalue())
  map_path = str(tmp_path / "map.npy") if where == "local" else f"file://{tmp_path}/map.npy"
  _payload_both("WatershedRemapTask", _per(
    dests, map_path=map_path, src_path=f"file://{src}", shape=[32, 32, 16], offset=[16, 0, 0]))
  _same(dests)


@pytest.mark.parametrize("mask_mip", [0, 1])
def test_mask_affinitymap_task_matches_reference(mask_mip, tmp_path):
  rng = np.random.default_rng(3)
  aff = rng.random((40, 36, 16, 3)).astype(np.float32)
  src, dests = _image_layers(tmp_path, aff, np.float32)
  mask = (rng.random((40, 36, 16)) > 0.4).astype(np.uint8)
  JaxVolume.from_numpy(mask, f"file://{tmp_path}/mask", resolution=(8, 8, 40),
                       chunk_size=(16, 16, 8))
  if mask_mip:
    JaxQueue(parallel=1, progress=False).insert(jax_tc.create_downsampling_tasks(
      f"file://{tmp_path}/mask", mip=0, num_mips=1))
  _payload_both("MaskAffinitymapTask", _per(
    dests, aff_path=f"file://{src}", mask_path=f"file://{tmp_path}/mask",
    shape=[40, 36, 16], offset=[0, 0, 0], mask_mip=mask_mip))
  got = _same(dests)
  assert len(got) > 4


def _model(patch):
  """A numpy model: two channels from local means and a sigmoid."""
  x = patch[..., 0].astype(np.float32)
  smooth = (x + np.roll(x, 1, 0) + np.roll(x, 1, 1)) / np.float32(3)
  return np.stack([smooth, 1 / (1 + np.exp(-x / np.float32(64)))], -1)


def test_legacy_inference_task_matches_reference(tmp_path):
  from igneous_tpu.tasks.obsolete import register_inference_model as jax_register

  img = np.asfortranarray(np.random.default_rng(4).integers(0, 255, (48, 40, 20)).astype(np.uint8))
  src = tmp_path / "img"
  JaxVolume.from_numpy(img, f"file://{src}", resolution=(8, 8, 40), chunk_size=(16, 16, 8))
  dests = {}
  for who in ("jax", "port"):
    dests[who] = tmp_path / who
    JaxVolume.from_numpy(np.zeros((48, 40, 20, 2), np.float32), f"file://{dests[who]}",
                         resolution=(8, 8, 40), chunk_size=(16, 16, 8))
  jax_register("toy", _model)
  tasks.register_inference_model("toy", _model)
  for name in ("LegacyInferenceTask", "InferenceTask"):
    assert getattr(tasks.obsolete, name) is tasks.LegacyInferenceTask
  _payload_both("LegacyInferenceTask", _per(
    dests, src_path=f"file://{src}", model_name="toy", shape=[48, 40, 20],
    offset=[0, 0, 0], patch_size=[24, 16, 12], overlap=[6, 4, 4]))
  _same(dests)
  with pytest.raises(KeyError, match="register_inference_model"):
    deserialize({"class": "LegacyInferenceTask", "params": {
      "src_path": f"file://{src}", "dest_path": f"file://{dests['port']}",
      "model_name": "missing", "shape": [8, 8, 8], "offset": [0, 0, 0]}}).execute()
