"""The port's multi-host pods against the JAX package's.

The partition arithmetic (``lease_partition``, ``page_partition``) and
``from_process_local``'s padding and errors equal the JAX package's over
200 seeded (n, devices, processes, index, weights) cases, each package's
topology set to the same counts (JAX's ``device_count``,
``process_count`` and ``process_index`` by monkeypatch; the port's
``_topology`` seam). ``throughput_weights`` equals the JAX package's on a
seeded journal. Then a real two-rank pod on localhost (gloo, ranks on the
CPU), as ``tests/test_multihost.py`` and ``tests/test_paged_batching.py``
run the JAX package's: ``ChunkExecutor.run_global`` on a lease of 7
chunks, every real row byte for byte the JAX package's ``run_global``
output for the same chunks in one process, and the all-reduced nonzero
count global on both ranks; ``planes=2`` uint64 mode on 3 chunks;
``PagedGlobalRunner`` on the 7 pages of three ragged items; and
``initialize``'s idempotence and its re-init error. Exact throughout.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import jax
from igneous_tpu.parallel import ChunkExecutor as JaxChunkExecutor
from igneous_tpu.parallel import make_mesh
from igneous_tpu.parallel import multihost as jax_multihost
from igneous_tpu.parallel.paged import PagedGlobalRunner as JaxPagedGlobalRunner
from igneous_tpu_torch import device
from igneous_tpu_torch.parallel import multihost

import torch_journal_records as seeded
from torch_pod_data import FACTORS, N_CHUNKS, N_LABELS, _chunks, _labels, _pages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


def _topologies(n_cases=200, seed=0):
  rng = np.random.default_rng(seed)
  for _ in range(n_cases):
    nproc = int(rng.integers(1, 9))
    ndev = nproc * int(rng.integers(1, 5))
    pid = int(rng.integers(0, nproc))
    n = int(rng.integers(0, 120))
    kind = int(rng.integers(0, 3))
    if kind == 0:
      weights = None
    elif kind == 1:
      weights = [float(w) for w in rng.uniform(0.0, 3.0, nproc)]
    else:  # a wrong length: both packages refuse it
      weights = [1.0] * (nproc + 1)
    yield n, ndev, nproc, pid, weights


def _set_topology(monkeypatch, ndev, nproc, pid):
  monkeypatch.setattr(jax, "device_count", lambda: ndev)
  monkeypatch.setattr(jax, "process_count", lambda: nproc)
  monkeypatch.setattr(jax, "process_index", lambda: pid)
  monkeypatch.setattr(multihost, "_topology", lambda: (ndev, nproc, pid))


def _outcome(fn, *args, **kw):
  try:
    return ("ok", fn(*args, **kw))
  except ValueError as exc:
    return ("ValueError", str(exc))


def test_partitions_equal_the_reference(monkeypatch):
  cases = list(_topologies())
  assert len(cases) == 200
  for n, ndev, nproc, pid, weights in cases:
    _set_topology(monkeypatch, ndev, nproc, pid)
    case = (n, ndev, nproc, pid, weights)
    assert multihost.lease_partition(n) == jax_multihost.lease_partition(n), case
    assert (_outcome(multihost.page_partition, n, weights=weights)
            == _outcome(jax_multihost.page_partition, n, weights=weights)), case
    assert (_outcome(multihost.page_partition, n)
            == _outcome(jax_multihost.page_partition, n)), case


def test_from_process_local_pads_and_refuses_as_the_reference():
  """One process on both sides (the JAX package builds a real global
  array over its test mesh here, so ``per`` is a multiple of that mesh's
  devices): the global batch is the local rows and zero rows to ``per``;
  more rows than ``per`` is the same ValueError."""
  rng = np.random.default_rng(1)
  mesh = make_mesh()
  ndev = int(np.prod(mesh.devices.shape))
  pod = multihost.pod_mesh()
  dtypes = (np.uint8, np.uint16, np.uint32, np.int32, np.float32)
  for case in range(200):
    per = ndev * int(rng.integers(1, 3))
    rows = int(rng.integers(0, per + 3))
    dtype = dtypes[case % len(dtypes)]
    shape = (rows,) + tuple(int(v) for v in rng.integers(1, 4, int(rng.integers(1, 4))))
    local = rng.integers(0, 200, shape).astype(dtype)
    got = _outcome(multihost.from_process_local, pod, local, per)
    exp = _outcome(jax_multihost.from_process_local, mesh, local, per)
    assert got[0] == exp[0], (case, got, exp)
    if got[0] == "ValueError":
      assert got[1] == exp[1], case
      continue
    batch = got[1]
    assert batch.shape == tuple(exp[1].shape) and batch.offset == 0, case
    assert np.array_equal(batch.data.numpy(), np.asarray(exp[1])), case
    shards = batch.addressable_shards
    assert [s.index[0].start for s in shards] == list(range(per)), case
    for s in shards:
      k = s.index[0].start
      assert np.array_equal(np.asarray(s.data)[0], np.asarray(exp[1])[k]), case


def test_throughput_weights_equal_the_reference(tmp_path):
  recs = seeded.records(3, now=time.time())
  seeded.write_segments(str(tmp_path / "journal"), recs)
  path = f"file://{tmp_path}/journal"
  for workers in (["w0", "w1", "w2"], ["w2", "w0", "new"], ["absent"]):
    got = multihost.throughput_weights(path, workers)
    assert got == jax_multihost.throughput_weights(path, workers), workers
  assert multihost.throughput_weights(path, ["w0", "w1", "w2"]) is not None
  assert multihost.throughput_weights(f"file://{tmp_path}/none", ["w0"]) is None


def test_outside_a_pod_one_process_of_one_device():
  pod = multihost.pod_mesh()
  assert (pod.axis_names, pod.world_size, pod.rank, pod.device_count) == (
    ("chunks",), 1, 0, 1)
  assert multihost.lease_partition(7) == (list(range(7)), 7)
  assert multihost.cpu_collectives_available()


def test_backend_rule():
  import torch

  cards = torch.cuda.device_count()
  assert multihost.backend_for(torch.device("cpu"), 1) == "gloo"
  # ranks sharing a card (more ranks on the host than cards): gloo
  assert multihost.backend_for(torch.device("cuda"), cards + 1) == "gloo"


# ---------------------------------------------------------------------------
# a real two-rank pod on localhost

RANK = textwrap.dedent("""
  import json, sys
  import numpy as np
  sys.path.insert(0, {tests!r})
  from torch_pod_data import FACTORS, _chunks, _labels, _pages
  from igneous_tpu_torch.parallel import ChunkExecutor, multihost
  from igneous_tpu_torch.parallel.paged import PagedGlobalRunner

  multihost.initialize()  # the knobs
  multihost.initialize()  # idempotent
  try:
    multihost.initialize(num_processes=3)
    raise SystemExit("re-init with other arguments did not raise")
  except RuntimeError as exc:
    assert "already ran" in str(exc), exc
  import torch.distributed as dist
  assert dist.get_backend() == "gloo", dist.get_backend()
  pod = multihost.pod_mesh()
  assert (pod.world_size, pod.device_count) == (2, 2), pod
  rank = pod.rank
  out = {{"rank": rank}}
  rows = {{}}

  chunks = _chunks()
  mine, per = multihost.lease_partition(len(chunks))
  batch = multihost.from_process_local(pod, chunks[mine], per)
  outs, nonzero = ChunkExecutor(FACTORS, method="average").run_global(batch)
  out["nonzero"] = nonzero
  out["per"] = per
  for m, o in enumerate(outs):
    for s in o.addressable_shards:
      k = s.index[0].start
      if k < len(chunks):
        rows[f"avg{{m}}_{{k}}"] = np.asarray(s.data)[0]

  labels = _labels()
  lo = (labels & np.uint64(0xFFFFFFFF)).astype(np.uint32)
  hi = (labels >> np.uint64(32)).astype(np.uint32)
  mine, per = multihost.lease_partition(len(labels))
  planes = (multihost.from_process_local(pod, lo[mine], per),
            multihost.from_process_local(pod, hi[mine], per))
  outs, nonzero = ChunkExecutor(FACTORS, method="mode", planes=2).run_global(planes)
  out["mode_nonzero"] = nonzero
  for m, (olo, ohi) in enumerate(outs):
    for slo, shi in zip(olo.addressable_shards, ohi.addressable_shards):
      k = slo.index[0].start
      assert k == shi.index[0].start
      if k < len(labels):
        rows[f"mode{{m}}_{{k}}_lo"] = np.asarray(slo.data)[0]
        rows[f"mode{{m}}_{{k}}_hi"] = np.asarray(shi.data)[0]

  pages, exts = _pages()
  start, stop, per = multihost.page_partition(len(pages))
  gp = multihost.from_process_local(pod, pages[start:stop], per)
  ge = multihost.from_process_local(pod, exts[start:stop], per)
  outs = PagedGlobalRunner(FACTORS, method="average", mesh=pod)(gp, ge)
  out["page_range"] = [start, stop, per]
  out["page_shape"] = list(outs[0].shape)
  for m, o in enumerate(outs):
    for s in o.addressable_shards:
      k = s.index[0].start
      if start <= k < stop:
        rows[f"page{{m}}_{{k}}"] = np.asarray(s.data)[0]
  np.savez({out_dir!r} + f"/rank{{rank}}.npz", **rows)
  print("POD_OK " + json.dumps(out))
""")


def _free_port() -> int:
  s = socket.socket()
  s.bind(("127.0.0.1", 0))
  port = s.getsockname()[1]
  s.close()
  return port


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
  out_dir = str(tmp_path_factory.mktemp("pod"))
  src = RANK.format(tests=os.path.join(REPO, "tests"), out_dir=out_dir)
  port = _free_port()
  procs = []
  for pid in range(2):
    env = dict(os.environ)
    env.update({
      "IGNEOUS_TORCH_DEVICE": "cpu",
      "IGNEOUS_COORDINATOR": f"tcp://127.0.0.1:{port}",
      "IGNEOUS_NUM_PROCESSES": "2",
      "IGNEOUS_PROCESS_ID": str(pid),
      "PYTHONPATH": REPO,
    })
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE"):
      env.pop(name, None)
    procs.append(subprocess.Popen(
      [sys.executable, "-c", src], env=env, cwd=REPO,
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ))
  results = []
  for p in procs:
    try:
      out, err = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
      for q in procs:
        q.kill()
      raise
    results.append((p.returncode, out, err))
  reports = []
  for pid, (rc, out, err) in enumerate(results):
    assert rc == 0, f"rank {pid} failed rc={rc}:\n{err[-3000:]}"
    line = next(l for l in out.splitlines() if l.startswith("POD_OK "))
    reports.append(json.loads(line[len("POD_OK "):]))
  rows = {}
  for pid in range(2):
    with np.load(os.path.join(out_dir, f"rank{pid}.npz")) as z:
      for k in z.files:
        assert k not in rows, k  # a rank addresses only its own rows
        rows[k] = z[k]
  return reports, rows


def _jax_per(n: int) -> int:
  """``n`` rows padded to the JAX test mesh's device count."""
  ndev = int(np.prod(make_mesh().devices.shape))
  return -(-n // ndev) * ndev


def _jax_run_global(executor, arrays, per):
  mesh = make_mesh()
  if isinstance(arrays, tuple):
    batch = tuple(jax_multihost.from_process_local(mesh, a, per) for a in arrays)
  else:
    batch = jax_multihost.from_process_local(mesh, arrays, per)
  return executor.run_global(batch)


def test_pod_run_global_rows_are_the_reference(pod_run):
  reports, rows = pod_run
  chunks = _chunks()
  assert [r["rank"] for r in reports] == [0, 1]
  ex = JaxChunkExecutor(make_mesh(), factors=FACTORS, method="average")
  outs, nonzero = _jax_run_global(ex, chunks, _jax_per(N_CHUNKS))
  for r in reports:  # the all-reduced tally is global on every rank
    assert r["nonzero"] == int(nonzero) == int((chunks != 0).sum())
    assert r["per"] == 4  # 7 chunks over 2 devices: 8 slots, one zero pad
  for m, o in enumerate(outs):
    ref = np.asarray(o)
    for k in range(N_CHUNKS):
      got = rows[f"avg{m}_{k}"]
      assert got.dtype == ref.dtype and got.tobytes() == ref[k].tobytes(), (m, k)


def test_pod_run_global_uint64_mode_planes(pod_run):
  reports, rows = pod_run
  labels = _labels()
  lo = (labels & np.uint64(0xFFFFFFFF)).astype(np.uint32)
  hi = (labels >> np.uint64(32)).astype(np.uint32)
  ex = JaxChunkExecutor(make_mesh(), factors=FACTORS, method="mode", planes=2)
  outs, nonzero = _jax_run_global(ex, (lo, hi), _jax_per(N_LABELS))
  for r in reports:
    assert r["mode_nonzero"] == int(nonzero) == int((labels != 0).sum())
  for m, (olo, ohi) in enumerate(outs):
    for k in range(N_LABELS):
      assert rows[f"mode{m}_{k}_lo"].tobytes() == np.asarray(olo)[k].tobytes(), (m, k)
      assert rows[f"mode{m}_{k}_hi"].tobytes() == np.asarray(ohi)[k].tobytes(), (m, k)


def test_pod_paged_global_runner_rows_are_the_reference(pod_run):
  reports, rows = pod_run
  pages, exts = _pages()
  mesh = make_mesh()
  runner = JaxPagedGlobalRunner(FACTORS, method="average", mesh=mesh)
  n = len(pages)
  outs = runner(jax_multihost.from_process_local(mesh, pages, _jax_per(n)),
                jax_multihost.from_process_local(mesh, exts, _jax_per(n)))
  ranges = sorted(tuple(r["page_range"]) for r in reports)
  assert ranges == [(0, 4, 4), (4, 7, 4)]  # page_partition over 2 ranks
  assert reports[0]["page_shape"] == [8, 1, 8, 4, 4]
  for m, o in enumerate(outs):
    ref = np.asarray(o)
    for k in range(n):
      assert rows[f"page{m}_{k}"].tobytes() == ref[k].tobytes(), (m, k)
