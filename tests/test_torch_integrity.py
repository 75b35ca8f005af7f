"""The port's write envelope, corruption guard, audit and heal against the
JAX package's.

Each case of ``tests/test_integrity.py`` runs on both packages and every
observation is compared: manifest records (without their ``ts``),
exemptions and the off knob, last writer wins, verify-after-write on a put
torn by a ``set_backend_wrapper`` wrapper, the typed ``CorruptChunkError``
with its counters and quarantine records, a decode cache that a corrupt
chunk never fills, audit findings (missing, decode_error,
digest_mismatch; ``--allow-missing``), the task's wire format both ways,
and heal. Across the packages: each one's audit reads the other's
manifests and finds the layer intact; the same damage gives the same
findings in both, and the port's ``audit --heal`` writes the JAX
package's healed bytes. Segment names are compared without their
``w<pid>_<seq>``.
"""

import json
import os
import pathlib
import re

import numpy as np
import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import chunk_cache as jax_chunk_cache
from igneous_tpu import integrity as jax_integrity
from igneous_tpu import storage as jax_storage
from igneous_tpu import task_creation as jax_tc
from igneous_tpu import telemetry as jax_telemetry
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.queues import LocalTaskQueue as JaxLocalTaskQueue
from igneous_tpu.queues.registry import deserialize as jax_deserialize
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu.task_creation import audit as jax_audit
from igneous_tpu_torch import Volume, chunk_cache, device, integrity, storage, telemetry
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize, serialize
from igneous_tpu_torch.task_creation import audit
from igneous_tpu_torch.tasks.audit import IntegrityAuditTask, expected_chunks, report_name

SIDE = {
  "jax": dict(integrity=jax_integrity, storage=jax_storage, Volume=JaxVolume, tc=jax_tc,
              audit=jax_audit, chunk_cache=jax_chunk_cache,
              counters=lambda: jax_telemetry.counters_snapshot(),
              queue=lambda: JaxLocalTaskQueue(parallel=1, progress=False)),
  "port": dict(integrity=integrity, storage=storage, Volume=Volume, tc=tc,
               audit=audit, chunk_cache=chunk_cache, counters=telemetry.counters_snapshot,
               queue=lambda: LocalTaskQueue(parallel=1)),
}


def flush_local() -> None:
  """Write both packages' buffered manifest records of file:// and mem://
  layers, and drop those of other protocols: a gs:// or s3:// layer's
  records, left by a test of this process whose fake server has stopped,
  would go to the service's real endpoint."""
  for mod in (jax_integrity, integrity):
    recorder = mod._RECORDER
    with recorder._lock:
      remote = [p for p in recorder._buf if not p.startswith(("file://", "mem://"))]
      for path in remote:
        del recorder._buf[path]
    for path in list(recorder._buf):
      mod.flush(path)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # the reference runs its device (XLA) pyramid, not its native host kernels
  monkeypatch.setenv("IGNEOUS_POOL_HOST", "0")
  for name in ("IGNEOUS_INTEGRITY", "IGNEOUS_INTEGRITY_BATCH",
               "IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE", "IGNEOUS_CHUNK_CACHE"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  flush_local()
  jax_telemetry.reset_all()
  telemetry.reset_all()
  for side in SIDE.values():
    side["chunk_cache"].clear()
  yield
  flush_local()
  for side in SIDE.values():
    side["chunk_cache"].clear()
    side["storage"].clear_memory_storage()
  device.reset_device()


def _record(line: str):
  """A JSONL record without its ``ts``; a torn line as it is."""
  try:
    rec = json.loads(line)
  except json.JSONDecodeError:
    return line
  rec.pop("ts", None)
  return rec


def sidecars(root) -> dict:
  """The ``integrity/`` files of a layer directory, normalised: the
  records of the JSONL files (without ``ts``) merged per directory and
  name with ``_w<pid>_<seq>`` taken out, and ``report.json`` without its
  ``ts`` and ``layer``."""
  base = pathlib.Path(root) / "integrity"
  out = {}
  for p in sorted(base.rglob("*")) if base.is_dir() else []:
    if not p.is_file():
      continue
    name = re.sub(r"_w\d+_\d+\.jsonl$", ".jsonl", str(p.relative_to(root)))
    if p.name == "report.json":
      rep = json.loads(p.read_text())
      out[name] = {k: v for k, v in rep.items() if k not in ("ts", "layer")}
      continue
    recs = [_record(line) for line in p.read_text().splitlines() if line.strip()]
    out.setdefault(name, []).extend(recs)
  return {k: sorted(v, key=lambda r: json.dumps(r, sort_keys=True))
          if isinstance(v, list) else v for k, v in out.items()}


def layer_tree(root) -> dict:
  """Every file of a layer but its provenance, with the sidecars
  normalised (``sidecars``)."""
  flush_local()
  root = pathlib.Path(root)
  files = {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(root.rglob("*"))
    if p.is_file() and p.name != "provenance" and "integrity" not in p.relative_to(root).parts
  }
  files["integrity"] = sidecars(root)
  assert files["integrity"], f"no integrity sidecars under {root}"
  return files


# -- the write envelope ------------------------------------------------------


def _envelope_script(who, path):
  side = SIDE[who]
  cf = side["storage"].CloudFiles(path)
  cf.put("1_1_1/0-32_0-32_0-32", b"\x01" * 64, compress="gzip")
  cf.put("1_1_1/32-64_0-32_0-32", b"\x02" * 64, compress=None)
  cf.put_stored("2_2_1/0-16_0-16_0-32", b"stored", None)
  cf.put("top", b"root key", compress=None)
  cf.put("info", b'{"type":"image"}', compress=None)
  cf.put("provenance", b"{}", compress=None)
  cf.put("mesh/provenance.bak", b"{}", compress=None)
  cf.put("journal/seg_1.jsonl", b"{}\n", compress=None)
  cf.put("report.json", b"{}", compress=None)
  side["integrity"].flush_all()
  man = side["integrity"].load_manifest(path)
  stored, method = cf.get_stored("1_1_1/0-32_0-32_0-32")
  assert method == "gzip"
  # the digest covers the stored bytes, so it is checked without decoding
  assert man["1_1_1/0-32_0-32_0-32.gz"]["digest"] == side["integrity"].digest_hex(stored)
  return ({k: {f: v for f, v in r.items() if f != "ts"} for k, r in man.items()},
          side["integrity"].load_manifest(path, prefix="1_1_1").keys(),
          side["counters"]().get("integrity.records"),
          side["counters"]().get("integrity.manifest_segments"))


@pytest.mark.parametrize("proto", ["mem", "file"])
def test_envelope_records_stored_bytes_and_exempts_metadata(tmp_path, proto):
  got = {}
  for who in SIDE:
    path = f"mem://integrity-{who}/env" if proto == "mem" else f"file://{tmp_path / who}"
    got[who] = _envelope_script(who, path)
  assert got["port"] == got["jax"]
  man, mip1_keys, records, segments = got["port"]
  assert set(man) == {"1_1_1/0-32_0-32_0-32.gz", "1_1_1/32-64_0-32_0-32",
                      "2_2_1/0-16_0-16_0-32", "top"}
  assert set(mip1_keys) == {"1_1_1/0-32_0-32_0-32.gz", "1_1_1/32-64_0-32_0-32"}
  assert (records, segments) == (4, 3)  # one segment a top-level directory
  if proto == "file":
    assert sidecars(tmp_path / "port") == sidecars(tmp_path / "jax")


@pytest.mark.parametrize("key", [
  "integrity/manifests/x", "info", "provenance", "mesh/provenance", "a/provenance_old",
  "x.json", "j/seg.jsonl", "1_1_1/0-1_0-1_0-1", "mesh/1:0:0-1_0-1_0-1.gz", "infos",
])
def test_exemptions_as_reference(key):
  assert integrity.exempt(key) == jax_integrity.exempt(key)
  assert integrity.digest_hex(key.encode()) == jax_integrity.digest_hex(key.encode())


@pytest.mark.parametrize("value", ["off", "0", "false", "no"])
def test_envelope_off_knob_restores_bytes_only_path(monkeypatch, value):
  monkeypatch.setenv("IGNEOUS_INTEGRITY", value)
  for who, side in SIDE.items():
    path = f"mem://integrity-{who}/off"
    side["storage"].CloudFiles(path).put("1_1_1/0-32_0-32_0-32", b"\x02" * 64, compress="gzip")
    side["integrity"].flush_all()
    assert side["integrity"].load_manifest(path) == {}
    assert side["counters"]().get("integrity.records", 0) == 0
    side["integrity"].quarantine(path, "k", "off")
    assert side["integrity"].load_quarantine(path) == []


@pytest.mark.parametrize("batch", ["1", "2", "256"])
def test_manifest_batches_and_last_writer_wins(monkeypatch, batch):
  monkeypatch.setenv("IGNEOUS_INTEGRITY_BATCH", batch)
  seen = {}
  for who, side in SIDE.items():
    path = f"mem://integrity-{who}/lww"
    cf = side["storage"].CloudFiles(path)
    cf.put("1_1_1/0-32_0-32_0-32", b"old-bytes", compress=None)
    cf.put("1_1_1/32-64_0-32_0-32", b"other", compress=None)
    side["integrity"].flush(path)
    cf.put("1_1_1/0-32_0-32_0-32", b"healed-bytes", compress=None)
    side["integrity"].flush_all()
    man = side["integrity"].load_manifest(path, prefix="1_1_1")
    assert man["1_1_1/0-32_0-32_0-32"]["digest"] == side["integrity"].digest_hex(b"healed-bytes")
    seen[who] = ({k: r["digest"] for k, r in man.items()},
                 side["counters"]().get("integrity.manifest_segments"))
  assert seen["port"] == seen["jax"]


class _TornBackend:
  """Wraps a backend: every put stores the first half of its bytes."""

  def __init__(self, backend):
    self._backend = backend

  def put(self, key, data):
    self._backend.put(key, bytes(data)[: len(data) // 2])

  def __getattr__(self, name):
    return getattr(self._backend, name)


def test_verify_after_write_catches_torn_put(tmp_path, monkeypatch):
  monkeypatch.setenv("IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE", "1")
  seen = {}
  for who, side in SIDE.items():
    side["storage"].set_backend_wrapper(lambda backend, pth: _TornBackend(backend))
    try:
      cf = side["storage"].CloudFiles(f"file://{tmp_path / who}")
      with pytest.raises(side["integrity"].CorruptChunkError) as ei:
        cf.put("1_1_1/0-32_0-32_0-32", b"\x03" * 128, compress="gzip")
    finally:
      side["storage"].set_backend_wrapper(None)
    counters = side["counters"]()
    seen[who] = (str(ei.value).replace(str(tmp_path / who), "<root>"), ei.value.key,
                 ei.value.expected, ei.value.actual,
                 counters.get("integrity.verify_failed"), counters.get("integrity.quarantined"))
  assert seen["port"] == seen["jax"]
  assert "verify-after-write" in seen["port"][0] and seen["port"][4:] == (1, 1)
  # one quarantine record each, torn too (the wrapper tears every put, and
  # where the cut falls depends on the digits of its ts)
  for who in SIDE:
    (torn,) = sidecars(tmp_path / who)["integrity/quarantine/q.jsonl"]
    assert torn.startswith('{"key": "1_1_1/0-32_0-32_0-32.gz", "reason": "ve')


def test_verify_after_write_passes_sound_puts(tmp_path, monkeypatch):
  monkeypatch.setenv("IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE", "1")
  cf = storage.CloudFiles(f"file://{tmp_path}")
  cf.put("1_1_1/0-32_0-32_0-32", b"\x03" * 128, compress="gzip")
  assert cf.get("1_1_1/0-32_0-32_0-32") == b"\x03" * 128
  assert telemetry.counters_snapshot().get("integrity.verify_failed", 0) == 0


# -- the read path's guard ---------------------------------------------------


def _small_volume(who, root, compress="gzip"):
  path = f"file://{root}"
  data = np.random.default_rng(3).integers(0, 200, (64, 64, 64)).astype(np.uint8)
  vol = SIDE[who]["Volume"].from_numpy(data, path, chunk_size=(32, 32, 32), compress=compress)
  SIDE[who]["integrity"].flush_all()
  return path, vol, data


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_chunk_read_raises_typed_error(tmp_path, damage):
  seen = {}
  for who, side in SIDE.items():
    path, vol, _ = _small_volume(who, tmp_path / who)
    chunk = tmp_path / who / vol.meta.key(0) / "0-32_0-32_0-32.gz"
    raw = chunk.read_bytes()
    i = len(raw) // 2
    chunk.write_bytes(raw[:i] + bytes([raw[i] ^ 0xFF]) + raw[i + 1:] if damage == "flip"
                      else raw[:i])
    side["chunk_cache"].clear()
    with pytest.raises(side["integrity"].CorruptChunkError) as ei:
      vol.download(vol.meta.bounds(0), mip=0)
    # not an IOError: fill_missing must never swallow corruption
    assert not isinstance(ei.value, (IOError, EOFError))
    counters = side["counters"]()
    seen[who] = (ei.value.key, ei.value.reason, counters.get("integrity.corrupt_reads"),
                 counters.get("integrity.quarantined"),
                 [_record(json.dumps(r)) for r in side["integrity"].load_quarantine(path)])
  assert seen["port"] == seen["jax"]
  assert seen["port"][0] == f"{vol.meta.key(0)}/0-32_0-32_0-32"
  assert seen["port"][2:4] == (1, 1)


def test_corrupt_chunk_never_populates_decode_cache(tmp_path, monkeypatch):
  monkeypatch.setenv("IGNEOUS_CHUNK_CACHE", "1")
  path, vol, data = _small_volume("port", tmp_path / "port")
  chunk = tmp_path / "port" / vol.meta.key(0) / "0-32_0-32_0-32.gz"
  good = chunk.read_bytes()
  chunk.write_bytes(good[: len(good) // 2])  # torn
  chunk_cache.clear()
  from igneous_tpu_torch.lib import Bbox

  with pytest.raises(integrity.CorruptChunkError):
    vol.download(Bbox((0, 0, 0), (32, 32, 32)), mip=0)
  assert len(chunk_cache.shared_cache()) == 0
  # restored bytes decode afresh: nothing of the corrupt read was kept
  chunk.write_bytes(good)
  assert np.array_equal(vol.download(vol.meta.bounds(0), mip=0)[..., 0], data)


# -- the audit task ----------------------------------------------------------


def _audit(who, path, mip, report_dir, **kw):
  side = SIDE[who]
  side["queue"]().insert(side["audit"].create_integrity_audit_tasks(
    path, mip=mip, report_dir=report_dir, **kw))
  return side["audit"].load_findings(report_dir)


def _damage_raw_layer(root, vol):
  """Delete the first chunk of mip 0 and overwrite the second with noise
  of its length (it decodes, so only the digest can tell)."""
  mip_dir = root / vol.meta.key(0)
  chunks = sorted(os.listdir(mip_dir))
  os.remove(mip_dir / chunks[0])
  n = os.path.getsize(mip_dir / chunks[1])
  (mip_dir / chunks[1]).write_bytes(
    bytes(np.random.default_rng(4).integers(0, 256, n).astype(np.uint8)))
  return chunks


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_audit_detects_missing_and_digest_mismatch(tmp_path, writer):
  """A raw layer damaged the same way gives the same findings and totals
  in both packages' audits, whichever package wrote it."""
  path, vol, _ = _small_volume(writer, tmp_path / "layer", compress=None)
  chunks = _damage_raw_layer(tmp_path / "layer", vol)
  got = {who: _audit(who, path, 0, f"file://{tmp_path / ('audit_' + who)}") for who in SIDE}
  assert got["port"] == got["jax"]
  findings, totals = got["port"]
  assert totals == {"chunks": len(chunks), "findings": 2, "unmanifested": 0, "cells": 1}
  assert {f["key"].rsplit("/", 1)[-1]: f["kind"] for f in findings} == {
    chunks[0]: "missing", chunks[1]: "digest_mismatch"}
  mismatch = next(f for f in findings if f["kind"] == "digest_mismatch")
  assert mismatch["expected"] != mismatch["actual"]
  assert sidecars(tmp_path / "audit_port") == sidecars(tmp_path / "audit_jax")


def test_audit_decode_error_on_torn_gzip(tmp_path):
  got = {}
  for who in SIDE:
    path, vol, _ = _small_volume(who, tmp_path / who)
    mip_dir = tmp_path / who / vol.meta.key(0)
    victim = mip_dir / sorted(os.listdir(mip_dir))[0]
    raw = victim.read_bytes()
    victim.write_bytes(raw[: len(raw) // 2])
    got[who] = _audit(who, path, 0, f"{path}/integrity/audit")
  assert got["port"] == got["jax"]
  findings = got["port"][0]
  assert len(findings) == 1 and findings[0]["kind"] == "decode_error"
  assert sidecars(tmp_path / "port") == sidecars(tmp_path / "jax")


@pytest.mark.parametrize("require_present,check_digest", [(False, True), (True, False)])
def test_audit_allow_missing_and_no_digest(tmp_path, require_present, check_digest):
  got = {}
  for who in SIDE:
    path, vol, _ = _small_volume(who, tmp_path / who, compress=None)
    _damage_raw_layer(tmp_path / who, vol)
    got[who] = _audit(who, path, 0, f"{path}/integrity/audit",
                      require_present=require_present, check_digest=check_digest)
  assert got["port"] == got["jax"]
  kinds = [f["kind"] for f in got["port"][0]]
  assert kinds == (["digest_mismatch"] if not require_present else ["missing"])


def test_audit_task_round_trips_through_wire_format(tmp_path):
  t = IntegrityAuditTask(
    layer_path=f"file://{tmp_path}/v", mip=1, shape=[64, 64, 32],
    offset=[0, 0, 0], report_dir=f"file://{tmp_path}/v/integrity/audit",
  )
  for payload in (serialize(t), jax_serialize(jax_deserialize(serialize(t)))):
    t2 = deserialize(payload)
    assert type(t2) is IntegrityAuditTask
    assert t2._params == t._params and t2.check_digest and t2.require_present
  jt = jax_deserialize(serialize(t))
  assert type(jt).__module__ == "igneous_tpu.tasks.audit"
  assert json.loads(jax_serialize(jt))["params"] == json.loads(serialize(t))["params"]


def test_audit_grid_and_report_names_as_reference(tmp_path):
  """The factory's grid (default cells of 8x8x4 chunks, bounds) and the
  chunks each cell expects are the JAX package's."""
  path = f"file://{tmp_path}/grid"
  data = np.zeros((300, 200, 70), np.uint8)
  JaxVolume.from_numpy(data, path, chunk_size=(32, 32, 16), voxel_offset=(5, 7, 3))
  from igneous_tpu.tasks.audit import expected_chunks as jax_expected
  from igneous_tpu.tasks.audit import report_name as jax_report_name
  for kw in ({}, {"shape": (64, 64, 32)}):
    mine = list(audit.create_integrity_audit_tasks(path, 0, "file:///r", **kw))
    ref = list(jax_audit.create_integrity_audit_tasks(path, 0, "file:///r", **kw))
    assert [t._params for t in mine] == [json.loads(jax_serialize(t))["params"] for t in ref]
  vol, jvol = Volume(path), JaxVolume(path)
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu.lib import Bbox as JaxBbox
  box = ((0, 0, 0), (200, 120, 50))
  assert [b.to_list() for b in expected_chunks(vol, Bbox(*box), 0)] == [
    b.to_list() for b in jax_expected(jvol, JaxBbox(*box), 0)]
  assert report_name(2, (64, 0, 32)) == jax_report_name(2, (64, 0, 32))


# -- heal --------------------------------------------------------------------


def _campaign(who, root):
  """A 256x256x16 uint8 layer (chunks 32x32x16) downsampled to mips 1-2
  by four 128x128x16 tasks."""
  path = f"file://{root}"
  data = np.random.default_rng(5).integers(0, 200, (256, 256, 16)).astype(np.uint8)
  side = SIDE[who]
  side["Volume"].from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(32, 32, 16),
                            compress="gzip")
  side["queue"]().insert(side["tc"].create_downsampling_tasks(
    path, mip=0, num_mips=2, memory_target=int(5e5), compress="gzip"))
  side["integrity"].flush_all()
  return path


def _damage_campaign(root):
  """Flip a byte of a mip-1 chunk, truncate a mip-2 chunk and delete
  another mip-2 chunk."""
  flipped = root / "16_16_40" / "32-64_0-32_0-16.gz"
  raw = flipped.read_bytes()
  flipped.write_bytes(raw[:-9] + bytes([raw[-9] ^ 0x01]) + raw[-8:])
  torn = root / "32_32_40" / "0-32_0-32_0-16.gz"
  torn.write_bytes(torn.read_bytes()[:10])
  os.remove(root / "32_32_40" / "32-64_32-64_0-16.gz")


def _cli(who, args):
  if who == "port":
    from contextlib import redirect_stdout
    import io

    buf = io.StringIO()
    with redirect_stdout(buf):
      code = cli_main(args)
    return code, buf.getvalue()
  res = CliRunner().invoke(jax_cli, args)
  if res.exception and not isinstance(res.exception, SystemExit):
    raise res.exception
  # its local queue draws progress bars on the same stream
  return res.exit_code, re.sub(r"\r?Tasks: [^\]]*\]", "\n", res.output)


def test_provenance_carries_every_field_the_repair_reads(tmp_path):
  got = {}
  for who in SIDE:
    path = _campaign(who, tmp_path / who)
    got[who] = SIDE[who]["audit"].downsample_provenance(SIDE[who]["Volume"](path))
  assert got["port"] == got["jax"]
  for field in ("mip", "shape", "bounds", "num_mips", "factor", "compress", "method",
                "fill_missing", "sparse", "delete_black_uploads", "background_color"):
    assert field in got["port"], field


@pytest.mark.parametrize("queue", [False, True])
def test_audit_heal_repairs_exactly_the_damaged_cells(tmp_path, queue):
  """The same damage on each package's layer: the same CORRUPT lines and
  exit 2 from ``audit``; ``audit --heal`` repairs with one task per
  damaged cell and rewrites the undamaged bytes; the healed layers,
  manifests and reports are equal."""
  before, out = {}, {}
  for who in SIDE:
    root = tmp_path / who
    path = _campaign(who, root)
    before[who] = layer_tree(root)
    _damage_campaign(root)
    code, text = _cli(who, ["audit", path])
    assert code == 2
    corrupt = sorted(line for line in text.splitlines() if line.startswith("CORRUPT"))
    args = ["audit", path, "--heal"]
    if queue:
      args += ["--queue", f"fq://{tmp_path / ('q_' + who)}"]
    code, text = _cli(who, args)
    out[who] = (corrupt, code, [line for line in text.splitlines() if "heal round" in line
                                or line.startswith("audited")])
  assert out["port"] == out["jax"]
  corrupt, code, lines = out["port"]
  assert corrupt == ["CORRUPT decode_error mip=1 16_16_40/32-64_0-32_0-16",
                     "CORRUPT decode_error mip=2 32_32_40/0-32_0-32_0-16",
                     "CORRUPT missing mip=2 32_32_40/32-64_32-64_0-16"]
  assert code == 0
  # the mip-1 chunk lies in cell (0, 0), the mip-2 chunks in (0, 0) and (1, 1)
  assert lines[0] == "heal round 1: 3 findings -> 2 repair tasks"
  healed = {who: layer_tree(tmp_path / who) for who in SIDE}
  for who in SIDE:
    for name, data in before[who].items():
      if name != "integrity":
        assert healed[who][name] == data, name
  assert healed["port"] == healed["jax"]


def test_port_heals_a_reference_layer_to_its_healed_bytes(tmp_path):
  """The JAX package's campaign, damaged; the port's ``--heal`` writes
  what the JAX package's ``--heal`` writes on a copy."""
  import shutil

  _campaign("jax", tmp_path / "a")
  _damage_campaign(tmp_path / "a")
  shutil.copytree(tmp_path / "a", tmp_path / "b")
  assert _cli("port", ["audit", f"file://{tmp_path / 'a'}", "--heal"])[0] == 0
  assert _cli("jax", ["audit", f"file://{tmp_path / 'b'}", "--heal"])[0] == 0
  assert layer_tree(tmp_path / "a") == layer_tree(tmp_path / "b")


@pytest.mark.parametrize("auditor", ["jax", "port"])
def test_each_package_audits_the_others_layer_intact(tmp_path, auditor):
  writer = "port" if auditor == "jax" else "jax"
  path = _campaign(writer, tmp_path / "layer")
  report = tmp_path / "report.json"
  code, text = _cli(auditor, ["audit", path, "--mip", "0", "--mip", "1", "--mip", "2",
                              "--out", str(report)])
  assert code == 0, text
  rep = json.loads(report.read_text())
  assert rep["complete"] and rep["findings"] == [] and rep["unmanifested"] == 0
  assert rep["chunks_checked"] == 64 + 16 + 4


def test_findings_at_the_source_mip_are_unhealable(tmp_path):
  out = {}
  for who in SIDE:
    root = tmp_path / who
    path = _campaign(who, root)
    finding = {"kind": "decode_error", "key": "x", "mip": 0, "bbox": [0, 0, 0, 32, 32, 16]}
    assert SIDE[who]["audit"].downsample_repair_tasks(path, [finding]) == ([], [finding])
    victim = root / "8_8_40" / "0-32_0-32_0-16.gz"
    raw = victim.read_bytes()
    victim.write_bytes(raw[:5] + bytes([raw[5] ^ 0x40]) + raw[6:])
    code, text = _cli(who, ["audit", path, "--mip", "0", "--mip", "1", "--heal"])
    out[who] = (code, [line for line in text.splitlines() if line.split(" ")[0]
                       in ("UNHEALABLE", "CORRUPT", "audited")])
  assert out["port"] == out["jax"]
  assert out["port"][0] == 2
  assert out["port"][1][0].startswith("UNHEALABLE ") and "mip=0" in out["port"][1][0]


def test_audit_without_a_campaign_needs_mips(tmp_path, capsys):
  path, _vol, _ = _small_volume("port", tmp_path / "v")
  assert cli_main(["audit", path]) == 1
  assert "pass --mip" in capsys.readouterr().err
  assert cli_main(["audit", path, "--mip", "0"]) == 0


def test_execute_flushes_the_envelope(tmp_path):
  """The worker writes its buffered manifest records before it exits:
  an audit right after finds every chunk it stored."""
  path = f"file://{tmp_path / 'layer'}"
  data = np.random.default_rng(6).integers(0, 200, (256, 256, 16)).astype(np.uint8)
  Volume.from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(32, 32, 16))
  integrity.flush_all()
  q = f"fq://{tmp_path / 'q'}"
  assert cli_main(["image", "downsample", path, "--num-mips", "2", "--memory",
                   "500000", "--queue", q]) == 0
  assert cli_main(["execute", q, "-x", "-q"]) == 0
  assert sorted(os.listdir(tmp_path / "layer" / "integrity" / "manifests")) == [
    "16_16_40", "32_32_40", "8_8_40"]
  man = jax_integrity.load_manifest(path, prefix="32_32_40")
  assert len(man) == 4
