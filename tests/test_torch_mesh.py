"""The port's marching cubes, marching tetrahedra, weld, simplification and
mesh codec against the JAX package, on the CPU.

Every comparison is exact: np.array_equal on values, and equal dtypes. The
JAX side runs as its own tests run it (a virtual 8-device CPU mesh, the
host emission by default, ``IGNEOUS_MESH_EMIT=device`` for its XLA
emission); the port runs its torch operations on CPU tensors. Masks are
16^3 to 40^3, so JAX compiles a few shape buckets only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from igneous_tpu import mesh_io as jax_mesh_io
from igneous_tpu.ops import mesh as jm
from igneous_tpu.ops import remap as jax_remap
from igneous_tpu_torch import device, mesh_io
from igneous_tpu_torch.ops import _build, remap
from igneous_tpu_torch.ops import mesh as pm


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.delenv("IGNEOUS_MESH_EMIT", raising=False)
  device.reset_device()
  yield
  device.reset_device()


@pytest.fixture
def needs_cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU with CUDA (run by chip_smoke.py on the card)")


def same(a, b) -> bool:
  a, b = np.asarray(a), np.asarray(b)
  return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def blob(rng, shape, p=0.4):
  return np.pad(ndimage.binary_closing(rng.random(shape) < p), 1).astype(np.uint8)


def checkerboard():
  m = np.zeros((8, 8, 8), np.uint8)
  m[(np.indices((8, 8, 8)).sum(0) % 2) == 0] = 1
  return np.pad(m, 1)


def sphere(n=30, r=11):
  g = np.indices((n, n, n)).astype(np.float32) - (n - 1) / 2
  return (np.sqrt((g**2).sum(0)) < r).astype(np.uint8)


MASKS = {
  "blob_18x16x14": lambda rng: blob(rng, (18, 16, 14)),
  "odd_shape_37x21x29": lambda rng: blob(rng, (35, 19, 27), 0.45),
  "exact_bucket_32": lambda rng: (rng.random((32, 32, 32)) < 0.3).astype(np.uint8),
  "empty": lambda rng: np.zeros((17, 9, 12), np.uint8),
  "full": lambda rng: np.ones((16, 16, 16), np.uint8),
  "checkerboard": lambda rng: checkerboard(),
  "sphere": lambda rng: sphere(),
}


def zyx(mask):
  return np.ascontiguousarray(mask.transpose(2, 1, 0))


# ---------------------------------------------------------------------------
# tables


@pytest.mark.parametrize(
  "name",
  ["CORNER_OFFSETS", "TETS", "NTRIS_TABLE", "EDGES_TABLE", "MC_NTRI", "MC_TRIS", "MC_EDGE_MID"],
)
def test_tables_equal_reference(name):
  assert same(getattr(pm, name), getattr(jm, name))


# ---------------------------------------------------------------------------
# the count passes


@pytest.mark.parametrize("name", sorted(MASKS))
def test_mc_count_pass_matches_reference(name):
  mask = MASKS[name](np.random.default_rng(3))
  bucket = jm._bucket_shape(mask.shape)
  padded = zyx(jm._pad_to_bucket(mask, bucket))
  case, ntri, total = jm._mc_count_kernel(jnp.asarray(padded))
  pc, pn, pt = pm._mc_count_kernel(torch.from_numpy(padded))
  assert pc.dtype == torch.uint8 and pn.dtype == torch.uint8
  assert same(pc.to(torch.int32).numpy(), np.asarray(case))
  assert same(pn.to(torch.int32).numpy(), np.asarray(ntri))
  assert int(pt) == int(total)
  # batched: each member as alone
  bc, bn, bt = pm._mc_count_kernel(torch.from_numpy(np.stack([padded, padded[::-1].copy()])))
  assert torch.equal(bc[0], pc) and torch.equal(bn[0], pn) and int(bt[0]) == int(total)
  single = pm._mc_count_kernel(torch.from_numpy(padded[::-1].copy()))
  assert torch.equal(bc[1], single[0]) and int(bt[1]) == int(single[2])


@pytest.mark.parametrize("name", sorted(MASKS))
def test_mt_count_pass_matches_reference(name):
  mask = MASKS[name](np.random.default_rng(4))
  padded = zyx(jm._pad_to_bucket(mask, jm._bucket_shape(mask.shape)))
  cases, per, total = jm._count_kernel(jnp.asarray(padded))
  pcases, pper, ptotal = pm._count_kernel(torch.from_numpy(padded))
  for a, b in zip(pcases + pper, cases + per):
    assert a.dtype == torch.uint8
    assert same(a.to(torch.int32).numpy(), np.asarray(b))
  assert int(ptotal) == int(total)


# ---------------------------------------------------------------------------
# emission


@pytest.mark.parametrize("name", sorted(MASKS))
def test_mc_emission_matches_host_and_device_kernel(name):
  mask = MASKS[name](np.random.default_rng(5))
  bucket = jm._bucket_shape(mask.shape)
  padded = zyx(jm._pad_to_bucket(mask, bucket))
  case, ntri, total = jm._mc_count_kernel(jnp.asarray(padded))
  total = int(total)
  pc, pn, _ = pm._mc_count_kernel(torch.from_numpy(padded))
  none = np.zeros((0, 3, 3), np.float32)

  def emit(real):
    got = pm._mc_emit_batch(pc[None].clone(), pn[None].clone(), [real])[0]
    return none if got is None else got

  # every cell of the bucket, as the JAX package's host and device kernels emit
  tris = emit(tuple(s - 1 for s in padded.shape[::-1]))
  host = jm._mc_emit_host(np.asarray(case), np.asarray(ntri), padded.shape)
  assert same(tris, host.astype(np.float32))
  if total:
    capacity = 1 << max(10, (total - 1).bit_length())
    ktris, _ = jm._mc_emit_kernel(case, ntri, capacity)
    assert same(tris, np.asarray(ktris)[:total])
  # with the pad ring dropped, as in a batch
  real = tuple(s - 1 for s in mask.shape)
  got = emit(real)
  assert same(got, jm._mc_emit_host(np.asarray(case), np.asarray(ntri), padded.shape, real))
  if total:
    assert same(got, jm._mc_emit_device(case, ntri, total, padded.shape, real))


# ---------------------------------------------------------------------------
# whole meshers


@pytest.mark.parametrize("emit", ["host", "device"])
@pytest.mark.parametrize("mesher", ["cubes", "tetrahedra"])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_mesher_matches_reference(name, mesher, emit, monkeypatch):
  monkeypatch.setenv("IGNEOUS_MESH_EMIT", emit)
  mask = MASKS[name](np.random.default_rng(6))
  kw = dict(anisotropy=(4.0, 4.0, 40.0), offset=(64.0, 3.0, -2.0))
  ref = (jm.marching_cubes if mesher == "cubes" else jm.marching_tetrahedra)(mask, **kw)
  got = (pm.marching_cubes if mesher == "cubes" else pm.marching_tetrahedra)(mask, **kw)
  assert same(got[0], ref[0]) and same(got[1], ref[1])
  if name == "empty":
    assert len(got[1]) == 0


@pytest.mark.parametrize("mesher", ["cubes", "tetrahedra"])
def test_batch_matches_reference(mesher, rng):
  """Masks of three buckets, more than one group in one of them."""
  masks = [blob(rng, (12, 10, 14)) for _ in range(5)]
  masks += [blob(rng, (20, 9, 6), 0.5) for _ in range(3)]
  masks += [np.zeros((5, 5, 5), np.uint8), blob(rng, (30, 17, 7))]
  offsets = [(float(i), 0.0, float(-i)) for i in range(len(masks))]
  fn = "marching_cubes_batch" if mesher == "cubes" else "marching_tetrahedra_batch"
  ref = getattr(jm, fn)(masks, anisotropy=(2, 3, 4), offsets=offsets)
  got = getattr(pm, fn)(masks, anisotropy=(2, 3, 4), offsets=offsets, batch_size=3)
  assert len(got) == len(ref)
  for (v, f), (rv, rf) in zip(got, ref):
    assert same(v, rv) and same(f, rf)


def test_all_256_neighbourhoods_match_reference():
  """Every 2x2x2 corner configuration inside a zero shell, meshed as one
  batch by the port (16 masks a count pass) and one by one by the JAX
  package."""
  masks = []
  for case in range(256):
    m = np.zeros((4, 4, 4), np.uint8)
    for i in range(8):
      if (case >> i) & 1:
        m[1 + (i & 1), 1 + ((i >> 1) & 1), 1 + ((i >> 2) & 1)] = 1
    masks.append(m)
  got = pm.marching_cubes_batch(masks)
  for case, (m, (v, f)) in enumerate(zip(masks, got)):
    rv, rf = jm.marching_cubes(m)
    assert same(v, rv) and same(f, rf), case
    assert (len(f) == 0) == (case == 0)


def test_label_masks_build_the_same_masks_on_the_device():
  """LabelMasks (masks built from a dense tensor) mesh as the numpy masks
  dense[box] == id do."""
  rng = np.random.default_rng(8)
  dense = rng.integers(0, 4, (20, 18, 16)).astype(np.int32)  # (x, y, z)
  dense = ndimage.median_filter(dense, 3)
  boxes = [(slice(0, 20), slice(0, 18), slice(0, 16)), (slice(3, 12), slice(5, 17), slice(1, 9)),
           (slice(0, 7), slice(2, 5), slice(4, 16))]
  ids = [1, 2, 3]
  dev = torch.from_numpy(np.ascontiguousarray(dense.transpose(2, 1, 0)))
  got = pm.marching_cubes_batch(pm.LabelMasks(dev, boxes, ids), anisotropy=(8, 8, 40))
  ref = jm.marching_cubes_batch([dense[b] == i for b, i in zip(boxes, ids)], anisotropy=(8, 8, 40))
  for (v, f), (rv, rf) in zip(got, ref):
    assert same(v, rv) and same(f, rf)


# ---------------------------------------------------------------------------
# the labels of a cutout


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_label_boxes_match_unique_renumber_find_objects(dtype):
  rng = np.random.default_rng(9)
  values = np.array([0, 5, 2**32 + 1, 2**63, 2**63 + 7, 2**64 - 1], dtype=np.uint64)
  if dtype == np.uint32:
    values = np.array([0, 5, 7, 2**31, 2**32 - 1, 11], dtype=np.uint64)
  img = values[rng.integers(0, len(values), (21, 17, 13))].astype(dtype)  # (x, y, z)
  img[3:9, 2:5, 1:12] = values[4]
  seg = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 1, 0)).view(np.int64)
                         if dtype == np.uint64 else img.transpose(2, 1, 0).astype(np.int64))
  labels, counts, dense, lo, hi = pm.label_boxes(seg, dtype == np.uint64)
  labels = labels.view(np.uint64) if dtype == np.uint64 else labels.astype(dtype)
  ulabels, ucounts = np.unique(img, return_counts=True)
  assert same(labels, ulabels) and np.array_equal(counts, ucounts)
  rdense, mapping = jax_remap.renumber(img)
  assert np.array_equal(dense.numpy().transpose(2, 1, 0), rdense)
  first = int(labels[0] == 0)
  for new_id, sl in enumerate(ndimage.find_objects(rdense.astype(np.int32)), start=1):
    assert [s.start for s in sl] == lo[new_id].tolist()
    assert [s.stop for s in sl] == hi[new_id].tolist()
    assert mapping[new_id] == int(labels[new_id - 1 + first])


@pytest.mark.parametrize("fn", ["renumber", "unique", "mask", "mask_except"])
def test_remap_helpers_match_reference(fn):
  rng = np.random.default_rng(10)
  arr = rng.choice(np.array([0, 3, 9, 2**40, 2**63 + 1], np.uint64), (9, 8, 7))
  if fn == "renumber":
    (a, am), (b, bm) = remap.renumber(arr), jax_remap.renumber(arr)
    assert same(a, b) and am == bm
  elif fn == "unique":
    for a, b in zip(remap.unique(arr, return_counts=True), jax_remap.unique(arr, return_counts=True)):
      assert same(a, b)
  else:
    for labels in ([3, 2**63 + 1], [], [5]):
      assert same(getattr(remap, fn)(arr, labels), getattr(jax_remap, fn)(arr, labels))


# ---------------------------------------------------------------------------
# weld, simplification, codec


def test_weld_and_cancel_match_reference():
  rng = np.random.default_rng(11)
  mask = blob(rng, (16, 14, 12))
  padded = zyx(mask)
  case, ntri, _ = jm._mc_count_kernel(jnp.asarray(padded))
  tris = jm._mc_emit_host(np.asarray(case), np.asarray(ntri), padded.shape)
  for aniso, off in (((1, 1, 1), (0, 0, 0)), ((8, 8, 40), (3.0, 5.0, 7.0))):
    v, f = pm._weld(tris, aniso, off)
    rv, rf = jm._weld(tris, aniso, off)
    assert same(v, rv) and same(f, rf)
  faces = np.array([[5, 6, 7], [0, 1, 2], [2, 1, 0], [1, 2, 0], [3, 4, 5], [5, 4, 3]], np.uint32)
  assert same(pm._cancel_coincident_pairs(faces), jm._cancel_coincident_pairs(faces))
  faces = rng.integers(0, 12, (300, 3)).astype(np.uint32)
  assert same(pm._cancel_coincident_pairs(faces), jm._cancel_coincident_pairs(faces))


@pytest.mark.parametrize("placement", ["qem", "centroid"])
@pytest.mark.parametrize("factor,max_error", [(100, 40), (10, 4), (1e6, None)])
def test_simplify_matches_reference(placement, factor, max_error):
  v, f = jm.marching_cubes(sphere(), anisotropy=(8, 8, 40))
  got = mesh_io.simplify(mesh_io.Mesh(v, f), factor, max_error, placement=placement)
  ref = jax_mesh_io.simplify(jax_mesh_io.Mesh(v, f), factor, max_error, placement=placement)
  assert same(got.vertices, ref.vertices) and same(got.faces, ref.faces)


def test_precomputed_bytes_match_reference():
  rng = np.random.default_rng(12)
  v, f = rng.random((40, 3)).astype(np.float32) * 100, rng.integers(0, 40, (70, 3))
  data = mesh_io.Mesh(v, f).to_precomputed()
  assert data == jax_mesh_io.Mesh(v, f).to_precomputed()
  assert data == mesh_io.encode_mesh(mesh_io.Mesh(v, f))
  back = mesh_io.decode_mesh(data)
  assert same(back.vertices, v) and same(back.faces, f.astype(np.uint32))
  got = mesh_io.Mesh.concatenate(back, back).consolidate()
  ref = jax_mesh_io.Mesh.concatenate(jax_mesh_io.Mesh(v, f), jax_mesh_io.Mesh(v, f)).consolidate()
  assert same(got.vertices, ref.vertices) and same(got.faces, ref.faces)
  with pytest.raises(NotImplementedError, match="draco"):
    mesh_io.encode_mesh(back, "draco")


def test_simplifier_build_failure_raises(monkeypatch, tmp_path):
  """A g++ build that fails raises; simplify does not fall back to vertex
  clustering."""
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
  monkeypatch.setattr(_build, "GXX_FLAGS", [*_build.GXX_FLAGS, "-no-such-flag"])
  v, f = jm.marching_cubes(sphere())
  with pytest.raises(RuntimeError, match="failed"):
    mesh_io.simplify(mesh_io.Mesh(v, f))
  assert list(tmp_path.iterdir()) == []
  # clustering still runs when asked for
  assert len(mesh_io.simplify(mesh_io.Mesh(v, f), placement="centroid").faces) > 0


def test_simplifier_library_is_named_by_source_and_flags():
  path = _build.library_path("simplify")
  assert path.parent == _build.BUILD_DIR and path.name.startswith("libsimplify-")
  assert _build.GXX_FLAGS == ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
  assert (_build.CSRC_DIR / "simplify.cpp").read_bytes() == (
    _build.PKG_DIR.parent / "igneous_tpu" / "native" / "csrc" / "simplify.cpp"
  ).read_bytes()


def test_meshing_without_cuda_raises_unless_the_cpu_is_asked_for(monkeypatch):
  monkeypatch.delenv(device.ENV)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  device.reset_device()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    pm.marching_cubes(sphere())
  with pytest.raises(RuntimeError, match="no CUDA device"):
    pm.marching_tetrahedra_batch([sphere()])


@pytest.mark.cuda
def test_card_meshes_as_the_cpu(needs_cuda, monkeypatch):
  rng = np.random.default_rng(13)
  masks = [blob(rng, (30, 20, 25)) for _ in range(4)] + [sphere()]
  cpu = pm.marching_cubes_batch(masks, anisotropy=(8, 8, 40))
  monkeypatch.setenv(device.ENV, "cuda")
  device.reset_device()
  card = pm.marching_cubes_batch(masks, anisotropy=(8, 8, 40))
  for (v, f), (cv, cf) in zip(card, cpu):
    assert same(v, cv) and same(f, cf)
