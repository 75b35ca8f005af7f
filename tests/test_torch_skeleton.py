"""The port's TEASAR skeletonization and skeleton codec against the JAX
package's.

The same labels, made with numpy from a seed, go through
``igneous_tpu.ops.skeletonize`` (its EDT on the native host path) and
``igneous_tpu_torch.ops.skeletonize`` (on the CPU: the plain EDT, the
labels' boxes in torch, the g++-built graph and Dijkstra libraries); the
skeletons must encode to the same ``to_precomputed`` bytes. The port's
host libraries (``csrc/fggraph.cpp``, ``csrc/dijkstra.cpp``) must give the
JAX package's graphs and fields exactly.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from igneous_tpu import skeleton_io as jax_io
from igneous_tpu.ops import edt as jax_edt
from igneous_tpu.ops import skeletonize as jax_sk
from igneous_tpu_torch import device, skeleton_io
from igneous_tpu_torch.lib import Bbox
from igneous_tpu_torch.ops import skeletonize as sk
from igneous_tpu_torch.ops.mesh import label_boxes


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  device.reset_device()
  yield
  device.reset_device()


def tubes(shape, n, seed=0, radius=(1.5, 4.5), dtype=np.uint64) -> np.ndarray:
  """(x, y, z) labels: ``n`` straight tubes between random points, painted
  in order; a third of the ids at or above 2^63 (uint64)."""
  rng = np.random.default_rng(seed)
  out = np.zeros(shape, dtype)
  grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
  grid = grid.astype(np.float64)
  for i in range(n):
    a, b = rng.random(3) * shape, rng.random(3) * shape
    d = b - a
    t = np.clip(((grid - a) @ d) / (d @ d), 0, 1)
    dist = np.linalg.norm(grid - (a + t[..., None] * d), axis=-1)
    if dtype == np.uint64 and i % 3 == 0:
      label = 2**63 + 17 * i
    else:
      label = 1000 + 7 * i
    out[dist <= rng.uniform(*radius)] = label
  return np.asfortranarray(out)


def _same(ref: dict, got: dict) -> None:
  assert list(got) == list(ref)
  for label in ref:
    assert got[label].to_precomputed() == ref[label].to_precomputed(), label


LABEL_CASES = {
  "uint64": lambda: tubes((40, 36, 24), 9),
  "uint32": lambda: tubes((40, 36, 24), 9, seed=1, dtype=np.uint32),
  "int32_negative": lambda: tubes((40, 36, 24), 9, seed=2, dtype=np.int32)
  * np.where(np.arange(24) % 2, 1, -1).astype(np.int32),
}


@pytest.mark.parametrize("parallel", [1, 4])
@pytest.mark.parametrize("fix_branching", [True, False])
@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_skeletonize_matches_reference(case, fix_branching, parallel):
  lab = LABEL_CASES[case]()
  kw = dict(anisotropy=(8, 8, 40), offset=(3, 5, 7), fix_branching=fix_branching,
            parallel=parallel, dust_threshold=30)
  ref = jax_sk.skeletonize(lab, params=jax_sk.TeasarParams(const=60), **kw)
  got = sk.skeletonize(lab, params=sk.TeasarParams(const=60), **kw)
  assert len(got) >= 5
  _same(ref, got)


def test_skeletonize_object_ids_and_extra_targets_match_reference():
  lab = tubes((40, 36, 24), 9, seed=3)
  ids = [int(v) for v in np.unique(lab) if v][::2]
  targets = {
    ids[0]: np.argwhere(lab == ids[0])[::17],
    ids[1]: np.argwhere(lab == ids[1])[:3],
  }
  kw = dict(anisotropy=(4, 4, 40), object_ids=ids, extra_targets_per_label=targets)
  _same(jax_sk.skeletonize(lab, **kw), sk.skeletonize(lab, **kw))


def _avocado() -> np.ndarray:
  """A hollow soma (label 5) around a nucleus (label 9), a neurite of
  label 5 leaving it, and an unrelated label 7."""
  grid = np.stack(np.meshgrid(*[np.arange(s) for s in (48, 40, 40)], indexing="ij"), -1)
  r = np.linalg.norm(grid - (20, 20, 20), axis=-1)
  lab = np.zeros((48, 40, 40), np.uint64)
  lab[r <= 14] = 5
  lab[r <= 6] = 9
  lab[30:47, 18:23, 18:23] = 5
  lab[2:10, 2:8, 30:38] = 7
  return np.asfortranarray(lab)


@pytest.mark.parametrize("object_ids", [None, [5], [9, 7]], ids=str)
def test_fix_avocados_matches_reference(object_ids):
  lab = _avocado()
  params = dict(soma_detection_threshold=8, soma_acceptance_threshold=10, const=10)
  kw = dict(anisotropy=(1, 1, 1), fix_avocados=True, object_ids=object_ids)
  ref = jax_sk.skeletonize(lab, params=jax_sk.TeasarParams(**params), **kw)
  got = sk.skeletonize(lab, params=sk.TeasarParams(**params), **kw)
  _same(ref, got)
  if object_ids is None:
    assert 9 not in got and 5 in got  # the nucleus went into the soma


@pytest.mark.parametrize("fix_branching", [True, False])
def test_skeletonize_mask_matches_reference(fix_branching):
  mask = np.zeros((60, 14, 12), bool)
  mask[2:58, 3:10, 3:9] = True
  mask[30:34, 3:14, 3:9] = True  # a side branch
  mask[50:52, 0:2, 0:2] = True  # a second piece
  targets = np.array([[30, 13, 5], [3, 5, 5], [50, 0, 0]])
  kw = dict(anisotropy=(2, 2, 3), offset=(1, 2, 3), extra_targets=targets,
            fix_branching=fix_branching)
  ref = jax_sk.skeletonize_mask(mask, params=jax_sk.TeasarParams(scale=2, const=3), **kw)
  got = sk.skeletonize_mask(mask, params=sk.TeasarParams(scale=2, const=3), **kw)
  assert len(got) > 20
  assert got.to_precomputed() == ref.to_precomputed()


def test_voxel_graph_matches_reference():
  """A voxel graph (refused here until the port ran it) cuts the
  foreground graph: a bar severed at x = 30 traces as two components, and
  a random graph over tubes gives the JAX package's skeletons."""
  from igneous_tpu.ops.ccl import voxel_connectivity_graph as jax_vcg

  mask = np.zeros((60, 8, 8), bool)
  mask[2:58, 2:6, 2:6] = True
  halves = np.where(np.arange(60) < 30, 1, 2)[:, None, None] * mask
  vg = jax_vcg(halves.astype(np.uint32), 26)
  kw = dict(anisotropy=(2, 2, 3), voxel_graph=vg)
  ref = jax_sk.skeletonize_mask(mask, params=jax_sk.TeasarParams(scale=2, const=3), **kw)
  got = sk.skeletonize_mask(mask, params=sk.TeasarParams(scale=2, const=3), **kw)
  assert got.to_precomputed() == ref.to_precomputed()
  sides = got.vertices[got.edges.astype(int), 0] > 59
  assert not (sides[:, 0] != sides[:, 1]).any()  # no edge crosses the cut
  lab = tubes((40, 32, 24), 8, seed=4)
  rng = np.random.default_rng(0)
  graph = jax_vcg(lab, 26) & rng.integers(0, 2**26, lab.shape).astype(np.uint32)
  params = dict(scale=4, const=20)
  ref = jax_sk.skeletonize(lab, params=jax_sk.TeasarParams(**params), voxel_graph=graph)
  got = sk.skeletonize(lab, params=sk.TeasarParams(**params), voxel_graph=graph)
  assert len(got) > 3
  _same(ref, got)


def test_cutout_labels_match_unique_renumber_find_objects():
  lab = LABEL_CASES["int32_negative"]()
  field, ids, counts, lo, hi = sk.cutout_labels(lab, (8, 8, 40))
  ref = jax_edt.edt(lab, (8, 8, 40), black_border=True)
  assert np.array_equal(field.view(np.uint32), ref.view(np.uint32))
  uniq, ucounts = np.unique(lab, return_counts=True)
  assert ids == [int(v) for v in uniq if v]
  assert counts.tolist() == ucounts[uniq != 0].tolist()
  dense = np.searchsorted(uniq[uniq != 0], lab) + 1
  dense[lab == 0] = 0
  for i, sl in enumerate(ndimage.find_objects(dense)):
    assert [s.start for s in sl] == lo[i].tolist()
    assert [s.stop for s in sl] == hi[i].tolist()


@pytest.mark.parametrize("dtype", [np.int16, np.int64])
def test_label_boxes_with_negative_labels(dtype):
  rng = np.random.default_rng(5)
  lab = rng.integers(-3, 4, (6, 7, 8)).astype(dtype)
  seg = torch.from_numpy(lab.astype(np.int64))
  labels, counts, dense, lo, hi = label_boxes(seg, False)
  uniq = np.unique(lab)
  nz = uniq[uniq != 0]
  exp = np.searchsorted(nz, lab) + 1
  exp[lab == 0] = 0
  assert labels.tolist() == uniq.tolist()
  assert np.array_equal(dense.numpy(), exp)
  for i, sl in enumerate(ndimage.find_objects(exp), start=1):
    assert [s.start for s in sl[::-1]] == lo[i].tolist()


def test_host_libraries_give_the_reference_graph_and_fields():
  rng = np.random.default_rng(11)
  mask = ndimage.gaussian_filter(rng.random((30, 26, 22)), 2) > 0.5
  pdrf = (rng.random(mask.shape) * 100).astype(np.float32)
  got, fg = sk._foreground_graph(mask, pdrf, (4, 4, 40))
  ref, rfg = jax_sk._foreground_graph_native(mask, pdrf, (4, 4, 40), None)
  assert np.array_equal(fg, rfg)
  for attr in ("indptr", "indices", "data"):
    assert np.array_equal(getattr(got, attr), getattr(ref, attr)), attr
  mine, theirs = sk._IncrementalDijkstra(got), jax_sk._IncrementalDijkstra(ref)
  for batch in ([0], [17, 99], list(rng.integers(0, got.shape[0], 10))):
    mine.update(batch)
    theirs.update(batch)
    assert np.array_equal(mine.dist, theirs.dist)
    assert np.array_equal(mine.pred, theirs.pred)
  with pytest.raises(ValueError, match="out of range"):
    mine.update([got.shape[0]])


def _fragments():
  """Two overlapping fragments of one label and a short twig."""
  rng = np.random.default_rng(3)
  verts = np.cumsum(rng.random((40, 3)) * 80, axis=0).astype(np.float32)
  edges = np.stack([np.arange(39), np.arange(1, 40)], 1)
  twig = np.array([verts[20] + (30, 0, 0), verts[20] + (60, 0, 0)], np.float32)
  radii = rng.random(40).astype(np.float32)
  parts = [
    (verts[:25], edges[:24], radii[:25]),
    (verts[22:], edges[:17], radii[22:]),
    (np.concatenate([verts[20:21], twig]), np.array([[0, 1], [1, 2]]), radii[:3]),
  ]
  return parts


@pytest.mark.parametrize("dust,tick", [(0, 0), (1000, 200), (10, 2000), (1e9, 0)])
def test_postprocess_and_skeleton_methods_match_reference(dust, tick):
  parts = _fragments()
  mine = skeleton_io.Skeleton.simple_merge(
    [skeleton_io.Skeleton(v, e, radii=r) for v, e, r in parts])
  theirs = jax_io.Skeleton.simple_merge([jax_io.Skeleton(v, e, radii=r) for v, e, r in parts])
  assert mine.to_precomputed() == theirs.to_precomputed()
  assert mine.consolidate().to_precomputed() == theirs.consolidate().to_precomputed()
  assert np.array_equal(mine.components_by_vertex(), theirs.components_by_vertex())
  assert mine.cable_length() == theirs.cable_length()
  box = Bbox((0, 0, 0), (900, 900, 900))
  assert mine.crop(box).to_precomputed() == theirs.crop(box).to_precomputed()
  got = skeleton_io.postprocess(mine, dust_threshold=dust, tick_threshold=tick)
  ref = jax_io.postprocess(theirs, dust_threshold=dust, tick_threshold=tick)
  assert got.to_precomputed() == ref.to_precomputed()
  back = skeleton_io.Skeleton.from_precomputed(ref.to_precomputed())
  assert back.to_precomputed() == ref.to_precomputed()
