"""The port's shard codec and hash math (``igneous_tpu_torch/sharding.py``)
against the JAX package's ``igneous_tpu/sharding.py``.

Seeded numpy inputs at small sizes; every comparison is exact: the
murmurhash of uint64 ids (ids at or above 2^63 included), compressed
morton codes on cubic, anisotropic and non-power-of-two grids, the three
shard-parameter solvers over a sweep, every shard file of
``synthesize_shard_files`` byte for byte (identity and murmurhash hashes,
raw and gzip data, both minishard index encodings, preambles), and each
package's ``ShardReader`` reading the other's shards.
"""

import itertools

import numpy as np
import pytest

from igneous_tpu import sharding as jax_sharding
from igneous_tpu.storage import CloudFiles as JaxCloudFiles
from igneous_tpu_torch import sharding
from igneous_tpu_torch.storage import CloudFiles

U64 = np.uint64


def _ids(n, seed):
  """Random uint64 ids, a quarter of them at or above 2^63, and the edges."""
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, 2**63, n, dtype=np.uint64)
  ids[: n // 4] |= U64(2**63)
  return np.concatenate([ids, np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1], U64)])


@pytest.mark.parametrize("n,seed", [(1, 0), (1000, 1), (20000, 2)])
def test_murmurhash_matches_reference(n, seed):
  ids = _ids(n, seed)
  got = sharding.murmurhash3_x86_128_low64(ids)
  assert got.dtype == U64
  np.testing.assert_array_equal(got, jax_sharding.murmurhash3_x86_128_low64(ids))
  for h in ("identity", "murmurhash3_x86_128"):
    np.testing.assert_array_equal(
      sharding._apply_hash(ids, h), jax_sharding._apply_hash(ids, h))
  with pytest.raises(ValueError, match="Unknown shard hash"):
    sharding._apply_hash(ids, "sha1")


@pytest.mark.parametrize("grid", [(8, 8, 8), (16, 4, 1), (5, 3, 7), (1, 1, 1), (33, 1, 2),
                                  (2, 64, 3)],
                         ids=["cubic", "anisotropic", "odd", "one", "odd_flat", "tall"])
def test_compressed_morton_code_matches_reference(grid):
  pts = np.array(list(itertools.product(*(range(g) for g in grid))), dtype=np.int64)
  got = sharding.compressed_morton_code(pts, grid)
  want = jax_sharding.compressed_morton_code(pts, grid)
  np.testing.assert_array_equal(np.atleast_1d(got), np.atleast_1d(want))
  # one point at a time: a Python int, as the reference returns
  for p in pts[:: max(1, len(pts) // 7)]:
    one = sharding.compressed_morton_code(p, grid)
    assert type(one) is int and one == jax_sharding.compressed_morton_code(p, grid)
  # distinct codes for distinct points
  assert len(np.unique(np.atleast_1d(got))) == len(pts)


@pytest.mark.parametrize("num_labels", [0, 1, 1666, 1667, 10**5, 3 * 10**6, 10**9])
@pytest.mark.parametrize("kw", [{}, dict(shard_index_bytes=2**13, minishard_index_bytes=2**15),
                                dict(min_shards=7), dict(shard_index_bytes=16)])
def test_compute_shard_params_for_hashed_matches_reference(num_labels, kw):
  assert sharding.compute_shard_params_for_hashed(num_labels, **kw) == \
    jax_sharding.compute_shard_params_for_hashed(num_labels, **kw)


SIZES = [(601, 421, 40), (4096, 4096, 64), (2048, 2048, 64), (100, 7000, 300), (64, 64, 64),
         (1, 1, 1)]
CHUNKS = [(64, 64, 16), (128, 128, 64), (256, 256, 1)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_create_sharded_image_info_matches_reference(size, chunk):
  for dtype, encoding, target, kw in [
    ("uint8", "raw", int(3.5e9), {}),
    ("uint8", "jpeg", int(2e6), {}),
    ("uint64", "compressed_segmentation", int(64 * 2**20), {}),
    ("uint64", "compresso", int(1e6), dict(min_shards=5)),
    ("float32", "raw", int(7e8), dict(data_encoding="raw", minishard_index_encoding="raw")),
    ("uint16", "png", int(3e7), dict(max_shard_index_bytes=512, minishard_index_bytes=4000)),
  ]:
    args = (size, chunk, encoding, dtype)
    got = sharding.create_sharded_image_info(*args, uncompressed_shard_bytesize=target, **kw)
    assert got == jax_sharding.create_sharded_image_info(
      *args, uncompressed_shard_bytesize=target, **kw)
    np.testing.assert_array_equal(
      sharding.image_shard_shape_from_spec(got, size, chunk),
      jax_sharding.image_shard_shape_from_spec(got, size, chunk))
    spec = sharding.ShardingSpecification.from_dict(got)
    assert spec.to_dict() == got
    np.testing.assert_array_equal(
      sharding.image_shard_shape_from_spec(spec, size, chunk),
      jax_sharding.image_shard_shape_from_spec(got, size, chunk))


def _specs(spec_kw):
  return (sharding.ShardingSpecification(**spec_kw),
          jax_sharding.ShardingSpecification(**spec_kw))


def _chunks(n, seed, ids=None):
  rng = np.random.default_rng(seed)
  if ids is None:
    ids = np.unique(_ids(n, seed))
  return {int(i): rng.bytes(int(rng.integers(0, 300))) * int(rng.integers(1, 3))
          for i in ids}


SPEC_CASES = {
  f"{h}_{d}_{m}_{bits}": dict(hash=h, data_encoding=d, minishard_index_encoding=m,
                              preshift_bits=bits[0], minishard_bits=bits[1],
                              shard_bits=bits[2])
  for h in ("identity", "murmurhash3_x86_128")
  for d in ("raw", "gzip")
  for m in ("raw", "gzip")
  for bits in ((0, 0, 0), (2, 3, 4), (0, 6, 9))
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_synthesize_shard_files_matches_reference(case):
  spec, ref = _specs(SPEC_CASES[case])
  chunks = _chunks(400, seed=len(case))
  got = spec.synthesize_shard_files(chunks)
  want = ref.synthesize_shard_files(chunks)
  assert sorted(got) == sorted(want) and len(got) >= 1
  assert all(got[k] == want[k] for k in want)
  for name in got:  # ceil(shard_bits / 4) hex digits, at least one
    assert len(name) == len(".shard") + max(1, -(-spec.shard_bits // 4))
  assert spec.synthesize_shard_files({}) == {}
  ids = np.array(sorted(chunks), dtype=U64)
  np.testing.assert_array_equal(spec.shard_number(ids), ref.shard_number(ids))
  np.testing.assert_array_equal(spec.minishard_number(ids), ref.minishard_number(ids))
  assert spec.assign_labels_to_shards(ids) == ref.assign_labels_to_shards(ids)
  # the assembled shard of pre-encoded chunks, in any order of arrival
  members = [i for i in chunks if int(spec.shard_number(i)) == int(spec.shard_number(ids[0]))]
  encoded = {i: spec.encode_chunk(chunks[i]) for i in reversed(members)}
  assert spec.assemble_shard(encoded) == ref.synthesize_shard({i: chunks[i] for i in members})


def test_synthesize_shard_with_preambles_matches_reference():
  spec, ref = _specs(dict(hash="murmurhash3_x86_128", data_encoding="raw",
                          minishard_bits=2, shard_bits=0))
  chunks = _chunks(50, seed=3)
  pre = {i: b"pre" * (i % 5) for i in list(chunks)[::2]}
  assert spec.synthesize_shard(chunks, preambles=pre) == ref.synthesize_shard(chunks, preambles=pre)
  gz, _ = _specs(dict(data_encoding="gzip"))
  with pytest.raises(ValueError, match="preambles"):
    gz.synthesize_shard(chunks, preambles=pre)


def test_spec_refuses_unknown_type():
  with pytest.raises(ValueError, match="Unknown sharding type"):
    sharding.ShardingSpecification(type="neuroglancer_legacy")


@pytest.mark.parametrize("case", ["murmurhash3_x86_128_gzip_gzip_(0, 6, 9)",
                                  "identity_raw_raw_(2, 3, 4)",
                                  "identity_gzip_raw_(0, 0, 0)"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_shard_reader_reads_the_others_shards(tmp_path, case, writer):
  spec, ref = _specs(SPEC_CASES[case])
  chunks = _chunks(300, seed=11)
  files = (spec if writer == "port" else ref).synthesize_shard_files(chunks)
  path = f"file://{tmp_path}/layer"
  cf = CloudFiles(path)
  for name, data in files.items():
    cf.put(f"key/{name}", data)
  readers = [sharding.ShardReader(CloudFiles(path), spec, prefix="key"),
             jax_sharding.ShardReader(JaxCloudFiles(path), ref, prefix="key")]
  for cid, data in chunks.items():
    assert [r.get_chunk(cid) for r in readers] == [data, data]
  absent = max(chunks) - 1
  while absent in chunks:
    absent -= 1
  assert [r.get_chunk(absent) for r in readers] == [None, None]
  for s in {int(spec.shard_number(c)) for c in chunks}:
    got, want = (np.sort(r.list_labels(s)) for r in readers)
    np.testing.assert_array_equal(got, want)
  # a shard file that is not there
  empty = (1 << spec.shard_bits) - 1
  if spec.shard_bits and empty not in {int(spec.shard_number(c)) for c in chunks}:
    assert len(readers[0].list_labels(empty)) == 0
