"""The port's chunk codecs against the JAX package's.

compressed_segmentation, compresso, jpeg, png and raw: the same seeded
chunks through ``igneous_tpu`` and ``igneous_tpu_torch`` give the same
bytes and the same arrays, with no tolerance; within the port the native
(``csrc/cseg.cpp``), bulk-numpy and per-block loop routes of cseg give the
same bytes; corrupt streams raise as the reference's do; the golden
chunks of ``tests/golden/`` (all but the gzip one) decode and re-encode
to their own bytes; a failed g++ build of ``cseg.cpp`` raises.
"""

import pathlib

import numpy as np
import pytest

from igneous_tpu import codecs as jax_codecs
from igneous_tpu import compresso as jax_compresso
from igneous_tpu import cseg as jax_cseg
from igneous_tpu.storage import compress_bytes as jax_compress_bytes
from igneous_tpu_torch import codecs, compresso, cseg
from igneous_tpu_torch.meta import advertised_encoding
from igneous_tpu_torch.ops import _build
from igneous_tpu_torch.storage import compress_bytes

GOLDEN = pathlib.Path(__file__).parent / "golden"
DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64]
SHAPES = [(1, 1, 1), (13, 7, 5), (64, 64, 64), (128, 128, 64)]
BLOCKS = [(8, 8, 8), (4, 4, 4), (8, 8, 4)]
CONTENTS = ["uniform", "sparse", "dense"]


def chunk(dtype, shape, channels, content, seed=0):
  """A seeded (x, y, z, c) chunk, Fortran-ordered like a download.
  uniform: one id; sparse: 1 voxel in 2000 carries one of 4 ids on a
  zero background (mostly constant blocks, the numpy route); dense: ids drawn
  from 3000 (or the dtype's range), the native route. uint64 ids sit at
  or above 2^63."""
  rng = np.random.default_rng(seed)
  dtype = np.dtype(dtype)
  full = tuple(shape) + (channels,)
  top = min(3000, np.iinfo(dtype).max)
  if content == "uniform":
    arr = np.full(full, top // 2, dtype=np.uint64)
  elif content == "sparse":
    arr = (rng.random(full) < 0.0005) * rng.integers(1, 5, full)
  else:
    arr = rng.integers(0, top, full)
  arr = arr.astype(np.uint64)
  if dtype == np.uint64:
    arr = arr + np.uint64(2**63)
  return np.asfortranarray(arr.astype(dtype))


# ---------------------------------------------------------------------------
# compressed_segmentation


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: "x".join(map(str, b)))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_cseg_matches_reference(dtype, shape, block, content):
  # three channels at every shape but the largest, which one chunk of a
  # real layer has (the time goes to gzip on its dense 16-bit streams)
  for channels in (1, 3) if shape != SHAPES[-1] else (1,):
    arr = chunk(dtype, shape, channels, content)
    want = jax_cseg.compress(arr, block_size=block)
    got = cseg.compress(arr, block_size=block)
    assert got == want
    out = cseg.decompress(got, arr.shape, dtype, block_size=block)
    assert out.dtype == arr.dtype and np.array_equal(out, arr)
    assert np.array_equal(
      out, jax_cseg.decompress(want, arr.shape, dtype, block_size=block)
    )
    if channels == 1:
      # the wire bytes too: gzip against the reference's at run time
      assert compress_bytes(got, "gzip") == jax_compress_bytes(want, "gzip")


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: "x".join(map(str, b)))
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=lambda d: np.dtype(d).name)
def test_cseg_routes_give_identical_bytes(dtype, block, content):
  """Native, bulk-numpy and the per-block loop spec: one stream, and each
  decoder reads it back."""
  for shape in ((13, 7, 5), (64, 64, 64)):
    chan = chunk(dtype, shape, 1, content)[..., 0]
    loop = cseg._encode_channel_loop(chan, block)
    assert np.array_equal(cseg._encode_channel(chan, block), loop)
    assert np.array_equal(cseg._native_encode_channel(chan, block), loop)
    # C-ordered and strided views encode to the same stream natively
    assert np.array_equal(cseg._native_encode_channel(np.ascontiguousarray(chan), block), loop)
    data = np.concatenate([np.uint32([1]), loop]).tobytes()
    full = shape + (1,)
    ref = cseg._decompress_loop(data, full, dtype, block)
    assert np.array_equal(ref[..., 0], chan)
    words = np.frombuffer(data, np.uint32)
    out = np.empty(shape, dtype=dtype, order="F")
    cseg._decode_channel_np(words, 1, shape, block, 2 if dtype == np.uint64 else 1,
                            dtype, out=out)
    assert np.array_equal(out, chan)
    assert np.array_equal(cseg._native_decode_channel(words[1:], shape, dtype, block), chan)


def test_cseg_routing_takes_both_routes(monkeypatch):
  """Mostly constant chunks encode and decode in numpy, dense ones in the
  native library; a channel of only constant blocks never reaches it."""
  calls = []
  for name in ("_native_encode_channel", "_encode_channel",
               "_native_decode_channel", "_decode_channel_np"):
    real = getattr(cseg, name)
    monkeypatch.setattr(cseg, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
  sparse = chunk(np.uint64, (64, 64, 64), 1, "sparse")
  dense = chunk(np.uint64, (64, 64, 64), 1, "dense")
  uniform = chunk(np.uint64, (64, 64, 64), 1, "uniform")
  cseg.decompress(cseg.compress(sparse), sparse.shape, np.uint64)
  assert calls == ["_encode_channel", "_native_decode_channel"]
  calls.clear()
  cseg.decompress(cseg.compress(dense), dense.shape, np.uint64)
  assert calls == ["_native_encode_channel", "_native_decode_channel"]
  calls.clear()
  cseg.decompress(cseg.compress(uniform), uniform.shape, np.uint64)
  assert calls == ["_encode_channel", "_decode_channel_np"]


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64], ids=lambda d: np.dtype(d).name)
def test_cseg_decompress_region_matches_reference(dtype):
  arr = chunk(dtype, (29, 27, 13), 2, "dense", seed=3)
  for block in BLOCKS:
    data = cseg.compress(arr, block_size=block)
    for lo, hi in (((0, 0, 0), (29, 27, 13)), ((3, 5, 1), (17, 9, 12)),
                   ((8, 8, 8), (9, 9, 9)), ((-4, 20, 2), (40, 27, 5))):
      for channel in (0, 1):
        got = cseg.decompress_region(data, arr.shape, dtype, lo, hi, block, channel)
        want = jax_cseg.decompress_region(data, arr.shape, dtype, lo, hi, block, channel)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        clo = [max(0, v) for v in lo]
        chi = [min(s, v) for s, v in zip(arr.shape, hi)]
        assert np.array_equal(got, arr[clo[0]:chi[0], clo[1]:chi[1], clo[2]:chi[2], channel])


def _raised(fn):
  try:
    fn()
  except Exception as e:  # noqa: BLE001 - the type and message are compared
    return type(e), str(e)
  return None


def _outcome(fn):
  """("ok", the decoded bytes) or (the exception's type, its message)."""
  try:
    return "ok", fn().tobytes()
  except Exception as e:  # noqa: BLE001 - the type and message are compared
    return type(e), str(e)


@pytest.mark.parametrize("content", ["sparse", "dense"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32, np.uint64], ids=lambda d: np.dtype(d).name)
def test_cseg_corrupt_streams_raise_as_the_reference(dtype, content):
  """Truncated streams, a bad bit width and an offset past the end: each
  decoder raises what the reference's raises (or, where a cut leaves every
  referenced word in place, decodes what it decodes)."""
  arr = chunk(dtype, (16, 16, 16), 1, content, seed=5)
  good = cseg.compress(arr)
  words = np.frombuffer(good, np.uint32)
  bad_bits = words.copy()
  bad_bits[1] = (np.uint32(3) << np.uint32(24)) | (bad_bits[1] & np.uint32(0xFFFFFF))
  past_end = words.copy()
  past_end[2] = np.uint32(len(words) + 7)
  streams = [good[: len(good) // 2], good[:9], good[:8], good[:4], good[:len(good) - 2],
             good[: len(good) // 3 // 4 * 4], bad_bits.tobytes(), past_end.tobytes()]
  raised = 0
  for data in streams:
    for fn in (cseg.decompress, cseg._decompress_loop):
      got = _outcome(lambda: fn(data, arr.shape, dtype))
      want = _outcome(lambda: getattr(jax_cseg, fn.__name__)(data, arr.shape, dtype))
      assert got == want, (len(data), fn.__name__)
      raised += want[0] is ValueError
  assert raised >= 10


@pytest.mark.parametrize("name,dtype,shape,block", [
  ("cseg_u64.bin", np.uint64, (32, 32, 16), (8, 8, 8)),
  ("cseg_u32.bin", np.uint32, (32, 32, 16), (8, 8, 8)),
  ("cseg_u64_odd.bin", np.uint64, (29, 27, 13), (8, 8, 8)),
  ("cseg_u64_block44.bin", np.uint64, (29, 27, 13), (4, 4, 4)),
  ("compresso_u64.bin", np.uint64, (32, 32, 16), None),
  ("raw_u8.bin", np.uint8, (32, 32, 8), None),
])
def test_goldens_decode_and_reencode_to_their_bytes(name, dtype, shape, block):
  data = (GOLDEN / name).read_bytes()
  enc = ("compressed_segmentation" if name.startswith("cseg")
         else name.split("_")[0])
  kw = {"block_size": block} if block else {}
  out = codecs.decode(data, enc, shape, dtype, **kw)
  assert out.shape == shape + (1,) and out.dtype == dtype
  assert np.array_equal(out, jax_codecs.decode(data, enc, shape, dtype, **kw))
  assert codecs.encode(out, enc, **kw) == data


# ---------------------------------------------------------------------------
# compresso


@pytest.mark.parametrize("content", CONTENTS + ["regions"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_compresso_matches_reference(dtype, shape, content):
  if content == "regions":
    # piecewise-constant labels with holes: the boundary, CC and
    # indeterminate-voxel streams all carry data
    base = chunk(dtype, tuple(-(-s // 4) for s in shape), 1, "dense", seed=2)
    arr = np.kron(base[..., 0], np.ones((4, 4, 1), base.dtype))[: shape[0], : shape[1]]
    arr = np.repeat(arr, 4, axis=2)[..., : shape[2]]
    arr[chunk(np.uint8, shape, 1, "sparse")[..., 0] > 0] = 0
    arr = np.asfortranarray(arr[..., None])
  else:
    arr = chunk(dtype, shape, 1, content)
  want = jax_compresso.compress(arr)
  got = compresso.compress(arr)
  assert got == want
  out = compresso.decompress(got, arr.shape, dtype)
  assert out.dtype == arr.dtype and np.array_equal(out, arr)
  assert compress_bytes(got, "gzip") == jax_compress_bytes(want, "gzip")


def test_compresso_refusals_match_reference():
  three = chunk(np.uint32, (8, 8, 4), 3, "dense")
  one = chunk(np.uint32, (8, 8, 4), 1, "dense")
  data = compresso.compress(one)
  cases = [
    (lambda m: m.compress(three)),
    (lambda m: m.compress(one, steps=(4, 4, 1))),
    (lambda m: m.decompress(b"nope" + data[4:])),
    (lambda m: m.decompress(data, (8, 8, 5, 1), np.uint32)),
    (lambda m: m.decompress(data, (8, 8, 4, 1), np.uint64)),
  ]
  for case in cases:
    want = _raised(lambda: case(jax_compresso))
    assert want is not None and want[0] is ValueError
    assert _raised(lambda: case(compresso)) == want


# ---------------------------------------------------------------------------
# jpeg and png


IMAGE_CASES = [
  ("jpeg", np.uint8, 1, {}), ("jpeg", np.uint8, 3, {}),
  ("jpeg", np.uint8, 1, {"jpeg_quality": 40}),
  ("png", np.uint8, 1, {}), ("png", np.uint8, 3, {}), ("png", np.uint8, 4, {}),
  ("png", np.uint16, 1, {}), ("png", np.uint8, 1, {"png_level": 9}),
]


@pytest.mark.parametrize("shape", [(13, 7, 5), (64, 64, 16)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("encoding,dtype,channels,kw", IMAGE_CASES,
                         ids=[f"{e}-{np.dtype(d).name}-c{c}-{'-'.join(map(str, k.values())) or 'default'}"
                              for e, d, c, k in IMAGE_CASES])
def test_image_codecs_match_reference(encoding, dtype, channels, kw, shape):
  rng = np.random.default_rng(11)
  # smooth content, as EM imagery, plus noise
  ramp = np.add.outer(np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1])),
                      3 * np.arange(shape[2]))
  top = np.iinfo(dtype).max
  arr = ramp[..., None] * 7 + rng.integers(0, top // 16, shape + (channels,))
  arr = np.asfortranarray((arr % top).astype(dtype))
  want = jax_codecs.encode(arr, encoding, **kw)
  got = codecs.encode(arr, encoding, **kw)
  assert got == want
  out = codecs.decode(got, encoding, arr.shape, dtype)
  assert out.dtype == arr.dtype and out.shape == arr.shape
  assert np.array_equal(out, jax_codecs.decode(want, encoding, arr.shape, dtype))
  if encoding == "png":
    assert np.array_equal(out, arr)


@pytest.mark.parametrize("encoding,dtype,channels", [
  ("jpeg", np.uint16, 1), ("jpeg", np.uint8, 2), ("jpeg", np.uint8, 4),
  ("png", np.uint8, 2), ("png", np.uint16, 3), ("png", np.uint32, 1),
  ("png", np.float32, 1),
])
def test_image_codecs_refuse_as_the_reference(encoding, dtype, channels):
  arr = np.zeros((8, 8, 2, channels), dtype=dtype)
  want = _raised(lambda: jax_codecs.encode(arr, encoding))
  assert want is not None and want[0] is ValueError
  assert _raised(lambda: codecs.encode(arr, encoding)) == want


# ---------------------------------------------------------------------------
# dispatch


@pytest.mark.parametrize("encoding", ["raw", "compressed_segmentation", "compresso",
                                      "compresso-cpsx"])
def test_dispatch_matches_reference(encoding):
  arr = chunk(np.uint32, (20, 18, 6), 1, "dense", seed=9)
  got = codecs.encode(arr[..., 0], encoding)  # (x, y, z) takes one channel
  assert got == jax_codecs.encode(arr, encoding)
  for writable in (True, False):
    out = codecs.decode(got, encoding, arr.shape[:3], np.uint32, writable=writable)
    assert out.shape == arr.shape and np.array_equal(out, arr)
  raw = codecs.decode(codecs.encode(arr, "raw"), "raw", arr.shape, np.uint32)
  assert raw.flags.writeable
  assert not codecs.decode(codecs.encode(arr, "raw"), "raw", arr.shape, np.uint32,
                           writable=False).flags.writeable
  assert advertised_encoding(encoding) == (
    "compresso-cpsx" if encoding.startswith("compresso") else encoding
  )


def test_unknown_encodings_raise_as_the_reference():
  arr = np.zeros((4, 4, 4, 1), np.uint8)
  for encoding in ("jxl", "fpzip", "zfpc", "crackle", "bogus"):
    want = _raised(lambda: jax_codecs.encode(arr, encoding))
    assert want[0] is NotImplementedError
    assert _raised(lambda: codecs.encode(arr, encoding)) == want
    want = _raised(lambda: jax_codecs.decode(b"", encoding, (4, 4, 4), np.uint8))
    assert _raised(lambda: codecs.decode(b"", encoding, (4, 4, 4), np.uint8)) == want


# ---------------------------------------------------------------------------
# the native library


def test_cseg_library_builds_at_first_use_from_a_copy_of_the_reference(tmp_path, monkeypatch):
  src, flags, _ = _build._source("cseg")
  assert src == _build.CSRC_DIR / "cseg.cpp" and flags == _build.GXX_FLAGS
  ref = pathlib.Path(jax_cseg.__file__).parent / "native" / "csrc" / "cseg.cpp"
  assert src.read_bytes() == ref.read_bytes()
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
  arr = chunk(np.uint64, (16, 16, 16), 1, "dense")
  assert cseg.compress(arr) == jax_cseg.compress(arr)
  assert [p.name for p in tmp_path.iterdir()] == [_build.library_path("cseg").name]


def test_failed_cseg_build_raises(tmp_path, monkeypatch):
  """A library that does not build raises out of encode and decode; no
  route falls back to numpy for it."""
  broken = tmp_path / "csrc"
  broken.mkdir()
  (broken / "cseg.cpp").write_text("this is not C++\n")
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "CSRC_DIR", broken)
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
  dense = chunk(np.uint64, (16, 16, 16), 1, "dense")
  with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
    cseg.compress(dense)
  data = jax_cseg.compress(dense)
  with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
    cseg.decompress(data, dense.shape, np.uint64)
  with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
    codecs.decode(data, "compressed_segmentation", dense.shape[:3], np.uint64)
  assert not (tmp_path / "build").exists() or not any(
    p.suffix == ".so" for p in (tmp_path / "build").iterdir()
  )
