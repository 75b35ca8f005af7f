"""Chunk encodings for Precomputed volumes.

The port's own copy of ``igneous_tpu/codecs.py``: ``raw``,
``compressed_segmentation`` (``cseg.py``), ``jpeg``, ``png`` and
``compresso`` (``compresso.py``, advertised as ``compresso-cpsx``), byte
for byte as the JAX package writes them.

Layout conventions: in-memory chunks are numpy arrays with shape
(x, y, z, c). ``raw`` stores them Fortran-ordered, i.e. x varies fastest
in the byte stream and channel slowest — exactly the Precomputed "raw"
spec. ``jpeg``/``png`` store one 2D image of width x and height y*z (the
z slices stacked vertically), grayscale for 1 channel and RGB(A) for 3(4)
— the Precomputed image-codec layout Neuroglancer decodes. PIL is imported
only inside the jpeg and png functions.
"""

from __future__ import annotations

import io

import numpy as np

from .cseg import compress as cseg_compress, decompress as cseg_decompress

JPEG_DEFAULT_QUALITY = 85


def encode_raw(img: np.ndarray) -> bytes:
  # consolidating a strided view to F-order first keeps the encode at copy
  # speed; the bytes are identical either way
  if not img.flags.f_contiguous:
    img = np.asfortranarray(img)
  return img.tobytes("F")


def decode_raw(data: bytes, shape, dtype, writable: bool = True) -> np.ndarray:
  """``writable=False`` skips the defensive buffer copy and returns a
  read-only view of ``data``, for callers that copy the voxels anyway."""
  if writable:
    arr = np.frombuffer(bytearray(data), dtype=dtype)
  else:
    arr = np.frombuffer(data, dtype=dtype)
  return arr.reshape(shape, order="F")


def _to_image_plane(img: np.ndarray) -> np.ndarray:
  """(x, y, z, c) -> stacked 2D plane (y*z, x, c): z slices vertically."""
  x, y, z, c = img.shape
  return np.ascontiguousarray(img.transpose(2, 1, 0, 3)).reshape(z * y, x, c)


def _from_image_plane(plane: np.ndarray, shape) -> np.ndarray:
  x, y, z, c = shape
  if plane.ndim == 2:
    plane = plane[..., np.newaxis]
  if plane.shape[0] != z * y or plane.shape[1] != x:
    raise ValueError(
      f"decoded image plane {plane.shape} does not match chunk {shape}"
    )
  return np.asfortranarray(plane.reshape(z, y, x, c).transpose(2, 1, 0, 3))


def encode_jpeg(img: np.ndarray, quality: int = JPEG_DEFAULT_QUALITY) -> bytes:
  from PIL import Image

  if img.dtype != np.uint8:
    raise ValueError(f"jpeg requires uint8 chunks, got {img.dtype}")
  if img.shape[3] not in (1, 3):
    raise ValueError(f"jpeg supports 1 or 3 channels, got {img.shape[3]}")
  plane = _to_image_plane(img)
  pil = Image.fromarray(plane[..., 0] if plane.shape[2] == 1 else plane)
  bio = io.BytesIO()
  pil.save(bio, format="JPEG", quality=int(quality))
  return bio.getvalue()


def decode_jpeg(data: bytes, shape, dtype) -> np.ndarray:
  from PIL import Image

  plane = np.asarray(Image.open(io.BytesIO(data)))
  return _from_image_plane(plane, shape).astype(dtype, copy=False)


def encode_png(img: np.ndarray, compress_level: int = 6) -> bytes:
  from PIL import Image

  c = img.shape[3]
  if img.dtype == np.uint8:
    if c not in (1, 3, 4):
      raise ValueError(f"png supports 1/3/4 uint8 channels, got {c}")
    plane = _to_image_plane(img)
    pil = Image.fromarray(plane[..., 0] if c == 1 else plane)
  elif img.dtype == np.uint16:
    if c != 1:
      raise ValueError(f"png uint16 supports 1 channel, got {c}")
    pil = Image.fromarray(_to_image_plane(img)[..., 0])  # mode I;16
  else:
    raise ValueError(f"png requires uint8/uint16 chunks, got {img.dtype}")
  bio = io.BytesIO()
  pil.save(bio, format="PNG", compress_level=int(compress_level))
  return bio.getvalue()


def decode_png(data: bytes, shape, dtype) -> np.ndarray:
  from PIL import Image

  pil = Image.open(io.BytesIO(data))
  if np.dtype(dtype) == np.uint16 and pil.mode == "I":
    plane = np.asarray(pil).astype(np.uint16)
  else:
    plane = np.asarray(pil)
  return _from_image_plane(plane, shape).astype(dtype, copy=False)


def encode(
  img: np.ndarray, encoding: str, block_size=(8, 8, 8),
  jpeg_quality: int = JPEG_DEFAULT_QUALITY, png_level: int = 6,
) -> bytes:
  if img.ndim == 3:
    img = img[..., np.newaxis]
  if encoding == "raw":
    return encode_raw(img)
  if encoding == "compressed_segmentation":
    return cseg_compress(img, block_size=block_size)
  if encoding == "jpeg":
    return encode_jpeg(img, quality=jpeg_quality)
  if encoding == "png":
    return encode_png(img, compress_level=png_level)
  if encoding in ("compresso", "compresso-cpsx"):
    # "compresso-cpsx" is how info files advertise the cpsx container
    # (meta.advertised_encoding); both names hit one codec
    from .compresso import compress as compresso_compress

    return compresso_compress(img)
  raise NotImplementedError(f"Encoding not supported: {encoding}")


def decode(data: bytes, encoding: str, shape, dtype, block_size=(8, 8, 8),
           writable: bool = True) -> np.ndarray:
  shape = tuple(int(v) for v in shape)
  if len(shape) == 3:
    shape = shape + (1,)
  if encoding == "raw":
    return decode_raw(data, shape, dtype, writable=writable)
  if encoding == "compressed_segmentation":
    return cseg_decompress(data, shape, dtype, block_size=block_size)
  if encoding == "jpeg":
    return decode_jpeg(data, shape, dtype)
  if encoding == "png":
    return decode_png(data, shape, dtype)
  if encoding in ("compresso", "compresso-cpsx"):
    from .compresso import decompress as compresso_decompress

    return compresso_decompress(data, shape, dtype)
  raise NotImplementedError(f"Encoding not supported: {encoding}")
