"""The staged pipeline's encode/upload stage: chunk encodes and puts on a
persistent thread pool, grouped under tickets."""

from .encoder import (
  EncodePool,
  SerialSink,
  UploadTicket,
  shared_encode_pool,
  shared_prefetch_pool,
)
