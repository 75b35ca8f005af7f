"""``serve``: the interactive Precomputed serving tier.

The port's own copy of ``igneous_tpu/serve``: an asyncio HTTP server over
one or many layers on any storage backend, with a cache of stored bytes
(RAM LRU, local-SSD spill, a CDN through strong ETags), request
coalescing (N clients, one backend fetch) and the synthesis of missing
mips through the port's pooling on the card. With peers configured the
fleet behaves as one cache: rendezvous ownership with peer fill before
origin, fleet-wide invalidation, per-layer QoS shedding and prewarming
from journal traces (``federation``).

    from igneous_tpu_torch.serve import start_server
    server = start_server("gs://bucket/layer", port=8080)
    ...
    server.shutdown()

or ``python -m igneous_tpu_torch serve gs://bucket/layer --port 8080``.
"""

from .app import LayerHandle, ServeApp, ServeConfig
from .cache import Entry, TieredStoredCache, strong_etag
from .federation import (
  PEER_FILL_HEADER, Federation, HashRing, Prewarmer, QosGate,
)
from .server import HttpServer, Request, Response, ServeServer


def start_server(layers, host: str = "0.0.0.0", port: int = 0,
                 config: ServeConfig = None,
                 default_layer: str = None) -> ServeServer:
  """A ``ServeApp`` over ``layers`` (a cloudpath, or ``{name: cloudpath}``)
  served on a background thread; returns the ``ServeServer`` handle
  (``.server_address``, ``.shutdown()``)."""
  app = ServeApp(layers, config=config, default_layer=default_layer)
  cfg = app.config
  return ServeServer(app, host=host, port=port, drain_timeout=cfg.drain_sec)


__all__ = [
  "Entry", "Federation", "HashRing", "HttpServer", "LayerHandle",
  "PEER_FILL_HEADER", "Prewarmer", "QosGate", "Request", "Response",
  "ServeApp", "ServeConfig", "ServeServer", "TieredStoredCache",
  "start_server", "strong_etag",
]
