"""A local Precomputed server and its Neuroglancer link: ``view``.

The port's own copy of ``igneous_tpu/view.py``: the single-layer mode of
the serving tier (``igneous_tpu_torch.serve``), so the development server
and the production tier share one request path (the CORS wildcard, the
path-traversal guard, Range for sharded reads, the ``.gz`` layout served
compressed or not, the cache, coalescing and request traces).
"""

from __future__ import annotations

import json


def neuroglancer_url(
  port: int, layer_name: str, layer_type: str,
  ng_url: "str | None" = None, position=None,
) -> str:
  state = {
    "layers": [
      {
        "type": layer_type,
        "source": f"precomputed://http://localhost:{port}",
        "name": layer_name,
      }
    ],
  }
  if position is not None:
    state["position"] = [float(v) for v in position]
  fragment = json.dumps(state, separators=(",", ":"))
  base = (ng_url or "https://neuroglancer-demo.appspot.com/").rstrip("/")
  return f"{base}/#!{fragment}"


def serve(
  cloudpath: str,
  port: int = 1337,
  block: bool = True,
  browser: bool = False,
  ng_url: "str | None" = None,
  position=None,
  layer_name: "str | None" = None,
):
  """Serve a layer for Neuroglancer; returns the server when
  ``block=False``. ``browser`` opens the link in the system browser,
  ``ng_url`` names another Neuroglancer deployment and ``position``
  centres the view.

  The handle's ``.server_address`` is ``(host, port)`` and its
  ``.shutdown()`` blocks until the server has drained."""
  from .serve import ServeApp, ServeConfig, ServeServer
  from .storage import CloudFiles

  name = layer_name or cloudpath.rstrip("/").split("/")[-1] or "layer"
  app = ServeApp({name: cloudpath}, default_layer=name,
                 config=ServeConfig.from_env())
  server = ServeServer(app, host="0.0.0.0", port=port,
                       drain_timeout=app.config.drain_sec)
  port = server.server_address[1]
  info = CloudFiles(cloudpath).get_json("info") or {}
  url = neuroglancer_url(
    port, name, info.get("type", "image"), ng_url=ng_url, position=position,
  )
  print(f"Serving {cloudpath} at http://localhost:{port}")
  print(f"View in Neuroglancer:\n  {url}")
  if browser:
    import webbrowser

    webbrowser.open(url, new=2)
  if block:
    try:
      server.join()
    except KeyboardInterrupt:
      pass
    finally:
      server.shutdown()
    return None
  return server
