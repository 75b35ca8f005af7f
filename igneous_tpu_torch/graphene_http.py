"""PyChunkGraph HTTP client: the graphene:// wire protocol.

The port's own copy of ``igneous_tpu/graphene_http.py``, on the port's
``secrets.py``, ``storage_http.py`` and ``retry.py``.
``graphene://https://server/segmentation/api/v1/table/<id>`` volumes talk
to a PCG server:

  * ``GET  {base}/info``: the ``graph`` section (chunk_size, n_layers)
    and ``data_dir`` (the watershed layer the Precomputed chunks live in).
  * ``POST {base}/node/roots_binary?timestamp=T[&stop_layer=N]``:
    supervoxel ids in (little-endian uint64), mapped node ids out;
    stop_layer=2 yields L2 ids, none yields roots. Ids are deduplicated
    before the POST.
  * ``GET  {base}/root/{root_id}/tabular_change_log``: the merge/split
    operation log of a root.

Auth: a bearer token from ``CAVE_TOKEN`` or the secrets directory
(``cave-secret.json``, then ``chunkedgraph-secret.json``); a found token
is cached per directory, a missing one never is (a token provisioned late
is picked up), and a 401 or 403 clears the cache and retries once with
the re-read secret (rotation).

The voxel-connectivity graph is the L2 field's bitfields with graph-chunk
boundary planes shaded from the root field; its per-voxel work runs on
the port's device.
"""

from __future__ import annotations

import json
import os
import urllib.parse
from typing import Optional

import numpy as np

from . import telemetry
from .retry import default_policy
from .storage_http import HttpError, request


_AUTH_CACHE: dict = {}


def _auth_header() -> dict:
  """CAVE/PCG deployments use a bearer token from
  ``<secrets dir>/cave-secret.json`` (or chunkedgraph-secret.json), or
  ``CAVE_TOKEN``. Successful loads cache per secrets dir
  (this sits on the hot download path); a MISSING token is never cached,
  so a long-running worker picks up a token provisioned after startup,
  and a 401/403 invalidates the cache (_invalidate_auth) so a rotated
  secret file is re-read. A secret file without a usable ``token`` key
  falls through to the next candidate instead of ending the search."""
  from . import secrets

  tok = os.environ.get("CAVE_TOKEN")
  if not tok:
    sdir = secrets.secrets_dir()
    tok = _AUTH_CACHE.get(sdir)
    if not tok:
      for name in ("cave-secret.json", "chunkedgraph-secret.json"):
        path = os.path.join(sdir, name)
        if not os.path.exists(path):
          continue
        with open(path) as f:
          blob = json.load(f)
        tok = blob.get("token")
        if tok:
          _AUTH_CACHE[sdir] = tok
          break
  return {"Authorization": f"Bearer {tok}"} if tok else {}


def _invalidate_auth() -> None:
  _AUTH_CACHE.clear()


def _auth_request(method: str, url: str, data=None, extra_headers=None):
  """request() with the bearer header, retried ONCE with a re-read token
  on 401/403 — so a worker whose secret was rotated (or provisioned late)
  recovers without a restart."""
  headers = dict(extra_headers or {})
  telemetry.incr("graphene.requests", 1)
  # unified retry schedule (retry.RetryPolicy): transient 5xx/connection
  # faults back off the same way the storage backends do
  policy = default_policy()
  try:
    return request(method, url, data=data,
                   headers={**headers, **_auth_header()}, policy=policy)
  except HttpError as e:
    # an env-var token can't be refreshed by re-reading secret files —
    # retrying would resend the identical request
    if e.status not in (401, 403) or os.environ.get("CAVE_TOKEN"):
      raise
    _invalidate_auth()
    return request(method, url, data=data,
                   headers={**headers, **_auth_header()}, policy=policy)


class PCGClient:
  """GrapheneClient protocol over the PyChunkGraph REST API."""

  def __init__(self, base_url: str):
    self.base = base_url.rstrip("/")
    self._info: Optional[dict] = None

  # -- metadata -------------------------------------------------------------

  @property
  def info(self) -> dict:
    if self._info is None:
      status, _h, body = _auth_request("GET", f"{self.base}/info")
      if status != 200:
        raise HttpError(status, f"{self.base}/info", body)
      self._info = json.loads(body)
    return self._info

  @property
  def chunk_size(self):
    return tuple(int(v) for v in self.info["graph"]["chunk_size"])

  @property
  def data_dir(self) -> Optional[str]:
    """Watershed layer path the Precomputed chunks live in."""
    return self.info.get("data_dir")

  # -- node mapping ---------------------------------------------------------

  def _map_nodes(
    self,
    supervoxels: np.ndarray,
    timestamp: Optional[float],
    stop_layer: Optional[int],
  ) -> np.ndarray:
    sv = np.asarray(supervoxels, dtype=np.uint64)
    uniq, inv = np.unique(sv, return_inverse=True)
    send = uniq[uniq != 0]
    out_uniq = np.zeros_like(uniq)
    if len(send):
      params = []
      if timestamp is not None:
        params.append(f"timestamp={urllib.parse.quote(str(timestamp))}")
      if stop_layer is not None:
        params.append(f"stop_layer={int(stop_layer)}")
      url = f"{self.base}/node/roots_binary"
      if params:
        url += "?" + "&".join(params)
      status, _h, body = _auth_request(
        "POST", url, data=send.astype("<u8").tobytes(),
        extra_headers={"Content-Type": "application/octet-stream"},
      )
      if status != 200:
        raise HttpError(status, url, body)
      mapped = np.frombuffer(body, dtype="<u8")
      if len(mapped) != len(send):
        raise ValueError(
          f"roots_binary returned {len(mapped)} ids for {len(send)} nodes"
        )
      out_uniq[uniq != 0] = mapped
    return out_uniq[inv].reshape(sv.shape)

  def get_roots(self, supervoxels, timestamp=None) -> np.ndarray:
    return self._map_nodes(supervoxels, timestamp, None)

  def get_l2_ids(self, supervoxels, voxel_chunks, timestamp=None) -> np.ndarray:
    """L2 node per voxel. PCG supervoxel ids encode their chunk, so the
    mapping is per-supervoxel and ``voxel_chunks`` (needed by the
    in-process LocalChunkGraph whose test ids carry no chunk info) is
    not sent over the wire."""
    del voxel_chunks
    return self._map_nodes(supervoxels, timestamp, 2)

  # -- merge log ------------------------------------------------------------

  def change_log(self, root_id: int) -> dict:
    """Merge/split operation log for one root
    (``tabular_change_log``): {"operations": [{"is_merge": bool,
    "timestamp": float, "sink": [...], "source": [...]}, ...]}."""
    url = f"{self.base}/root/{int(root_id)}/tabular_change_log"
    status, _h, body = _auth_request("GET", url)
    if status != 200:
      raise HttpError(status, url, body)
    return json.loads(body)

  # -- voxel connectivity graph --------------------------------------------

  def voxel_connectivity_graph(
    self, supervoxels, connectivity: int = 26, timestamp=None,
    offset=(0, 0, 0), downsample_ratio=(1, 1, 1),
  ) -> np.ndarray:
    """Bitfields of the L2 label field, with the graph-chunk boundary
    planes shaded from the root field.

    ``offset`` is the cutout's global minpt at its mip and
    ``downsample_ratio`` the mip->base scale: boundary planes are located
    on the global graph-chunk grid. The cutout's unique supervoxels go to
    the server (one request at stop_layer 2, then one for the roots); the
    fields, both bitfields and the shading are computed on the port's
    device."""
    import torch

    from .device import get_device
    from .ops.ccl import graph_bits_to_numpy, voxel_graph_tensor
    from .ops.graphene_ids import map_on_device

    dev = get_device()
    sv = np.asarray(supervoxels)
    l2 = map_on_device(sv, lambda u: self._map_nodes(u, timestamp, 2), dev)
    vcg = voxel_graph_tensor(l2, connectivity)
    del l2
    roots = map_on_device(sv, lambda u: self._map_nodes(u, timestamp, None), dev)
    root_vcg = voxel_graph_tensor(roots, connectivity)
    del roots

    gcs = np.maximum(
      np.asarray(self.chunk_size) // np.asarray(downsample_ratio), 1
    ).astype(np.int64)
    off = np.asarray(offset, dtype=np.int64)
    shape = np.asarray(sv.shape[:3], dtype=np.int64)
    g_lo = (off // gcs).astype(np.int64)
    g_hi = -(-(off + shape) // gcs)  # ceil of global max in chunk units
    for gx in range(int(g_lo[0]), int(g_hi[0])):
      for gy in range(int(g_lo[1]), int(g_hi[1])):
        for gz in range(int(g_lo[2]), int(g_hi[2])):
          lo = np.maximum(np.array([gx, gy, gz]) * gcs - off, 0)
          hi = np.minimum((np.array([gx, gy, gz]) + 1) * gcs - off, shape)
          if (lo >= hi).any():
            continue
          for axis in range(3):
            for plane in (lo[axis], hi[axis] - 1):
              sl = [slice(int(a), int(b)) for a, b in zip(lo, hi)]
              sl[axis] = slice(int(plane), int(plane) + 1)
              zyx = tuple(sl[::-1])  # the device layout is (z, y, x)
              vcg[zyx] = root_vcg[zyx]
    del root_vcg
    if vcg.is_cuda:
      torch.cuda.synchronize(vcg.device)
    return graph_bits_to_numpy(vcg)


def parse_graphene_server(inner_path: str) -> Optional[str]:
  """graphene:// inner paths addressing a PCG server start with http(s)."""
  if inner_path.startswith(("http://", "https://")):
    return inner_path
  return None
