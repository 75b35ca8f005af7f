"""Asyncio HTTP/1.1 front end of the serving tier.

The port's own copy of ``igneous_tpu/serve/server.py``, standard library
only (``asyncio.start_server``): GET, HEAD and OPTIONS, keep-alive, Range
and conditional requests, what Neuroglancer and a CDN need.

Request handling is async; anything that blocks (storage, codecs, the
card) goes to the app's thread pool. A graceful drain (SIGTERM) stops
accepting, lets in-flight requests finish writing, closes idle keep-alive
connections and returns; the ``serve`` command then exits 0, since a load
balancer retries HTTP requests for free.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..observability import metrics

MAX_HEADER_LINE = 65536
MAX_HEADERS = 200
MAX_BODY = 1 << 20  # request bodies are never meaningful here

REASONS = {
  200: "OK", 204: "No Content", 206: "Partial Content",
  304: "Not Modified", 400: "Bad Request", 403: "Forbidden",
  404: "Not Found", 405: "Method Not Allowed",
  413: "Payload Too Large", 416: "Range Not Satisfiable",
  429: "Too Many Requests", 500: "Internal Server Error",
  502: "Bad Gateway", 503: "Service Unavailable",
}


class Request:
  __slots__ = ("method", "target", "version", "headers")

  def __init__(self, method: str, target: str, version: str,
               headers: Dict[str, str]):
    self.method = method
    self.target = target
    self.version = version
    self.headers = headers  # lower-cased names

  def header(self, name: str, default: str = "") -> str:
    return self.headers.get(name.lower(), default)


class Response:
  __slots__ = ("status", "body", "headers", "close")

  def __init__(self, status: int, body: bytes = b"",
               headers: Optional[list] = None, close: bool = False):
    self.status = status
    self.body = body
    self.headers = headers or []
    self.close = close


class _Conn:
  """Per-connection drain state (identity-hashed for the conn set)."""

  __slots__ = ("busy", "writer")

  def __init__(self, writer):
    self.busy = False
    self.writer = writer


class HttpServer:
  """One listening socket inside a running event loop."""

  def __init__(self, handler: Callable, host: str, port: int):
    self._handler = handler
    self._host = host
    self._port = port
    self._server: Optional[asyncio.AbstractServer] = None
    self._conns: set = set()
    self._draining = False
    self.port: Optional[int] = None

  async def start(self) -> int:
    self._server = await asyncio.start_server(
      self._client, self._host, self._port, limit=MAX_HEADER_LINE
    )
    self.port = self._server.sockets[0].getsockname()[1]
    return self.port

  async def _read_request(self, reader) -> Optional[Request]:
    try:
      line = await reader.readline()
    except (asyncio.LimitOverrunError, ConnectionError):
      return None
    if not line or line in (b"\r\n", b"\n"):
      return None
    try:
      method, target, version = line.decode("latin-1").rstrip("\r\n").split(" ", 2)
    except ValueError:
      return None
    headers: Dict[str, str] = {}
    for _ in range(MAX_HEADERS):
      try:
        h = await reader.readline()
      except (asyncio.LimitOverrunError, ConnectionError):
        return None
      if h in (b"\r\n", b"\n", b""):
        break
      name, _, value = h.decode("latin-1").partition(":")
      headers[name.strip().lower()] = value.strip()
    else:
      return None
    # drain any request body (never meaningful for GET/HEAD, but a
    # client that sends one must not desync the keep-alive stream)
    try:
      n = int(headers.get("content-length", "0") or "0")
    except ValueError:
      return None
    if n:
      if n > MAX_BODY:
        return None
      try:
        await reader.readexactly(n)
      except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return Request(method.upper(), target, version, headers)

  async def _write_response(self, writer, req: Request, resp: Response,
                            close: bool) -> None:
    body = b"" if req.method == "HEAD" else resp.body
    names = {n.lower() for n, _ in resp.headers}
    lines = [f"HTTP/1.1 {resp.status} {REASONS.get(resp.status, 'Unknown')}"]
    for name, value in resp.headers:
      lines.append(f"{name}: {value}")
    if "content-length" not in names and resp.status not in (204, 304):
      lines.append(f"Content-Length: {len(resp.body)}")
    lines.append(f"Connection: {'close' if close else 'keep-alive'}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    writer.write(head + body)
    await writer.drain()

  async def _client(self, reader, writer) -> None:
    conn = _Conn(writer)
    self._conns.add(conn)
    try:
      while not self._draining:
        req = await self._read_request(reader)
        if req is None:
          break
        conn.busy = True
        try:
          try:
            resp = await self._handler(req)
          except Exception:
            metrics.incr("serve.http.handler_error")
            resp = Response(500, b"internal error", close=True)
          close = (
            self._draining or resp.close
            or req.header("connection").lower() == "close"
            or (req.version == "HTTP/1.0"
                and req.header("connection").lower() != "keep-alive")
          )
          try:
            await self._write_response(writer, req, resp, close)
          except (ConnectionError, asyncio.CancelledError):
            break
        finally:
          conn.busy = False
        if close:
          break
    except (ConnectionError, asyncio.CancelledError):
      pass
    finally:
      self._conns.discard(conn)
      try:
        writer.close()
        await writer.wait_closed()
      except Exception:
        pass

  async def drain(self, timeout: float = 30.0) -> None:
    """Stop accepting; finish in-flight requests; close idle conns."""
    self._draining = True
    if self._server is not None:
      self._server.close()
      await self._server.wait_closed()
    # idle keep-alive connections sit in readline and would never notice
    # the drain flag: closing their transport pops them out with EOF.
    # Busy ones finish their current response first.
    deadline = time.monotonic() + timeout
    while self._conns and time.monotonic() < deadline:
      for conn in list(self._conns):
        if not conn.busy:
          try:
            conn.writer.close()
          except Exception:
            pass
      if not self._conns:
        break
      await asyncio.sleep(0.02)


class ServeServer:
  """The event loop and its ``HttpServer`` on a thread of their own, with
  ``view.serve(block=False)``'s handle: ``.server_address`` and a blocking
  ``.shutdown()``."""

  def __init__(self, app, host: str = "0.0.0.0", port: int = 0,
               drain_timeout: float = 30.0):
    self.app = app
    self.host = host
    self.port: Optional[int] = None
    self._drain_timeout = drain_timeout
    self._requested_port = port
    self._ready = threading.Event()
    self._startup_error: Optional[BaseException] = None
    self._loop: Optional[asyncio.AbstractEventLoop] = None
    self._stop: Optional[asyncio.Event] = None
    self._thread = threading.Thread(
      target=self._run, daemon=True, name="ig-serve"
    )
    self._thread.start()
    self._ready.wait()
    if self._startup_error is not None:
      raise self._startup_error

  @property
  def server_address(self) -> Tuple[str, int]:
    return (self.host, self.port or 0)

  def _run(self) -> None:
    try:
      asyncio.run(self._main())
    except BaseException as e:  # startup failures surface in __init__
      if not self._ready.is_set():
        self._startup_error = e
        self._ready.set()

  async def _main(self) -> None:
    self._loop = asyncio.get_running_loop()
    self._stop = asyncio.Event()
    self.app.attach_loop(self._loop)
    http = HttpServer(self.app.handle, self.host, self._requested_port)
    try:
      self.port = await http.start()
    except OSError as e:
      self._startup_error = e
      self._ready.set()
      return
    self._ready.set()
    housekeeper = asyncio.ensure_future(self.app.housekeeping())
    try:
      await self._stop.wait()
    finally:
      housekeeper.cancel()
      await http.drain(self._drain_timeout)
      await self._loop.run_in_executor(None, self.app.close)

  def request_shutdown(self) -> None:
    """Signal-handler-safe: begin the drain without blocking."""
    loop, stop = self._loop, self._stop
    if loop is not None and stop is not None:
      loop.call_soon_threadsafe(stop.set)

  def shutdown(self) -> None:
    """Drain and join (blocks until the server is fully down)."""
    self.request_shutdown()
    if self._thread.is_alive():
      self._thread.join(timeout=self._drain_timeout + 10.0)

  def join(self) -> None:
    """Block until the serve loop exits (SIGTERM/shutdown)."""
    while self._thread.is_alive():
      self._thread.join(timeout=0.2)
