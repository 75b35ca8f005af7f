"""The port's ``view`` and its ``serve`` and ``view`` commands against the
JAX package's.

``neuroglancer_url`` returns the JAX function's string; ``serve(block=
False)`` serves the layer at the root and under its name, with the JAX
server's bytes and headers; ``serve --help`` and ``view --help`` list
every option of the JAX commands; a ``serve`` subprocess prints its
readiness line, serves, and drains on SIGTERM with exit 0; ``view`` skips
to a free port.
"""

import http.client
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import view as jax_view
from igneous_tpu.cli import main as jax_cli
from igneous_tpu_torch import device, view
from igneous_tpu_torch.cli import build_parser
from igneous_tpu_torch.cli import main as cli_main

REPO = pathlib.Path(__file__).resolve().parent.parent
CHUNK = "1_1_1/0-64_0-64_0-64"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


def _get(port, path, headers=None):
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
  try:
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()
  finally:
    conn.close()


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


@pytest.mark.parametrize("kw", [
  dict(port=1337, layer_name="img", layer_type="image"),
  dict(port=8081, layer_name="seg", layer_type="segmentation",
       ng_url="https://ng.example.org/", position=(10, 20.5, 3)),
  dict(port=9, layer_name="a b", layer_type="image", position=[1, 2, 3]),
])
def test_neuroglancer_url_is_the_jax_string(kw):
  assert view.neuroglancer_url(**kw) == jax_view.neuroglancer_url(**kw)


def test_serve_nonblocking_serves_the_layer(tmp_path, capsys):
  path = f"file://{tmp_path}/layer"
  data = np.random.default_rng(0).integers(0, 200, (64, 64, 64)).astype(np.uint8)
  JaxVolume.from_numpy(data, path, chunk_size=(64, 64, 64), compress="gzip")
  srv = view.serve(path, port=0, block=False, layer_name="mine")
  ref = jax_view.serve(path, port=0, block=False, layer_name="mine")
  try:
    out = capsys.readouterr().out.splitlines()
    port = srv.server_address[1]
    assert out[0] == f"Serving {path} at http://localhost:{port}"
    assert out[2].strip() == view.neuroglancer_url(port, "mine", "image")
    for key in (f"/{CHUNK}", f"/mine/{CHUNK}", "/info"):
      for hdr in ({}, {"Accept-Encoding": "gzip"}):
        got = _get(port, key, hdr)
        assert got[0] == 200 and got == _get(ref.server_address[1], key, hdr)
  finally:
    srv.shutdown()
    ref.shutdown()


def _jax_options(name):
  cmd = jax_cli.commands[name]
  return sorted({o for p in cmd.params for o in list(p.opts) + list(p.secondary_opts)
                 if o.startswith("--")})


def _port_options(name):
  sub = next(a for a in build_parser()._subparsers._group_actions)
  return sorted({o for a in sub.choices[name]._actions for o in a.option_strings
                 if o.startswith("--") and o != "--help"})


@pytest.mark.parametrize("name", ["serve", "view"])
def test_help_lists_the_jax_options(name, capsys):
  assert _port_options(name) == _jax_options(name)
  with pytest.raises(SystemExit) as e:
    cli_main([name, "--help"])
  assert e.value.code == 0
  text = capsys.readouterr().out
  assert all(opt in text for opt in _jax_options(name))


def test_serve_names_and_refuses_duplicate_layers(capsys):
  with pytest.raises(SystemExit) as e:
    cli_main(["serve", "a=file:///x/one", "a=file:///x/two"])
  assert e.value.code == 2
  assert "duplicate layer name: 'a'" in capsys.readouterr().err


def test_serve_subprocess_drains_on_sigterm(tmp_path):
  path = f"file://{tmp_path}/layer"
  data = np.random.default_rng(1).integers(0, 200, (64, 64, 64)).astype(np.uint8)
  JaxVolume.from_numpy(data, path, chunk_size=(64, 64, 64), compress="gzip")
  env = dict(os.environ, PYTHONPATH=str(REPO), IGNEOUS_TORCH_DEVICE="cpu")
  env.pop("IGNEOUS_JOURNAL", None)
  proc = subprocess.Popen(
    [sys.executable, "-m", "igneous_tpu_torch", "serve", f"named={path}", "--port", "0",
     "--host", "127.0.0.1", "--no-synth"],
    cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
  )
  try:
    ready = json.loads(proc.stdout.readline())
    assert ready["event"] == "serve.listening" and ready["layers"] == ["named"]
    assert ready["self_url"] is None and ready["metrics_port"] is None
    status, _, body = _get(ready["port"], f"/named/{CHUNK}")
    assert status == 200 and len(body) == 64 ** 3
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait()
    proc.stdout.close()
    proc.stderr.close()


def test_view_skips_to_a_free_port(tmp_path, monkeypatch):
  path = f"file://{tmp_path}/layer"
  JaxVolume.from_numpy(np.zeros((8, 8, 8), np.uint8), path, chunk_size=(8, 8, 8))
  busy = socket.socket()
  busy.bind(("127.0.0.1", 0))
  busy.listen(1)
  taken = busy.getsockname()[1]
  seen = {}

  def fake_serve(cloudpath, port, block, browser, ng_url, position, layer_name):
    seen.update(port=port, block=block, browser=browser, position=position, name=layer_name)

  monkeypatch.setattr(view, "serve", fake_serve)
  try:
    assert cli_main(["view", path, "--port", str(taken), "--no-browser", "--pos", "1,2,3",
                     "--name", "nm"]) == 0
  finally:
    busy.close()
  assert seen["port"] > taken and seen["block"] and not seen["browser"]
  assert seen["position"] == (1, 2, 3) and seen["name"] == "nm"
