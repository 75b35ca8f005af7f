"""The port's command line: ``python -m igneous_tpu_torch image
{downsample [--batched|--sharded|--isotropic],xfer [--sharded],infer,rm,
roi,reorder,create}``, ``python -m igneous_tpu_torch image contrast
{histogram,equalize,clahe}``,
``python -m igneous_tpu_torch image voxels {count,sum}``,
``python -m igneous_tpu_torch image ccl {faces,links,
calc-labels,relabel,clean,auto}``, ``python -m igneous_tpu_torch mesh
{forge [--sharded],merge [--nlod N],merge-sharded,clean,xfer [--sharded],rm,
spatial-index {create,db}}``, ``python -m igneous_tpu_torch skeleton
{forge [--sharded],merge,merge-sharded,clean,xfer [--sharded],rm,convert,
spatial-index {create,db}}``,
``python -m igneous_tpu_torch execute``, ``python -m igneous_tpu_torch
queue {status,wait,release,purge,rezero,fsck,cp,mv,dlq {ls,retry,purge}}``,
``python -m igneous_tpu_torch audit``, ``python -m igneous_tpu_torch
fleet {status,trace,top,devices,compact,gc,check,watch}``, ``python -m
igneous_tpu_torch profile {capture,ls}``, ``python -m igneous_tpu_torch
design {ds-memory,ds-shape,bounds}``, ``python -m igneous_tpu_torch
license``, ``python -m igneous_tpu_torch tune``, ``python -m
igneous_tpu_torch serve`` and ``python -m igneous_tpu_torch view``.

A minimal counterpart of ``igneous-tpu image
downsample|xfer|infer|rm|roi|reorder|create``, ``igneous-tpu image
contrast``, ``igneous-tpu image voxels count|sum``, ``igneous-tpu image
ccl``, ``igneous-tpu mesh``, ``igneous-tpu skeleton``,
``igneous-tpu execute``, ``igneous-tpu queue``, ``igneous-tpu audit``,
``igneous-tpu fleet``, ``igneous-tpu profile``, ``igneous-tpu design``,
``igneous-tpu license``, ``igneous-tpu tune``, ``igneous-tpu serve`` and
``igneous-tpu view``
(``igneous_tpu/cli.py``), with the same option
names, output lines and exit codes (where the JAX CLI raises a usage
error the port exits 2, where it raises any other error it prints
``Error: ...`` and exits 1); an option the port does not have is
refused by the parser. A
command that
makes tasks runs them in a ``LocalTaskQueue`` on the port's device (cuda;
``IGNEOUS_TORCH_DEVICE=cpu`` asks for the CPU), or, with ``--queue
fq://...`` (or ``sqs://``), inserts them there for ``execute`` workers.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def _tuple3(text: str):
  parts = [int(v) for v in text.split(",")]
  if len(parts) != 3:
    raise argparse.ArgumentTypeError(f"{text!r} is not an int triple like 2,2,1")
  return tuple(parts)


def _tuple2or1(text: str):
  """'8' or '8,8' -> (8, 8)."""
  try:
    parts = [int(v) for v in text.split(",")]
  except ValueError:
    raise argparse.ArgumentTypeError(f"{text!r} is not like 8 or 8,8")
  if len(parts) == 1:
    parts = parts * 2
  if len(parts) != 2:
    raise argparse.ArgumentTypeError(f"{text!r} must have 1 or 2 components")
  return tuple(parts)


def _tuple2(text: str):
  parts = [int(v) for v in text.split(",")]
  if len(parts) != 2:
    raise argparse.ArgumentTypeError(f"{text!r} is not an int pair like 0,1024")
  return tuple(parts)


def _resolve_compress(compress: str, encoding):
  """'none'/'false' -> False; the image codecs, which compress
  themselves, take no second-stage compression."""
  if compress.lower() in ("none", "false"):
    return False
  if encoding and encoding.lower() in ("jpeg", "jxl", "png", "fpzip", "zfpc"):
    return False
  return compress


def _queue_opt(cmd) -> None:
  cmd.add_argument("--queue", "-q", default=None,
                   help="fq:// (or sqs://) queue to insert the tasks into "
                        "for `execute` workers (local execution if omitted).")


def enqueue(queue_spec: Optional[str], tasks, parallel: int = 1) -> None:
  """Run ``tasks`` in a ``LocalTaskQueue``, or insert them into the queue
  at ``queue_spec`` (as segments, sized by the task count when the
  iterator knows it)."""
  from .queues import LocalTaskQueue, TaskQueue

  if queue_spec is None:
    LocalTaskQueue(parallel=parallel).insert(tasks)
    return
  total = len(tasks) if hasattr(tasks, "__len__") else None
  TaskQueue(queue_spec).insert_batch(tasks, total=total)


def _range_opts(cmd) -> None:
  for axis in "xyz":
    cmd.add_argument(f"--{axis}range", type=_tuple2, default=None,
                     help=f"Restrict {axis}-bounds (in the bounds mip), e.g. 0,1024")


def _cli_bounds(path: str, mip: int, args):
  """The volume's bounds at ``mip`` with the given axis ranges put in;
  None when no range is given."""
  ranges = (args.xrange, args.yrange, args.zrange)
  if not any(ranges):
    return None
  from .volume import Volume

  bounds = Volume(path).meta.bounds(mip)
  for axis, rng in enumerate(ranges):
    if rng:
      bounds.minpt[axis], bounds.maxpt[axis] = sorted(rng)
  return bounds


def _encoding_opts(cmd) -> None:
  cmd.add_argument("--encoding", default=None,
                   help="raw, compressed_segmentation, compresso, jpeg or png.")
  cmd.add_argument("--encoding-level", type=int, default=None,
                   help="png level / jpeg quality.")
  cmd.add_argument("--encoding-effort", type=int, default=None,
                   help="(jpeg xl) accepted for parity; jxl is not shipped.")
  cmd.add_argument("--compress", default="gzip",
                   help="Chunk compression: gzip, none, or auto (gzip for "
                        "raw and the segmentation codecs, none for jpeg and png).")


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(prog="python -m igneous_tpu_torch")
  parser.add_argument("-p", "--parallel", type=int, default=1,
                      help="Worker processes for local execution.")
  groups = parser.add_subparsers(dest="group", required=True)
  image = groups.add_parser("image").add_subparsers(dest="command", required=True)
  ds = image.add_parser("downsample", help="Build the downsample pyramid of PATH.")
  ds.add_argument("path")
  _queue_opt(ds)
  ds.add_argument("--mip", type=int, default=0)
  ds.add_argument("--num-mips", type=int, default=5)
  ds.add_argument("--factor", type=_tuple3, default=None, help="e.g. 2,2,1")
  ds.add_argument("--volumetric", action="store_true", help="Use 2x2x2 downsampling.")
  ds.add_argument("--isotropic", action="store_true",
                  help="Per-mip factors driving the resolution toward isotropy.")
  ds.add_argument("--sparse", action="store_true")
  ds.add_argument("--sharded", action="store_true",
                  help="Write the new mips as sharded scales.")
  ds.add_argument("--fill-missing", action="store_true")
  ds.add_argument("--chunk-size", type=_tuple3, default=None)
  _encoding_opts(ds)
  ds.add_argument("--delete-bg", action="store_true",
                  help="Delete background tiles instead of uploading them.")
  ds.add_argument("--bg-color", type=int, default=0)
  ds.add_argument("--memory", dest="memory_target", type=int, default=int(3.5e9))
  ds.add_argument("--method", dest="downsample_method", default="auto")
  _range_opts(ds)
  ds.add_argument("--batched", action="store_true",
                  help="Run on this host's device now (K cutouts per launch, "
                       "double-buffered IO) instead of running per-cutout tasks.")
  ds.add_argument("--batch-size", type=int, default=8,
                  help="Cutouts per device launch with --batched.")
  ds.add_argument("--shape", type=_tuple3, default=(256, 256, 64),
                  help="Cutout shape with --batched.")
  _add_xfer(image.add_parser("xfer", help="Transfer/rechunk/re-encode SRC into DEST."))
  _add_infer(image.add_parser(
    "infer", help="Run conv-net inference over SRC into DEST."))
  _add_rm(image.add_parser("rm", help="Delete image chunks at mip (... mip+num-mips)."))
  _add_contrast(image.add_parser(
    "contrast", help="Luminance histograms, contrast stretch, CLAHE."
  ).add_subparsers(dest="contrast_command", required=True))
  _add_roi(image.add_parser(
    "roi", help="Detect tissue regions of interest at the coarsest mip."))
  _add_reorder(image.add_parser(
    "reorder", help="Shuffle z-slices per a {dest_z: src_z} JSON mapping."))
  _add_create(image.add_parser(
    "create", help="Ingest an array file (npy/npy.gz/h5/nrrd/nii/nii.gz) as a layer."))
  _add_voxels(image.add_parser("voxels", help="Voxel statistics.").add_subparsers(
    dest="voxels_command", required=True))
  _add_ccl(image.add_parser(
    "ccl", help="Whole-image connected components labeling (4-pass)."
  ).add_subparsers(dest="ccl_command", required=True))
  _add_mesh(groups.add_parser("mesh", help="Mesh forging.").add_subparsers(
    dest="command", required=True))
  _add_skeleton(groups.add_parser("skeleton", help="Skeleton forging.").add_subparsers(
    dest="command", required=True))
  _add_tune(groups.add_parser(
    "tune", help="Autotune the kernel knobs for this device kind."))
  _add_execute(groups.add_parser(
    "execute", help="Worker poll loop: lease -> run -> delete."))
  _add_queue(groups.add_parser(
    "queue", help="Queue inspection and maintenance.").add_subparsers(
      dest="command", required=True))
  _add_design(groups.add_parser(
    "design", help="Capacity planning math.").add_subparsers(dest="command", required=True))
  groups.add_parser("license", help="Print the license.")
  _add_audit(groups.add_parser(
    "audit", help="Verify a campaign's outputs: presence, decode, manifest digests."))
  _add_fleet(groups.add_parser(
    "fleet", help="Fleet observability: merge worker journal segments.").add_subparsers(
      dest="command", required=True))
  _add_profile(groups.add_parser(
    "profile", help="On-demand torch.profiler capture across the fleet.").add_subparsers(
      dest="command", required=True))
  _add_campaign(groups.add_parser(
    "campaign", help="Closed-loop campaign survival: autoscale + speculation + "
                     "stealing.").add_subparsers(dest="command", required=True))
  _add_view(groups.add_parser(
    "view", help="Serve PATH locally and print a Neuroglancer link."))
  _add_serve(groups.add_parser(
    "serve", help="Serve one or more Precomputed layers over HTTP."))
  return parser


def _add_view(cmd) -> None:
  cmd.add_argument("path")
  cmd.add_argument("--port", type=int, default=1337, help="[default: 1337]")
  cmd.add_argument("--browser", dest="browser", action="store_true", default=True,
                   help="Open the link in the system browser. [default: browser]")
  cmd.add_argument("--no-browser", dest="browser", action="store_false")
  cmd.add_argument("--ng", default=None, help="Alternative Neuroglancer deployment URL.")
  cmd.add_argument("--pos", type=_tuple3, default=None,
                   help="Open the view centered at this voxel position.")
  cmd.add_argument("--name", default=None, help="Custom layer name.")
  cmd.add_argument("--indirect", action="store_true",
                   help="Accepted for parity: private buckets are served "
                        "through the local server as any layer.")


def _run_view(args) -> int:
  """``view``: the first free port from ``--port`` on (ten tries), then
  ``view.serve`` until interrupted."""
  import socket

  from .view import serve

  port = args.port
  for _ in range(10):
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
      if sock.connect_ex(("localhost", port)) != 0:
        break
    port += 1
  serve(args.path, port=port, block=True, browser=args.browser, ng_url=args.ng,
        position=args.pos, layer_name=args.name)
  return 0


def _add_serve(cmd) -> None:
  cmd.add_argument("paths", nargs="+")
  cmd.add_argument("--port", type=int, default=8080, help="[default: 8080]")
  cmd.add_argument("--host", default="0.0.0.0", help="[default: 0.0.0.0]")
  cmd.add_argument("--ram-mb", type=float, default=None,
                   help="RAM cache budget (env IGNEOUS_SERVE_RAM_MB; default 256).")
  cmd.add_argument("--ssd-dir", default=None,
                   help="Local-SSD spill directory (env IGNEOUS_SERVE_SSD_DIR; "
                        "default off). Entries survive restarts.")
  cmd.add_argument("--ssd-mb", type=float, default=None,
                   help="SSD spill budget (env IGNEOUS_SERVE_SSD_MB; default 4096).")
  cmd.add_argument("--synth", dest="synth", action="store_true", default=None,
                   help="Synthesize missing mips on the fly from the parent "
                        "scale (env IGNEOUS_SERVE_SYNTH_MIPS; default on).")
  cmd.add_argument("--no-synth", dest="synth", action="store_false")
  cmd.add_argument("--writeback", dest="writeback", action="store_true", default=None,
                   help="Write synthesized mips back to storage "
                        "(env IGNEOUS_SERVE_WRITEBACK; default off).")
  cmd.add_argument("--no-writeback", dest="writeback", action="store_false")
  cmd.add_argument("--cache-control", default=None,
                   help="Cache-Control header for CDN fronting "
                        "(env IGNEOUS_SERVE_CACHE_CONTROL; default "
                        "'public, max-age=300').")
  cmd.add_argument("--journal", default=None,
                   help="Journal cloudpath for request traces (env IGNEOUS_JOURNAL).")
  cmd.add_argument("--metrics-port", type=int, default=None,
                   help="Prometheus /metrics port (also served inline at "
                        "/metrics on the main port; 0 auto-assigns).")
  cmd.add_argument("--peers", default=None,
                   help="Comma-separated replica base URLs: static federation "
                        "ring membership (env IGNEOUS_SERVE_FLEET_PEERS).")
  cmd.add_argument("--peers-file", default=None,
                   help="Shared membership directory cloudpath: replicas "
                        "heartbeat + discover the ring here "
                        "(env IGNEOUS_SERVE_FLEET_MEMBERSHIP).")
  cmd.add_argument("--self-url", default=None,
                   help="This replica's advertised base URL (env "
                        "IGNEOUS_SERVE_FLEET_SELF; default derived from the "
                        "bound host/port).")
  cmd.add_argument("--prewarm", dest="prewarm", action="store_true", default=None,
                   help="Telemetry-driven prefetch of predicted-hot chunks "
                        "mined from journal traces (env IGNEOUS_SERVE_PREWARM; "
                        "default off).")
  cmd.add_argument("--no-prewarm", dest="prewarm", action="store_false")


def _run_serve(parser, args) -> int:
  """``serve``: PATHS are cloudpaths, optionally named (``name=gs://...``);
  one unnamed path also serves at the root. It prints one JSON line with
  the bound ports once it listens, and SIGTERM or SIGINT drains it (exit
  0)."""
  import json
  import os
  import signal
  import socket

  from . import secrets
  from .observability import journal as journal_mod
  from .observability import prom
  from .serve import Federation, ServeApp, ServeConfig, ServeServer

  layers = {}
  for spec in args.paths:
    if "=" in spec.split("://")[0]:
      name, _, cloudpath = spec.partition("=")
    else:
      cloudpath = spec
      name = cloudpath.rstrip("/").split("/")[-1] or "layer"
    if name in layers:
      parser.error(f"duplicate layer name: {name!r}")
    layers[name] = cloudpath
  default_layer = next(iter(layers)) if len(layers) == 1 else None

  jpath = args.journal if args.journal is not None else os.environ.get(journal_mod.PATH_ENV)
  if jpath:
    worker_id = f"serve-{socket.gethostname().split('.')[0]}-{os.getpid()}"
    journal_mod.set_active(journal_mod.Journal(jpath, worker_id=worker_id))
  journal_mod.install_last_will({"role": "serve"})

  config = ServeConfig.from_env(
    ram_mb=args.ram_mb, ssd_dir=args.ssd_dir, ssd_mb=args.ssd_mb, synth_mips=args.synth,
    writeback=args.writeback, cache_control=args.cache_control,
  )
  federation = Federation.from_env(peers=args.peers, membership_dir=args.peers_file)
  app = ServeApp(layers, config=config, default_layer=default_layer,
                 federation=federation, prewarm=args.prewarm)
  server = ServeServer(app, host=args.host, port=args.port, drain_timeout=config.drain_sec)
  bound_metrics = None
  if args.metrics_port is not None:
    bound_metrics = prom.start_http_server(args.metrics_port)
    if bound_metrics is not None:
      print(f"metrics: http://0.0.0.0:{bound_metrics}/metrics")
  # the advertised URL needs the bound port (--port 0 picks one), so the
  # federation starts once the socket listens
  if federation.configured:
    adv = args.self_url or secrets.get_str("IGNEOUS_SERVE_FLEET_SELF")
    if not adv:
      adv_host = args.host
      if adv_host in ("0.0.0.0", "::", ""):
        adv_host = socket.gethostname().split(".")[0]
      adv = f"http://{adv_host}:{server.server_address[1]}"
    federation.activate(adv)
  print(json.dumps({
    "event": "serve.listening", "port": server.server_address[1],
    "host": args.host, "layers": sorted(layers),
    "metrics_port": bound_metrics,
    "self_url": federation.self_url if federation.configured else None,
  }), flush=True)

  def _on_signal(_signum, _frame):
    server.request_shutdown()

  signal.signal(signal.SIGTERM, _on_signal)
  signal.signal(signal.SIGINT, _on_signal)
  server.join()
  return 0


def _add_tune(cmd) -> None:
  cmd.add_argument("--out", default=None,
                   help="Config root to write tuned/<device_kind>.json under "
                        "(default: IGNEOUS_TUNE_CONFIG or IGNEOUS_COMPILE_CACHE).")
  cmd.add_argument("--budget", dest="budget_sec", type=float, default=None,
                   help="Wall-clock budget of the whole sweep in seconds "
                        "(default: IGNEOUS_TUNE_BUDGET_SEC; unset: none).")
  cmd.add_argument("--repeats", type=int, default=None,
                   help="Timed runs per candidate, best of (default: IGNEOUS_TUNE_REPEATS or 2).")
  cmd.add_argument("--size", type=int, default=48,
                   help="Edge length of the seeded sweep workloads.")
  cmd.add_argument("--knob", dest="only", action="append", default=[],
                   help="Sweep only this knob (repeatable; default: all).")
  cmd.add_argument("--json", dest="as_json", action="store_true",
                   help="Print the whole tuned config as JSON.")


def _run_tune(parser, args) -> int:
  """Sweep the tunable knobs (``tune.run``); refused while a swept knob is
  pinned in the environment, which would always outrank the result."""
  import json
  import os

  from . import tune

  for name in args.only:
    if name not in tune.TUNABLE:
      parser.error(f"unknown tunable {name!r}; choose from {', '.join(tune.TUNABLE)}")
  pinned = [n for n in (args.only or tune.TUNABLE) if os.environ.get(n, "").strip()]
  if pinned:
    parser.error(
      f"refusing to tune while {', '.join(pinned)} is pinned in the environment: "
      "the environment always outranks tuned configs, so the sweep could never "
      "take effect; unset it first"
    )
  config = tune.run(out=args.out, budget_sec=args.budget_sec, repeats=args.repeats,
                    size=args.size, only=args.only or None, log=print)
  if args.as_json:
    print(json.dumps(config, indent=2, sort_keys=True))
  elif config["knobs"]:
    print(f"tuned {len(config['knobs'])} knob(s): "
          + ", ".join(f"{k}={v}" for k, v in config["knobs"].items()))
  return 0


def _add_execute(cmd) -> None:
  cmd.add_argument("queue_spec", nargs="?", default=None,
                   help="fq:// or sqs:// queue [default: $QUEUE_URL].")
  cmd.add_argument("--aws-region", default=None,
                   help="AWS region of the SQS queue [default: $SQS_REGION_NAME].")
  cmd.add_argument("--lease-sec", type=int, default=None,
                   help="Visibility timeout [default: $LEASE_SECONDS or 600].")
  cmd.add_argument("--tally", dest="tally", action="store_true", default=True,
                   help="Tally completed fq:// tasks (default).")
  cmd.add_argument("--no-tally", dest="tally", action="store_false")
  cmd.add_argument("-n", "--num-tasks", type=int, default=None,
                   help="Stop after N tasks.")
  cmd.add_argument("-x", "--exit-on-empty", action="store_true")
  cmd.add_argument("--min-sec", type=float, default=-1.0,
                   help="Keep polling at least this long (<0: forever; 0: at "
                        "most one task).")
  cmd.add_argument("-q", "--quiet", action="store_true",
                   help="Suppress per-task status messages.")
  cmd.add_argument("--time", dest="timing", action="store_true",
                   help="Log per-task (per-round with --batch) wall time and "
                        "stages as JSON lines.")
  cmd.add_argument("--batch", dest="batch_size", type=int, default=1,
                   help="Lease up to K compatible tasks per round and run "
                        "their device stage as one dispatch; each lease still "
                        "completes or recycles on its own.")
  cmd.add_argument("--max-deliveries", type=int, default=None,
                   help="Quarantine a task in the queue's dlq/ after this many "
                        "deliveries [default: retry forever].")
  cmd.add_argument("--task-deadline", type=float, default=None,
                   help="Per-task wall-clock deadline in seconds; an overrun "
                        "counts as a failed delivery.")
  cmd.add_argument("--heartbeat-sec", type=float, default=None,
                   help="Renew held leases at this interval [default: "
                        "$IGNEOUS_HEARTBEAT_SEC or lease/3; 0 disables].")
  cmd.add_argument("--drain-sentinel", default=None,
                   help="Drain (finish the task in flight, release the rest, "
                        "exit 83) when this file appears [default: "
                        "$IGNEOUS_PREEMPT_SENTINEL; SIGTERM, SIGINT and "
                        "$IGNEOUS_PREEMPT_URL drain too].")
  cmd.add_argument("--pipeline", dest="pipeline", action="store_true", default=None,
                   help="Thread each task's chunk encodes and uploads (joined "
                        "before every lease delete) [default: $IGNEOUS_PIPELINE].")
  cmd.add_argument("--no-pipeline", dest="pipeline", action="store_false")
  cmd.add_argument("--metrics-port", type=int, default=None,
                   help="Serve Prometheus text metrics on this port (/metrics; "
                        "0 picks a free port) [default: $IGNEOUS_METRICS_PORT; "
                        "unset disables].")
  cmd.add_argument("--journal", dest="journal_path", default=None,
                   help="Where to append fleet journal segments [default: "
                        "$IGNEOUS_JOURNAL, else <queue>/journal/ for fq:// "
                        "queues].")


def _run_execute(parser, args) -> int:
  """The worker: lease -> run -> delete (``queues.poll_loop``, or the
  lease batcher with ``--batch K``). ``-p N`` spawns N workers and
  forwards a drain request (SIGTERM, SIGINT) to each; a drained worker
  exits 83 (``lifecycle.EXIT_PREEMPTED``)."""
  import os

  from . import lifecycle, secrets
  from .device import get_device

  queue_spec = args.queue_spec or secrets.queue_url()
  if not queue_spec:
    parser.error("provide QUEUE_SPEC or set $QUEUE_URL")
  lease_sec = secrets.lease_seconds() if args.lease_sec is None else args.lease_sec
  if args.aws_region:
    os.environ["SQS_REGION_NAME"] = args.aws_region
  if args.pipeline is not None:
    # the environment, so that spawned workers inherit the choice
    os.environ["IGNEOUS_PIPELINE"] = "1" if args.pipeline else "off"
  if args.journal_path is not None:
    secrets.set_env("IGNEOUS_JOURNAL", args.journal_path)  # children too
  if args.metrics_port is not None:
    # several workers each need a port of their own: 0 lets the OS pick
    secrets.set_env("IGNEOUS_METRICS_PORT",
                    0 if args.parallel > 1 else args.metrics_port)
  worker_args = (
    queue_spec, lease_sec, args.num_tasks, args.exit_on_empty, args.min_sec,
    args.timing, args.quiet, args.batch_size, args.max_deliveries,
    args.task_deadline, args.heartbeat_sec, args.drain_sentinel,
  )
  # resolved here, so a worker without CUDA raises before anything leases
  device = str(get_device())
  if args.parallel <= 1:
    return _execute_worker(*worker_args)

  import multiprocessing as mp
  import time

  ctx = mp.get_context("spawn")
  procs = [
    ctx.Process(target=_execute_child, args=(device,) + worker_args)
    for _ in range(args.parallel)
  ]
  for p in procs:
    p.start()
  flag = lifecycle.StopFlag()
  restore = lifecycle.install_signal_handlers(flag)
  try:
    while any(p.is_alive() for p in procs):
      if flag.is_set():
        for p in procs:
          if p.is_alive():
            p.terminate()  # SIGTERM: the child's own drain path
        break
      time.sleep(0.2)
    for p in procs:
      p.join()
  finally:
    restore()
  codes = [p.exitcode for p in procs]
  if flag.is_set() or lifecycle.EXIT_PREEMPTED in codes:
    return lifecycle.EXIT_PREEMPTED
  return 0 if all(c == 0 for c in codes) else 1


def _execute_child(device: str, *worker_args) -> None:
  """A spawned worker: the parent's device, then the worker loop."""
  import sys

  from .device import set_device

  set_device(device)
  sys.exit(_execute_worker(*worker_args))


def _execute_worker(queue_spec, lease_sec, num_tasks, exit_on_empty, min_sec,
                    timing=False, quiet=False, batch_size=1,
                    max_deliveries=None, task_deadline=None,
                    heartbeat_sec=None, drain_sentinel=None) -> int:
  import time

  from . import lifecycle
  from .queues import TaskQueue

  import igneous_tpu_torch.tasks  # noqa: F401  (registers the port's tasks)
  from .observability import device as device_mod
  from .observability import journal as journal_mod
  from .observability import metrics, prom

  flag = lifecycle.StopFlag()
  restore = lifecycle.install_signal_handlers(flag)
  watcher = lifecycle.PreemptionWatcher(flag, sentinel=drain_sentinel)
  watcher.start()
  tq = TaskQueue(queue_spec, max_deliveries=max_deliveries)

  # the journal (fq:// queues: <queue>/journal by default), the device
  # ledger's records and the profiler trigger on its flush cadence, and a
  # last will so even a crashing worker leaves its counters and last
  # span batch behind
  jpath = journal_mod.journal_path_for(tq, queue_spec)
  if jpath:
    journal_mod.set_active(journal_mod.Journal(jpath))
    device_mod.install()
  journal_mod.install_last_will({"queue": queue_spec})
  # the liveness gauge: present while this process answers scrapes
  metrics.gauge_set("worker.up", 1.0)
  bound_port = prom.start_http_server()
  if bound_port is not None and not quiet:
    print(f"metrics: http://0.0.0.0:{bound_port}/metrics", flush=True)
  start = time.time()

  def drained() -> bool:
    # with a delivery budget the worker outlives failed leases, so every
    # task ends completed or dead-lettered, not stranded mid-recycle
    if max_deliveries is None:
      return True
    try:
      return tq.enqueued == 0
    except (NotImplementedError, AttributeError):
      return True

  def stop_fn(executed: int, empty: bool) -> bool:
    if num_tasks is not None and 0 <= num_tasks <= executed:
      return True
    if min_sec == 0 and (executed >= 1 or empty):
      return True  # the special value: at most a single task
    if empty and exit_on_empty and drained():
      return True
    if empty and 0 <= min_sec <= (time.time() - start) and drained():
      return True
    return False

  try:
    if batch_size > 1:
      from .parallel.lease_batcher import poll_batched

      # --num-tasks and --min-sec 0 bound the leases, not just the rounds
      task_budget = None
      if num_tasks is not None and num_tasks >= 0:
        task_budget = num_tasks
      if min_sec == 0:
        task_budget = 1 if task_budget is None else min(task_budget, 1)
      executed, stats = poll_batched(
        tq, batch_size=batch_size, lease_seconds=lease_sec,
        verbose=not quiet, stop_fn=stop_fn, task_budget=task_budget,
        timing=timing, task_deadline_seconds=task_deadline,
        heartbeat_seconds=heartbeat_sec, drain_flag=flag,
      )
      if not quiet:
        print(
          f"executed {executed} tasks ({stats['batched']} batched in "
          f"{sum(stats['dispatches'].values())} dispatches, "
          f"{stats['solo']} solo, {stats['failed']} failed, "
          f"{stats['released']} released)", flush=True,
        )
    else:
      before_fn = after_fn = None
      if timing:
        from .telemetry import timed_poll_hooks

        before_fn, after_fn = timed_poll_hooks()
      executed = tq.poll(
        lease_seconds=lease_sec, verbose=not quiet, stop_fn=stop_fn,
        before_fn=before_fn, after_fn=after_fn,
        task_deadline_seconds=task_deadline,
        heartbeat_seconds=heartbeat_sec, drain_flag=flag,
      )
      if not quiet:
        print(f"executed {executed} tasks", flush=True)
  except BaseException:
    # a crashing worker: the counters line and the journal batch land
    # now, under the real event's name
    journal_mod.fire_last_will("crash", {"queue": queue_spec})
    _end_worker_run()
    raise
  finally:
    # an audit must find the digests of everything this worker stored
    from . import integrity

    integrity.flush_all(swallow=True)
    watcher.stop()
    restore()
  try:
    if flag.is_set():
      print(f"drained ({flag.reason}) after {executed} tasks", flush=True)
      journal_mod.fire_last_will("drain", {"reason": flag.reason, "executed": executed})
      return lifecycle.EXIT_PREEMPTED
    # a clean exit: the journal's last segment lands, no counters line
    journal_mod.disarm_last_will()
    return 0
  finally:
    _end_worker_run()


def _end_worker_run() -> None:
  """The journal and the /metrics server live as long as one worker run:
  a process that runs the worker loop again (or runs anything else after
  it) writes nothing more into that run's journal."""
  from .observability import journal as journal_mod
  from .observability import prom

  journal_mod.set_active(None)
  prom.stop_http_server()


def _add_queue(queue) -> None:
  cmd = queue.add_parser("status", help="Counts of a queue.")
  cmd.add_argument("queue_spec")
  cmd.add_argument("--eta", action="store_true",
                   help="Sample throughput and estimate ETA.")
  cmd.add_argument("--sample-sec", type=float, default=10.0,
                   help="Live-sampling window for --eta; skipped entirely when "
                        "journal segments provide the throughput.")
  cmd = queue.add_parser("wait", help="Block until the queue is empty.")
  cmd.add_argument("queue_spec")
  cmd.add_argument("--interval", "--rate", dest="interval", type=float, default=5.0,
                   help="seconds between checks")
  cmd.add_argument("--timeout", type=float, default=None,
                   help="give up after this many seconds")
  cmd.add_argument("--aws-region", default=None, help="AWS region of the SQS queue.")
  cmd = queue.add_parser("release", help="Drop all leases (crashed workers' "
                                         "tasks return at once).")
  cmd.add_argument("queue_spec")
  cmd.add_argument("--reset-deliveries", action="store_true",
                   help="Also zero the delivery counts of tasks still in "
                        "rotation (fq:// only; DLQ'd tasks keep theirs).")
  for name, help_ in (("purge", "Drop every task and counter."),
                      ("rezero", "Reset the insert and completion counters.")):
    queue.add_parser(name, help=help_).add_argument("queue_spec")
  cmd = queue.add_parser("fsck", help="Audit queue consistency.")
  cmd.add_argument("queue_spec")
  cmd.add_argument("--repair", action="store_true",
                   help="Quarantine malformed tasks, recycle bad leases.")
  for name, help_ in (("cp", "Copy pending tasks between queues."),
                      ("mv", "Move pending tasks between queues.")):
    cmd = queue.add_parser(name, help=help_)
    cmd.add_argument("src")
    cmd.add_argument("dest")
  dlq = queue.add_parser("dlq", help="Dead-letter queue (fq:// only).").add_subparsers(
    dest="dlq_command", required=True)
  dlq.add_parser("ls", help="One JSON line per quarantined task.").add_argument(
    "queue_spec")
  cmd = dlq.add_parser("retry", help="Requeue with a fresh delivery budget.")
  cmd.add_argument("queue_spec")
  cmd.add_argument("--name", dest="names", action="append", default=[],
                   help="Specific task file(s); default: all.")
  dlq.add_parser("purge", help="Drop all quarantined tasks.").add_argument(
    "queue_spec")


def _run_queue(parser, args) -> int:
  """``queue status|wait|release|purge|rezero|fsck|cp|mv|dlq``, printing
  what ``igneous-tpu queue`` prints."""
  import json
  import os
  import sys
  import time

  from .queues import TaskQueue, copy_queue, move_queue

  cmd = args.command
  if cmd == "cp":
    print(f"copied {copy_queue(args.src, args.dest)} tasks")
    return 0
  if cmd == "mv":
    print(f"moved {move_queue(args.src, args.dest)} tasks")
    return 0
  if cmd == "wait" and args.aws_region:
    os.environ["SQS_REGION_NAME"] = args.aws_region
  tq = TaskQueue(args.queue_spec)
  if cmd == "status":
    print(f"inserted: {tq.inserted}")
    print(f"enqueued: {tq.enqueued}")
    print(f"leased: {tq.leased}")
    print(f"completed: {tq.completed}")
    if hasattr(tq, "queue_files"):
      print(f"queue files: {tq.queue_files}")
    if hasattr(tq, "dlq_count"):
      print(f"dead-lettered: {tq.dlq_count}")
    if hasattr(tq, "stale_leases"):
      print(f"stale leases: {tq.stale_leases}")
    if hasattr(tq, "lease_ages"):
      ages = tq.lease_ages()
      if ages:
        print(f"lease_expiry_sec (min/max): {ages[0]:.0f}/{ages[-1]:.0f}")
    if args.eta:
      from .observability import journal as journal_mod
      from .telemetry import queue_eta

      # the journal's throughput where the fleet left segments (no
      # sampling sleep); two live samples otherwise
      stats = queue_eta(tq, sample_seconds=args.sample_sec,
                        journal_path=journal_mod.journal_path_for(tq, args.queue_spec))
      print(f"tasks/sec: {stats['tasks_per_sec']} ({stats['source']})")
      print(f"eta_sec: {stats['eta_sec']}")
  elif cmd == "wait":
    deadline = None if args.timeout is None else time.monotonic() + args.timeout
    while not tq.is_empty():
      now = time.monotonic()
      if deadline is not None and now >= deadline:
        print(f"Error: queue not empty after {args.timeout}s", file=sys.stderr)
        return 1
      time.sleep(args.interval if deadline is None
                 else min(args.interval, deadline - now))
    print("queue empty")
  elif cmd == "release":
    tq.release_all()
    if args.reset_deliveries:
      if not hasattr(tq, "reset_deliveries"):
        parser.error("--reset-deliveries supports fq:// queues only")
      print(f"reset delivery counts for {tq.reset_deliveries()} tasks")
  elif cmd == "purge":
    tq.purge()
  elif cmd == "rezero":
    tq.rezero()
  elif cmd == "fsck":
    if not hasattr(tq, "fsck"):
      parser.error("fsck supports fq:// queues only")
    print(json.dumps(tq.fsck(repair=args.repair), indent=2))
  else:
    if not hasattr(tq, "dlq_ls"):
      parser.error("queue dlq supports fq:// queues only")
    if args.dlq_command == "ls":
      for rec in tq.dlq_ls():
        print(json.dumps(rec))
    elif args.dlq_command == "retry":
      print(f"requeued {tq.dlq_retry(args.names or None)} tasks")
    else:
      print(f"purged {tq.dlq_purge()} tasks")
  return 0


class _CommandError(Exception):
  """A failure the JAX CLI reports as ``Error: ...`` with exit code 1."""


def _journal_opts(cmd) -> None:
  cmd.add_argument("--journal", dest="journal_path", default=None,
                   help="Journal path override [default: $IGNEOUS_JOURNAL or "
                        "<queue>/journal/].")
  cmd.add_argument("--queue", "-q", dest="queue_spec", default=None,
                   help="Queue whose journal/ sidecar to read [default: $QUEUE_URL].")


def _health_opts(cmd) -> None:
  cmd.add_argument("--window-sec", type=float, default=None,
                   help="Analysis window [default: $IGNEOUS_HEALTH_WINDOW_SEC or 600].")
  cmd.add_argument("--stall-sec", type=float, default=None,
                   help="Flag a worker whose journal went silent this long with "
                        "backlog remaining [default: $IGNEOUS_HEALTH_STALL_SEC or 120].")
  cmd.add_argument("--straggler-ratio", type=float, default=None,
                   help="Flag a worker at p95 >= ratio x fleet median "
                        "[default: $IGNEOUS_HEALTH_STRAGGLER_RATIO or 3].")
  cmd.add_argument("--horizon-sec", type=float, default=None,
                   help="Autoscaler target: drain the backlog within this many "
                        "seconds [default: $IGNEOUS_AUTOSCALE_HORIZON_SEC or 600].")


def _add_fleet(fleet) -> None:
  cmd = fleet.add_parser("status", help="Per-stage fleet aggregates.")
  _journal_opts(cmd)
  cmd.add_argument("--json", dest="as_json", action="store_true", help="Machine-readable.")
  cmd = fleet.add_parser("trace", help="One task's merged lineage.")
  cmd.add_argument("trace_id")
  _journal_opts(cmd)
  cmd.add_argument("-o", "--out", dest="out_path", default=None,
                   help="Also write a Perfetto/Chrome trace JSON here.")
  cmd = fleet.add_parser("top", help="Slowest task executions by trace.")
  _journal_opts(cmd)
  cmd.add_argument("-n", dest="top_n", type=int, default=10)
  cmd = fleet.add_parser("devices", help="Merged per-device utilization table.")
  _journal_opts(cmd)
  cmd.add_argument("--json", dest="as_json", action="store_true", help="Machine-readable.")
  cmd = fleet.add_parser("compact", help="Fold raw journal segments into windowed rollups.")
  _journal_opts(cmd)
  cmd.add_argument("--window-sec", dest="window", type=float, default=None,
                   help="Rollup window width [default: $IGNEOUS_ROLLUP_WINDOW_SEC or 60].")
  cmd.add_argument("--min-segments", type=int, default=2,
                   help="Skip when fewer uncovered raw segments exist.")
  cmd = fleet.add_parser("gc", help="Delete raw journal segments already folded into rollups.")
  _journal_opts(cmd)
  cmd.add_argument("--retain-sec", type=float, default=None,
                   help="Keep covered raw segments at least this long "
                        "[default: $IGNEOUS_JOURNAL_RETAIN or 3600].")
  cmd = fleet.add_parser("check", help="One health evaluation; exit 2 when unhealthy.")
  _journal_opts(cmd)
  _health_opts(cmd)
  cmd.add_argument("--json", dest="as_json", action="store_true", help="Machine-readable.")
  cmd.add_argument("--out", dest="out_path", default=None,
                   help="Also write the full report JSON here.")
  cmd.add_argument("--emit-events", dest="emit_events", action="store_true", default=True,
                   help="Append structured health.* events to the journal (default).")
  cmd.add_argument("--no-emit-events", dest="emit_events", action="store_false")
  cmd.add_argument("--flags", dest="write_flags", action="store_true", default=True,
                   help="Publish <journal>/health/flags.json (default).")
  cmd.add_argument("--no-flags", dest="write_flags", action="store_false")
  cmd.add_argument("--textfile", default=None,
                   help="Write the Prometheus textfile here "
                        "[default: $IGNEOUS_METRICS_TEXTFILE].")
  cmd = fleet.add_parser("watch", help="Live fleet dashboard over the journal.")
  _journal_opts(cmd)
  _health_opts(cmd)
  cmd.add_argument("--interval", type=float, default=5.0, help="Seconds between refreshes.")
  cmd.add_argument("--iterations", type=int, default=None,
                   help="Render N frames then exit [default: until Ctrl-C].")
  cmd.add_argument("--no-clear", action="store_true",
                   help="Append frames instead of redrawing in place.")
  cmd.add_argument("--once", action="store_true", help="Render exactly one frame and exit.")
  cmd.add_argument("--json", dest="as_json", action="store_true",
                   help="Emit each frame as one JSON object.")
  _add_fleet_simulate(fleet.add_parser(
    "simulate", help="Forecast a campaign on virtual workers from mined journal history."))
  _add_fleet_autoscale(fleet.add_parser(
    "autoscale", help="Closed-loop fleet autoscaler: act on the HealthEngine's "
                      "desired_workers signal."))


def _journal_location(parser, queue_spec, journal_path) -> str:
  from . import secrets
  from .observability import journal as journal_mod
  from .queues import TaskQueue

  path = journal_path or secrets.get_str("IGNEOUS_JOURNAL")
  if path is None and queue_spec:
    path = journal_mod.journal_path_for(TaskQueue(queue_spec), queue_spec)
  if not path:
    parser.error("no journal location: pass --journal, set $IGNEOUS_JOURNAL, or give "
                 "an fq:// queue spec (whose journal/ sidecar is implied)")
  return path


def _fleet_records(parser, queue_spec, journal_path, effective=True):
  """Rollups and uncovered raw segments (``effective``), or every raw
  segment (``fleet trace`` needs the per-span detail)."""
  from .observability import fleet

  path = _journal_location(parser, queue_spec, journal_path)
  records = fleet.load_effective(path) if effective else fleet.load(path)
  if not records:
    raise _CommandError(f"no journal segments under {path}")
  return records


def _queue_depth_stats(parser, queue_spec):
  if not queue_spec:
    return None
  from .queues import TaskQueue

  try:
    tq = TaskQueue(queue_spec)
  except Exception as e:
    parser.error(f"cannot open queue {queue_spec}: {e}")
  if hasattr(tq, "depth_snapshot"):
    return tq.depth_snapshot()
  return {"backlog": getattr(tq, "backlog", None) or tq.enqueued}


def _evaluate_health(parser, args, queue_spec):
  from .observability import fleet, health

  path = _journal_location(parser, queue_spec, args.journal_path)
  records = fleet.load_effective(path)
  if not records:
    raise _CommandError(f"no journal segments under {path}")
  cfg = health.HealthConfig.from_env(
    window_sec=args.window_sec, stall_sec=args.stall_sec,
    straggler_ratio=args.straggler_ratio, horizon_sec=args.horizon_sec,
  )
  queue_stats = _queue_depth_stats(parser, queue_spec)
  return path, health.HealthEngine(cfg).evaluate(records, queue_stats), queue_stats


def _run_fleet(parser, args) -> int:
  """``fleet status|trace|top|devices|compact|gc|check|watch|simulate|
  autoscale``, printing what ``igneous-tpu fleet`` prints."""
  import sys

  try:
    if args.command == "simulate":
      return _fleet_simulate(parser, args)
    if args.command == "autoscale":
      return _fleet_autoscale(parser, args)
    return _fleet_command(parser, args)
  except _CommandError as e:
    print(f"Error: {e}", file=sys.stderr)
    return 1


def _fleet_command(parser, args) -> int:
  import json
  import sys
  import time

  from . import secrets
  from .observability import device as device_mod
  from .observability import fleet, health, perfetto, prom, rollup
  from .observability import journal as journal_mod

  queue_spec = args.queue_spec or secrets.queue_url()
  cmd = args.command
  if cmd == "status":
    st = fleet.status(_fleet_records(parser, queue_spec, args.journal_path))
    if args.as_json:
      print(json.dumps(st, indent=2))
      return 0
    print(f"workers: {len(st['workers'])} ({', '.join(st['workers'])})")
    print(f"window: {st['window_sec']}s")
    print(f"tasks: {st['tasks']} ({st['tasks_failed']} failed spans, "
          f"{st['tasks_failed_counter']} failure counters)")
    if st["tasks_per_sec"] is not None:
      print(f"tasks/sec: {st['tasks_per_sec']}")
    if st["stall_ratio"] is not None:
      print(f"stall ratio: {st['stall_ratio']}")
    print(f"zombie fences: {st['zombie_fences']}  dlq promoted: {st['dlq_promoted']}")
    surv = {k: v for k, v in st["counters"].items()
            if k.startswith(("speculation.", "steal."))}
    if surv:
      print("campaign survival: " + "  ".join(
        f"{k.split('.', 1)[1] if k.startswith('speculation.') else k} {v}"
        for k, v in sorted(surv.items())))
    print("stage                                count   total_s  p50_ms   p95_ms")
    for name, v in st["stages"].items():
      print(f"{name:<36} {v['count']:>6} {v['total_s']:>9} "
            f"{v['p50_ms']:>8} {v['p95_ms']:>8}")
    return 0
  if cmd == "trace":
    records = _fleet_records(parser, queue_spec, args.journal_path, effective=False)
    spans = fleet.trace_records(records, args.trace_id)
    if not spans:
      raise _CommandError(f"no spans recorded for trace {args.trace_id}")
    for line in fleet.render_trace(spans):
      print(line)
    if args.out_path:
      n = perfetto.dump(records, args.out_path, trace_id=args.trace_id)
      print(f"wrote {n} events to {args.out_path}")
    return 0
  if cmd == "top":
    rows = fleet.slowest_tasks(
      _fleet_records(parser, queue_spec, args.journal_path), n=args.top_n)
    if not rows:
      raise _CommandError("no task spans in the journal")
    print("dur_s     task                       attempt  trace_id")
    for r in rows:
      err = f"  ERROR={r['error']}" if r.get("error") else ""
      print(f"{r['dur_s']:>8.3f}  {r['task']:<25} {str(r['attempt'] or '-'):>7}"
            f"  {r['trace_id']}  @{r['worker']}{err}")
    return 0
  if cmd == "devices":
    ledgers = device_mod.device_ledgers(
      _fleet_records(parser, queue_spec, args.journal_path))
    if args.as_json:
      print(device_mod.report_json(ledgers))
      return 0
    for line in device_mod.render_devices(ledgers):
      print(line)
    return 0
  if cmd == "compact":
    path = _journal_location(parser, queue_spec, args.journal_path)
    print(json.dumps(rollup.compact(path, window=args.window,
                                    min_segments=args.min_segments)))
    return 0
  if cmd == "gc":
    path = _journal_location(parser, queue_spec, args.journal_path)
    print(json.dumps(rollup.gc(path, retain=args.retain_sec)))
    return 0
  if cmd == "check":
    path, report, _ = _evaluate_health(parser, args, queue_spec)
    health.publish_gauges(report)
    if args.textfile or secrets.get_str("IGNEOUS_METRICS_TEXTFILE"):
      prom.write_textfile(args.textfile)
    if args.emit_events:
      health.emit_events(
        report, journal_mod.Journal(path, worker_id=health.default_checker_id()))
    if args.write_flags:
      health.write_flags(path, report)
    if args.out_path:
      with open(args.out_path, "w") as f:
        f.write(health.report_json(report))
    if args.as_json:
      print(health.report_json(report))
    else:
      for line in health.check_lines(report):
        print(line)
    return 0 if report["healthy"] else 2
  # watch
  iterations = 1 if args.once else args.iterations
  n = 0
  while True:
    report = queue_stats = None
    try:
      _path, report, queue_stats = _evaluate_health(parser, args, queue_spec)
      lines = health.render_dashboard(report, queue_stats)
    except _CommandError as e:
      lines = [f"fleet watch: {e} (waiting...)"]
    if args.as_json:
      print(json.dumps({
        "report": report, "queue": queue_stats,
        "error": None if report is not None else lines[0],
      }))
    else:
      if not args.no_clear:
        sys.stdout.write("\x1b[2J\x1b[H")
      for line in lines:
        print(line)
    sys.stdout.flush()
    n += 1
    if iterations is not None and n >= iterations:
      return 0
    time.sleep(max(args.interval, 0.0))


def _parse_kv_spec(parser, spec, caster=float):
  out = {}
  for part in (spec or "").split(","):
    part = part.strip()
    if not part:
      continue
    if "=" not in part:
      parser.error(f"expected key=value, got {part!r}")
    k, v = part.split("=", 1)
    try:
      out[k.strip()] = caster(v)
    except ValueError:
      parser.error(f"bad value in {part!r}")
  return out


def _load_or_mine_model(mine_path, model_path, window_sec=None):
  import json

  from .observability import replay

  if model_path:
    with open(model_path) as f:
      return replay.WorkloadModel.from_dict(json.load(f))
  model = replay.mine_journal(mine_path, window_sec=window_sec)
  if not model.task_types:
    raise _CommandError(
      f"no task spans to mine under {mine_path} — run a journaled "
      "campaign first, or pass --model"
    )
  return model


def _autoscale_policy_opts(cmd) -> None:
  cmd.add_argument("--min-workers", type=int, default=None,
                   help="Fleet floor [default: $IGNEOUS_AUTOSCALE_MIN or 1].")
  cmd.add_argument("--max-workers", type=int, default=None,
                   help="Fleet ceiling [default: $IGNEOUS_AUTOSCALE_MAX or 1000].")
  cmd.add_argument("--horizon-sec", dest="as_horizon_sec", type=float, default=None,
                   help="Drain the backlog within this many seconds "
                        "[default: $IGNEOUS_AUTOSCALE_HORIZON_SEC or 600].")
  cmd.add_argument("--hysteresis", type=float, default=None,
                   help="Dead band around current size "
                        "[default: $IGNEOUS_AUTOSCALE_HYSTERESIS or 0.2].")
  cmd.add_argument("--cooldown-sec", type=float, default=None,
                   help="Min seconds between scale actions "
                        "[default: $IGNEOUS_AUTOSCALE_COOLDOWN_SEC or 60].")
  cmd.add_argument("--step-max", type=int, default=None,
                   help="Max workers added/removed per action "
                        "[default: $IGNEOUS_AUTOSCALE_STEP_MAX or uncapped].")


def _policy_from_opts(args):
  from .observability import autoscale

  return autoscale.AutoscalePolicy.from_env(
    min_workers=args.min_workers, max_workers=args.max_workers,
    horizon_sec=args.as_horizon_sec, hysteresis=args.hysteresis,
    cooldown_sec=args.cooldown_sec, step_max=args.step_max,
  )


def _actuator_opts(cmd, help_) -> None:
  cmd.add_argument("--actuator", dest="actuator_kind",
                   choices=["local", "textfile", "command"], default="local",
                   help=help_)
  cmd.add_argument("--target-file", default=None, help="Path for --actuator textfile.")


def _make_actuator(parser, args, env=None):
  from .observability import autoscale

  if args.actuator_kind == "local":
    return autoscale.LocalPoolActuator(
      args.queue_spec, worker_args=list(args.worker_args), env=env,
    )
  if args.actuator_kind == "textfile":
    if not args.target_file:
      parser.error("--actuator textfile needs --target-file")
    return autoscale.TextfileActuator(args.target_file)
  if not args.scale_command:
    parser.error("--actuator command needs --scale-command")
  return autoscale.CommandActuator(args.scale_command)


def _add_fleet_simulate(cmd) -> None:
  _journal_opts(cmd)
  cmd.add_argument("--from-journal", dest="mine_path", default=None,
                   help="Journal to mine the workload model from [default: the "
                        "--journal/--queue location].")
  cmd.add_argument("--model", dest="model_path", default=None,
                   help="Load a saved workload_model.json instead of mining.")
  cmd.add_argument("--save-model", dest="save_model_path", default=None,
                   help="Write the mined model JSON here (commit it, diff it, "
                        "re-simulate it months later).")
  cmd.add_argument("--workers", type=int, default=4)
  cmd.add_argument("--tasks", type=int, default=None,
                   help="Scale the campaign to N total tasks (mined mix "
                        "proportions kept) [default: replay the mined counts].")
  cmd.add_argument("--seed", type=int, default=0)
  cmd.add_argument("--batch-size", type=int, default=None,
                   help="Members per lease round [default: $IGNEOUS_SIM_BATCH or 1].")
  cmd.add_argument("--fail-scale", type=float, default=None,
                   help="Multiply mined failure probabilities (what-if on "
                        "fault rates) [default: $IGNEOUS_SIM_FAIL_SCALE or 1].")
  cmd.add_argument("--policy", dest="policy_mode", choices=["fixed", "auto"],
                   default="fixed",
                   help="fixed = N workers for the whole run; auto = a virtual "
                        "autoscale controller (the SAME PolicyLoop `fleet "
                        "autoscale` runs) sizes the fleet as it goes.")
  _autoscale_policy_opts(cmd)
  cmd.add_argument("--chaos", dest="chaos_spec", default=None,
                   help="Fault injection, e.g. "
                        "'preempt=1,kill=1,stragglers=2,stall=1'. Keys: "
                        "preempt, preempt_at, kill, kill_at, stragglers, "
                        "straggler_factor, stall, stall_at.")
  cmd.add_argument("--speculate", dest="sim_speculate", action="store_true",
                   help="Model cross-host straggler speculation (duplicate-issue "
                        "with first-ack-wins fencing) [default: "
                        "$IGNEOUS_SIM_SPECULATE].")
  cmd.add_argument("--steal", dest="sim_steal", action="store_true",
                   help="Model idle-worker work stealing (unstarted tails carved "
                        "off long-held rounds) [default: $IGNEOUS_SIM_STEAL].")
  cmd.add_argument("--what-if", dest="what_if_spec", default=None,
                   help="Comma-separated alternative worker counts to forecast "
                        "alongside the base run, e.g. '1,8,32'.")
  cmd.add_argument("--cost-per-worker-hour", type=float, default=0.0,
                   help="Price forecasts in $ (0 = no cost column).")
  cmd.add_argument("--emit-journal", dest="emit_path", default=None,
                   help="Write the simulated run AS journal segments here: "
                        "`fleet status|watch|top|trace` and the Perfetto "
                        "exporter work on it unchanged.")
  cmd.add_argument("--base-ts", type=float, default=0.0,
                   help="Timestamp anchor for --emit-journal (0 keeps output "
                        "bit-identical across same-seed reruns; pass a unix "
                        "time to overlay simulated history on live dashboards).")
  cmd.add_argument("--json", dest="as_json", action="store_true", help="Machine-readable.")
  cmd.add_argument("--out", dest="out_path", default=None,
                   help="Also write the full forecast JSON here (CI artifact).")


def _fleet_simulate(parser, args) -> int:
  """Forecast a campaign on virtual workers from mined journal history:
  the JAX CLI's ``fleet simulate``, the same forecast and the same
  journal bytes for the same seed, model and config."""
  import json

  from . import secrets
  from .observability import sim as sim_mod

  queue_spec = args.queue_spec or secrets.queue_url()
  mine_path = args.mine_path
  if not args.model_path:
    mine_path = mine_path or _journal_location(parser, queue_spec, args.journal_path)
  model = _load_or_mine_model(mine_path, args.model_path)
  if args.save_model_path:
    with open(args.save_model_path, "w") as f:
      json.dump(model.to_dict(), f)

  chaos = sim_mod.ChaosSpec(**{
    k: (int(v) if k in ("preempt", "kill", "stragglers", "stall") else v)
    for k, v in _parse_kv_spec(parser, args.chaos_spec).items()
  }) if args.chaos_spec else sim_mod.ChaosSpec()
  policy = _policy_from_opts(args)
  cfg = sim_mod.SimConfig.from_env(
    workers=args.workers, seed=args.seed, tasks=args.tasks,
    batch_size=args.batch_size, fail_scale=args.fail_scale, base_ts=args.base_ts,
    cost_per_worker_hour=args.cost_per_worker_hour,
    speculate=1 if args.sim_speculate else None,
    steal=1 if args.sim_steal else None,
  )
  cfg.chaos = chaos
  cfg.autoscale = args.policy_mode == "auto"
  cfg.policy = policy

  results = sim_mod.simulate(model, cfg, journal_path=args.emit_path)
  alternatives = []
  if args.what_if_spec:
    counts = [int(x) for x in args.what_if_spec.split(",") if x.strip()]
    alternatives = sim_mod.what_if(model, cfg, counts)

  payload = {
    "model": model.summary(),
    "config": {
      "workers": cfg.workers, "seed": cfg.seed,
      "batch_size": cfg.batch_size, "policy": args.policy_mode,
      "fail_scale": cfg.fail_scale, "tasks": results["tasks"],
    },
    "forecast": results,
    "what_if": alternatives,
  }
  if args.out_path:
    with open(args.out_path, "w") as f:
      json.dump(payload, f, indent=2)
  if args.as_json:
    print(json.dumps(payload, indent=2))
    return 0

  ms = model.summary()
  print(f"model: {ms['tasks_seen']} tasks mined across "
        f"{len(ms['task_types'])} type(s); round overhead p50 "
        f"{ms['round_overhead_p50_ms']}ms")
  for name, t in ms["task_types"].items():
    print(f"  {name:<30} n={t['count']:<6} p50 {t['p50_ms']}ms  "
          f"p95 {t['p95_ms']}ms  fail {t['fail_prob'] * 100:.1f}%")
  r = results
  mode = "autoscaled" if cfg.autoscale else "fixed"
  print(f"forecast ({mode}, {r['workers']} worker(s), seed {r['seed']}): "
        f"{r['tasks']} tasks in {r['makespan_sec']}s "
        f"({r['tasks_per_sec']}/s, utilization "
        f"{r['utilization'] * 100:.0f}%)")
  print(f"  completed {r['completed']}  dlq {r['dlq']}  retries "
        f"{r['failed_deliveries']}  lease recycles {r['lease_recycles']}  "
        f"released {r['released']}"
        + (f"  cost ${r['cost_usd']}" if r["cost_usd"] is not None else ""))
  spec, steals = r.get("speculation") or {}, r.get("steals") or {}
  if spec.get("issued") or steals.get("claims"):
    print(f"  campaign survival: speculated {spec.get('issued', 0)} "
          f"(won {spec.get('won', 0)}, fenced {spec.get('fenced', 0)})  "
          f"steals {steals.get('claims', 0)} "
          f"({steals.get('tasks', 0)} task(s))")
  if r["scale_events"]:
    print(f"  scale events: {len(r['scale_events'])} "
          f"(peak {r['peak_workers']} workers)")
  if not r["completed_all"]:
    print("  WARNING: campaign did not complete "
          f"(timed_out={r['timed_out']})")
  if alternatives:
    print("what-if:")
    print(f"  {'workers':>8}  {'makespan_s':>11}  {'delta':>8}  "
          f"{'dlq':>5}  {'util':>6}  cost")
    for alt in alternatives:
      delta = alt["makespan_sec"] - r["makespan_sec"]
      cost = f"${alt['cost_usd']}" if alt["cost_usd"] is not None else "-"
      print(f"  {alt['workers']:>8}  {alt['makespan_sec']:>11}  "
            f"{delta:>+8.1f}  {alt['dlq']:>5}  "
            f"{alt['utilization'] * 100:>5.0f}%  {cost}")
  if args.emit_path:
    print(f"emitted {results['journal_segments']} journal segment(s) to "
          f"{args.emit_path} (try: igneous fleet status --journal {args.emit_path})")
  return 0


def _add_fleet_autoscale(cmd) -> None:
  _journal_opts(cmd)
  _autoscale_policy_opts(cmd)
  _actuator_opts(cmd, "local = spawn/drain real `igneous execute` "
                      "subprocesses; textfile = atomically publish the "
                      "target for an external reconciler; command = shell "
                      "out to a template with {n}.")
  cmd.add_argument("--scale-command", default=None,
                   help="Template for --actuator command, e.g. "
                        "'kubectl scale --replicas={n} deploy/igneous-worker'.")
  cmd.add_argument("--worker-arg", dest="worker_args", action="append", default=[],
                   help="Extra args for spawned workers (local actuator), repeatable.")
  cmd.add_argument("--interval", type=float, default=None,
                   help="Seconds between controller ticks "
                        "[default: $IGNEOUS_AUTOSCALE_INTERVAL_SEC or 15].")
  cmd.add_argument("--iterations", type=int, default=None,
                   help="Tick N times then exit [default: until drained or Ctrl-C].")
  cmd.add_argument("--drain-exit", dest="drain_exit", action="store_true", default=True,
                   help="Exit once the backlog is empty and the pool is at "
                        "the policy floor (batch-campaign mode) (default).")
  cmd.add_argument("--no-drain-exit", dest="drain_exit", action="store_false",
                   help="Run as a service.")
  cmd.add_argument("--validate", dest="validate", action="store_true", default=True,
                   help="Before touching the fleet, replay the mined journal "
                        "through the simulator under THIS policy and abort if "
                        "the simulated campaign fails to complete (default).")
  cmd.add_argument("--no-validate", dest="validate", action="store_false")
  cmd.add_argument("--json", dest="as_json", action="store_true",
                   help="One JSON object per controller decision.")


def _fleet_autoscale(parser, args) -> int:
  """The JAX CLI's ``fleet autoscale``: each tick reads the journal and
  the live queue depth, runs the policy formula the health report and
  the simulator use, damps it and actuates. Scale-down is always a
  graceful SIGTERM drain."""
  import json
  import sys
  import time

  from . import secrets
  from .observability import autoscale, replay, sim as sim_mod
  from .queues import TaskQueue

  args.queue_spec = args.queue_spec or secrets.queue_url()
  if not args.queue_spec:
    parser.error("fleet autoscale needs a queue (-q or $QUEUE_URL): backlog "
                 "drives the policy")
  path = _journal_location(parser, args.queue_spec, args.journal_path)
  policy = _policy_from_opts(args)
  if args.validate:
    try:
      model = replay.mine_journal(path)
    except Exception:
      model = None
    if model and model.task_types:
      cfg = sim_mod.SimConfig.from_env(workers=policy.min_workers)
      cfg.autoscale = True
      cfg.policy = policy
      forecast = sim_mod.simulate(model, cfg)
      if not forecast["completed_all"]:
        raise _CommandError(
          "policy validation failed: the simulated campaign did not "
          f"complete (dlq={forecast['dlq']}, "
          f"timed_out={forecast['timed_out']}). Loosen the policy or "
          "pass --no-validate."
        )
      print(f"policy validated in simulation: {forecast['tasks']} tasks in "
            f"{forecast['makespan_sec']}s, peak {forecast['peak_workers']} "
            f"worker(s), {len(forecast['scale_events'])} scale event(s)",
            file=sys.stderr)
    else:
      print("policy validation skipped: no task history to mine yet", file=sys.stderr)

  actuator = _make_actuator(parser, args)
  controller = autoscale.AutoscaleController(
    path, TaskQueue(args.queue_spec), actuator,
    policy=policy, interval_sec=args.interval,
  )
  n = 0
  try:
    while True:
      decision = controller.step()
      if args.as_json:
        print(json.dumps(decision), flush=True)
      else:
        print(f"[{time.strftime('%H:%M:%S')}] backlog "
              f"{decision['backlog']}  rate {decision['per_worker_rate']}/s"
              f"/worker  {decision['current']} -> {decision['target']} "
              f"({decision['reason']})", flush=True)
      n += 1
      actuator.reap()
      if (
        args.drain_exit and decision["backlog"] <= 0
        and actuator.current() <= policy.min_workers
        and n > 1
      ):
        break
      if args.iterations is not None and n >= args.iterations:
        break
      time.sleep(controller.interval_sec)
  finally:
    actuator.shutdown()
  summary = {
    "ticks": n,
    "actions": sum(1 for d in controller.history if d["actuated"]),
  }
  if isinstance(actuator, autoscale.LocalPoolActuator):
    summary["spawned"] = actuator.stats["spawned"]
    summary["drained"] = actuator.stats["drained"]
    summary["exits"] = actuator.stats["exits"]
  print(json.dumps(summary))
  return 0


def _add_campaign(campaign) -> None:
  cmd = campaign.add_parser(
    "run", help="Run a campaign to completion on a hostile fleet.")
  _journal_opts(cmd)
  _autoscale_policy_opts(cmd)
  cmd.add_argument("--tick-sec", type=float, default=None,
                   help="Seconds between driver ticks "
                        "[default: $IGNEOUS_CAMPAIGN_TICK_SEC or 5].")
  cmd.add_argument("--max-wall-sec", type=float, default=None,
                   help="Abort (gracefully) after this much wall clock "
                        "[default: $IGNEOUS_CAMPAIGN_MAX_WALL_SEC; 0 = never].")
  cmd.add_argument("--iterations", type=int, default=None,
                   help="Tick N times then exit [default: until drained].")
  cmd.add_argument("--speculate", dest="speculate", action="store_true", default=None,
                   help="Twin the tails of flagged/slow holders' range leases "
                        "[default: $IGNEOUS_CAMPAIGN_SPECULATE or on].")
  cmd.add_argument("--no-speculate", dest="speculate", action="store_false")
  cmd.add_argument("--steal", dest="steal", action="store_true", default=None,
                   help="Let idle workers claim unstarted sub-ranges off "
                        "long-held range leases [default: $IGNEOUS_STEAL or off].")
  cmd.add_argument("--no-steal", dest="steal", action="store_false")
  cmd.add_argument("--worker-arg", dest="worker_args", action="append", default=[],
                   help="Extra args for spawned workers, repeatable "
                        "(e.g. --worker-arg=--batch-size=4).")
  _actuator_opts(cmd, "How scale actions reach the fleet (see fleet autoscale).")
  cmd.add_argument("--scale-command", default=None,
                   help="Template for --actuator command with {n}.")
  cmd.add_argument("--json", dest="as_json", action="store_true",
                   help="One JSON object per tick + a summary object.")


def _run_campaign(parser, args) -> int:
  """``campaign run``: autoscale sizes the fleet, health flags route queue
  depth away from stragglers, speculation twins their unfinished tails,
  and (with ``--steal``) idle workers carve unstarted sub-ranges off
  long-held leases. Exits 0 once the queue is drained, 3 when it timed
  out or left work behind."""
  import json
  import time

  from . import secrets
  from .observability import campaign as campaign_mod
  from .queues import TaskQueue

  args.queue_spec = args.queue_spec or secrets.queue_url()
  if not args.queue_spec:
    parser.error("campaign run needs a queue (-q or $QUEUE_URL)")
  path = _journal_location(parser, args.queue_spec, args.journal_path)
  policy = _policy_from_opts(args)
  worker_env = {}
  if args.steal is not None:
    # ship the steal knob into every worker this command spawns; the
    # command itself never steals (it holds no leases)
    secrets.set_env("IGNEOUS_STEAL", "1" if args.steal else "0")
    worker_env["IGNEOUS_STEAL"] = "1" if args.steal else "0"
  actuator = _make_actuator(parser, args, env=worker_env or None)
  runner = campaign_mod.CampaignRunner(
    path, TaskQueue(args.queue_spec), actuator,
    policy=policy, tick_sec=args.tick_sec, speculate=args.speculate,
    max_wall_sec=args.max_wall_sec,
  )

  def narrate(sleep_sec):
    d = runner.history[-1]
    if args.as_json:
      print(json.dumps(d), flush=True)
    else:
      extras = ""
      if d["speculated"]:
        extras += f"  speculated {d['speculated']}"
      if d["flagged"]:
        extras += f"  flagged {','.join(d['flagged'])}"
      print(f"[{time.strftime('%H:%M:%S')}] backlog {d['backlog']}  "
            f"workers {d['current']} -> {d['target']} ({d['reason']})"
            + extras, flush=True)
    time.sleep(sleep_sec)

  summary = runner.run(iterations=args.iterations, sleep_fn=narrate)
  print(json.dumps(summary if args.as_json else {
    k: v for k, v in summary.items() if k != "fleet_status"
  }))
  if summary["timed_out"] or summary["queue"].get("enqueued", 0) > 0:
    return 3
  return 0


def _add_profile(profile) -> None:
  cmd = profile.add_parser("capture", help="Trigger a bounded profiler capture on "
                                           "fleet workers.")
  _journal_opts(cmd)
  cmd.add_argument("--duration", type=float, default=5.0,
                   help="Seconds of device activity to capture.")
  cmd.add_argument("--worker", dest="workers", action="append", default=[],
                   help="Restrict the trigger to these worker ids "
                        "[default: every worker captures once].")
  cmd.add_argument("--wait", type=float, default=0.0,
                   help="Poll up to this many seconds for artifacts to land "
                        "before returning (0 = fire and forget).")
  cmd.add_argument("--local", action="store_true",
                   help="Capture in THIS process instead of publishing a worker "
                        "trigger.")
  _journal_opts(profile.add_parser(
    "ls", help="List captured profile artifacts under <journal>/profiles/."))


def _run_profile(parser, args) -> int:
  """``profile capture|ls``: the request file workers poll on their
  journal cadence, and the Chrome traces they upload."""
  import os
  import sys
  import time

  from . import secrets
  from .observability import device as device_mod
  from .observability import journal as journal_mod

  path = _journal_location(parser, args.queue_spec or secrets.queue_url(),
                           args.journal_path)
  if args.command == "ls":
    keys = device_mod.list_profiles(path)
    if not keys:
      print("no profile artifacts")
    for key in keys:
      print(key)
    return 0
  if args.local:
    j = journal_mod.Journal(path, worker_id=f"profile-cli-{os.getpid()}")
    device_mod._capture_blocking(args.duration, j, "manual", None)
    for key in device_mod.list_profiles(path):
      print(key)
    return 0
  req = device_mod.write_profile_request(
    path, duration_sec=args.duration, workers=args.workers or None)
  print(f"published capture request {req['id']} ({args.duration}s) at "
        f"{path}/{device_mod.PROFILE_REQUEST_KEY}")
  if args.wait <= 0:
    return 0
  deadline = time.monotonic() + args.wait
  prefix = device_mod.PROFILE_ARTIFACT_PREFIX
  while time.monotonic() < deadline:
    found = [k for k in device_mod.list_profiles(path) if req["id"] in k]
    if found:
      print(f"{len(found)} artifact file(s):")
      for key in found:
        print(f"  {prefix}{key}" if not key.startswith(prefix) else f"  {key}")
      return 0
    time.sleep(1.0)
  print(f"Error: no artifacts for request {req['id']} within {args.wait}s (are "
        "workers running with a journal?)", file=sys.stderr)
  return 1


def _add_audit(cmd) -> None:
  cmd.add_argument("path")
  cmd.add_argument("--queue", "-q", dest="queue_spec", default=None,
                   help="fq:// queue to fan the audit grid through (this process "
                        "drains it); runs locally if omitted.")
  cmd.add_argument("--mip", dest="mips", action="append", type=int, default=[],
                   help="Mip level(s) to audit [default: every mip the layer's "
                        "recorded downsample campaign produced].")
  cmd.add_argument("--report-dir", default=None,
                   help="Findings location [default: <path>/integrity/audit].")
  cmd.add_argument("--out", default=None,
                   help="Also write the report JSON to this local file.")
  cmd.add_argument("--heal", action="store_true",
                   help="Re-run the producing DownsampleTask of each damaged cell "
                        "and audit again, until clean or --max-rounds.")
  cmd.add_argument("--max-rounds", type=int, default=5, help="Heal rounds at most.")
  cmd.add_argument("--no-digest", action="store_true",
                   help="Skip the manifest digest checks (presence and decode only).")
  cmd.add_argument("--allow-missing", action="store_true",
                   help="Missing chunks are not findings.")
  cmd.add_argument("--lease-sec", type=float, default=60.0)
  cmd.add_argument("--drain-sec", type=float, default=600.0,
                   help="Deadline for each queued round to drain.")


def _audit_round(path, mips, report_dir, queue_spec, parallel,
                 check_digest, require_present, lease_sec, drain_sec):
  """One audit pass: the grid of every mip, drained; its findings."""
  from . import integrity
  from .task_creation.audit import create_integrity_audit_tasks, load_findings

  integrity.flush_all()
  for mip in mips:
    enqueue(queue_spec, create_integrity_audit_tasks(
      path, mip=mip, report_dir=report_dir,
      check_digest=check_digest, require_present=require_present,
    ), parallel)
  if queue_spec is not None:
    _drain_inline(queue_spec, lease_sec, drain_sec)
  return load_findings(report_dir)


def _drain_inline(queue_spec, lease_sec, deadline_sec) -> None:
  """Lease, run and delete the queue's tasks in this process until it is
  empty (workers leasing the same queue just finish it sooner)."""
  import time

  from .queues import TaskQueue

  import igneous_tpu_torch.tasks  # noqa: F401  (registers the port's tasks)

  tq = TaskQueue(queue_spec)
  deadline = time.monotonic() + deadline_sec

  def stop_fn(executed, empty):
    return (empty and tq.enqueued == 0) or time.monotonic() > deadline

  tq.poll(lease_seconds=lease_sec, verbose=False, stop_fn=stop_fn,
          max_backoff_window=0.25)
  if tq.enqueued > 0:
    raise SystemExit(
      f"Error: audit queue failed to drain within {deadline_sec:.0f}s "
      f"({tq.enqueued} tasks left)"
    )


def _run_audit(args) -> int:
  """Replay PATH's chunk grid against the write envelope and report every
  missing, undecodable or digest-mismatched chunk: exit 0 when complete
  and intact, 2 while findings remain (each printed as a CORRUPT line).
  ``--heal`` re-runs the producing DownsampleTask of exactly the damaged
  cells and audits again; a finding with no producer is UNHEALABLE."""
  import json
  import sys
  import time

  from . import chunk_cache, integrity
  from .storage import CloudFiles
  from .task_creation.audit import downsample_provenance, downsample_repair_tasks
  from .volume import Volume

  path = args.path.rstrip("/")
  report_dir = args.report_dir or f"{path}/{integrity.INTEGRITY_PREFIX}/audit"
  prov = downsample_provenance(Volume(path, mip=0))
  if args.mips:
    mips = sorted(set(args.mips))
  elif prov is not None:
    src = int(prov["mip"])
    mips = list(range(src + 1, src + int(prov["num_mips"]) + 1))
  else:
    print("Error: no recorded downsample campaign in provenance: pass --mip "
          "explicitly to name the levels to audit", file=sys.stderr)
    return 1

  round_args = (path, mips, report_dir, args.queue_spec, args.parallel,
                not args.no_digest, not args.allow_missing, args.lease_sec,
                args.drain_sec)
  findings, totals = _audit_round(*round_args)
  rounds = 1
  repaired = 0
  while findings and args.heal and rounds <= args.max_rounds:
    tasks, unhealable = downsample_repair_tasks(path, findings, prov)
    if unhealable:
      for f in unhealable:
        print(f"UNHEALABLE {f['kind']} mip={f['mip']} {f['key']}")
      break
    if not tasks:
      break
    print(f"heal round {rounds}: {len(findings)} findings -> {len(tasks)} repair tasks",
          flush=True)
    enqueue(args.queue_spec, tasks, args.parallel)
    if args.queue_spec is not None:
      _drain_inline(args.queue_spec, args.lease_sec, args.drain_sec)
    repaired += len(tasks)
    # repaired chunks are read afresh
    for mip in mips:
      chunk_cache.invalidate(path, mip)
    findings, totals = _audit_round(*round_args)
    rounds += 1

  report = {
    "layer": path,
    "mips": list(mips),
    "rounds": rounds,
    "repair_tasks": repaired,
    "chunks_checked": totals["chunks"],
    "unmanifested": totals["unmanifested"],
    "findings": findings,
    "complete": not findings,
    "ts": time.time(),
  }
  CloudFiles(report_dir).put_json("report.json", report)
  if args.out:
    with open(args.out, "w") as f:
      json.dump(report, f, indent=2, sort_keys=True)

  for f in findings:
    print(f"CORRUPT {f['kind']} mip={f['mip']} {f['key']}")
  print(
    f"audited {totals['chunks']} chunks across mips {list(mips)}: "
    + ("complete and intact" if not findings else f"{len(findings)} findings")
    + (f" ({repaired} repair tasks over {rounds} rounds)" if repaired else "")
  )
  return 2 if findings else 0


def _add_xfer(cmd) -> None:
  cmd.add_argument("src")
  cmd.add_argument("dest")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--chunk-size", type=_tuple3, default=None)
  cmd.add_argument("--shape", type=_tuple3, default=None,
                   help="(overrides --memory) Task shape in voxels.")
  cmd.add_argument("--translate", type=_tuple3, default=(0, 0, 0))
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--sharded", action="store_true",
                   help="Write the destination scale sharded.")
  _encoding_opts(cmd)
  cmd.add_argument("--downsample", dest="do_downsample", action="store_true",
                   default=True, help="Produce downsamples from transfer tiles (default).")
  cmd.add_argument("--skip-downsample", dest="do_downsample", action="store_false")
  cmd.add_argument("--max-mips", type=int, default=5,
                   help="Maximum number of additional pyramid levels.")
  cmd.add_argument("--num-mips", type=int, default=None,
                   help="Deprecated alias for --max-mips.")
  cmd.add_argument("--memory", dest="memory_target", type=int, default=int(3.5e9))
  cmd.add_argument("--sparse", action="store_true")
  cmd.add_argument("--volumetric", action="store_true", help="Use 2x2x2 downsampling.")
  cmd.add_argument("--method", "--downsample-method", dest="downsample_method",
                   default="auto")
  cmd.add_argument("--delete-bg", action="store_true")
  cmd.add_argument("--bg-color", type=int, default=0)
  cmd.add_argument("--dest-voxel-offset", type=_tuple3, default=None,
                   help="Set the new volume's global origin.")
  cmd.add_argument("--clean-info", action="store_true",
                   help="Scrub mesh/skeleton fields from the new info.")
  cmd.add_argument("--no-src-update", action="store_true",
                   help="Skip the source provenance note.")
  cmd.add_argument("--truncate-scales", dest="truncate_scales", action="store_true",
                   default=True, help="Drop source scales above --mip in the new info (default).")
  cmd.add_argument("--no-truncate-scales", dest="truncate_scales", action="store_false")
  cmd.add_argument("--use-https-src", action="store_true",
                   help="Implies --no-src-update.")
  _range_opts(cmd)
  cmd.add_argument("--bounds-mip", type=int, default=None,
                   help="Mip the ranges are specified in [default: --mip].")
  cmd.add_argument("--cutout", action="store_true",
                   help="Restrict a newly created volume to the given bounds.")


def _run_xfer(args) -> int:
  from .task_creation import create_image_shard_transfer_tasks, create_transfer_tasks

  bounds_mip = args.mip if args.bounds_mip is None else args.bounds_mip
  bounds = _cli_bounds(args.src, bounds_mip, args)
  max_mips = args.max_mips if args.num_mips is None else args.num_mips
  if not args.do_downsample:
    max_mips = 0
  if args.sharded:
    tasks = create_image_shard_transfer_tasks(
      args.src, args.dest, mip=args.mip, chunk_size=args.chunk_size,
      encoding=args.encoding, encoding_level=args.encoding_level,
      encoding_effort=args.encoding_effort, translate=args.translate,
      fill_missing=args.fill_missing, dest_voxel_offset=args.dest_voxel_offset,
      bounds=bounds, bounds_mip=bounds_mip,
      uncompressed_shard_bytesize=args.memory_target, cutout=args.cutout,
      clean_info=args.clean_info, truncate_scales=args.truncate_scales,
    )
    enqueue(args.queue, tasks, args.parallel)
    return 0
  tasks = create_transfer_tasks(
    args.src, args.dest, chunk_size=args.chunk_size, shape=args.shape,
    mip=args.mip, translate=args.translate, fill_missing=args.fill_missing,
    encoding=args.encoding, encoding_level=args.encoding_level,
    encoding_effort=args.encoding_effort,
    compress=_resolve_compress(args.compress, args.encoding),
    num_mips=max_mips, memory_target=args.memory_target, sparse=args.sparse,
    factor=(2, 2, 2) if args.volumetric else None,
    downsample_method=args.downsample_method,
    delete_black_uploads=args.delete_bg, background_color=args.bg_color,
    dest_voxel_offset=args.dest_voxel_offset, clean_info=args.clean_info,
    no_src_update=args.no_src_update, truncate_scales=args.truncate_scales,
    use_https_for_source=args.use_https_src,
    bounds=bounds, bounds_mip=bounds_mip, cutout=args.cutout,
  )
  enqueue(args.queue, tasks, args.parallel)
  return 0


def _add_rm(cmd) -> None:
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--num-mips", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=None, help="Task shape in voxels.")
  _range_opts(cmd)


def _run_rm(args) -> int:
  from .task_creation import create_deletion_tasks

  enqueue(args.queue, create_deletion_tasks(
    args.path, mip=args.mip, num_mips=args.num_mips, shape=args.shape,
    bounds=_cli_bounds(args.path, args.mip, args), bounds_mip=args.mip,
  ), args.parallel)
  return 0


def _bounds_mip_opt(cmd) -> None:
  cmd.add_argument("--bounds-mip", type=int, default=None,
                   help="Mip the ranges are specified in [default: --mip].")


def _add_contrast(contrast) -> None:
  cmd = contrast.add_parser("histogram", help="Phase 1: per-z luminance histograms.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--coverage", type=float, default=0.01)
  cmd.add_argument("--fill-missing", action="store_true")
  _range_opts(cmd)
  _bounds_mip_opt(cmd)
  cmd = contrast.add_parser("equalize",
                            help="Phase 2: histogram stretch using phase-1 levels.")
  cmd.add_argument("src")
  cmd.add_argument("dest")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--clip-fraction", type=float, default=0.01)
  cmd.add_argument("--shape", type=_tuple3, default=None)
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--minval", type=int, default=0, help="Stretch floor value.")
  cmd.add_argument("--maxval", type=int, default=255, help="Stretch ceiling value.")
  cmd.add_argument("--translate", type=_tuple3, default=(0, 0, 0))
  _range_opts(cmd)
  _bounds_mip_opt(cmd)
  cmd = contrast.add_parser("clahe", help="Contrast-limited adaptive histogram equalization.")
  cmd.add_argument("src")
  cmd.add_argument("dest")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--clip-limit", type=float, default=40.0)
  cmd.add_argument("--tile-grid-size", "--tile-grid", dest="tile_grid", type=_tuple2or1,
                   default=(8, 8), help="Size of the adaptive grid: 8 or 8,8.")
  cmd.add_argument("--shape", type=_tuple3, default=(2048, 2048, 64))
  cmd.add_argument("--fill-missing", action="store_true")
  _range_opts(cmd)
  _bounds_mip_opt(cmd)


def _run_contrast(args) -> int:
  from . import task_creation as tc

  cmd = args.contrast_command
  path = args.path if cmd == "histogram" else args.src
  bounds_mip = args.mip if args.bounds_mip is None else args.bounds_mip
  bounds = _cli_bounds(path, bounds_mip, args)
  if cmd == "histogram":
    tasks = tc.create_luminance_levels_tasks(
      path, mip=args.mip, coverage_factor=args.coverage,
      fill_missing=args.fill_missing, bounds=bounds, bounds_mip=bounds_mip,
    )
  elif cmd == "equalize":
    tasks = tc.create_contrast_normalization_tasks(
      args.src, args.dest, mip=args.mip, clip_fraction=args.clip_fraction,
      shape=args.shape, fill_missing=args.fill_missing, minval=args.minval,
      maxval=args.maxval, translate=args.translate, bounds=bounds,
      bounds_mip=bounds_mip,
    )
  else:
    tasks = tc.create_clahe_tasks(
      args.src, args.dest, mip=args.mip, clip_limit=args.clip_limit,
      tile_grid_size=args.tile_grid, shape=args.shape,
      fill_missing=args.fill_missing, bounds=bounds, bounds_mip=bounds_mip,
    )
  enqueue(args.queue, tasks, args.parallel)
  return 0


def _add_roi(cmd) -> None:
  cmd.add_argument("path")
  cmd.add_argument("--threshold", type=float, default=0.0)
  cmd.add_argument("--dust", type=int, default=100,
                   help="Suppress components smaller than this many voxels.")
  cmd.add_argument("--suppress-faint", type=int, default=0,
                   help="Voxels at or below this value become background.")
  cmd.add_argument("--max-axial-len", type=int, default=512,
                   help="Downsample in memory until XY fits this square.")
  cmd.add_argument("--z-step", type=int, default=None,
                   help="Evaluate ROIs per z-slab of this depth.")
  cmd.add_argument("--progress", action="store_true")


def _run_roi(args) -> int:
  from . import task_creation as tc

  rois = tc.compute_rois(
    args.path, threshold=args.threshold, dust_threshold=args.dust,
    suppress_faint_voxels=args.suppress_faint,
    max_axial_length=args.max_axial_len, z_step=args.z_step,
    progress=args.progress,
  )
  for roi in rois:
    print(str(roi))
  print(f"{len(rois)} ROI detected. info file updated.")
  return 0


def _add_reorder(cmd) -> None:
  cmd.add_argument("src")
  cmd.add_argument("dest")
  cmd.add_argument("mapping_json", nargs="?", default=None,
                   help="JSON file of {dest_z: src_z}.")
  cmd.add_argument("--mapping-file", default=None,
                   help="JSON file of {dest_z: src_z} (flag form).")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--encoding", default=None)
  cmd.add_argument("--encoding-level", type=int, default=None)
  cmd.add_argument("--encoding-effort", type=int, default=None,
                   help="(jpeg xl) accepted for parity; jxl is not shipped.")
  cmd.add_argument("--compress", default="gzip")
  cmd.add_argument("--delete-bg", action="store_true")
  cmd.add_argument("--bg-color", type=int, default=0)


def _run_reorder(parser, args) -> int:
  import json
  import os

  from . import task_creation as tc

  path = args.mapping_json or args.mapping_file
  if not path:
    parser.error("provide MAPPING_JSON or --mapping-file")
  if not os.path.exists(path):
    parser.error(f"mapping file {path!r} does not exist")
  with open(path) as f:
    mapping = json.load(f)
  enqueue(args.queue, tc.create_reordering_tasks(
    args.src, args.dest, mapping, mip=args.mip, fill_missing=args.fill_missing,
    encoding=args.encoding, encoding_level=args.encoding_level,
    compress=_resolve_compress(args.compress, args.encoding),
    delete_black_uploads=args.delete_bg, background_color=args.bg_color,
  ), args.parallel)
  return 0


def _add_create(cmd) -> None:
  cmd.add_argument("src")
  cmd.add_argument("dest")
  cmd.add_argument("--resolution", type=_tuple3, default=(1, 1, 1))
  cmd.add_argument("--offset", type=_tuple3, default=(0, 0, 0))
  cmd.add_argument("--chunk-size", type=_tuple3, default=(64, 64, 64))
  cmd.add_argument("--layer-type", default=None, choices=["image", "segmentation"])
  cmd.add_argument("--seg", action="store_true",
                   help="Shorthand for --layer-type segmentation.")
  cmd.add_argument("--encoding", default="raw")
  cmd.add_argument("--encoding-level", type=int, default=None,
                   help="png level / jpeg quality.")
  cmd.add_argument("--encoding-effort", type=int, default=None,
                   help="(jpeg xl) accepted for parity; jxl is not shipped.")
  cmd.add_argument("--compress", default="gzip",
                   help="Chunk compression: none, gzip, br.")
  cmd.add_argument("--h5-dataset", default="main",
                   help="Which h5 dataset to access (hdf5 imports only).")


def _run_create(parser, args) -> int:
  from .formats import load_volume_file
  from .volume import Volume

  layer_type = "segmentation" if args.seg else args.layer_type
  try:
    arr = load_volume_file(args.src, h5_dataset=args.h5_dataset)
  except (ValueError, OSError) as e:  # OSError: corrupt gzip members
    parser.error(str(e))
  Volume.from_numpy(
    arr, args.dest, resolution=args.resolution, voxel_offset=args.offset,
    chunk_size=args.chunk_size, layer_type=layer_type, encoding=args.encoding,
    encoding_level=args.encoding_level,
    compress=_resolve_compress(args.compress, args.encoding),
  )
  print(f"Created {args.dest} from {args.src} {arr.shape} {arr.dtype}")
  return 0


def _add_spatial_index(group, dir_flag: str, shape) -> None:
  sub = group.add_parser("spatial-index", help="Spatial-index maintenance.").add_subparsers(
    dest="spatial_index_command", required=True)
  cmd = sub.add_parser("create", help="Rebuild the .spatial files from the segmentation.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=shape)
  cmd.add_argument(dir_flag, dest="index_dir", default=None)
  cmd.add_argument("--fill-missing", action="store_true")
  cmd = sub.add_parser("db", help="Materialize the spatial index into a sqlite database.")
  cmd.add_argument("path")
  cmd.add_argument("db_path")
  cmd.add_argument(dir_flag, dest="index_dir", default=None)
  cmd.add_argument("--progress", action="store_true",
                   help="Print the cells read to stderr.")
  cmd.add_argument("--allow-missing", action="store_true",
                   help="Tolerate missing index files.")


def _run_spatial_index(args, dir_for) -> int:
  from . import task_creation as tc
  from .volume import Volume

  vol = Volume(args.path)
  index_dir = dir_for(vol, args.index_dir)
  if args.spatial_index_command == "db":
    from .spatial_index import SpatialIndex

    n = SpatialIndex(vol.cf, index_dir).to_sqlite(
      args.db_path, progress=args.progress, allow_missing=args.allow_missing,
    )
    print(f"wrote {n} rows to {args.db_path}")
    return 0
  enqueue(args.queue, tc.create_spatial_index_tasks(
    args.path, index_dir, mip=args.mip,
    shape=args.shape, fill_missing=args.fill_missing,
  ), args.parallel)
  return 0


def _add_infer(cmd) -> None:
  cmd.add_argument("src")
  cmd.add_argument("dest")
  _queue_opt(cmd)
  cmd.add_argument("--model", dest="model_path", required=True,
                   help="Cloudpath of a saved model (model.json + params.npz).")
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=None,
                   help="Task shape in voxels (snapped up to chunk multiples).")
  cmd.add_argument("--halo", type=_tuple3, default=None,
                   help="Context voxels per face [default: the model overlap].")
  cmd.add_argument("--batch-size", type=int, default=4,
                   help="Patches per device dispatch group.")
  cmd.add_argument("--postprocess", default="none",
                   choices=["none", "quantize", "argmax"],
                   help="none: float32 channels; quantize: uint8 [0,1]*255; "
                        "argmax: uint8 channel argmax (segmentation).")
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--compress", default="gzip")
  cmd.add_argument("--chunk-size", type=_tuple3, default=None,
                   help="Destination chunk size [default: source's].")
  _range_opts(cmd)
  cmd.add_argument("--bounds-mip", type=int, default=None,
                   help="Mip the ranges are specified in [default: --mip].")


def _run_infer(args) -> int:
  from .task_creation import create_inference_tasks

  bounds_mip = args.mip if args.bounds_mip is None else args.bounds_mip
  tasks = create_inference_tasks(
    args.src, args.dest, args.model_path, mip=args.mip, shape=args.shape,
    halo=args.halo, bounds=_cli_bounds(args.src, bounds_mip, args),
    bounds_mip=bounds_mip, fill_missing=args.fill_missing,
    batch_size=args.batch_size, postprocess=args.postprocess,
    compress=args.compress, chunk_size=args.chunk_size,
  )
  enqueue(args.queue, tasks, args.parallel)
  return 0


def _add_voxels(voxels) -> None:
  cmd = voxels.add_parser("count", help="Census phase; run `voxels sum` afterwards.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=(512, 512, 512))
  cmd.add_argument("--fill-missing", action="store_true")
  cmd = voxels.add_parser("sum", help="Reduce census files into voxel_counts.im.")
  cmd.add_argument("path")
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--compress", default="gzip",
                   help="Compression for the stored voxel_counts.im.")
  cmd.add_argument("-o", "--output", default=None,
                   help="Also write the IntMap file locally at this path.")


def _run_voxels(args) -> int:
  from . import task_creation as tc

  if args.voxels_command == "count":
    enqueue(args.queue, tc.create_voxel_counting_tasks(
      args.path, mip=args.mip, shape=args.shape, fill_missing=args.fill_missing,
    ), args.parallel)
    return 0
  totals = tc.accumulate_voxel_counts(
    args.path, args.mip, compress=_resolve_compress(args.compress, None) or None,
    additional_output=args.output,
  )
  print(f"labels: {len(totals)}")
  return 0


def _id_list(text: str):
  """'5,6,7' -> [5, 6, 7]; blanks ignored; empty -> None."""
  try:
    ids = [int(tok) for tok in text.split(",") if tok.strip()]
  except ValueError:
    raise argparse.ArgumentTypeError(f"not a comma-separated id list: {text!r}")
  return ids or None


def _add_mesh(mesh) -> None:
  cmd = mesh.add_parser("forge", help="Stage 1: mesh every label of PATH.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=(448, 448, 448))
  cmd.add_argument("--simplify", dest="simplify", action="store_true", default=True,
                   help="Enable mesh simplification (default).")
  cmd.add_argument("--skip-simplify", dest="simplify", action="store_false")
  cmd.add_argument("--simplify-factor", type=int, default=100)
  cmd.add_argument("--max-error", type=int, default=40)
  cmd.add_argument("--mesh-dir", "--dir", dest="mesh_dir", default=None,
                   help="Write meshes into this directory instead of the "
                        "one in the info file.")
  cmd.add_argument("--dust-threshold", "--dust", dest="dust_threshold", type=int,
                   default=None, help="Skip objects smaller than this many voxels.")
  cmd.add_argument("--dust-global", dest="dust_global", action="store_true",
                   default=False,
                   help="Dust by the layer's voxel-count census (run `image "
                        "voxels count` and `image voxels sum` first).")
  cmd.add_argument("--dust-local", dest="dust_global", action="store_false")
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--fill-holes", type=int, default=0,
                   help="Fill cavities: 0 off, 1-2 enclosed cavities, 3 and "
                        "up a morphological closing first.")
  cmd.add_argument("--compress", default="gzip",
                   help="Fragment compression: gzip, gzip-1..gzip-9, zstd or none.")
  cmd.add_argument("--sharded", action="store_true",
                   help="Write one .frags container a task, for `mesh merge-sharded`.")
  cmd.add_argument("--spatial-index", dest="spatial_index", action="store_true",
                   default=True)
  cmd.add_argument("--no-spatial-index", dest="spatial_index", action="store_false")
  cmd.add_argument("--closed-edge", dest="closed_edge", action="store_true",
                   default=True, help="Close meshes against the dataset boundary.")
  cmd.add_argument("--open-edge", dest="closed_edge", action="store_false")
  cmd.add_argument("--labels", "--obj-ids", dest="obj_ids", type=_id_list,
                   default=None, help="comma-separated: mesh only these labels")
  cmd.add_argument("--exclude-labels", "--exclude-obj-ids", dest="exclude_obj_ids",
                   type=_id_list, default=None,
                   help="comma-separated: never mesh these labels")
  cmd.add_argument("--mesher", default="cubes", choices=["cubes", "tetrahedra"])
  cmd.add_argument("--simplify-parallel", type=int, default=1,
                   help="threads for per-label simplification inside each task")
  _add_spatial_index(mesh, "--mesh-dir", (448, 448, 448))
  cmd = mesh.add_parser("merge", help="Stage 2: write the legacy manifests, or "
                        "unsharded multires with --nlod > 0.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--magnitude", type=int, default=2)
  cmd.add_argument("--mesh-dir", "--dir", dest="mesh_dir", default=None)
  cmd.add_argument("--nlod", type=int, default=0,
                   help="(multires) Extra levels of detail; 0 = legacy manifests.")
  cmd.add_argument("--vqb", type=int, default=16,
                   help="(multires) Vertex quantization bits: 10 or 16.")
  cmd.add_argument("--min-chunk-size", type=_tuple3, default=(256, 256, 256),
                   help="(multires) Minimum finest-LOD fragment cell (voxels).")
  cmd = mesh.add_parser("merge-sharded", help="Sharded multires merge of the "
                        "`forge --sharded` .frags.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mesh-dir", "--dir", dest="mesh_dir", default=None)
  cmd.add_argument("--num-lods", type=int, default=None,
                   help="Total levels of detail [default: 2].")
  cmd.add_argument("--nlod", type=int, default=None,
                   help="EXTRA levels of detail (total = nlod + 1).")
  cmd.add_argument("--vqb", type=int, default=16,
                   help="Vertex quantization bits: 10 or 16.")
  cmd.add_argument("--min-chunk-size", type=_tuple3, default=(256, 256, 256),
                   help="Minimum finest-LOD fragment cell (voxels).")
  cmd.add_argument("--compress-level", type=int, default=7,
                   help="Draco compression level (recorded; the encoder is "
                        "the fixed sequential method).")
  _shard_opts(cmd, max_labels_per_shard=1000)
  cmd = mesh.add_parser("clean", help="Delete stage-1 intermediates (fragment "
                        "files, .frags containers, .spatial cells).")
  cmd.add_argument("path")
  cmd.add_argument("--mesh-dir", default=None)
  cmd = mesh.add_parser("xfer", help="Copy the mesh dir of SRC into DEST.")
  cmd.add_argument("src")
  cmd.add_argument("dest")
  _queue_opt(cmd)
  cmd.add_argument("--mesh-dir", "--dir", dest="mesh_dir", default=None)
  cmd.add_argument("--magnitude", type=int, default=1)
  cmd.add_argument("--sharded", action="store_true",
                   help="Convert unsharded meshes to sharded multires at the "
                        "destination.")
  cmd.add_argument("--nlod", type=int, default=0,
                   help="(--sharded) Extra levels of detail.")
  cmd.add_argument("--mip", type=int, default=None,
                   help="Accepted for parity; the multires info records the "
                        "source mip.")
  cmd = mesh.add_parser("rm", help="Delete the mesh dir's files.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mesh-dir", "--dir", dest="mesh_dir", default=None)
  cmd.add_argument("--magnitude", type=int, default=1)


def _shard_opts(cmd, max_labels_per_shard: int) -> None:
  cmd.add_argument("--shard-index-bytes", type=int, default=2**13)
  cmd.add_argument("--minishard-index-bytes", type=int, default=2**15)
  cmd.add_argument("--minishard-index-encoding", default="gzip")
  cmd.add_argument("--min-shards", type=int, default=1)
  cmd.add_argument("--max-labels-per-shard", type=int, default=max_labels_per_shard)
  cmd.add_argument("--spatial-index-db", default=None,
                   help="Query labels from this sqlite db (`spatial-index db`) "
                        "instead of listing .spatial files.")


def _clean(path: str, index_dir, dir_for, intermediate) -> int:
  """Delete the keys under the layer's mesh or skeleton dir for which
  ``intermediate(key)`` holds."""
  from .volume import Volume

  vol = Volume(path)
  idir = dir_for(vol, index_dir)
  doomed = [k for k in vol.cf.list(f"{idir}/") if intermediate(k)]
  vol.cf.delete(doomed)
  print(f"deleted {len(doomed)} intermediate files")
  return 0


def _run_mesh(args) -> int:
  from . import task_creation as tc
  from .tasks.mesh import mesh_dir_for

  if args.command == "spatial-index":
    return _run_spatial_index(args, mesh_dir_for)
  if args.command == "merge":
    if args.nlod > 0:
      tasks = tc.create_unsharded_multires_mesh_tasks(
        args.path, magnitude=args.magnitude, mesh_dir=args.mesh_dir,
        num_lods=args.nlod + 1, vertex_quantization_bits=args.vqb,
        min_chunk_size=args.min_chunk_size,
      )
    else:
      tasks = tc.create_mesh_manifest_tasks(
        args.path, magnitude=args.magnitude, mesh_dir=args.mesh_dir)
    enqueue(args.queue, tasks, args.parallel)
    return 0
  if args.command == "merge-sharded":
    num_lods = args.num_lods
    if num_lods is None:
      num_lods = (args.nlod + 1) if args.nlod is not None else 2
    enqueue(args.queue, tc.create_sharded_multires_mesh_tasks(
      args.path, mesh_dir=args.mesh_dir, num_lods=num_lods,
      vertex_quantization_bits=args.vqb, min_chunk_size=args.min_chunk_size,
      draco_compression_level=args.compress_level,
      shard_index_bytes=args.shard_index_bytes,
      minishard_index_bytes=args.minishard_index_bytes,
      minishard_index_encoding=args.minishard_index_encoding,
      min_shards=args.min_shards, max_labels_per_shard=args.max_labels_per_shard,
      spatial_index_db=args.spatial_index_db,
    ), args.parallel)
    return 0
  if args.command == "clean":
    # label:0:bbox fragments, .frags containers and .spatial cells
    return _clean(args.path, args.mesh_dir, mesh_dir_for, lambda k: (
      k.endswith(".frags") or k.endswith(".spatial")
      or len(k.split("/")[-1].split(":")) == 3
    ))
  if args.command == "xfer":
    if args.sharded:
      tasks = tc.create_sharded_multires_mesh_from_unsharded_tasks(
        args.src, dest_cloudpath=args.dest, mesh_dir=args.mesh_dir,
        num_lods=args.nlod + 1,
      )
    else:
      tasks = tc.create_mesh_transfer_tasks(
        args.src, args.dest, mesh_dir=args.mesh_dir, magnitude=args.magnitude)
    enqueue(args.queue, tasks, args.parallel)
    return 0
  if args.command == "rm":
    enqueue(args.queue, tc.create_mesh_deletion_tasks(
      args.path, magnitude=args.magnitude, mesh_dir=args.mesh_dir), args.parallel)
    return 0
  enqueue(args.queue, tc.create_meshing_tasks(
    args.path, mip=args.mip, shape=args.shape, simplification=args.simplify,
    simplification_factor=args.simplify_factor,
    max_simplification_error=args.max_error, mesh_dir=args.mesh_dir,
    dust_threshold=args.dust_threshold, dust_global=args.dust_global,
    fill_missing=args.fill_missing, fill_holes=args.fill_holes,
    sharded=args.sharded, spatial_index=args.spatial_index,
    closed_dataset_edges=args.closed_edge, object_ids=args.obj_ids,
    exclude_object_ids=args.exclude_obj_ids, mesher=args.mesher,
    parallel=args.simplify_parallel, compress=args.compress,
  ), args.parallel)
  return 0


def _add_skeleton(skel) -> None:
  cmd = skel.add_parser("forge", help="Stage 1: skeletonize every label of PATH.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=(512, 512, 512))
  cmd.add_argument("--scale", type=float, default=4.0, help="TEASAR scale")
  cmd.add_argument("--const", type=float, default=500.0, help="TEASAR const (nm)")
  cmd.add_argument("--max-paths", type=float, default=None,
                   help="Abort an object after tracing this many paths.")
  cmd.add_argument("--dust-threshold", type=int, default=1000)
  cmd.add_argument("--dust-global", dest="dust_global", action="store_true",
                   default=False,
                   help="Dust by the layer's voxel-count census (run `image "
                        "voxels count` and `image voxels sum` first).")
  cmd.add_argument("--dust-local", dest="dust_global", action="store_false")
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--fill-holes", type=int, default=0,
                   help="Fill cavities: 0 off, 1-2 enclosed cavities, 3 and "
                        "up a morphological closing first.")
  cmd.add_argument("--sharded", action="store_true",
                   help="Write one .frags container a task, for `skeleton "
                        "merge-sharded`.")
  cmd.add_argument("--skel-dir", default=None)
  cmd.add_argument("--spatial-index", dest="spatial_index", action="store_true",
                   default=True)
  cmd.add_argument("--skip-spatial-index", dest="spatial_index", action="store_false")
  cmd.add_argument("--fix-borders", dest="fix_borders", action="store_true", default=True)
  cmd.add_argument("--no-fix-borders", dest="fix_borders", action="store_false")
  cmd.add_argument("--fix-branching", dest="fix_branching", action="store_true",
                   default=True)
  cmd.add_argument("--no-fix-branching", dest="fix_branching", action="store_false")
  cmd.add_argument("--fix-avocados", action="store_true")
  cmd.add_argument("--fix-autapses", action="store_true",
                   help="(graphene) constrain TEASAR to the chunk graph so "
                        "self-contacts are severed")
  cmd.add_argument("--soma-detect", type=float, default=1100.0)
  cmd.add_argument("--soma-accept", type=float, default=3500.0)
  cmd.add_argument("--soma-scale", type=float, default=2.0)
  cmd.add_argument("--soma-const", type=float, default=300.0)
  cmd.add_argument("--labels", type=_id_list, default=None,
                   help="comma-separated: skeletonize only these labels")
  cmd.add_argument("--cross-section", type=int, default=0,
                   help="Compute per-vertex cross sectional area; the value is "
                        "the normal-vector smoothing window (0 = off).")
  cmd.add_argument("--cross-section-label-repair-sec", type=int, default=-1,
                   help="Per-label time budget for contact repair: 0 off, "
                        "-1 unlimited.")
  cmd.add_argument("--output", "-o", default=None,
                   help="Write stage-1 fragments to this path instead.")
  cmd.add_argument("--timestamp", type=int, default=None,
                   help="(graphene) proofreading state at this UNIX time.")
  cmd.add_argument("--root-ids", default=None,
                   help="(graphene) materialized root-id layer to read instead "
                        "of querying the server.")
  cmd.add_argument("--progress", action="store_true",
                   help="Accepted as the JAX package accepts it; no effect.")
  _add_spatial_index(skel, "--skel-dir", (512, 512, 512))
  cmd = skel.add_parser("convert", help="Export finished skeletons as SWC files.")
  cmd.add_argument("path")
  cmd.add_argument("out_dir")
  cmd.add_argument("--skel-dir", default=None)
  cmd.add_argument("--labels", type=_id_list, default=None,
                   help="comma-separated label ids")
  cmd = skel.add_parser("merge", help="Stage 2: fuse each label's fragments.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--magnitude", type=int, default=1)
  cmd.add_argument("--skel-dir", default=None)
  cmd.add_argument("--dust-threshold", "--min-cable-length", dest="dust_threshold",
                   type=float, default=4000.0,
                   help="Skip objects shorter than this physical path length.")
  cmd.add_argument("--tick-threshold", type=float, default=6000.0)
  cmd.add_argument("--delete-fragments", action="store_true")
  cmd.add_argument("--max-cable-length", type=float, default=None)
  cmd = skel.add_parser("merge-sharded", help="Stage 2 (sharded): fuse the "
                        "`forge --sharded` .frags into shard files.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--skel-dir", default=None)
  cmd.add_argument("--dust-threshold", "--min-cable-length", dest="dust_threshold",
                   type=float, default=4000.0,
                   help="Skip objects shorter than this physical path length.")
  cmd.add_argument("--tick-threshold", type=float, default=6000.0)
  cmd.add_argument("--max-cable-length", type=float, default=None)
  cmd.add_argument("--data-encoding", default="gzip",
                   help="Shard data compression: gzip or raw.")
  _shard_opts(cmd, max_labels_per_shard=2000)
  cmd = skel.add_parser("clean", help="Delete stage-1 intermediates (.sk "
                        "fragments, .frags containers, .spatial cells).")
  cmd.add_argument("path")
  cmd.add_argument("--skel-dir", default=None)
  cmd = skel.add_parser("xfer", help="Copy the skeleton dir of SRC into DEST.")
  cmd.add_argument("src")
  cmd.add_argument("dest")
  _queue_opt(cmd)
  cmd.add_argument("--skel-dir", "--dir", dest="skel_dir", default=None)
  cmd.add_argument("--magnitude", type=int, default=1)
  cmd.add_argument("--sharded", action="store_true",
                   help="Convert unsharded skeletons to sharded format at the "
                        "destination.")
  cmd = skel.add_parser("rm", help="Delete the skeleton dir's files.")
  cmd.add_argument("path")
  _queue_opt(cmd)
  cmd.add_argument("--skel-dir", "--dir", dest="skel_dir", default=None)
  cmd.add_argument("--magnitude", type=int, default=1)


def _run_skeleton(args) -> int:
  from . import task_creation as tc
  from .tasks.skeleton import skel_dir_for

  if args.command == "spatial-index":
    return _run_spatial_index(args, skel_dir_for)
  if args.command == "merge-sharded":
    enqueue(args.queue, tc.create_sharded_skeleton_merge_tasks(
      args.path, skel_dir=args.skel_dir, dust_threshold=args.dust_threshold,
      tick_threshold=args.tick_threshold, max_cable_length=args.max_cable_length,
      shard_index_bytes=args.shard_index_bytes,
      minishard_index_bytes=args.minishard_index_bytes,
      minishard_index_encoding=args.minishard_index_encoding,
      data_encoding=args.data_encoding, min_shards=args.min_shards,
      max_labels_per_shard=args.max_labels_per_shard,
      spatial_index_db=args.spatial_index_db,
    ), args.parallel)
    return 0
  if args.command == "clean":
    return _clean(args.path, args.skel_dir, skel_dir_for, lambda k: (
      k.endswith(".sk") or k.endswith(".frags") or k.endswith(".spatial")
    ))
  if args.command == "xfer":
    if args.sharded:
      tasks = tc.create_sharded_from_unsharded_skeleton_merge_tasks(
        args.src, dest_cloudpath=args.dest, skel_dir=args.skel_dir)
    else:
      tasks = tc.create_skeleton_transfer_tasks(
        args.src, args.dest, skel_dir=args.skel_dir, magnitude=args.magnitude)
    enqueue(args.queue, tasks, args.parallel)
    return 0
  if args.command == "rm":
    enqueue(args.queue, tc.create_skeleton_deletion_tasks(
      args.path, magnitude=args.magnitude, skel_dir=args.skel_dir), args.parallel)
    return 0
  if args.command == "merge":
    enqueue(args.queue, tc.create_unsharded_skeleton_merge_tasks(
      args.path, magnitude=args.magnitude, skel_dir=args.skel_dir,
      dust_threshold=args.dust_threshold, tick_threshold=args.tick_threshold,
      delete_fragments=args.delete_fragments,
      max_cable_length=args.max_cable_length,
    ), args.parallel)
    return 0
  if args.command == "convert":
    return _skeleton_convert(args.path, args.out_dir, args.skel_dir, args.labels)
  enqueue(args.queue, tc.create_skeletonizing_tasks(
    args.path, mip=args.mip, shape=args.shape,
    teasar_params={
      "scale": args.scale, "const": args.const,
      "soma_detection_threshold": args.soma_detect,
      "soma_acceptance_threshold": args.soma_accept,
      "soma_invalidation_scale": args.soma_scale,
      "soma_invalidation_const": args.soma_const,
      "max_paths": args.max_paths,
    },
    dust_threshold=args.dust_threshold, dust_global=args.dust_global,
    fill_missing=args.fill_missing, fill_holes=args.fill_holes,
    sharded=args.sharded, skel_dir=args.skel_dir,
    spatial_index=args.spatial_index, fix_borders=args.fix_borders,
    fix_branching=args.fix_branching, fix_avocados=args.fix_avocados,
    fix_autapses=args.fix_autapses, object_ids=args.labels,
    cross_sectional_area=args.cross_section > 0,
    csa_smoothing_window=max(int(args.cross_section), 1),
    csa_repair_sec_per_label=args.cross_section_label_repair_sec,
    frag_path=args.output, timestamp=args.timestamp,
    root_ids_cloudpath=args.root_ids,
  ), args.parallel)
  return 0


def _skeleton_convert(path: str, out_dir: str, skel_dir, labels) -> int:
  """Write ``<label>.swc`` for each finished skeleton of PATH (the bare
  label files of the skeleton dir), as ``igneous-tpu skeleton convert``."""
  import os

  from .skeleton_io import Skeleton, to_swc
  from .tasks.skeleton import skel_dir_for
  from .volume import Volume

  vol = Volume(path)
  sdir = skel_dir_for(vol, skel_dir)
  attrs = (vol.cf.get_json(f"{sdir}/info") or {}).get("vertex_attributes")
  os.makedirs(out_dir, exist_ok=True)
  wanted = set(labels) if labels else None
  n = 0
  for key in vol.cf.list(f"{sdir}/"):
    name = key.split("/")[-1]
    if not name.isdigit():
      continue
    label = int(name)
    if wanted is not None and label not in wanted:
      continue
    s = Skeleton.from_precomputed(vol.cf.get(key), vertex_attributes=attrs)
    with open(os.path.join(out_dir, f"{label}.swc"), "w") as f:
      f.write(to_swc(s, label=label))
    n += 1
  print(f"wrote {n} swc files to {out_dir}")
  return 0


def _ccl_opts(cmd) -> None:
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=(448, 448, 448))
  cmd.add_argument("--threshold-gte", type=float, default=None)
  cmd.add_argument("--threshold-lte", type=float, default=None)
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--dust", dest="dust_threshold", type=int, default=0,
                   help="Delete objects smaller than this many voxels "
                        "within a cutout.")


def _dest_opts(cmd) -> None:
  cmd.add_argument("--encoding", default="compressed_segmentation",
                   help="Destination encoding (raw, compressed_segmentation, "
                        "compresso, ...).")
  cmd.add_argument("--chunk-size", type=_tuple3, default=None,
                   help="Chunk size of the destination layer.")


def _add_ccl(ccl) -> None:
  for name, help_ in (("faces", "Pass 1: store each task's back faces."),
                      ("links", "Pass 2: link the faces of adjacent tasks.")):
    cmd = ccl.add_parser(name, help=help_)
    cmd.add_argument("path")
    _queue_opt(cmd)
    _ccl_opts(cmd)
  cmd = ccl.add_parser("calc-labels", help="Single-machine global union-find (pass 3).")
  cmd.add_argument("path")
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=(448, 448, 448),
                   help="Accepted for parity; the stored equivalence files "
                        "already determine the task grid.")
  cmd = ccl.add_parser("relabel", help="Pass 4: write the destination layer.")
  cmd.add_argument("path")
  cmd.add_argument("dest")
  _queue_opt(cmd)
  _ccl_opts(cmd)
  _dest_opts(cmd)
  cmd = ccl.add_parser("clean", help="Delete the scratch files.")
  cmd.add_argument("path")
  cmd.add_argument("--mip", type=int, default=0)
  cmd = ccl.add_parser("auto", help="All four passes, each drained before the next.")
  cmd.add_argument("path")
  cmd.add_argument("dest")
  cmd.add_argument("--queue", "-q", default=None,
                   help="Lease queue to drain each pass through "
                        "(local execution if omitted).")
  _ccl_opts(cmd)
  _dest_opts(cmd)
  cmd.add_argument("--clean", dest="clean", action="store_true", default=True,
                   help="Delete scratch files afterwards (default).")
  cmd.add_argument("--no-clean", dest="clean", action="store_false")


def _run_ccl(args) -> int:
  from . import task_creation as tc
  from .queues import LocalTaskQueue, TaskQueue

  cmd = args.ccl_command
  if cmd == "calc-labels":
    print(f"max_label: {tc.create_relabeling(args.path, args.mip, args.shape)}")
    return 0
  if cmd == "clean":
    tc.clean_ccl_files(args.path, args.mip)
    return 0
  kw = dict(
    fill_missing=args.fill_missing, threshold_gte=args.threshold_gte,
    threshold_lte=args.threshold_lte, dust_threshold=args.dust_threshold,
  )
  if cmd == "faces":
    enqueue(args.queue, tc.create_ccl_face_tasks(
      args.path, args.mip, args.shape, **kw), args.parallel)
  elif cmd == "links":
    enqueue(args.queue, tc.create_ccl_equivalence_tasks(
      args.path, args.mip, args.shape, **kw), args.parallel)
  elif cmd == "relabel":
    enqueue(args.queue, tc.create_ccl_relabel_tasks(
      args.path, args.dest, args.mip, args.shape, encoding=args.encoding,
      chunk_size=args.chunk_size, **kw,
    ), args.parallel)
  else:
    queue = (
      TaskQueue(args.queue) if args.queue
      else LocalTaskQueue(parallel=args.parallel)
    )
    max_label = tc.ccl_auto(
      args.path, args.dest, mip=args.mip, shape=args.shape, queue=queue,
      encoding=args.encoding, chunk_size=args.chunk_size, clean=args.clean,
      **kw,
    )
    print(f"components: {max_label}")
  return 0


def _run_batched(parser, args, factor) -> int:
  if args.sharded or args.queue:
    parser.error("--batched runs unsharded on this host (no -q)")
  if args.encoding or args.chunk_size:
    parser.error(
      "--batched downsamples in place; --encoding/--chunk-size apply "
      "only to the task factories"
    )
  from .parallel.batch_runner import batched_downsample

  stats = batched_downsample(
    args.path, mip=args.mip, num_mips=args.num_mips, shape=args.shape,
    batch_size=args.batch_size, factor=factor or (2, 2, 1),
    sparse=args.sparse, fill_missing=args.fill_missing,
    method=args.downsample_method, bounds=_cli_bounds(args.path, args.mip, args),
  )
  print(
    f"batched: {stats['batched_cutouts']} cutouts in "
    f"{stats['dispatches']} dispatches, {stats['edge_cutouts']} edge "
    f"cutouts via the task path"
  )
  return 0


def _add_design(design) -> None:
  cmd = design.add_parser("ds-memory", help="Optimal task shape and mip count "
                          "for a byte budget.")
  cmd.add_argument("path")
  cmd.add_argument("--memory", type=int, default=int(3.5e9))
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--factor", type=_tuple3, default=(2, 2, 1))
  cmd.add_argument("--max-mips", type=int, default=None,
                   help="Cap the downsample count even if memory allows more.")
  cmd.add_argument("--verbose", action="store_true")
  cmd = design.add_parser("ds-shape", help="Optimal task shape for a byte budget.")
  cmd.add_argument("path")
  cmd.add_argument("--memory", type=int, default=int(3.5e9))
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--factor", type=_tuple3, default=(2, 2, 1))
  cmd.add_argument("--num-mips", type=int, default=None)
  cmd = design.add_parser("bounds", help="Bounds from the stored chunk filenames.")
  cmd.add_argument("path")
  cmd.add_argument("--mip", type=int, default=0)


def _run_design(args) -> int:
  from .downsample_scales import (
    downsample_shape_from_memory_target,
    num_mips_from_memory_target,
  )
  from .lib import Bbox
  from .volume import Volume

  if args.command == "bounds":
    vol = Volume(args.path)
    boxes = []
    for key in vol.cf.list(f"{vol.meta.key(args.mip)}/"):
      try:
        boxes.append(Bbox.from_filename(key))
      except ValueError:
        continue
    if not boxes:
      print("no chunks found")
      return 0
    print(f"chunks: {len(boxes)}")
    print(f"bounds: {Bbox.expand(*boxes)}")
    print(f"info bounds: {vol.meta.bounds(args.mip)}")
    return 0
  vol = Volume(args.path, mip=args.mip)
  cs = vol.meta.chunk_size(args.mip)
  max_mips = args.max_mips if args.command == "ds-memory" else args.num_mips
  shape = downsample_shape_from_memory_target(
    vol.dtype.itemsize, int(cs.x), int(cs.y), int(cs.z), args.factor, args.memory,
    max_mips=max_mips, num_channels=vol.num_channels,
  )
  shape_text = ",".join(str(int(v)) for v in shape)
  if args.command == "ds-shape":
    print(shape_text)
    return 0
  mips = num_mips_from_memory_target(
    args.memory, vol.dtype.itemsize, cs, args.factor, vol.num_channels
  )
  if max_mips is not None:
    mips = min(mips, max_mips)
  if args.verbose:
    print(f"Data width: {vol.dtype.itemsize} B")
    print(f"Chunk size: {int(cs.x)},{int(cs.y)},{int(cs.z)}")
    print(f"Memory limit: {args.memory:.2e} B")
    print(f"Optimized shape: {shape_text}")
    print(f"Downsamples: {mips}")
  else:
    print(f"mips achievable in {args.memory:.2e} bytes: {mips}")
    print(shape_text)
  return 0


def _glue_worker_args(argv: List[str]) -> List[str]:
  """``--worker-arg --batch`` as the JAX CLI takes it: argparse would read
  a value that starts with ``-`` as an option, so glue it on with ``=``."""
  out = []
  it = iter(argv)
  for tok in it:
    if tok == "--worker-arg":
      val = next(it, None)
      out.append(tok if val is None else f"--worker-arg={val}")
    else:
      out.append(tok)
  return out


def main(argv: Optional[List[str]] = None) -> int:
  import sys

  parser = build_parser()
  args = parser.parse_args(_glue_worker_args(
    list(sys.argv[1:] if argv is None else argv)))
  if args.group == "license":
    print("igneous-tpu is licensed under the BSD 3-Clause license.")
    return 0
  if args.group == "design":
    return _run_design(args)
  if args.group == "tune":
    return _run_tune(parser, args)
  if args.group == "execute":
    return _run_execute(parser, args)
  if args.group == "queue":
    return _run_queue(parser, args)
  if args.group == "audit":
    return _run_audit(args)
  if args.group == "fleet":
    return _run_fleet(parser, args)
  if args.group == "profile":
    return _run_profile(parser, args)
  if args.group == "campaign":
    return _run_campaign(parser, args)
  if args.group == "view":
    return _run_view(args)
  if args.group == "serve":
    return _run_serve(parser, args)
  if args.group == "mesh":
    return _run_mesh(args)
  if args.group == "skeleton":
    return _run_skeleton(args)
  if args.command == "ccl":
    return _run_ccl(args)
  if args.command == "xfer":
    return _run_xfer(args)
  if args.command == "infer":
    return _run_infer(args)
  if args.command == "voxels":
    return _run_voxels(args)
  if args.command == "rm":
    return _run_rm(args)
  if args.command == "contrast":
    return _run_contrast(args)
  if args.command == "roi":
    return _run_roi(args)
  if args.command == "reorder":
    return _run_reorder(parser, args)
  if args.command == "create":
    return _run_create(parser, args)
  from .task_creation import create_downsampling_tasks, create_image_shard_downsample_tasks

  factor = args.factor
  if args.isotropic:
    if factor is not None or args.volumetric:
      parser.error("--isotropic excludes --factor/--volumetric")
    if args.sharded or args.batched:
      parser.error("--isotropic plans per-mip factors, which only the unsharded "
                   "task factory supports")
    factor = "isotropic"
  elif args.volumetric:
    if factor is not None:
      raise SystemExit("--volumetric and --factor are exclusive")
    factor = (2, 2, 2)
  if args.batched:
    return _run_batched(parser, args, factor)
  bounds = _cli_bounds(args.path, args.mip, args)
  if args.sharded:
    tasks = create_image_shard_downsample_tasks(
      args.path, mip=args.mip, fill_missing=args.fill_missing, sparse=args.sparse,
      chunk_size=args.chunk_size, encoding=args.encoding,
      encoding_level=args.encoding_level, encoding_effort=args.encoding_effort,
      factor=factor or (2, 2, 1), memory_target=args.memory_target,
      downsample_method=args.downsample_method, bounds=bounds, bounds_mip=args.mip,
      num_mips=args.num_mips,
    )
    enqueue(args.queue, tasks, args.parallel)
    return 0
  tasks = create_downsampling_tasks(
    args.path, mip=args.mip, num_mips=args.num_mips,
    fill_missing=args.fill_missing, sparse=args.sparse,
    chunk_size=args.chunk_size, encoding=args.encoding,
    encoding_level=args.encoding_level, encoding_effort=args.encoding_effort,
    delete_black_uploads=args.delete_bg, background_color=args.bg_color,
    compress=_resolve_compress(args.compress, args.encoding), factor=factor,
    memory_target=args.memory_target,
    downsample_method=args.downsample_method, bounds=bounds, bounds_mip=args.mip,
  )
  enqueue(args.queue, tasks, args.parallel)
  return 0
