"""The port's command line: ``python -m igneous_tpu_torch image downsample``.

A minimal counterpart of ``igneous-tpu image downsample``
(``igneous_tpu/cli.py``), with the same option names. Tasks run in a
``LocalTaskQueue`` on the port's device (cuda; ``IGNEOUS_TORCH_DEVICE=cpu``
asks for the CPU).
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def _tuple3(text: str):
  parts = [int(v) for v in text.split(",")]
  if len(parts) != 3:
    raise argparse.ArgumentTypeError(f"{text!r} is not an int triple like 2,2,1")
  return tuple(parts)


def build_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(prog="python -m igneous_tpu_torch")
  parser.add_argument("-p", "--parallel", type=int, default=1,
                      help="Worker processes for local execution.")
  groups = parser.add_subparsers(dest="group", required=True)
  image = groups.add_parser("image").add_subparsers(dest="command", required=True)
  ds = image.add_parser("downsample", help="Build the downsample pyramid of PATH.")
  ds.add_argument("path")
  ds.add_argument("--mip", type=int, default=0)
  ds.add_argument("--num-mips", type=int, default=5)
  ds.add_argument("--factor", type=_tuple3, default=None, help="e.g. 2,2,1")
  ds.add_argument("--volumetric", action="store_true", help="Use 2x2x2 downsampling.")
  ds.add_argument("--sparse", action="store_true")
  ds.add_argument("--fill-missing", action="store_true")
  ds.add_argument("--chunk-size", type=_tuple3, default=None)
  ds.add_argument("--compress", default="gzip", help="gzip or none.")
  ds.add_argument("--delete-bg", action="store_true",
                  help="Delete background tiles instead of uploading them.")
  ds.add_argument("--bg-color", type=int, default=0)
  ds.add_argument("--memory", dest="memory_target", type=int, default=int(3.5e9))
  ds.add_argument("--method", dest="downsample_method", default="auto")
  return parser


def main(argv: Optional[List[str]] = None) -> int:
  args = build_parser().parse_args(argv)
  from .queues import LocalTaskQueue
  from .task_creation import create_downsampling_tasks

  factor = args.factor
  if args.volumetric:
    if factor is not None:
      raise SystemExit("--volumetric and --factor are exclusive")
    factor = (2, 2, 2)
  compress = args.compress
  if compress.lower() in ("none", "false"):
    compress = False
  tasks = create_downsampling_tasks(
    args.path, mip=args.mip, num_mips=args.num_mips,
    fill_missing=args.fill_missing, sparse=args.sparse,
    chunk_size=args.chunk_size, delete_black_uploads=args.delete_bg,
    background_color=args.bg_color, compress=compress, factor=factor,
    memory_target=args.memory_target,
    downsample_method=args.downsample_method,
  )
  LocalTaskQueue(parallel=args.parallel).insert(tasks)
  return 0
