"""The port's command line: ``python -m igneous_tpu_torch image
{downsample [--batched],xfer}``, ``python -m igneous_tpu_torch image ccl {faces,links,
calc-labels,relabel,clean,auto}``, ``python -m igneous_tpu_torch mesh
{forge,merge}`` and ``python -m igneous_tpu_torch skeleton {forge,merge}``.

A minimal counterpart of ``igneous-tpu image downsample|xfer``,
``igneous-tpu image ccl``, ``igneous-tpu mesh forge|merge`` and
``igneous-tpu skeleton forge|merge`` (``igneous_tpu/cli.py``), with the
same option names; an
option the port does not have is refused by the parser, and the ones it
does not run yet raise ``NotImplementedError`` before anything is written. Tasks run in a ``LocalTaskQueue`` on the
port's device (cuda; ``IGNEOUS_TORCH_DEVICE=cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def _tuple3(text: str):
  parts = [int(v) for v in text.split(",")]
  if len(parts) != 3:
    raise argparse.ArgumentTypeError(f"{text!r} is not an int triple like 2,2,1")
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
  ds.add_argument("--mip", type=int, default=0)
  ds.add_argument("--num-mips", type=int, default=5)
  ds.add_argument("--factor", type=_tuple3, default=None, help="e.g. 2,2,1")
  ds.add_argument("--volumetric", action="store_true", help="Use 2x2x2 downsampling.")
  ds.add_argument("--sparse", action="store_true")
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
  _add_ccl(image.add_parser(
    "ccl", help="Whole-image connected components labeling (4-pass)."
  ).add_subparsers(dest="ccl_command", required=True))
  _add_mesh(groups.add_parser("mesh", help="Mesh forging.").add_subparsers(
    dest="command", required=True))
  _add_skeleton(groups.add_parser("skeleton", help="Skeleton forging.").add_subparsers(
    dest="command", required=True))
  return parser


def _add_xfer(cmd) -> None:
  cmd.add_argument("src")
  cmd.add_argument("dest")
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--chunk-size", type=_tuple3, default=None)
  cmd.add_argument("--shape", type=_tuple3, default=None,
                   help="(overrides --memory) Task shape in voxels.")
  cmd.add_argument("--translate", type=_tuple3, default=(0, 0, 0))
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--sharded", action="store_true", help="Not ported yet: raises.")
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
  from .queues import LocalTaskQueue
  from .task_creation import create_transfer_tasks

  if args.sharded:
    raise NotImplementedError(
      "sharded transfers (--sharded) are not ported to igneous_tpu_torch yet"
    )
  bounds_mip = args.mip if args.bounds_mip is None else args.bounds_mip
  max_mips = args.max_mips if args.num_mips is None else args.num_mips
  if not args.do_downsample:
    max_mips = 0
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
    bounds=_cli_bounds(args.src, bounds_mip, args), bounds_mip=bounds_mip,
    cutout=args.cutout,
  )
  LocalTaskQueue(parallel=args.parallel).insert(tasks)
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
                   default=False, help="Not ported yet: raises.")
  cmd.add_argument("--dust-local", dest="dust_global", action="store_false")
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--fill-holes", type=int, default=0,
                   help="Not ported yet: any value above 0 raises.")
  cmd.add_argument("--compress", default="gzip", help="gzip or none.")
  cmd.add_argument("--sharded", action="store_true", help="Not ported yet: raises.")
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
  cmd = mesh.add_parser("merge", help="Stage 2: write the legacy manifests.")
  cmd.add_argument("path")
  cmd.add_argument("--magnitude", type=int, default=2)
  cmd.add_argument("--mesh-dir", "--dir", dest="mesh_dir", default=None)
  cmd.add_argument("--nlod", type=int, default=0,
                   help="(multires) not ported yet: any value above 0 raises.")
  cmd.add_argument("--vqb", type=int, default=16, help="(multires) not ported yet.")
  cmd.add_argument("--min-chunk-size", type=_tuple3, default=(256, 256, 256),
                   help="(multires) not ported yet.")


def _run_mesh(args) -> int:
  from . import task_creation as tc
  from .queues import LocalTaskQueue

  queue = LocalTaskQueue(parallel=args.parallel)
  if args.command == "merge":
    if args.nlod > 0:
      raise NotImplementedError(
        "multires meshes (--nlod > 0) are not ported to igneous_tpu_torch yet"
      )
    queue.insert(tc.create_mesh_manifest_tasks(
      args.path, magnitude=args.magnitude, mesh_dir=args.mesh_dir))
    return 0
  compress = args.compress
  if compress.lower() in ("none", "false"):
    compress = None
  queue.insert(tc.create_meshing_tasks(
    args.path, mip=args.mip, shape=args.shape, simplification=args.simplify,
    simplification_factor=args.simplify_factor,
    max_simplification_error=args.max_error, mesh_dir=args.mesh_dir,
    dust_threshold=args.dust_threshold, dust_global=args.dust_global,
    fill_missing=args.fill_missing, fill_holes=args.fill_holes,
    sharded=args.sharded, spatial_index=args.spatial_index,
    closed_dataset_edges=args.closed_edge, object_ids=args.obj_ids,
    exclude_object_ids=args.exclude_obj_ids, mesher=args.mesher,
    parallel=args.simplify_parallel, compress=compress,
  ))
  return 0


def _add_skeleton(skel) -> None:
  cmd = skel.add_parser("forge", help="Stage 1: skeletonize every label of PATH.")
  cmd.add_argument("path")
  cmd.add_argument("--mip", type=int, default=0)
  cmd.add_argument("--shape", type=_tuple3, default=(512, 512, 512))
  cmd.add_argument("--scale", type=float, default=4.0, help="TEASAR scale")
  cmd.add_argument("--const", type=float, default=500.0, help="TEASAR const (nm)")
  cmd.add_argument("--max-paths", type=float, default=None,
                   help="Abort an object after tracing this many paths.")
  cmd.add_argument("--dust-threshold", type=int, default=1000)
  cmd.add_argument("--dust-global", dest="dust_global", action="store_true",
                   default=False, help="Not ported yet: raises.")
  cmd.add_argument("--dust-local", dest="dust_global", action="store_false")
  cmd.add_argument("--fill-missing", action="store_true")
  cmd.add_argument("--fill-holes", type=int, default=0,
                   help="Not ported yet: any value above 0 raises.")
  cmd.add_argument("--sharded", action="store_true", help="Not ported yet: raises.")
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
  cmd.add_argument("--fix-autapses", action="store_true", help="Not ported yet: raises.")
  cmd.add_argument("--soma-detect", type=float, default=1100.0)
  cmd.add_argument("--soma-accept", type=float, default=3500.0)
  cmd.add_argument("--soma-scale", type=float, default=2.0)
  cmd.add_argument("--soma-const", type=float, default=300.0)
  cmd.add_argument("--labels", type=_id_list, default=None,
                   help="comma-separated: skeletonize only these labels")
  cmd.add_argument("--cross-section", type=int, default=0,
                   help="Not ported yet: any value above 0 raises.")
  cmd.add_argument("--output", "-o", default=None,
                   help="Write stage-1 fragments to this path instead.")
  cmd.add_argument("--timestamp", type=int, default=None,
                   help="(graphene) not ported yet: raises.")
  cmd.add_argument("--root-ids", default=None, help="(graphene) not ported yet: raises.")
  cmd = skel.add_parser("merge", help="Stage 2: fuse each label's fragments.")
  cmd.add_argument("path")
  cmd.add_argument("--magnitude", type=int, default=1)
  cmd.add_argument("--skel-dir", default=None)
  cmd.add_argument("--dust-threshold", "--min-cable-length", dest="dust_threshold",
                   type=float, default=4000.0,
                   help="Skip objects shorter than this physical path length.")
  cmd.add_argument("--tick-threshold", type=float, default=6000.0)
  cmd.add_argument("--delete-fragments", action="store_true")
  cmd.add_argument("--max-cable-length", type=float, default=None)


def _run_skeleton(args) -> int:
  from . import task_creation as tc
  from .queues import LocalTaskQueue

  queue = LocalTaskQueue(parallel=args.parallel)
  if args.command == "merge":
    queue.insert(tc.create_unsharded_skeleton_merge_tasks(
      args.path, magnitude=args.magnitude, skel_dir=args.skel_dir,
      dust_threshold=args.dust_threshold, tick_threshold=args.tick_threshold,
      delete_fragments=args.delete_fragments,
      max_cable_length=args.max_cable_length,
    ))
    return 0
  if args.timestamp is not None:
    raise NotImplementedError(
      "--timestamp (graphene layers) is not ported to igneous_tpu_torch yet"
    )
  queue.insert(tc.create_skeletonizing_tasks(
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
    frag_path=args.output, root_ids_cloudpath=args.root_ids,
  ))
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
  _ccl_opts(cmd)
  _dest_opts(cmd)
  cmd = ccl.add_parser("clean", help="Delete the scratch files.")
  cmd.add_argument("path")
  cmd.add_argument("--mip", type=int, default=0)
  cmd = ccl.add_parser("auto", help="All four passes locally.")
  cmd.add_argument("path")
  cmd.add_argument("dest")
  _ccl_opts(cmd)
  _dest_opts(cmd)
  cmd.add_argument("--clean", dest="clean", action="store_true", default=True,
                   help="Delete scratch files afterwards (default).")
  cmd.add_argument("--no-clean", dest="clean", action="store_false")


def _run_ccl(args) -> int:
  from . import task_creation as tc
  from .queues import LocalTaskQueue

  queue = LocalTaskQueue(parallel=args.parallel)
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
    queue.insert(tc.create_ccl_face_tasks(args.path, args.mip, args.shape, **kw))
  elif cmd == "links":
    queue.insert(tc.create_ccl_equivalence_tasks(args.path, args.mip, args.shape, **kw))
  elif cmd == "relabel":
    queue.insert(tc.create_ccl_relabel_tasks(
      args.path, args.dest, args.mip, args.shape, encoding=args.encoding,
      chunk_size=args.chunk_size, **kw,
    ))
  else:
    max_label = tc.ccl_auto(
      args.path, args.dest, mip=args.mip, shape=args.shape, queue=queue,
      encoding=args.encoding, chunk_size=args.chunk_size, clean=args.clean,
      **kw,
    )
    print(f"components: {max_label}")
  return 0


def _run_batched(parser, args, factor) -> int:
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


def main(argv: Optional[List[str]] = None) -> int:
  parser = build_parser()
  args = parser.parse_args(argv)
  if args.group == "mesh":
    return _run_mesh(args)
  if args.group == "skeleton":
    return _run_skeleton(args)
  if args.command == "ccl":
    return _run_ccl(args)
  if args.command == "xfer":
    return _run_xfer(args)
  from .queues import LocalTaskQueue
  from .task_creation import create_downsampling_tasks

  factor = args.factor
  if args.volumetric:
    if factor is not None:
      raise SystemExit("--volumetric and --factor are exclusive")
    factor = (2, 2, 2)
  if args.batched:
    return _run_batched(parser, args, factor)
  tasks = create_downsampling_tasks(
    args.path, mip=args.mip, num_mips=args.num_mips,
    fill_missing=args.fill_missing, sparse=args.sparse,
    chunk_size=args.chunk_size, encoding=args.encoding,
    encoding_level=args.encoding_level, encoding_effort=args.encoding_effort,
    delete_black_uploads=args.delete_bg, background_color=args.bg_color,
    compress=_resolve_compress(args.compress, args.encoding), factor=factor,
    memory_target=args.memory_target,
    downsample_method=args.downsample_method,
    bounds=_cli_bounds(args.path, args.mip, args), bounds_mip=args.mip,
  )
  LocalTaskQueue(parallel=args.parallel).insert(tasks)
  return 0
