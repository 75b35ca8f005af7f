"""Drive igneous_tpu_torch's downsample, transfer, connected-components,
meshing, skeleton, morphology, census and inference paths, solo, batched
and pipelined, on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. build: compile the kernel sources (csrc/pooling.cu, csrc/ccl.cu,
     csrc/edt.cu) with nvcc and the host libraries of the mesh and skeleton
     paths and the chunk codec (csrc/simplify.cpp, csrc/dijkstra.cpp,
     csrc/fggraph.cpp, csrc/cseg.cpp) with g++, one process per source,
     started together;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, bit for bit, at the main paths' shapes, with its time (device
     time: calls captured in a CUDA graph and replayed between CUDA
     events), its time for one call from the host, its bound and the plain
     time; pool2x2x1 at every element width on its vector and element-wise
     paths; tile_resolve on five cases at connectivity 6, 18 and 26, on
     every tile of the sweep and on an odd tile (the runtime-shape
     instance); edt_pass (three passes, one EDT) on seven cases, the first
     the default skeleton task's 515^3 uint64 field, also timed pass by
     pass and held against the JAX package's host EDT (native/csrc/edt.cpp,
     built with g++ and timed on the host's cores as context), with the
     float32 square root equal to numpy's, the last two with lines longer
     than the shared-memory threshold along z and along x (the long-line
     kernel); each case run twice with the same output both times; single
     passes on seeded random values along each axis, first and not, on
     the first and the long-line cases; the worst stack depth (one label,
     equal values) along each axis, timed; edt_pass's bound the larger of
     its bytes and its FP64 work counted on this run's data;
  3. e2e downsample: four file:// layers through Volume.from_numpy ->
     create_downsampling_tasks -> LocalTaskQueue -> DownsampleTask, every
     produced mip read back and compared with the plain pyramid computed
     on the card; the kernels' launch counts are set to 0 just before and
     read just after, and each kernel must have launched;
  3a. codecs (host): 64 chunks of the segmentation layer's mip 0 and all 4
     of its mip 3, chosen from seed 1, through the compressed_segmentation
     codec's native, numpy and per-block loop routes (one stream, each
     decoder gives the chunk back) and through compresso (round trip
     equal), with their rates on one host thread;
  3b. e2e xfer: the same raw segmentation layer through
     create_transfer_tasks into compressed_segmentation in 64^3 chunks with
     4 new mips (compress at its default, gzip), task by task on a
     LocalTaskQueue: each task's wall, stage split and launches (set to 0
     just before; pyramid2x2x1 must launch), the bytes written against the
     raw bytes, every mip 0-4 read back equal to the raw layer's same mip;
     then a compresso transfer of a 512x512x64 crop with no pyramid, read
     back equal, its info advertising compresso-cpsx;
  3c. batched: phase 3's image layer twice through batched_downsample,
     at 1024x1024x64 in batches of 8 (2 dispatches, 3 mips; a profiler
     trace for the card's busy share) and through `image downsample
     --batched` at its defaults (256x256x64, batch 8: 32 dispatches, 1
     mip), the segmentation at 512x512x64 (2 dispatches, 2 mips) and the
     ragged image at 256x256x64 (9 full cutouts, 7 through PagedPyramid
     in 28 page rounds), each into a new layer sharing phase 3's mip 0:
     per run its wall, dispatches, launches (pyramid2x2x1 once per
     full-cutout dispatch, pool2x2x1 once per level of every page round)
     and stage split, every produced chunk and the info's scales equal to
     phase 3's solo output; the page kernel (X5) on one round against its
     plain version, timed; entry() once, equal to the plain pyramid; then,
     after phase 4, batched_ccl_faces over its segmentation layer
     (paged_ccl, tile_resolve once per page round), every face file equal
     to the task path's pass 1, both walls; and after phase 6, edt_batch
     and paged_edt on the two default skeleton cutouts, bit for bit the
     solo edt, with their walls, launches and peak memory, and
     batched_skeleton_forge over the layer's two tasks into a second
     skeleton directory, its fragments and spatial files equal to phase
     6's; the launch counts are set to 0 just before each part;
  3d. pipelined (after phase 3c, on phase 3's and 3b's layers): the
     image as 16 tasks of 1024x1024x64 with 3 mips (phase 3c's first
     batched grid) and the segmentation as 16 tasks of 512x512x64 with 2
     mips, each through create_downsampling_tasks -> LocalTaskQueue into
     new layers that share phase 3's mip 0, once with IGNEOUS_PIPELINE=off
     (the serial loop) and once at the default (the staged pipeline): per
     run its wall, stage split (thread-seconds), the caller's waits, the
     prefetch buffer's stalls and high-water bytes and the chunk cache's
     counts; pyramid2x2x1 once a task (counts set to 0 just before each
     run), the runner's stats 16 staged, none solo or failed, every chunk
     and the info's scales equal to phase 3's solo output; then phase 3b's
     cseg layer and phase 3's image (its mip 0 stored uncompressed, so
     compress none) through create_transfer_tasks with skip_downsamples
     into layers of the same chunking and encoding: the passthrough moves
     every chunk verbatim, each file byte for byte the source's, no kernel
     launched; the decode route (IGNEOUS_TRANSFER_PASSTHROUGH=off, and for
     the cseg layer once more with IGNEOUS_CHUNK_CACHE=off) writes the
     same bytes; every wall printed;
  4. e2e ccl: two file:// layers (an 896x896x224 thresholded smooth image
     and an 896x448x224 uint64 segmentation of 750 balls, both at half
     the task's depth) through ccl_auto (the four passes on a
     LocalTaskQueue, task shape 448^3, raw destination), with the wall time
     of every pass and the stage split of its tasks; the launch counts are
     set to 0 just before each layer and read just after, tile_resolve must
     have launched at least once per task in each recomputing pass, and
     the destination must be the same partition as scipy.ndimage.label's
     (6-connected, per label), with max_label its component count;
  5. e2e mesh: a 896x448x224 uint64 Voronoi segmentation (500 seeds, ids
     above 2^32 and 2^63, membrane gaps) through create_meshing_tasks ->
     LocalTaskQueue -> MeshTask (two tasks of the default 448^3 shape, at
     half its depth: 448x448x224; simplification 100 with
     error 40, spatial index, gzip; 8 simplification threads) and
     create_mesh_manifest_tasks; each task's wall, stage split and
     label and face counts, the merge's wall; every fragment listed in
     exactly one manifest and every listed fragment present; the first
     task's labels, boxes and dense ids, and 64 of its labels (from seed
     1) plus its largest meshed on the card and on the CPU, byte for byte
     equal, unsimplified and simplified, and equal to the written
     fragments; the launch counts are set to 0 before and none of the
     kernels may launch; the device programs of the path (the XLA
     programs X1-X3 the port runs as torch ops) timed at the first
     task's largest count pass against their bytes bound;
  6. e2e skeleton: a 1024x512x256 uint64 layer of 150 neurite-like tubes
     (radius 3-12 voxels along random polylines, ids above 2^32 and 2^63,
     many across x = 512; half the depth and tubes of the 1024x512x512
     layer it had before phases 8 and 9) through
     create_skeletonizing_tasks -> LocalTaskQueue -> SkeletonTask (two
     tasks of the default 512^3 shape with every default, 8 tracing
     threads) and
     create_unsharded_skeleton_merge_tasks; each task's wall, stage split,
     label and vertex counts, the card's busy time from a profiler trace
     and its peak memory; edt_pass must launch three times a task (the
     counts set to 0 before) and the other kernels not at all; every tube
     component across x = 512 one connected merged skeleton; the first
     task's EDT field equal to the plain version's (run on the card) bit
     for bit, and 32 of its labels (seed 1) plus its largest skeletonized
     to the same bytes on the card and on the CPU route, and equal to the
     written fragments;
  8. morphology and the census (after phase 6): a 448x448x224 uint64
     "hollow cells" layer (150 Voronoi cells with cavities, every third
     opened by a one-voxel channel, and 400 specks, a quarter across
     x = 224): dilate and erode of the first mesh task's cutout on the
     card and on the CPU route, bit for bit, and X6 (the dilation step)
     timed against its bound; create_voxel_counting_tasks (224^3) ->
     LocalTaskQueue -> CountVoxelsTask and accumulate_voxel_counts, the
     totals equal to numpy's over the layer; two MeshTasks of 224x448x224
     with fill_holes=3, dust_threshold=100 and dust_global (8
     simplification threads): the meshed labels exactly those of 100 or
     more voxels in the census, the first task's labels (32 and its
     largest) card against CPU and against the written fragments, the
     level-3 fill count above the level-1 count above 0, each task's
     stage split (fill_holes on the host, dilate and erode on the card);
     no pooling, CCL or EDT kernel launched;
  9. inference (after phase 3d, on phase 3's image, bounds 1024x1024x64):
     the repo's inference model (convnet3d 1 -> 8 -> 2, patch 64x64x32,
     overlap 16x16x8, init_params(seed=0)) through create_inference_tasks
     -> LocalTaskQueue -> InferenceTask, 16 tasks of 108 patches at batch
     4, pipelined with postprocess none, again with IGNEOUS_PIPELINE=off
     and with batch 7 (both byte for byte the first), and with argmax
     (equal to the argmax of the first's floats); the identity model on
     the card and on the CPU route, byte for byte; the first task on the
     card and on the CPU route within rtol 1e-5 and atol 1e-5 of the
     largest output, argmax differences only at margins within it; per
     run its wall, stage split, the caller's waits, patches, padded slots
     and dispatches; X7 (one dispatch of the model, cuDNN with TF32 off)
     against its bound and cuDNN's batched call; the card's busy share
     over one task from a profiler trace; no hand kernel launched;
  7. the card's name and power limit, the programs line (X1-X3, X5-X7),
     the kernels line (each kernel's launches on the main paths, the
     transfer, the batched phase and the pipelined streams), and the
     result.

Exits non-zero, printing no result, without a CUDA device or without the
package beside it.

    python3 chip_smoke.py --baseline NAME=DIR [--baseline NAME=DIR ...]

times the kernels of other copies of the package (an earlier commit's, say:
``git archive <commit> igneous_tpu_torch | tar -x -C DIR0`` makes
DIR0/igneous_tpu_torch) against this checkout's, in turns on the same card,
with equal outputs (edt_pass pass by pass and over the three passes on
the 515^3 field), and runs phases 1 and 2 only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost (Hopper white paper)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations per output voxel: 4 loads' sum, round, shift (average);
# 6 compares, 4 counts, 3 score selects (mode)
OPS_PER_OUTPUT = {"average": 5, "mode": 16}
TOLERANCE = 0  # the pooling and CCL contracts are bitwise
CCL_CUTOUT = 449  # the default CCL task's cutout: 448^3 plus the overlap
CCL_TASK_SHAPE = (448, 448, 448)
CCL_TILE_SWEEP = [(8, 16, 64), (16, 16, 32), (8, 16, 32)]
CCL_ODD_TILE = (3, 5, 7)


def fail(msg: str) -> None:
  print(f"FAIL: {msg}", file=sys.stderr)
  sys.exit(1)


def card_line() -> str:
  proc = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60,
  )
  return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not read"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
  import torch

  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def device_ms(fn, reps: int = 10, batch: int = 10) -> float:
  """Device time of one call of ``fn`` (a kernel wrapper): ``batch`` calls
  captured in a CUDA graph and replayed ``reps`` times between CUDA events;
  the median over the replays, divided by ``batch``. Unlike ``cuda_ms``
  this leaves out the host's time to launch, which for a kernel of tens of
  microseconds is as long as the kernel."""
  import torch

  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(batch):
      fn()
  ms = cuda_ms(graph.replay, reps, warmup=1) / batch
  del graph
  torch.cuda.empty_cache()
  return ms


def max_abs_err(outs, refs) -> float:
  import torch

  from igneous_tpu_torch.ops.cuda_pooling import SIGNED_VIEW

  err = 0.0
  for o, r in zip(outs, refs):
    if o.shape != r.shape:
      return float("inf")
    signed = SIGNED_VIEW.get(o.dtype, o.dtype)
    if not torch.equal(o.view(signed), r.view(signed)):
      a = o.cpu().numpy().astype(np.float64)
      b = r.cpu().numpy().astype(np.float64)
      err = max(err, float(np.abs(a - b).max()))
  return err


def bound(method: str, x, outs):
  """(ms, "bytes" or "operations"): the least time for the work, the larger
  of each input byte read once and each output byte written once over the
  memory rate, and the integer operations over the INT32 rate."""
  nbytes = x.numel() * x.element_size() + sum(o.numel() * o.element_size() for o in outs)
  ops = OPS_PER_OUTPUT[method] * sum(o.numel() for o in outs)
  bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT32_OPS_PER_S
  return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def against(fn, others, reps: int = 10):
  """Times ``fn`` against each (name, other) of ``others``, the same
  function from another copy of the package, in turns (other, fn, fn,
  other) on this card with ``device_ms``; returns one record per other,
  with the means of both pairs and whether the two outputs are equal."""
  import torch

  records = []
  for name, other in others:
    o1 = device_ms(other, reps)
    c1 = device_ms(fn, reps)
    c2 = device_ms(fn, reps)
    o2 = device_ms(other, reps)
    a, b = fn(), other()
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    equal = all(
      torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b)
    )
    records.append({"against": name, "ms": (c1 + c2) / 2,
                    "other_ms": (o1 + o2) / 2, "equal": equal})
  return records


def pool_input(dtype: str, shape, g, torch, dev):
  """Seeded test data: uint8 noise, int16 noise with negative sums, uint32
  labels above 2^31 and uint64 labels above 2^32, three labels each."""
  if dtype == "uint8":
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)
  if dtype == "int16":
    return torch.randint(-32768, 32768, shape, dtype=torch.int16, device=dev, generator=g)
  lab = torch.randint(0, 3, shape, dtype=torch.int64, device=dev, generator=g)
  if dtype == "uint32":
    return (lab * 65537 + 2**31).to(torch.uint32)
  return (lab * (2**33 + 7) + 2**40).view(torch.uint64)


# the single step: (dtype, method, plane); every element width on a vector
# path (even widths) and on the element-wise path (odd widths), and the
# 4-byte chunks of a 500 plane (the ragged task's second level)
POOL_CASES = [
  ("uint8", "average", (1000, 1000)),  # the ragged task's first level
  ("uint8", "average", (125, 125)),
  ("uint32", "mode", (1000, 1000)),
  ("uint8", "average", (999, 999)),
  ("uint8", "average", (500, 500)),
  ("int16", "average", (1000, 1000)),
  ("int16", "average", (999, 999)),
  ("uint32", "mode", (999, 999)),
  ("uint64", "mode", (1000, 1000)),
  ("uint64", "mode", (999, 999)),
]


def kernel_phase(cp, torch, dev, others=()):
  """Each pooling kernel against its plain version at the main path's
  shapes and at every element width; ``others`` are (name, cuda_pooling
  of another copy of the package) to time against."""
  g = torch.Generator(device=dev).manual_seed(0)
  cases = []

  def run(name, kernel, plain, x, method, label, other_fns=()):
    outs = kernel()
    refs = plain()
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, list) else [outs]
    refs = refs if isinstance(refs, list) else [refs]
    err = max_abs_err(outs, refs)
    del refs
    bound_ms, bound_by = bound(method, x, outs)
    case = {
      "kernel": name, "case": label, "max_abs_err": err,
      "ms": device_ms(kernel),
      "call_ms": cuda_ms(kernel, reps=20),
      "plain_ms": cuda_ms(plain, reps=3, warmup=1),
      "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if other_fns:
      case["against"] = against(kernel, other_fns)
    print("kernel " + json.dumps(case), flush=True)
    if err > TOLERANCE:
      fail(f"{name} {label}: max abs err {err} against its plain version")
    if not all(r["equal"] for r in case.get("against", ())):
      fail(f"{name} {label}: differs from the other copy's kernel")
    cases.append(case)

  # fused walk: uint8 image, 5 levels (the image layer's task)
  x = pool_input("uint8", (1, 64, 4096, 4096), g, torch, dev)
  run("pyramid2x2x1", lambda: cp.pyramid2x2x1(x, 5, "average"),
      lambda: cp.pyramid2x2x1_plain(x, 5, "average"), x, "average",
      "uint8 average L=5 (1,64,4096,4096)")
  del x
  # fused walk: uint64 labels above 2^32, 4 levels (the segmentation task)
  x = pool_input("uint64", (1, 64, 2048, 2048), g, torch, dev)
  run("pyramid2x2x1", lambda: cp.pyramid2x2x1(x, 4, "mode"),
      lambda: cp.pyramid2x2x1_plain(x, 4, "mode"), x, "mode",
      "uint64 mode L=4 (1,64,2048,2048)")
  del x
  # fused walk: int16 with negative sums (floor, not truncation)
  x = pool_input("int16", (1, 64, 2048, 2048), g, torch, dev)
  run("pyramid2x2x1", lambda: cp.pyramid2x2x1(x, 4, "average"),
      lambda: cp.pyramid2x2x1_plain(x, 4, "average"), x, "average",
      "int16 average L=4 (1,64,2048,2048)")
  del x
  for dtype, method, (Y, X) in POOL_CASES:
    x = pool_input(dtype, (1, 64, Y, X), g, torch, dev)
    vec = cp.row_vector_bytes(X, x.element_size(), x.data_ptr(), 0)
    other_fns = [(n, (lambda m=m: m.pool2x2x1(x, method))) for n, m in others]
    run("pool2x2x1", lambda: cp.pool2x2x1(x, method),
        lambda: cp.pool2x2x1_plain(x, method), x, method,
        f"{dtype} {method} (1,64,{Y},{X}), {vec or 'element'}-byte chunks", other_fns)
    del x
  torch.cuda.empty_cache()
  return cases


def smooth_image(shape, rng, torch, dev) -> np.ndarray:
  """A spatially correlated uint8 surrogate of EM imagery, (x, y, z) in
  Fortran order: grey 128 plus three octaves of trilinearly interpolated
  value noise (cells of 64, 16 and 4 voxels in x and y; 16, 8 and 4 in z)
  and voxel noise of standard deviation 4, clipped to 0..255. Made on the
  card from ``rng``; unlike uniform noise, gzip compresses it."""
  import torch.nn.functional as F

  X, Y, Z = shape
  acc = torch.full((1, 1, Z, Y, X), 128.0, device=dev)
  for cxy, cz, amp in ((64, 16, 40.0), (16, 8, 20.0), (4, 4, 10.0)):
    coarse = rng.standard_normal((Z // cz + 1, Y // cxy + 1, X // cxy + 1), dtype=np.float32)
    acc += amp * F.interpolate(
      torch.from_numpy(coarse).to(dev)[None, None], size=(Z, Y, X),
      mode="trilinear", align_corners=True,
    )
  g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
  acc += 4.0 * torch.randn(acc.shape, device=dev, generator=g)
  img = acc.clamp_(0, 255).round_().to(torch.uint8)[0, 0].cpu().numpy()
  del acc
  torch.cuda.empty_cache()
  return img.transpose(2, 1, 0)  # (z, y, x) C order is (x, y, z) F order


def layer_data(kind: str, rng, torch, dev) -> np.ndarray:
  if kind == "segmentation":
    # labels above 2^32 in 3x3 blocks: odd blocks straddle the 2x2 windows,
    # so the votes see 2-2 ties
    blocks = rng.integers(0, 6, (683, 683, 64), dtype=np.int64).astype(np.uint64)
    blocks = blocks * np.uint64(2**33 + 7) + np.uint64(2**40)
    img = np.repeat(np.repeat(blocks, 3, axis=0), 3, axis=1)[:2048, :2048]
    return np.asfortranarray(img)
  if kind == "smooth":
    return smooth_image((4096, 4096, 64), rng, torch, dev)
  # uniform noise: incompressible, the worst case for gzip
  shape = (4096, 4096, 64) if kind == "image" else (1000, 1000, 64)
  return np.asfortranarray(rng.integers(0, 256, shape, dtype=np.uint8))


LAYERS = [
  # name, data kind, chunk size, num_mips, expected kernel
  ("image", "image", (128, 128, 64), 5, "pyramid2x2x1"),
  ("segmentation", "segmentation", (128, 128, 64), 4, "pyramid2x2x1"),
  ("ragged_image", "ragged", (64, 64, 64), 5, "pool2x2x1"),
  ("smooth_image", "smooth", (128, 128, 64), 5, "pyramid2x2x1"),
]


def written_ratio(root: str, name: str, vol, num_mips: int) -> float:
  """Raw bytes of mips 1..num_mips over the bytes their chunk files take."""
  import os

  raw = stored = 0
  for mip in range(1, num_mips + 1):
    raw += int(np.prod(vol.meta.volume_size(mip))) * vol.dtype.itemsize
    d = os.path.join(root, name, vol.meta.key(mip))
    stored += sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
  return raw / stored


def e2e_phase(root, cp, torch, dev):
  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.ops import pooling
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_downsampling_tasks

  rng = np.random.default_rng(1)
  datas = {}
  for name, kind, chunk, num_mips, _ in LAYERS:
    t0 = time.perf_counter()
    datas[name] = layer_data(kind, rng, torch, dev)
    # mip 0 goes in uncompressed to save host time; the tasks keep gzip
    Volume.from_numpy(
      datas[name], f"file://{root}/{name}", resolution=(8, 8, 40),
      chunk_size=chunk, compress=None,
    )
    print(f"ingest {name}: {datas[name].shape} {datas[name].dtype} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

  for key in cp.LAUNCHES:
    cp.LAUNCHES[key] = 0
  for name, _kind, _chunk, num_mips, expect in LAYERS:
    path = f"file://{root}/{name}"
    before = dict(cp.LAUNCHES)
    tasks = create_downsampling_tasks(path, mip=0, num_mips=num_mips)
    if len(tasks) != 1:
      fail(f"{name}: expected one task, planned {len(tasks)}")
    telemetry.reset()
    t0 = time.perf_counter()
    LocalTaskQueue(parallel=1).insert(tasks)
    wall = time.perf_counter() - t0
    stages = {k: round(v["seconds"], 4) for k, v in telemetry.snapshot().items()}
    launched = {k: cp.LAUNCHES[k] - before[k] for k in cp.LAUNCHES}
    ratio = written_ratio(root, name, Volume(path), num_mips)
    print(f"e2e {name}: task wall {wall:.3f} s, stages (s) {json.dumps(stages)}, "
          f"launches {json.dumps(launched)}, gzip ratio {ratio:.3f}", flush=True)
    if launched[expect] < 1:
      fail(f"{name}: the {expect} kernel was not launched")
  main_launches = dict(cp.LAUNCHES)
  for key, n in main_launches.items():
    if n < 1:
      fail(f"e2e: kernel {key} was launched no time on the main path")

  # read every produced mip back; compare with the plain pyramid on the card
  for name, _kind, _chunk, num_mips, _ in LAYERS:
    path = f"file://{root}/{name}"
    vol = Volume(path)
    if vol.meta.num_mips != num_mips + 1:
      fail(f"{name}: {vol.meta.num_mips} scales, expected {num_mips + 1}")
    method = pooling.method_for_layer(vol.layer_type)
    x = torch.from_numpy(datas[name].transpose(2, 1, 0)).to(dev)[None]
    refs = cp.pyramid2x2x1_plain(x, num_mips, method)
    for mip, ref in enumerate(refs, start=1):
      got = Volume(path, mip=mip)
      got = got.download(got.mip_bounds(mip))[..., 0]
      want = ref[0].cpu().numpy().transpose(2, 1, 0)
      if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"{name} mip {mip}: read back differs from the plain pyramid")
    del x, refs
    torch.cuda.empty_cache()
    print(f"e2e {name}: {num_mips} mips read back, equal to the plain pyramid", flush=True)
  return main_launches


# ---------------------------------------------------------------------------
# chunk codecs and the transfer (host codecs, the pyramid on the card)

CODEC_SAMPLE = 64  # chunks of each mip, chosen from seed 1 (all, where fewer)
CODEC_MIPS = (0, 3)
XFER_CHUNK = (64, 64, 64)
XFER_MIPS = 4
XFER_CROP = (512, 512, 64)  # the compresso transfer's bounds


def rate(nbytes: int, seconds: float) -> float:
  return round(nbytes / seconds / 1e6, 1) if seconds > 0 else float("inf")


def codec_phase(root: str) -> None:
  """Chunks of phase 3's raw uint64 segmentation through every route of
  the compressed_segmentation codec (native, numpy, the per-block loop
  spec: one stream) and through compresso, each read back equal; rates of
  one thread on the host."""
  import os

  from igneous_tpu_torch import Volume, compresso, cseg

  t_phase = time.perf_counter()
  rng = np.random.default_rng(1)
  block = (8, 8, 8)
  for mip in CODEC_MIPS:
    vol = Volume(f"file://{root}/segmentation", mip=mip)
    chunks = vol._chunks(vol.mip_bounds(mip), mip)
    pick = rng.choice(len(chunks), min(CODEC_SAMPLE, len(chunks)), replace=False)
    secs = {k: 0.0 for k in ("native_enc", "numpy_enc", "loop_enc", "native_dec",
                             "numpy_dec")}
    raw = stored = 0
    cutouts = []
    for i in sorted(pick):
      chan = vol.download(chunks[i], mip)[..., 0]  # (x, y, z), Fortran order
      cutouts.append(chan)
      t0 = time.perf_counter()
      native = cseg._native_encode_channel(chan, block)
      t1 = time.perf_counter()
      numpy_words = cseg._encode_channel(chan, block)
      t2 = time.perf_counter()
      loop = cseg._encode_channel_loop(chan, block)
      t3 = time.perf_counter()
      if not (np.array_equal(native, loop) and np.array_equal(numpy_words, loop)):
        fail(f"codec: cseg routes disagree on chunk {chunks[i]} at mip {mip}")
      words = np.concatenate([np.uint32([1]), loop])
      t4 = time.perf_counter()
      back = cseg._native_decode_channel(words[1:], chan.shape, np.uint64, block)
      t5 = time.perf_counter()
      back_np = np.empty(chan.shape, np.uint64, order="F")
      cseg._decode_channel_np(words, 1, chan.shape, block, 2, np.uint64, out=back_np)
      t6 = time.perf_counter()
      if not (np.array_equal(back, chan) and np.array_equal(back_np, chan)):
        fail(f"codec: cseg decode differs from chunk {chunks[i]} at mip {mip}")
      if cseg.compress(chan) != words.tobytes():
        fail(f"codec: cseg.compress differs from its routes at mip {mip}")
      for key, dt in zip(secs, (t1 - t0, t2 - t1, t3 - t2, t5 - t4, t6 - t5)):
        secs[key] += dt
      raw += chan.nbytes
      stored += words.nbytes
    rates = {k: rate(raw, v) for k, v in secs.items()}
    print(f"codec cseg mip {mip}: {len(pick)} chunks {chunks[0].size3().tolist()} uint64, "
          f"{raw / 2**20:.0f} MiB, native = numpy = loop bytes, decoded equal; "
          f"raw/cseg {raw / stored:.2f}; MB/s one thread {json.dumps(rates)}; "
          f"host cores {os.cpu_count()}", flush=True)

    # compresso: the same chunks, one thread
    enc = dec = 0.0
    stored = 0
    for chan in cutouts:
      t0 = time.perf_counter()
      data = compresso.compress(chan)
      t1 = time.perf_counter()
      back = compresso.decompress(data, chan.shape + (1,), np.uint64)
      t2 = time.perf_counter()
      if not np.array_equal(back[..., 0], chan):
        fail(f"codec: compresso round trip differs at mip {mip}")
      enc += t1 - t0
      dec += t2 - t1
      stored += len(data)
    print(f"codec compresso mip {mip}: {len(cutouts)} chunks round trip equal, "
          f"raw/compresso {raw / stored:.2f}, MB/s one thread "
          f"enc {rate(raw, enc)} dec {rate(raw, dec)}", flush=True)
  print(f"codec: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


def tree_bytes(path: str) -> int:
  import os

  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files)


def xfer_e2e_phase(root, cp, torch, dev):
  """Phase 3's raw segmentation through create_transfer_tasks into a
  compressed_segmentation layer of 64^3 chunks with 4 new mips (compress
  at its default), task by task on a LocalTaskQueue; every mip read back
  equal to the same mip of the raw layer (which phase 3 held against the
  plain pyramid on the card); then a compresso transfer of a crop.
  Returns the kernels' launches."""
  from igneous_tpu_torch import Bbox, Volume, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_transfer_tasks

  t_phase = time.perf_counter()
  src, dest = f"file://{root}/segmentation", f"file://{root}/segmentation_cseg"
  for key in cp.LAUNCHES:
    cp.LAUNCHES[key] = 0
  t0 = time.perf_counter()
  tasks = list(create_transfer_tasks(
    src, dest, chunk_size=XFER_CHUNK, encoding="compressed_segmentation",
    num_mips=XFER_MIPS,
  ))
  plan = time.perf_counter() - t0
  for i, task in enumerate(tasks):
    telemetry.reset()
    before = dict(cp.LAUNCHES)
    t0 = time.perf_counter()
    LocalTaskQueue(parallel=1).insert([task])
    wall = time.perf_counter() - t0
    stages = {k: round(v["seconds"], 4) for k, v in telemetry.snapshot().items()}
    launched = {k: cp.LAUNCHES[k] - before[k] for k in cp.LAUNCHES}
    print(f"e2e xfer task {i}: {task.shape.tolist()} at {task.offset.tolist()}, "
          f"wall {wall:.3f} s, stages (s) {json.dumps(stages)}, "
          f"launches {json.dumps(launched)}", flush=True)
  launches = dict(cp.LAUNCHES)
  if launches["pyramid2x2x1"] < 1:
    fail("xfer: pyramid2x2x1 was not launched")

  dvol = Volume(dest)
  if dvol.meta.num_mips != XFER_MIPS + 1:
    fail(f"xfer: {dvol.meta.num_mips} scales, expected {XFER_MIPS + 1}")
  raw = sum(int(np.prod(dvol.meta.volume_size(m))) * 8 for m in range(XFER_MIPS + 1))
  written = tree_bytes(f"{root}/segmentation_cseg")
  print(f"e2e xfer: {len(tasks)} tasks (planned in {plan:.3f} s), launches "
        f"{json.dumps(launches)}, written {written} bytes, raw {raw} bytes, "
        f"raw/written {raw / written:.2f}", flush=True)

  t0 = time.perf_counter()
  for mip in range(XFER_MIPS + 1):
    want = Volume(src, mip=mip)
    got = Volume(dest, mip=mip)
    if got.mip_bounds(mip) != want.mip_bounds(mip) or got.meta.encoding(mip) != \
        "compressed_segmentation":
      fail(f"xfer mip {mip}: bounds or encoding differ")
    a = got.download(got.mip_bounds(mip))
    b = want.download(want.mip_bounds(mip))
    if not np.array_equal(a, b):
      fail(f"xfer mip {mip}: the cseg layer differs from the raw layer")
    del a, b
  print(f"e2e xfer: mips 0-{XFER_MIPS} read back equal to the raw layer's, "
        f"{time.perf_counter() - t0:.1f} s", flush=True)

  # compresso: a crop, no pyramid
  cdest = f"file://{root}/segmentation_compresso"
  crop = Bbox((0, 0, 0), XFER_CROP)
  t0 = time.perf_counter()
  LocalTaskQueue(parallel=1).insert(create_transfer_tasks(
    src, cdest, encoding="compresso", bounds=crop, skip_downsamples=True,
  ))
  wall = time.perf_counter() - t0
  cvol = Volume(cdest)
  if cvol.meta.encoding(0) != "compresso-cpsx":
    fail(f"xfer compresso: info advertises {cvol.meta.encoding(0)!r}")
  if not np.array_equal(cvol.download(crop), Volume(src).download(crop)):
    fail("xfer compresso: the crop read back differs from the raw layer")
  print(f"e2e xfer compresso: {list(XFER_CROP)} crop in {wall:.3f} s, "
        f"{tree_bytes(f'{root}/segmentation_compresso')} bytes written, read back "
        f"equal, info advertises compresso-cpsx", flush=True)
  if any(cp.LAUNCHES[k] != launches[k] for k in launches):
    fail("xfer compresso: a kernel ran on a transfer with no pyramid")
  print(f"e2e xfer: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return launches


# ---------------------------------------------------------------------------
# connected components


def serpentine(n: int, torch, dev):
  """(z, y, x) int32 n^3: one tube that winds through every tile. Even z
  planes hold strips 7 voxels wide in x, each a row-by-row serpentine along
  y (a turn every two rows), joined by the full last row; odd z planes
  join consecutive even planes at one voxel."""
  y = torch.arange(n, device=dev).view(n, 1)
  x = torch.arange(n, device=dev).view(1, n)
  pos = x % 8
  turn_x = torch.where((y // 2) % 2 == 0, 6, 0)
  plane = ((y % 2 == 0) & (pos < 7)) | ((y % 2 == 1) & (pos == turn_x)) | (y == n - 1)
  vol = torch.zeros((n, n, n), dtype=torch.int32, device=dev)
  vol[0::2] = plane.to(torch.int32)
  vol[1::2, n - 1, 0] = 1
  return vol


def ccl_kernel_phase(cc, ccl_ops, torch, dev, others=()):
  """tile_resolve against tile_resolve_plain at the default task's 449^3
  cutout: five cases in the CUDA default tile, then every tile of the
  sweep and an odd tile at connectivity 6 and 26. Each check runs the
  kernel twice and needs the same output both times and bit for bit the
  plain version's. ``others`` are (name, cuda_ccl of another copy of the
  package) to time the five cases against."""
  n = CCL_CUTOUT
  tile = ccl_ops._tile_shape(dev)
  rng = np.random.default_rng(1)
  mask = smooth_image((n, n, n), rng, torch, dev) >= 128  # (x, y, z)
  mask = torch.from_numpy(np.ascontiguousarray(mask.transpose(2, 1, 0))).to(dev).to(torch.int32)
  g = torch.Generator(device=dev).manual_seed(2)
  dense = torch.randint(1, 4, (n, n, n), dtype=torch.int32, device=dev, generator=g)
  inputs = [
    ("mask of the smooth image >= 128", mask, 6),
    ("dense multilabel, 3 labels", dense, 6),
    ("serpentine tube", serpentine(n, torch, dev), 6),
    ("dense multilabel, 3 labels, connectivity 26", dense, 26),
    ("dense multilabel, 3 labels, connectivity 18", dense, 18),
  ]

  def check(label, labt, conn):
    """The kernel twice and its plain version: max abs err, plain ms."""
    first = cc.tile_resolve(labt, conn)
    second = cc.tile_resolve(labt, conn)
    t0 = time.perf_counter()
    plain = cc.tile_resolve_plain(labt, conn)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(first, second):
      fail(f"tile_resolve {label}: two runs gave different outputs")
    err = 0.0 if torch.equal(first, plain) else float(
      (first.to(torch.int64) - plain.to(torch.int64)).abs().max()
    )
    if err > TOLERANCE:
      fail(f"tile_resolve {label}: max abs err {err} against its plain version")
    return err, plain_s

  def instance(labt):
    return "fixed" if cc.fixed_instance(labt.shape[1:], labt.data_ptr()) else "runtime"

  cases = []
  for label, vol, conn in inputs:
    labt = ccl_ops.to_tiles(vol, tile)[0]
    err, _ = check(label, labt, conn)
    nbytes = 2 * labt.numel() * labt.element_size()
    # one label comparison per neighbour pair: half the neighbourhood
    ops = labt.numel() * len(cc.neighbor_offsets(conn)) // 2
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT32_OPS_PER_S
    fn = lambda: cc.tile_resolve(labt, conn)  # noqa: E731
    case = {
      "kernel": "tile_resolve",
      "case": f"{label}, {n}^3, tiles {list(labt.shape)}, {instance(labt)} instance",
      "max_abs_err": err,
      "ms": device_ms(fn),
      "call_ms": cuda_ms(fn, reps=20),
      "plain_ms": cuda_ms(lambda: cc.tile_resolve_plain(labt, conn), reps=3, warmup=1),
      "bound_ms": max(bytes_ms, ops_ms),
      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      "library": "none",
    }
    if others:
      case["against"] = against(fn, [(k, lambda m=m: m.tile_resolve(labt, conn)) for k, m in others])
      if not all(r["equal"] for r in case["against"]):
        fail(f"tile_resolve {label}: differs from the other copy's kernel")
    print("kernel " + json.dumps(case), flush=True)
    print("library: none (PyTorch has no connected-components call)", flush=True)
    cases.append(case)
  # every tile of the sweep, and an odd tile (the runtime-shape instance,
  # plain loads), checked on the mask at 6 and on dense labels at 26; the
  # time on the mask, and the share of voxel pairs that straddle a tile
  # face (what the host merge handles)
  for sweep in CCL_TILE_SWEEP + [CCL_ODD_TILE]:
    line = {"tile": list(sweep), "default": tuple(sweep) == tuple(tile),
            "face_pairs_a_voxel": sum(1 / t for t in sweep)}
    for label, vol, conn in (inputs[0], inputs[3]):
      labt = ccl_ops.to_tiles(vol, sweep)[0]
      line["instance"] = instance(labt)
      line[f"plain_s_{conn}"] = check(f"{label}, tile {list(sweep)}", labt, conn)[1]
      fn = lambda: cc.tile_resolve(labt, conn)  # noqa: E731
      line[f"ms_{conn}"] = device_ms(fn)
      if others:
        line[f"against_{conn}"] = against(
          fn, [(k, lambda m=m: m.tile_resolve(labt, conn)) for k, m in others], reps=5)
    print("tile sweep " + json.dumps(line), flush=True)
  del inputs, mask, dense, labt
  torch.cuda.empty_cache()
  return cases


def blobs(shape, n_labels: int, n_blobs: int, rng, torch, dev) -> np.ndarray:
  """(x, y, z) uint64 Fortran-ordered: background 0 and ``n_blobs`` balls
  (radius 8..32) painted with ``n_labels`` labels above 2^32, so one label
  recurs in places that do not touch. Painted on the card from ``rng``."""
  X, Y, Z = shape
  vol = torch.zeros((Z, Y, X), dtype=torch.int64, device=dev)
  values = 2**32 + 7919 * (1 + rng.permutation(10 * n_labels)[:n_labels])
  for _ in range(n_blobs):
    r = int(rng.integers(8, 33))
    cz, cy, cx = (int(rng.integers(0, s)) for s in (Z, Y, X))
    z0, y0, x0 = max(cz - r, 0), max(cy - r, 0), max(cx - r, 0)
    z1, y1, x1 = min(cz + r + 1, Z), min(cy + r + 1, Y), min(cx + r + 1, X)
    zz = torch.arange(z0, z1, device=dev).view(-1, 1, 1) - cz
    yy = torch.arange(y0, y1, device=dev).view(1, -1, 1) - cy
    xx = torch.arange(x0, x1, device=dev).view(1, 1, -1) - cx
    ball = zz * zz + yy * yy + xx * xx <= r * r
    box = vol[z0:z1, y0:y1, x0:x1]
    box[ball] = int(values[int(rng.integers(n_labels))])
  out = vol.cpu().numpy().view(np.uint64).transpose(2, 1, 0)
  del vol
  torch.cuda.empty_cache()
  return out


CCL_LAYERS = [
  # name, shape (x, y, z), dtype, ccl_auto options; both layers run at half
  # the depth of the default 448^3 task (the mask layer since the mesh
  # phase, the segmentation since phases 8 and 9) so that the whole
  # script stays inside its time limit
  ("ccl_mask", (896, 896, 224), "uint8", {"threshold_gte": 128}),
  ("ccl_segmentation", (896, 448, 224), "uint64", {}),
]
CCL_BLOBS = 750  # balls of the segmentation layer (1500 at its full depth)


def oracle(data: np.ndarray, kw: dict, torch, dev):
  """scipy.ndimage.label, 6-connected: of the thresholded image, or of each
  label of a segmentation, on the (z, y, x) view (C-contiguous, as the
  arrays are Fortran-ordered (x, y, z)). Returns (components, an int64
  (z, y, x) tensor on the card, and their count)."""
  from scipy import ndimage

  s6 = ndimage.generate_binary_structure(3, 1)
  zyx = data.transpose(2, 1, 0)
  if "threshold_gte" in kw:
    exp, n = ndimage.label(zyx >= kw["threshold_gte"], structure=s6)
    return torch.from_numpy(exp).to(dev).to(torch.int64), n
  seg = torch.from_numpy(zyx.view(np.int64)).to(dev)  # labels are below 2^63
  exp = torch.zeros(seg.shape, dtype=torch.int64, device=dev)
  total = 0
  for v in torch.unique(seg[seg != 0]).tolist():
    m, k = ndimage.label((seg == v).cpu().numpy(), structure=s6)
    m = torch.from_numpy(m).to(dev).to(torch.int64)
    exp = torch.where(m > 0, m + total, exp)
    total += k
  return exp, total


def same_partition(out: np.ndarray, exp, torch, dev) -> bool:
  """True when ``out`` ((x, y, z) uint16 or uint32, Fortran-ordered) and
  ``exp`` (its (z, y, x) oracle on the card) have the same background and a
  bijection between their component ids (checked on the card)."""
  signed = {2: np.int16, 4: np.int32}[out.dtype.itemsize]
  a = torch.from_numpy(out.transpose(2, 1, 0).view(signed)).to(dev).to(torch.int64)
  a &= (1 << (8 * out.dtype.itemsize)) - 1
  fg = a != 0
  if not torch.equal(fg, exp != 0):
    return False
  a, b = a[fg], exp[fg]
  for x, y in ((a, b), (b, a)):
    m = torch.full((int(x.max()) + 1,), -1, dtype=torch.int64, device=dev)
    m[x] = y
    if not torch.equal(m[x], y):
      return False
  return True


class TimedQueue:
  """A LocalTaskQueue that records, for each insert (each pass of
  ccl_auto), its start and end on the host clock, its task count and the
  telemetry stages of its tasks."""

  def __init__(self):
    from igneous_tpu_torch.queues import LocalTaskQueue

    self.queue = LocalTaskQueue(parallel=1)
    self.passes = []

  def insert(self, tasks):
    from igneous_tpu_torch import telemetry

    tasks = list(tasks)
    telemetry.reset()
    t0 = time.perf_counter()
    self.queue.insert(tasks)
    t1 = time.perf_counter()
    self.passes.append({
      "start": t0, "end": t1, "tasks": len(tasks),
      "stages": {k: round(v["seconds"], 4) for k, v in telemetry.snapshot().items()},
    })


def ccl_e2e_phase(root, cc, cp, torch, dev):
  """Each CCL layer through ccl_auto; returns tile_resolve's launches."""
  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.task_creation import ccl_auto

  rng = np.random.default_rng(1)
  launches = 0
  for name, shape, dtype, kw in CCL_LAYERS:
    t0 = time.perf_counter()
    if dtype == "uint8":
      data = smooth_image(shape, rng, torch, dev)
    else:
      data = blobs(shape, 16, CCL_BLOBS, rng, torch, dev)
    src, dest = f"file://{root}/{name}", f"file://{root}/{name}_out"
    Volume.from_numpy(data, src, resolution=(8, 8, 40), chunk_size=(64, 64, 64),
                      compress=None)
    print(f"ingest {name}: {data.shape} {data.dtype} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    queue = TimedQueue()
    for counts in (cc.LAUNCHES, cp.LAUNCHES):
      for key in counts:
        counts[key] = 0
    t0 = time.perf_counter()
    max_label = ccl_auto(src, dest, shape=CCL_TASK_SHAPE, queue=queue,
                         encoding="raw", **kw)
    wall = time.perf_counter() - t0
    launched = cc.LAUNCHES["tile_resolve"]
    p1, p2, p4 = queue.passes
    walls = {
      "faces": p1["end"] - p1["start"], "links": p2["end"] - p2["start"],
      "calc-labels": p4["start"] - p2["end"], "relabel": p4["end"] - p4["start"],
      "clean": t0 + wall - p4["end"],
    }
    print(f"e2e {name}: ccl_auto {wall:.3f} s, {p1['tasks']} tasks, "
          f"max_label {max_label}, tile_resolve launches {launched}, "
          f"pass walls (s) {json.dumps({k: round(v, 3) for k, v in walls.items()})}",
          flush=True)
    for pname, p in zip(("faces", "links", "relabel"), queue.passes):
      print(f"e2e {name} {pname}: stages over {p['tasks']} tasks (s) "
            f"{json.dumps(p['stages'])}", flush=True)
    if any(cp.LAUNCHES.values()):
      fail(f"{name}: the pooling kernels ran on the CCL path")
    if launched < 3 * p1["tasks"]:
      fail(f"{name}: tile_resolve launched {launched} times for "
           f"{p1['tasks']} tasks in 3 recomputing passes")
    launches += launched

    t0 = time.perf_counter()
    exp, n = oracle(data, kw, torch, dev)
    vol = Volume(dest)
    out = vol.download(vol.mip_bounds(0))[..., 0]
    ok = same_partition(out, exp, torch, dev)
    print(f"e2e {name}: oracle {n} components, same partition {ok}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not ok or max_label != n:
      fail(f"{name}: destination differs from scipy.ndimage.label "
           f"(max_label {max_label}, oracle {n}, same partition {ok})")
    del data, exp, out
    torch.cuda.empty_cache()
  return launches


# ---------------------------------------------------------------------------
# meshing

# (x, y, z): two tasks of the default 448^3 shape, at half its depth so that
# the whole script, skeleton phase included, stays near 700 s
MESH_SHAPE = (896, 448, 224)
MESH_SEEDS = 500
MESH_SAMPLE = 64  # labels of the first task held card against CPU, + its largest
# threads for the per-label simplification inside each task (the forge's
# --simplify-parallel; its output does not depend on it): at the default 1
# the host's QEM collapse takes 93% of a 179-201 s task, and the phase would
# not fit half the run's time limit beside the others;
# --mesh-simplify-threads 1 runs the forge with every default
MESH_SIMPLIFY_THREADS = 8
# the XLA device programs of the mesh path that the port runs as torch ops
MESH_PROGRAMS = {
  "X1 mc_count": "igneous_tpu/ops/mesh.py:543",
  "X2 mc_emit": "igneous_tpu/ops/mesh.py:613",
  "X3 mt_count": "igneous_tpu/ops/mesh.py:126",
}


def voronoi_segmentation(shape, n_seeds: int, rng, torch, dev) -> np.ndarray:
  """(x, y, z) uint64 Fortran-ordered: the Voronoi partition (in voxel
  distances) of ``n_seeds`` random seeds, with ids above 2^32, eight of
  them at or above 2^63, and every voxel with a 6-neighbour of another
  label set to 0, like the membrane gaps of an EM segmentation. Made on
  the card from ``rng``."""
  X, Y, Z = shape
  seeds = torch.from_numpy(rng.random((n_seeds, 3)) * np.array([X, Y, Z])).to(dev, torch.float32)
  ids = (2**32 + 7919 * (1 + rng.permutation(10 * n_seeds)[:n_seeds])).astype(np.uint64)
  ids[rng.choice(n_seeds, 8, replace=False)] |= np.uint64(2**63)
  ids = torch.from_numpy(ids.view(np.int64)).to(dev)
  yy, xx = torch.meshgrid(torch.arange(Y, device=dev), torch.arange(X, device=dev), indexing="ij")
  pts = torch.stack([xx.reshape(-1), yy.reshape(-1), torch.zeros_like(xx).reshape(-1)], 1)
  pts = pts.to(torch.float32)
  seg = torch.empty((Z, Y, X), dtype=torch.int64, device=dev)
  for z in range(Z):
    pts[:, 2] = z
    seg[z] = ids[torch.cdist(pts, seeds).argmin(1)].view(Y, X)
  edge = torch.zeros(seg.shape, dtype=torch.bool, device=dev)
  for d in range(3):
    n = seg.shape[d]
    diff = seg.narrow(d, 1, n - 1) != seg.narrow(d, 0, n - 1)
    edge.narrow(d, 1, n - 1).logical_or_(diff)
    edge.narrow(d, 0, n - 1).logical_or_(diff)
  seg.masked_fill_(edge, 0)
  out = seg.cpu().numpy().view(np.uint64).transpose(2, 1, 0)
  del seg, edge, diff
  if dev.type == "cuda":
    torch.cuda.empty_cache()
  return out


def check_manifests(path: str) -> int:
  """Every fragment in the mesh directory is listed in exactly one
  manifest, its label's, and every listed fragment exists. Returns the
  fragment count."""
  from igneous_tpu_torch import CloudFiles, Volume

  mdir = Volume(path).info["mesh"]
  cf = CloudFiles(path)
  names = [k.split("/")[-1] for k in cf.list(f"{mdir}/")]
  frags = {n for n in names if n.count(":") == 2}
  listed = []
  for manifest in (n for n in names if n.count(":") == 1):
    label = manifest.split(":")[0]
    doc = cf.get_json(f"{mdir}/{manifest}")
    for name in doc["fragments"]:
      if name.split(":")[0] != label:
        fail(f"mesh: manifest {manifest} lists another label's fragment {name}")
    listed += doc["fragments"]
  if len(listed) != len(set(listed)) or set(listed) != frags:
    fail(f"mesh: {len(frags)} fragments, {len(listed)} manifest entries "
         f"({len(set(listed))} distinct, {len(set(listed) - frags)} missing)")
  return len(frags)


def mesh_card_against_cpu(task, path: str, sample: int, torch, dev):
  """The first task's label work and ``sample`` of its labels (from seed
  1) plus its largest, on the card and on the CPU: equal jobs and dense
  labels, and byte for byte the same unsimplified and simplified meshes,
  equal to the fragments the run wrote. Returns the card's context."""
  from igneous_tpu_torch import CloudFiles, Volume, set_device
  from igneous_tpu_torch.mesh_io import Mesh, simplify
  from igneous_tpu_torch.ops.mesh import marching_cubes_batch
  from igneous_tpu_torch.tasks import MeshTask

  t0 = time.perf_counter()
  card = task.prepare_jobs()
  set_device("cpu")
  try:
    cpu = task.prepare_jobs()
  finally:
    set_device(dev)
  if card["jobs"] != cpu["jobs"]:
    fail("mesh: the card's labels, boxes or dense ids differ from the CPU's")
  if not torch.equal(card["dense"].cpu(), cpu["dense"]):
    fail("mesh: the card's dense renumbering differs from the CPU's")
  jobs = card["jobs"]
  voxels = torch.bincount(card["dense"].view(-1)).cpu().numpy()
  largest = max(range(len(jobs)), key=lambda j: int(voxels[jobs[j][2]]))
  pick = np.random.default_rng(1).choice(len(jobs), min(sample, len(jobs)), replace=False)
  group = [jobs[j] for j in sorted(set(pick.tolist()) | {largest})]
  mdir = Volume(path).info["mesh"]
  cf = CloudFiles(path)
  meshes = []
  for g0 in range(0, len(group), MeshTask.MESH_BATCH):
    grp = group[g0 : g0 + MeshTask.MESH_BATCH]
    res = [
      marching_cubes_batch(MeshTask.group_masks(ctx, grp), anisotropy=ctx["resolution"],
                           offsets=MeshTask.group_offsets(ctx, grp))
      for ctx in (card, cpu)
    ]
    for (label, _, _), (v, f), (cv, cf_) in zip(grp, *res):
      if v.dtype != cv.dtype or f.dtype != cf_.dtype or not (
        np.array_equal(v, cv) and np.array_equal(f, cf_)
      ):
        fail(f"mesh: label {label}: the card's mesh differs from the CPU's")
      meshes.append((label, Mesh(v, f)))

  def simplified_as_written(item):
    # equal inputs to the same host code: one simplification serves both
    label, mesh = item
    small = simplify(mesh, task.simplification_factor, task.max_simplification_error)
    written = cf.get(f"{mdir}/{label}:0:{card['core'].to_filename()}")
    return written is not None and Mesh.from_precomputed(written) == small

  with ThreadPoolExecutor(MESH_SIMPLIFY_THREADS) as pool:
    same = list(pool.map(simplified_as_written, meshes))
  for (label, _), ok in zip(meshes, same):
    if not ok:
      fail(f"mesh: label {label}: the written fragment differs from the card's mesh")
  faces = sum(len(m.faces) for _, m in meshes)
  big = jobs[largest]
  print(f"e2e mesh check: task 0, {len(group)} of {len(jobs)} labels (the largest, "
        f"{big[0]}, {int(voxels[big[2]])} voxels): card and CPU equal byte for byte "
        f"(jobs, dense ids, {faces} faces unsimplified, the simplified meshes, the "
        f"written fragments) {time.perf_counter() - t0:.1f} s", flush=True)
  return card


def profiled_device_ms(fn, torch, reps: int = 5, attempts: int = 3) -> float:
  """Kernel time on the card per call of ``fn`` (a sequence of torch ops),
  summed from a torch.profiler trace. A trace that shows no kernel time
  is taken again, up to ``attempts`` traces in all (an H100 run once gave
  an empty trace of a program that had traced before); fails where every
  trace shows none."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  for attempt in range(1, attempts + 1):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    us = traced_device_us(prof)
    if us > 0:
      if attempt > 1:
        print(f"profiler: kernel time in trace {attempt} of {attempts}", flush=True)
      return us / 1e3 / reps
    print(f"profiler: trace {attempt} of {attempts} shows no kernel time", flush=True)
  fail("profiler: the trace shows no kernel time on the card")


def traced_device_us(prof) -> float:
  """Microseconds of kernels and copies on the card in a profiler trace."""
  return sum(
    getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    for e in prof.key_averages()
  )


def mesh_programs(ctx, passes_per_task, torch, dev):
  """X1-X3 at the first task's largest count pass (the bucket batch with
  the most voxels): time per call between CUDA events, kernel time from
  the profiler, and the bytes bound (input and output bytes once)."""
  from igneous_tpu_torch.ops import mesh as mesh_ops
  from igneous_tpu_torch.tasks import MeshTask

  best = None
  jobs = ctx["jobs"]
  for g0 in range(0, len(jobs), MeshTask.MESH_BATCH):
    masks = MeshTask.group_masks(ctx, jobs[g0 : g0 + MeshTask.MESH_BATCH])
    buckets = {}
    for i in range(len(masks)):
      buckets.setdefault(mesh_ops._bucket_shape(masks.shape(i)), []).append(i)
    for bucket, idxs in buckets.items():
      size = len(idxs) * int(np.prod(bucket))
      if best is None or size > best[0]:
        best = (size, masks, bucket, idxs)
  _, masks, (bx, by, bz), idxs = best
  batch = torch.empty((len(idxs), bz, by, bx), dtype=torch.uint8, device=dev)
  for k, i in enumerate(idxs):
    masks.fill(i, batch[k])
  case, ntri, _ = mesh_ops._mc_count_kernel(batch)
  mesh_ops._drop_pad_ring(ntri, [tuple(s - 1 for s in masks.shape(i)) for i in idxs])
  nt = ntri.reshape(-1)
  total = int(nt.sum(dtype=torch.int64))
  cells = case.numel()
  label = f"{len(idxs)} masks of bucket {bx}x{by}x{bz}, {total} triangles"
  runs = [
    ("X1 mc_count", lambda: mesh_ops._mc_count_kernel(batch),
     batch.numel() + 2 * cells + 8 * len(idxs), passes_per_task),
    ("X2 mc_emit", lambda: mesh_ops._mc_tris(case, *mesh_ops._emit_slots(nt, total)),
     nt.numel() + 36 * total, passes_per_task),
    ("X3 mt_count", lambda: mesh_ops._count_kernel(batch),
     batch.numel() + 12 * cells + 8 * len(idxs), 0),
  ]
  programs = []
  for name, fn, nbytes, launches in runs:
    programs.append({
      "name": name, "replaces": MESH_PROGRAMS[name], "case": label,
      "launches_per_task": launches,
      "ms": cuda_ms(fn, reps=10), "device_ms": profiled_device_ms(fn, torch),
      "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
    })
  del batch, case, ntri, nt
  torch.cuda.empty_cache()
  return programs


def mesh_e2e_phase(root, torch, dev, shape=MESH_SHAPE, n_seeds=MESH_SEEDS,
                   sample=MESH_SAMPLE, simplify_threads=MESH_SIMPLIFY_THREADS):
  """The mesh forge and merge on a Voronoi segmentation with the defaults
  (task shape 448^3, simplification 100 with error 40, spatial index,
  gzip) but ``simplify_threads``: per task its wall, stage split (a
  stage's seconds are summed over the simplification threads), label and
  face counts, the card's busy time from a profiler trace of the task
  and its peak memory; the merge's wall; manifest coverage; the first
  task's labels held card against CPU; the device programs. Returns the
  programs."""
  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_mesh_manifest_tasks, create_meshing_tasks
  from torch.profiler import ProfilerActivity, profile

  t0 = time.perf_counter()
  data = voronoi_segmentation(shape, n_seeds, np.random.default_rng(1), torch, dev)
  path = f"file://{root}/mesh_segmentation"
  Volume.from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(64, 64, 64),
                    compress=None)
  print(f"ingest mesh_segmentation: {data.shape} {data.dtype}, "
        f"{len(np.unique(data)) - 1} labels {time.perf_counter() - t0:.1f} s", flush=True)
  del data

  tasks = list(create_meshing_tasks(path, parallel=simplify_threads))
  if len(tasks) != 2:
    fail(f"mesh: expected 2 tasks, planned {len(tasks)}")
  queue = LocalTaskQueue(parallel=1)
  passes = 0
  for i, task in enumerate(tasks):
    telemetry.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      queue.insert([task])
      wall = time.perf_counter() - t0
    busy = traced_device_us(prof) / 1e6
    if not busy > 0:
      fail(f"mesh task {i}: the trace shows no work on the card")
    snap = telemetry.snapshot()
    counts = telemetry.counters()
    passes += snap["count"]["count"]
    print(f"e2e mesh task {i}: wall {wall:.3f} s, {simplify_threads} simplification "
          f"thread(s), {counts['labels']} labels, "
          f"{counts['faces']} faces, {counts['faces_simplified']} simplified, "
          f"card busy {busy:.4f} s (traced; idle {100 * (1 - busy / wall):.2f}%), "
          f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
          f"stages (s) {json.dumps({k: round(v['seconds'], 4) for k, v in snap.items()})}, "
          f"entries {json.dumps({k: v['count'] for k, v in snap.items()})}", flush=True)
  t0 = time.perf_counter()
  queue.insert(create_mesh_manifest_tasks(path, magnitude=2))
  merge = time.perf_counter() - t0
  frags = check_manifests(path)
  print(f"e2e mesh merge: wall {merge:.3f} s, {frags} fragments, each listed in "
        f"exactly one manifest, every listed fragment exists", flush=True)
  ctx = mesh_card_against_cpu(tasks[0], path, sample, torch, dev)
  if dev.type != "cuda":
    return []
  return mesh_programs(ctx, passes / len(tasks), torch, dev)


# ---------------------------------------------------------------------------
# EDT and skeletons

# (x, y, z): two tasks of the default 512^3 shape at half its depth (and
# half the tubes of the full depth), so that phases 8 and 9 fit the run
SKEL_SHAPE = (1024, 512, 256)
SKEL_TUBES = 150
SKEL_SAMPLE = 32  # labels of the first task held card against CPU, + its largest
SKEL_MIN_CROSSING = 10  # boundary-crossing tube components the merge check needs
# threads for the per-label tracing of each task (the task's ``parallel``;
# its output does not depend on it), as the mesh phase uses 8 threads
SKEL_TRACE_THREADS = 8
EDT_CUTOUT = 513  # the default skeleton task's cutout: 512^3 plus the overlap
# (x, y, z) shapes whose lines exceed the shared-memory threshold (7264
# after the first pass): along z, and along x
EDT_LONG_Z = (32, 32, 8192)
EDT_LONG_X = (8192, 64, 64)
EDT_WORST = 515  # side of the worst-stack-depth case
EDT_REPLACES = "igneous_tpu/ops/edt.py:256"  # _edt_sq_kernel (XLA), three axis passes
# the JAX package's host EDT (threaded C++), timed as context only
HOST_EDT_SOURCE = "igneous_tpu/native/csrc/edt.cpp"


def neurites(shape, n_tubes: int, rng, torch, dev):
  """(z, y, x) int64 on ``dev`` holding uint64 bits: ``n_tubes`` tubes of
  radius 3-12 voxels along random polylines (5-8 segments of 60-160
  voxels, turning by up to 60 degrees), painted in order, so that later
  tubes cut earlier ones, with ids above 2^32, eight of them at or above
  2^63 (all of them if fewer). ``shape`` is (x, y, z). Made on the card
  from ``rng``."""
  X, Y, Z = shape
  vol = torch.zeros((Z, Y, X), dtype=torch.int64, device=dev)
  ids = (2**32 + 7919 * (1 + rng.permutation(10 * n_tubes)[:n_tubes])).astype(np.uint64)
  ids[rng.choice(n_tubes, min(8, n_tubes), replace=False)] |= np.uint64(2**63)
  size = np.array([X, Y, Z], dtype=np.float64)
  for t in range(n_tubes):
    r = float(rng.uniform(3, 12))
    p = rng.random(3) * size
    d = rng.standard_normal(3)
    d /= np.linalg.norm(d)
    label = int(ids.view(np.int64)[t])
    for _ in range(int(rng.integers(5, 9))):
      turn = rng.standard_normal(3)
      turn -= turn.dot(d) * d
      turn /= np.linalg.norm(turn)
      ang = float(rng.uniform(0, np.pi / 3))
      d = np.cos(ang) * d + np.sin(ang) * turn
      q = np.clip(p + d * rng.uniform(60, 160), 0, size - 1)
      lo = np.maximum(np.floor(np.minimum(p, q) - r), 0).astype(int)
      hi = np.minimum(np.ceil(np.maximum(p, q) + r) + 1, size).astype(int)
      xs = torch.arange(lo[0], hi[0], device=dev, dtype=torch.float32).view(1, 1, -1)
      ys = torch.arange(lo[1], hi[1], device=dev, dtype=torch.float32).view(1, -1, 1)
      zs = torch.arange(lo[2], hi[2], device=dev, dtype=torch.float32).view(-1, 1, 1)
      seg = q - p
      den = float(seg.dot(seg)) or 1.0
      u = ((xs - p[0]) * seg[0] + (ys - p[1]) * seg[1] + (zs - p[2]) * seg[2]) / den
      u = u.clamp(0, 1)
      dist2 = (xs - p[0] - u * seg[0]) ** 2 + (ys - p[1] - u * seg[1]) ** 2 \
        + (zs - p[2] - u * seg[2]) ** 2
      box = vol[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]]
      box.masked_fill_(dist2 <= r * r, label)
      p = q
  return vol


def host_edt_lib(torch):
  """The JAX package's host EDT (``HOST_EDT_SOURCE``) built with g++ into
  the port's build directory, or None where the source is absent. It is
  timed as context beside the card's EDT, and its output is held against
  the kernel's."""
  import ctypes
  import hashlib
  import os

  path = os.path.join(os.path.dirname(os.path.abspath(__file__)), HOST_EDT_SOURCE)
  if not os.path.exists(path):
    return None
  from igneous_tpu_torch.ops import _build

  src = open(path, "rb").read()
  out = _build.BUILD_DIR / f"libhostedt-{hashlib.sha256(src).hexdigest()[:8]}.so"
  if not out.exists():
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", *_build.GXX_FLAGS, "-o", str(out), path],
                   check=True, capture_output=True)
  lib = ctypes.CDLL(str(out))
  lib.edt_ml_sq64.restype = None
  lib.edt_ml_sq64.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
  ]
  return lib


def host_squared_edt(lib, lab, anisotropy):
  """Seconds and (z, y, x) float32 result of the host EDT on the (z, y, x)
  int64 tensor ``lab`` (passes along x, y, z, as the port's)."""
  import ctypes

  xyz = np.ascontiguousarray(lab.cpu().numpy().transpose(2, 1, 0))
  out = np.empty(xyz.shape, dtype=np.float32)
  t0 = time.perf_counter()
  lib.edt_ml_sq64(xyz.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
                  *xyz.shape, *(float(a) for a in anisotropy), 0)
  return time.perf_counter() - t0, out.transpose(2, 1, 0)


def squared_edt_with(edt_pass, lab, anisotropy):
  """The three passes of ``ops.edt.squared_edt`` with ``edt_pass``: a plain
  version, or another copy's kernel."""
  import torch

  wx, wy, wz = anisotropy
  a = torch.empty(lab.shape, dtype=torch.float32, device=lab.device)
  b = torch.empty_like(a)
  edt_pass(lab, a, a, 2, wx, True)
  edt_pass(lab, a, b, 1, wy, False)
  edt_pass(lab, b, a, 0, wz, False)
  return a


def plain_squared_edt(ce, lab, anisotropy):
  """The three passes of ``ops.edt.squared_edt`` with the plain version."""
  return squared_edt_with(ce.edt_pass_plain, lab, anisotropy)


# FP64 instructions a voxel, counted from csrc/edt.cu: a __ddiv_rn is
# FP64_PER_DIV of them (the reciprocal's Newton steps and the rounding
# correction nvcc emits for sm_90, its fast path), an add, subtract or
# multiply one
FP64_PER_DIV = 8
# 64 FP64 lanes per SM x 132 SMs x 1.98 GHz boost (Hopper white paper)
FP64_OPS_PER_S = 64 * 132 * 1.98e9


def edt_fp64_ops(lab, anisotropy, torch) -> float:
  """The least FP64 work of the three passes on this field, counted from
  the kernel's code and this run's data: the edge term's two multiplies
  for every voxel of every pass; in the y and z passes, for each value
  below the skip threshold (a push) its height (a division) and its
  offset (an add) and, at the queries, one add and one multiply; and for
  every push but the first of a run one pop test (a division, an add and
  a subtract). The values are the x and y passes' outputs."""
  from igneous_tpu_torch.ops import cuda_edt as ce

  wx, wy, _ = anisotropy
  ops = 3 * 2 * lab.numel()
  vals = torch.empty(lab.shape, dtype=torch.float32, device=lab.device)
  ce.edt_pass(lab, vals, vals, 2, wx, True)
  for axis in (1, 0):
    pushes = int((vals < ce._SKIP).sum())
    moved = lab.movedim(axis, -1)
    runs = int((moved[..., 1:] != moved[..., :-1]).sum()) + moved.numel() // moved.shape[-1]
    ops += pushes * (FP64_PER_DIV + 1 + 2) + max(0, pushes - runs) * (FP64_PER_DIV + 2)
    if axis == 1:
      vals = ce.edt_pass(lab, vals, torch.empty_like(vals), 1, wy, False)
  return float(ops)


def edt_bound(lab, anisotropy, torch):
  """(ms, "bytes" or "operations"): the least time of the three passes,
  the larger of the bytes (labels read once a pass, values read in passes
  2-3 and written in all three, float32) over the memory rate and the
  FP64 work of ``edt_fp64_ops`` over the FP64 rate."""
  nbytes = lab.numel() * (3 * lab.element_size() + 5 * 4)
  bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
  fp64_ms = 1e3 * edt_fp64_ops(lab, anisotropy, torch) / FP64_OPS_PER_S
  return (bytes_ms, "bytes") if bytes_ms >= fp64_ms else (fp64_ms, "operations"), fp64_ms


def edt_single_passes(ce, lab, label, g, torch, reps: int = 0):
  """``edt_pass`` alone on each axis, first and not, on seeded random
  values (uniform in [0, 1000), one in twenty 1e20), against its plain
  version bit for bit; returns {pass: device ms} when ``reps``."""
  dev = lab.device
  val = torch.rand(lab.shape, device=dev, generator=g) * 1000
  val[torch.rand(lab.shape, device=dev, generator=g) < 0.05] = ce.INF
  times = {}
  for axis in (0, 1, 2):
    for first in (True, False):
      got = ce.edt_pass(lab, val, torch.empty_like(val), axis, 3.0, first)
      ref = ce.edt_pass_plain(lab, val, torch.empty_like(val), axis, 3.0, first)
      if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        fail(f"edt_pass {label}: axis {axis} first={first} differs from its plain version")
      if reps:
        out = torch.empty_like(val)
        times[f"axis {axis}{' first' if first else ''}"] = device_ms(
          lambda: ce.edt_pass(lab, val, out, axis, 3.0, first), reps=reps, batch=3)
      del got, ref
  return times


def edt_kernel_phase(ce, edt_ops, torch, dev, others=()):
  """``edt_pass`` against its plain version on the card, bit for bit, on
  five cases: the default task's field (a 513^3 cutout of neurite-like
  uint64 labels, some at or above 2^63, padded to 515^3) at (8, 8, 40);
  a 257^3 crop of it at (1, 1, 1), and its low 32 bits as int32 labels;
  thin slabs; an odd shape. Each case runs twice and must give the same
  output; the float32 square root and cleared background must equal
  numpy's sqrt of the same squared field. The first case is also timed
  pass by pass, against each (name, cuda_edt of another copy of the
  package) of ``others`` in turns with equal outputs, and held against
  the JAX package's host EDT and timed there, as context. Then single
  passes on seeded random values along each axis, first and not, on the
  first case; the worst stack depth (one label, equal values: every
  position a stack entry) at 515^3, timed; and two cases whose lines
  exceed the shared-memory threshold (the long-line kernel), along z and
  along x."""
  rng = np.random.default_rng(1)
  g = torch.Generator(device=dev).manual_seed(1)
  n = EDT_CUTOUT
  field = neurites((n, n, n), 180, rng, torch, dev)
  full = torch.nn.functional.pad(field, (1, 1, 1, 1, 1, 1))
  slabs = torch.zeros((128, 256, 512), dtype=torch.int64, device=dev)  # (z, y, x)
  slabs[:, :, ::2] = 5  # 1-thick x slabs
  slabs[:, :128, :] += 7  # a label wall mid-y
  slabs[32:96, 64:192, 128:384] = 11
  odd = neurites((257, 3, 129), 6, rng, torch, dev)
  crop = full[:257, :257, :257]
  long_z = neurites(EDT_LONG_Z, 40, rng, torch, dev)
  long_x = neurites(EDT_LONG_X, 40, rng, torch, dev)
  inputs = [
    ("neurites 513^3 cutout padded to 515^3, uint64, (8, 8, 40)", full, (8, 8, 40)),
    ("neurites 257^3 crop of it, uint64, (1, 1, 1)", crop, (1, 1, 1)),
    ("neurites 257^3 crop, low 32 bits as int32, (8, 8, 40)", crop.to(torch.int32), (8, 8, 40)),
    ("thin slabs (512, 256, 128), (2, 3, 5)", slabs, (2, 3, 5)),
    ("odd shape (257, 3, 129) neurites, (4, 4, 40)", odd, (4, 4, 40)),
    (f"long lines along z {tuple(long_z.shape[::-1])} neurites, (8, 8, 40)", long_z, (8, 8, 40)),
    (f"long lines along x {tuple(long_x.shape[::-1])} neurites, (8, 8, 40)", long_x, (8, 8, 40)),
  ]
  host = host_edt_lib(torch)
  cases = []
  for label, lab, anis in inputs:
    lab = lab.contiguous()
    first = edt_ops.squared_edt(lab, anis)
    second = edt_ops.squared_edt(lab, anis)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
      fail(f"edt_pass {label}: two runs gave different outputs")
    t0 = time.perf_counter()
    plain = plain_squared_edt(ce, lab, anis)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = torch.equal(first.view(torch.int32), plain.view(torch.int32))
    err = 0.0 if same else float((first.double() - plain.double()).abs().max())
    dist = edt_ops.distance_field(lab, anis)
    want = np.sqrt(first.cpu().numpy(), dtype=np.float32)
    want[(lab == 0).cpu().numpy()] = 0
    sqrt_same = np.array_equal(dist.cpu().numpy().view(np.uint32), want.view(np.uint32))
    fn = lambda: edt_ops.squared_edt(lab, anis)  # noqa: E731
    (bound_ms, bound_by), fp64_ms = edt_bound(lab, anis, torch)
    case = {
      "kernel": "edt_pass", "case": f"{label}, 3 passes", "max_abs_err": err,
      "ms": device_ms(fn, reps=5, batch=3), "call_ms": cuda_ms(fn, reps=5),
      "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms, "bound_by": bound_by,
      "fp64_bound_ms": fp64_ms,
      "scratch_gb": max(ce.scratch_bytes(lab.shape, a, a == 2) for a in range(3)) / 1e9,
      "long_line_passes": [a for a in range(3) if ce.long_line(lab.shape, a, a == 2)],
      "sqrt_bitwise": sqrt_same, "library": "none",
    }
    if lab is full:
      # each pass on its own input (the previous pass's output) into its
      # own buffer, so that every call of a pass does the same work
      wx, wy, wz = anis
      xo = torch.empty(lab.shape, dtype=torch.float32, device=dev)
      yo = torch.empty_like(xo)
      ce.edt_pass(lab, xo, xo, 2, wx, True)
      ce.edt_pass(lab, xo, yo, 1, wy, False)
      mine, theirs = torch.empty_like(xo), torch.empty_like(xo)
      passes = {
        "x (contiguous lines, first)": lambda m, dst: m.edt_pass(lab, dst, dst, 2, wx, True),
        "y": lambda m, dst: m.edt_pass(lab, xo, dst, 1, wy, False),
        "z": lambda m, dst: m.edt_pass(lab, yo, dst, 0, wz, False),
      }
      case["pass_ms"] = {k: device_ms(lambda f=f: f(ce, mine), reps=5, batch=3)
                         for k, f in passes.items()}
      Z, Y, X = lab.shape
      case["blocks_per_sm"] = {"x": ce.blocks_per_sm(X, 1, True),
                               "y": ce.blocks_per_sm(Y, X, False),
                               "z": ce.blocks_per_sm(Z, Y * X, False)}
      if others:
        case["against"] = {
          k: against(lambda f=f: f(ce, mine),
                     [(nm, lambda f=f, m=m: f(m, theirs)) for nm, m in others], reps=5)
          for k, f in passes.items()
        }
        case["against"]["3 passes"] = against(
          fn, [(nm, lambda m=m: squared_edt_with(m.edt_pass, lab, anis)) for nm, m in others],
          reps=5)
        for rec in [r for recs in case["against"].values() for r in recs]:
          if not rec["equal"]:
            fail(f"edt_pass {label}: differs from {rec['against']}'s kernel")
      del xo, yo, mine, theirs
    if host is not None and lab is full:
      host_s, host_sq = host_squared_edt(host, lab, anis)
      case["host_edt_cpp_ms"] = 1e3 * host_s
      case["host_edt_cpp_equal"] = np.array_equal(
        host_sq.view(np.uint32), first.cpu().numpy().view(np.uint32))
      if not case["host_edt_cpp_equal"]:
        fail(f"edt_pass {label}: differs from the JAX package's host EDT")
    if lab is full or lab is long_z or lab is long_x:
      # single passes on random values (the long-line cases' long passes
      # among them), bit for bit
      case["single_passes_bitwise"] = True
      case["single_pass_ms"] = edt_single_passes(ce, lab, label, g, torch,
                                                 reps=3 if lab is not full else 0)
    print("kernel " + json.dumps(case), flush=True)
    if err > TOLERANCE:
      fail(f"edt_pass {label}: max abs err {err} against its plain version")
    if not sqrt_same:
      fail(f"edt_pass {label}: the distances differ from numpy's sqrt of the squared field")
    cases.append(case)
    del first, second, plain, dist

  # the worst stack depth: one label and equal values, so that every
  # position of every line is a stack entry, along each axis
  one = torch.full((EDT_WORST,) * 3, 3, dtype=torch.int64, device=dev)
  val = torch.full(one.shape, 4.0, dtype=torch.float32, device=dev)
  worst = {}
  for axis in (0, 1, 2):
    out = torch.empty_like(val)
    got = ce.edt_pass(one, val, out, axis, 8.0, False)
    ref = ce.edt_pass_plain(one, val, torch.empty_like(val), axis, 8.0, False)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
      fail(f"edt_pass worst stack depth: axis {axis} differs from its plain version")
    worst[f"axis {axis}"] = device_ms(lambda: ce.edt_pass(one, val, out, axis, 8.0, False),
                                      reps=5, batch=3)
    del got, ref
  print("kernel " + json.dumps({
    "kernel": "edt_pass", "case": f"worst stack depth: one label, equal values, "
    f"{EDT_WORST}^3, single passes at w = 8", "max_abs_err": 0.0, "pass_ms": worst,
  }), flush=True)
  print("library: none (PyTorch has no multilabel distance transform)", flush=True)
  del inputs, field, full, crop, slabs, odd, long_z, long_x, one, val
  torch.cuda.empty_cache()
  return cases


def crossing_components(seg, boundary: int, dust: int, torch):
  """{label: [(component mask (x, y, z) bool over its box, box lo)]} for
  every 26-connected component of a label with voxels on both sides of
  the plane x = ``boundary``, where the label has at least ``dust`` voxels
  in each task's cutout (x < boundary + 1 and x >= boundary; a task skips
  a label below its dust threshold, so no weld is expected there).
  ``seg``: the (z, y, x) int64 layer on the card."""
  from scipy import ndimage

  out = {}
  both = np.intersect1d(torch.unique(seg[:, :, boundary - 1]).cpu().numpy(),
                        torch.unique(seg[:, :, boundary]).cpu().numpy())
  for label in both[both != 0].tolist():
    hit = seg == label
    if min(int(hit[:, :, : boundary + 1].sum()), int(hit[:, :, boundary:].sum())) < dust:
      continue
    idx = hit.nonzero()
    lo, hi = idx.min(0).values.tolist(), (idx.max(0).values + 1).tolist()
    box = hit[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].cpu().numpy().transpose(2, 1, 0)
    comps, _ = ndimage.label(box, structure=np.ones((3, 3, 3), bool))
    origin = np.array(lo[::-1])
    for ci, sl in enumerate(ndimage.find_objects(comps), start=1):
      if sl is None or not (origin[0] + sl[0].start < boundary < origin[0] + sl[0].stop):
        continue
      out.setdefault(int(np.int64(label).view(np.uint64)), []).append(
        (comps[sl] == ci, origin + np.array([s.start for s in sl])))
  return out


def skeleton_card_against_cpu(task, path: str, sample: int, ce, edt_ops, torch, dev):
  """The first task's field on the card equals the plain version's (run on
  the card, the CPU route's code) bit for bit; ``sample`` of its labels
  (seed 1) plus its largest skeletonize, with the task's border pins, to
  the same bytes on the card and on the CPU route (labels and boxes in
  torch on the CPU, the plain field), equal to the written fragments."""
  import gzip
  import os

  from igneous_tpu_torch import Volume, set_device
  from igneous_tpu_torch.ops.mesh import labels_on_device
  from igneous_tpu_torch.ops.skeletonize import TeasarParams, cutout_labels, skeletonize

  t0 = time.perf_counter()
  vol = Volume(path)
  labels, cutout, core, bounds = task.prepare_labels(vol)
  anis = tuple(float(v) for v in vol.resolution)
  card_field, ids, counts, _, _ = cutout_labels(labels, anis)
  seg, _ = labels_on_device(labels, (0, 0, 0), (0, 0, 0), dev)
  pad = torch.nn.functional.pad(seg, (1, 1, 1, 1, 1, 1))
  sq = plain_squared_edt(ce, pad, (anis[0], anis[1], anis[2]))[1:-1, 1:-1, 1:-1]
  plain_field = torch.sqrt(sq).masked_fill_(seg == 0, 0.0).cpu().numpy().transpose(2, 1, 0)
  del seg, pad, sq
  torch.cuda.empty_cache()
  if not np.array_equal(card_field.view(np.uint32), plain_field.view(np.uint32)):
    fail("skeleton: the card's EDT field differs from the plain version's")
  largest = ids[int(np.argmax(counts))]
  pick = np.random.default_rng(1).choice(len(ids), min(sample, len(ids)), replace=False)
  chosen = sorted({ids[i] for i in pick} | {largest})
  kw = dict(
    anisotropy=anis, params=TeasarParams.from_dict(task.teasar_params),
    offset=tuple(float(v) for v in cutout.minpt), object_ids=chosen,
    dust_threshold=task.local_dust, parallel=SKEL_TRACE_THREADS,
    extra_targets_per_label=task.targets(labels, cutout, core, bounds),
  )
  card = skeletonize(labels, **kw)
  set_device("cpu")
  try:
    cpu = skeletonize(labels, edt_field=plain_field, **kw)
  finally:
    set_device(dev)
  if list(card) != list(cpu):
    fail("skeleton: the card and the CPU route skeletonized different labels")
  sdir = vol.info["skeletons"]
  verts = 0
  for label in card:
    data = card[label].to_precomputed()
    if data != cpu[label].to_precomputed():
      fail(f"skeleton: label {label}: the card's skeleton differs from the CPU route's")
    written = os.path.join(path[len("file://"):], sdir, f"{label}:{core.to_filename()}.sk.gz")
    with open(written, "rb") as f:
      if gzip.decompress(f.read()) != data:
        fail(f"skeleton: label {label}: the written fragment differs from the card's")
    verts += len(card[label].vertices)
  print(f"e2e skeleton check: task 0, {len(card)} of {len(ids)} labels (the largest, "
        f"{largest}, {int(counts.max())} voxels): the EDT field equal to the plain "
        f"version's, the skeletons ({verts} vertices) equal on the card and on the CPU "
        f"route and to the written fragments, {time.perf_counter() - t0:.1f} s", flush=True)


def skeleton_e2e_phase(root, ce, edt_ops, torch, dev):
  """The skeleton forge and merge with the defaults (task shape 512^3,
  +1 overlap, fix_borders, fix_branching, spatial index, TEASAR scale 4
  and const 500, forge dust 1000, merge dust 4000 and tick 6000,
  magnitude 1) but ``SKEL_TRACE_THREADS`` tracing threads: per task its
  wall, stage split, label and vertex counts, the card's busy time from a
  profiler trace and its peak memory, and ``edt_pass``'s launches (three
  a task); the merge's wall; every boundary-crossing tube one connected
  skeleton; the first task held card against CPU. Returns the launches."""
  from igneous_tpu_torch import CloudFiles, Volume, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.skeleton_io import Skeleton
  from igneous_tpu_torch.task_creation import (
    create_skeletonizing_tasks,
    create_unsharded_skeleton_merge_tasks,
  )
  from torch.profiler import ProfilerActivity, profile

  t0 = time.perf_counter()
  shape = SKEL_SHAPE
  seg = neurites(shape, SKEL_TUBES, np.random.default_rng(1), torch, dev)
  data = seg.cpu().numpy()
  path = f"file://{root}/skeleton_segmentation"
  Volume.from_numpy(data.view(np.uint64).transpose(2, 1, 0), path, resolution=(8, 8, 40),
                    chunk_size=(64, 64, 64), compress=None, layer_type="segmentation")
  print(f"ingest skeleton_segmentation: {shape} uint64, {len(torch.unique(seg)) - 1} labels, "
        f"{100 * float((seg != 0).double().mean()):.1f}% foreground "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  del data

  tasks = list(create_skeletonizing_tasks(path, parallel=SKEL_TRACE_THREADS))
  if len(tasks) != 2:
    fail(f"skeleton: expected 2 tasks, planned {len(tasks)}")
  queue = LocalTaskQueue(parallel=1)
  ce.LAUNCHES["edt_pass"] = 0
  for i, task in enumerate(tasks):
    telemetry.reset()
    before = ce.LAUNCHES["edt_pass"]
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      queue.insert([task])
      wall = time.perf_counter() - t0
    busy = traced_device_us(prof) / 1e6
    if not busy > 0:
      fail(f"skeleton task {i}: the trace shows no work on the card")
    launched = ce.LAUNCHES["edt_pass"] - before
    snap = telemetry.snapshot()
    counts = telemetry.counters()
    print(f"e2e skeleton task {i}: wall {wall:.3f} s, {SKEL_TRACE_THREADS} tracing "
          f"threads, {counts.get('labels', 0)} labels, {counts.get('vertices', 0)} "
          f"vertices, edt_pass launches {launched}, card busy {busy:.4f} s (traced; idle "
          f"{100 * (1 - busy / wall):.2f}%), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, stages (s) "
          f"{json.dumps({k: round(v['seconds'], 4) for k, v in snap.items()})}", flush=True)
    if launched != 3:
      fail(f"skeleton task {i}: edt_pass launched {launched} times, not 3")
  launches = ce.LAUNCHES["edt_pass"]

  t0 = time.perf_counter()
  merges = list(create_unsharded_skeleton_merge_tasks(path))
  queue.insert(merges)
  merge = time.perf_counter() - t0
  cf = CloudFiles(path)
  sdir = Volume(path).info["skeletons"]
  names = [k.split("/")[-1] for k in cf.list(f"{sdir}/")]
  frags = sum(n.endswith(".sk") for n in names)
  merged = [n for n in names if n.isdigit()]
  print(f"e2e skeleton merge: wall {merge:.3f} s, {len(merges)} tasks, {frags} fragments, "
        f"{len(merged)} skeletons", flush=True)

  # every tube component crossing the task boundary is one skeleton there
  res = np.array([8, 8, 40], np.float32)
  crossing = crossing_components(seg, shape[0] // 2, tasks[0].dust_threshold, torch)
  del seg
  torch.cuda.empty_cache()
  checked = spanning = 0
  for label, comps in crossing.items():
    blob = cf.get(f"{sdir}/{label}")
    if blob is None:
      continue
    skel = Skeleton.from_precomputed(blob)
    comp = skel.components_by_vertex()
    vox = np.rint(skel.vertices / res).astype(np.int64)
    for mask, lo in comps:
      local = vox - lo
      inside = np.all((local >= 0) & (local < mask.shape), axis=1)
      inside[inside] = mask[tuple(local[inside].T)]
      if not inside.any():
        continue
      pieces = np.unique(comp[inside])
      if len(pieces) != 1:
        fail(f"skeleton: label {label}: a tube across x = {shape[0] // 2} is "
             f"{len(pieces)} skeleton pieces")
      checked += 1
      xs = vox[inside, 0]
      spanning += int(xs.min() < shape[0] // 2 < xs.max())
  print(f"e2e skeleton merge check: {checked} tube components across x = "
        f"{shape[0] // 2} ({len(crossing)} labels) each one connected skeleton, "
        f"{spanning} with vertices on both sides", flush=True)
  if checked < SKEL_MIN_CROSSING:
    fail(f"skeleton: only {checked} boundary-crossing tubes were checked")
  skeleton_card_against_cpu(tasks[0], path, SKEL_SAMPLE, ce, edt_ops, torch, dev)
  return launches


# ---------------------------------------------------------------------------
# morphology and the voxel-count census (phase 8)

HOLLOW_SHAPE = (448, 448, 224)  # (x, y, z): two mesh tasks of 224x448x224
HOLLOW_TASK = (224, 448, 224)
HOLLOW_SEEDS = 150
HOLLOW_SPECKS = 400  # a quarter of them across x = 224
HOLLOW_DUST = 100  # the forge's dust threshold, applied to the census counts
HOLLOW_CENSUS_TASK = (224, 224, 224)
HOLLOW_SAMPLE = 32  # labels of the first task held card against CPU, + its largest
X6_REPLACES = "igneous_tpu/ops/morphology.py:19"  # _dilate_kernel (XLA)


def hollow_cells(shape, n_seeds: int, n_specks: int, seed: int, torch, dev) -> np.ndarray:
  """(x, y, z) uint64 Fortran-ordered: ``voronoi_segmentation`` of
  ``n_seeds`` seeds (ids above 2^32, eight at or above 2^63, 6-connected
  boundaries zeroed) with a background ball of radius 3-8 voxels at every
  seed, an enclosed cavity where the ball lies inside its cell; every
  third ball joined to its cell's boundary (or the volume's face) by a
  straight one-voxel channel along +x, which fill_holes levels 1-2 leave
  open and level 3 closes. Then ``n_specks`` specks with ids of their own
  (2^34 + k): three quarters boxes of 2-4 voxels a side (8-64 voxels)
  anywhere, a quarter boxes of 4-8 x 3-6 x 3-6 voxels (36-288) across
  x = X / 2, some of which reach the dust threshold only in the whole
  layer."""
  X, Y, Z = shape
  seeds = np.random.default_rng(seed).random((n_seeds, 3)) * np.array([X, Y, Z])
  out = voronoi_segmentation(shape, n_seeds, np.random.default_rng(seed), torch, dev)
  out = np.asfortranarray(out)
  rng = np.random.default_rng(seed + 1)
  for i, c in enumerate(np.floor(seeds).astype(np.int64)):
    r = float(rng.uniform(3, 8))
    lo = np.maximum(c - int(np.ceil(r)), 0)
    hi = np.minimum(c + int(np.ceil(r)) + 1, [X, Y, Z])
    grid = np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)], indexing="ij")
    ball = sum((g - ci) ** 2 for g, ci in zip(grid, c)) <= r * r
    out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]][ball] = 0
    if i % 3 == 0:
      row = out[:, c[1], c[2]]
      beyond = np.flatnonzero(row[c[0] + int(np.ceil(r)) + 1:] == 0)
      end = c[0] + int(np.ceil(r)) + 1 + int(beyond[0]) if len(beyond) else X
      out[c[0]:end, c[1], c[2]] = 0
  for k in range(n_specks):
    if k % 4 == 0:
      dx = int(rng.integers(4, 9))
      x0 = X // 2 - int(rng.integers(1, dx))
      dims = (dx, int(rng.integers(3, 7)), int(rng.integers(3, 7)))
      lo = (x0, int(rng.integers(0, Y - dims[1])), int(rng.integers(0, Z - dims[2])))
    else:
      dims = tuple(int(v) for v in rng.integers(2, 5, 3))
      lo = tuple(int(rng.integers(0, n - d)) for n, d in zip((X, Y, Z), dims))
    out[lo[0]:lo[0] + dims[0], lo[1]:lo[1] + dims[1], lo[2]:lo[2] + dims[2]] = 2**34 + k
  return out


def morphology_phase(root, cp, cc, ce, torch, dev):
  """Phase 8 on a "hollow cells" layer (``hollow_cells``): ``dilate`` and
  ``erode`` of the first mesh task's cutout on the card and on the CPU
  route, bit for bit, and X6 (``dilate_step``) timed against its bound;
  the census (``create_voxel_counting_tasks`` at 224^3 on a
  ``LocalTaskQueue``, then ``accumulate_voxel_counts``), its totals equal
  to numpy's over the whole layer; the mesh forge of two 224x448x224
  tasks with ``fill_holes=3``, ``dust_threshold=100`` and
  ``dust_global``: the meshed labels exactly those whose census count is
  100 or more, the first task's labels (32 and its largest) card against
  CPU and against the written fragments, the level-3 fill count above 0;
  no pooling, CCL or EDT kernel launched. Returns X6's record."""
  from igneous_tpu_torch import Bbox, CloudFiles, Volume, set_device, telemetry
  from igneous_tpu_torch.ops import morphology
  from igneous_tpu_torch.ops.mesh import unique_on_device
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import (
    accumulate_voxel_counts,
    create_meshing_tasks,
    create_voxel_counting_tasks,
  )

  t_phase = time.perf_counter()
  for counts in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES):
    for key in counts:
      counts[key] = 0
  t0 = time.perf_counter()
  data = hollow_cells(HOLLOW_SHAPE, HOLLOW_SEEDS, HOLLOW_SPECKS, 2, torch, dev)
  path = f"file://{root}/hollow_cells"
  Volume.from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(64, 64, 64),
                    compress=None, layer_type="segmentation")
  uniq, counts = np.unique(data, return_counts=True)
  half = HOLLOW_SHAPE[0] // 2
  left, right = (
    {int(l): int(c) for l, c in zip(*np.unique(part, return_counts=True))}
    for part in (data[: half + 1], data[half:])
  )
  big = {int(l) for l, c in zip(uniq, counts) if l and c >= HOLLOW_DUST}
  rescued = [int(l) for l in big if max(left.get(l, 0), right.get(l, 0)) < HOLLOW_DUST]
  print(f"ingest hollow_cells: {HOLLOW_SHAPE} uint64, {len(uniq) - 1} labels, {len(big)} "
        f"of {HOLLOW_DUST}+ voxels, {len(rescued)} of them below it in each task "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  if not rescued:
    fail("morphology: no label reaches the dust threshold only across the task boundary")

  # dilate and erode of the first task's cutout: the card against the CPU route
  img = Volume(path).download(Bbox((0, 0, 0), (half + 1,) + HOLLOW_SHAPE[1:]))[..., 0]
  t0 = time.perf_counter()
  grown, shrunk = morphology.dilate(img), morphology.erode(img)
  card_s = time.perf_counter() - t0
  _, fills3 = morphology.fill_holes(img, return_fill_count=True, level=3)
  _, fills1 = morphology.fill_holes(img, return_fill_count=True, level=1)
  set_device("cpu")
  try:
    t0 = time.perf_counter()
    cpu_grown, cpu_shrunk = morphology.dilate(img), morphology.erode(img)
    cpu_s = time.perf_counter() - t0
  finally:
    set_device(dev)
  if not (np.array_equal(grown, cpu_grown) and np.array_equal(shrunk, cpu_shrunk)):
    fail("morphology: dilate or erode on the card differs from the CPU route")
  n1, n3 = sum(fills1.values()), sum(fills3.values())
  print(f"morphology: dilate and erode of the {img.shape} cutout equal on the card "
        f"({card_s:.3f} s with copies) and the CPU route ({cpu_s:.3f} s); fill_holes "
        f"level 1 fills {n1} voxels of {len(fills1)} labels, level 3 {n3} of "
        f"{len(fills3)}", flush=True)
  if not n3 > n1 > 0:
    fail(f"morphology: fill counts level 1 {n1}, level 3 {n3}")
  del grown, shrunk, cpu_grown, cpu_shrunk

  # X6: one dilation step of the cutout's dense labels on the card
  _, inverse = unique_on_device(img, dev, return_inverse=True)
  x = inverse.to(torch.int32)
  del inverse
  nbytes = 2 * x.numel() * x.element_size()
  x6 = {
    "name": "X6 dilate_step", "replaces": X6_REPLACES,
    "case": f"task 0's cutout {img.shape} (x, y, z), int32 dense ids",
    "launches_per_task": 1, "ms": cuda_ms(lambda: morphology.dilate_step(x), reps=10),
    "device_ms": profiled_device_ms(lambda: morphology.dilate_step(x), torch),
    "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes", "library_ms": None,
  }
  del x, img
  torch.cuda.empty_cache()

  # the census
  telemetry.reset()
  t0 = time.perf_counter()
  tasks = list(create_voxel_counting_tasks(path, shape=HOLLOW_CENSUS_TASK))
  LocalTaskQueue(parallel=1).insert(tasks)
  totals = accumulate_voxel_counts(path)
  wall = time.perf_counter() - t0
  snap = telemetry.snapshot()
  if totals != {int(l): int(c) for l, c in zip(uniq, counts)}:
    fail("census: the totals differ from numpy's unique counts of the layer")
  print(f"census: {len(tasks)} tasks of {HOLLOW_CENSUS_TASK}, wall {wall:.3f} s, "
        f"{len(totals)} labels equal to numpy's counts, stages (s) "
        f"{json.dumps(stage_split(snap))}", flush=True)

  # the mesh forge with fill_holes=3 and dust_global
  tasks = list(create_meshing_tasks(
    path, shape=HOLLOW_TASK, fill_holes=3, dust_threshold=HOLLOW_DUST, dust_global=True,
    parallel=MESH_SIMPLIFY_THREADS))
  if len(tasks) != 2:
    fail(f"morphology mesh: expected 2 tasks, planned {len(tasks)}")
  queue = LocalTaskQueue(parallel=1)
  for i, task in enumerate(tasks):
    telemetry.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    queue.insert([task])
    wall = time.perf_counter() - t0
    c = telemetry.counters()
    print(f"morphology mesh task {i}: wall {wall:.3f} s, {c.get('labels', 0)} labels, "
          f"{c.get('faces', 0)} faces, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, stages (s) "
          f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  mdir = Volume(path).info["mesh"]
  names = [k.split("/")[-1] for k in CloudFiles(path).list(f"{mdir}/")]
  meshed = {int(n.split(":")[0]) for n in names if n.count(":") == 2}
  if meshed != big:
    fail(f"morphology mesh: {len(meshed)} labels meshed, {len(big)} of {HOLLOW_DUST}+ "
         f"voxels in the census ({len(meshed - big)} extra, {len(big - meshed)} missing)")
  print(f"morphology mesh: the {len(meshed)} meshed labels are those of {HOLLOW_DUST}+ "
        f"voxels in the census, {len(rescued)} of them below it in each task", flush=True)
  mesh_card_against_cpu(tasks[0], path, HOLLOW_SAMPLE, torch, dev)
  if any(any(c.values()) for c in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES)):
    fail("morphology: a pooling, CCL or EDT kernel launched")
  print(f"morphology: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return x6


# ---------------------------------------------------------------------------
# conv-net inference (phase 9)

# the repo's own inference configuration (bench.py:942-946)
INFER_SPEC = dict(architecture="convnet3d", in_channels=1, out_channels=2,
                  patch_shape=(64, 64, 32), overlap=(16, 16, 8), hidden=(8,))
INFER_BOUNDS = ((0, 0, 0), (1024, 1024, 64))  # of phase 3's image
INFER_TASKS = 16  # of the default 256x256x64
INFER_PATCHES = 108  # a task's 288x288x80 halo'd cutout: 6 x 6 x 3 patches
INFER_BATCH = 4
# card against the CPU route: |a - b| <= RTOL |b| + ATOL max|b| (the two
# sum 27 float32 products a channel in different orders)
INFER_RTOL = INFER_ATOL = 1e-5
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
X7_REPLACES = "igneous_tpu/infer/registry.py:105"  # _convnet3d (XLA)


def layer_files(path: str) -> dict:
  """{name: bytes} of a layer's chunk files at mip 0 (``path`` file://)."""
  import os

  base = path[len("file://"):]
  key = json.load(open(os.path.join(base, "info")))["scales"][0]["key"]
  d = os.path.join(base, key)
  return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def inference_phase(root, cp, cc, ce, torch, dev):
  """Phase 9 on phase 3's image (bounds 1024x1024x64): the repo's
  inference model (``INFER_SPEC``, ``init_params(seed=0)``) through
  ``create_inference_tasks`` -> ``LocalTaskQueue`` -> ``InferenceTask``,
  16 tasks of 108 patches at batch 4: pipelined with postprocess none,
  the same with ``IGNEOUS_PIPELINE=off`` and with batch 7 (both byte for
  byte the first), argmax (equal to the argmax of the first's floats);
  the identity model on the card and on the CPU route, byte for byte, and
  equal to the image; the first task's halo'd cutout on the card and on
  the CPU route within the stated tolerance, argmax mismatches only at
  margins within it; X7 (one dispatch) against its bound and cuDNN's
  batched call; the card's busy share over one task from a profiler
  trace. No hand kernel launches. Returns X7's record."""
  import os

  from igneous_tpu_torch import Bbox, Volume, set_device, telemetry
  from igneous_tpu_torch.infer import ModelSpec, infer_cutout, init_params, load_model, save_model
  from igneous_tpu_torch.infer.engine import _to_device_layout
  from igneous_tpu_torch.infer.registry import conv_flags
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_inference_tasks
  from torch.profiler import ProfilerActivity, profile

  t_phase = time.perf_counter()
  src = f"file://{root}/image"
  spec = ModelSpec(**INFER_SPEC)
  model_path, ident_path = f"file://{root}/model", f"file://{root}/model_identity"
  save_model(model_path, spec, init_params(spec, seed=0))
  save_model(ident_path, ModelSpec("identity", 1, 1, spec.patch_shape, spec.overlap), {})
  bounds = Bbox(*INFER_BOUNDS)

  def campaign(name, model, env=(), batch_size=INFER_BATCH, **kw):
    dest = f"file://{root}/infer_{name}"
    tasks = list(create_inference_tasks(src, dest, model, bounds=bounds,
                                        batch_size=batch_size, **kw))
    if len(tasks) != INFER_TASKS:
      fail(f"infer {name}: planned {len(tasks)} tasks, expected {INFER_TASKS}")
    for counts in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES):
      for key in counts:
        counts[key] = 0
    telemetry.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    os.environ.update(dict(env))
    queue = LocalTaskQueue(parallel=1)
    t0 = time.perf_counter()
    try:
      queue.insert(tasks)
    finally:
      for k, _ in env:
        os.environ.pop(k, None)
    wall = time.perf_counter() - t0
    counters = telemetry.counters()
    dispatches = -(-INFER_PATCHES // batch_size)
    want = {"infer.patches": INFER_TASKS * INFER_PATCHES,
            "infer.dispatches": INFER_TASKS * dispatches,
            "infer.padded_slots": INFER_TASKS * (dispatches * batch_size - INFER_PATCHES)}
    got = {k: counters.get(k, 0) for k in want}
    print(f"infer {name}: {len(tasks)} tasks, batch {batch_size}, wall {wall:.3f} s, "
          f"{json.dumps(got)}, runner {json.dumps(queue.pipeline_stats)}, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
          f"{pipeline_line(telemetry.snapshot(), telemetry.gauges(), counters)}", flush=True)
    if got != want:
      fail(f"infer {name}: counted {got}, expected {want}")
    if queue.completed != INFER_TASKS:
      fail(f"infer {name}: {queue.completed} of {INFER_TASKS} tasks completed")
    if any(any(c.values()) for c in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES)):
      fail(f"infer {name}: a pooling, CCL or EDT kernel launched")
    return dest, tasks

  first, tasks = campaign("none", model_path)
  ref_files = layer_files(first)
  for name, kw in (("none_serial", {"env": (("IGNEOUS_PIPELINE", "off"),)}),
                   ("none_batch7", {"batch_size": 7})):
    dest, _ = campaign(name, model_path, **kw)
    if layer_files(dest) != ref_files:
      fail(f"infer {name}: the files differ from the pipelined batch-4 run's")
    print(f"infer {name}: {len(ref_files)} chunk files byte for byte the pipelined "
          f"batch-4 run's", flush=True)
  out = Volume(first)
  floats = out.download(bounds)
  want = tuple(int(v) for v in bounds.size3()) + (spec.out_channels,)
  if floats.dtype != np.float32 or floats.shape != want or not np.isfinite(floats).all():
    fail(f"infer: output {floats.dtype} {floats.shape}, finite {np.isfinite(floats).all()}")
  dest, _ = campaign("argmax", model_path, postprocess="argmax")
  labels = Volume(dest).download(bounds)[..., 0]
  if not np.array_equal(labels, np.argmax(floats, axis=3).astype(np.uint8)):
    fail("infer argmax: differs from the argmax of the float run on the card")

  # the identity model: the engine alone, the card against the CPU route
  ident, _ = campaign("identity", ident_path)
  set_device("cpu")
  try:
    ident_cpu, _ = campaign("identity_cpu", ident_path)
  finally:
    set_device(dev)
  if layer_files(ident) != layer_files(ident_cpu):
    fail("infer identity: the card's files differ from the CPU route's")
  img = Volume(src).download(bounds)[..., :1].astype(np.float32)
  got = Volume(ident).download(bounds)
  if not np.allclose(got, img, rtol=1e-6, atol=1e-3):
    fail("infer identity: the blend does not give the image back")
  print("infer identity: card and CPU route byte for byte, equal to the image within "
        "the blend's rounding", flush=True)

  # the first task: card against the CPU route, within the tolerance
  task = tasks[0]
  halo = np.asarray(task.halo)
  core = Bbox(task.offset, task.offset + task.shape)
  cut = Volume(src, bounded=False).download(Bbox(core.minpt - halo, core.maxpt + halo))
  model = load_model(model_path)
  card, _ = infer_cutout(model, cut, INFER_BATCH)
  set_device("cpu")
  try:
    t0 = time.perf_counter()
    cpu, _ = infer_cutout(model, cut, INFER_BATCH)
    cpu_s = time.perf_counter() - t0
  finally:
    set_device(dev)
  err = np.abs(card - cpu)
  limit = INFER_RTOL * np.abs(cpu) + INFER_ATOL * float(np.abs(cpu).max())
  if not (err <= limit).all():
    fail(f"infer: the card's task 0 differs from the CPU route's by {float(err.max())}")
  hx, hy, hz = (int(v) for v in halo)
  sx, sy, sz = (int(v) for v in task.shape)
  core_cpu = cpu[hx:hx + sx, hy:hy + sy, hz:hz + sz]
  margin = np.abs(core_cpu[..., 0] - core_cpu[..., 1])
  differ = labels[:sx, :sy, :sz] != np.argmax(core_cpu, axis=3)
  tol = INFER_RTOL * np.abs(core_cpu).max(axis=3) + INFER_ATOL * float(np.abs(cpu).max())
  if (differ & (margin > 2 * tol)).any():
    fail("infer argmax: the card and the CPU route disagree at a margin above the tolerance")
  print(f"infer task 0: card and CPU route ({cpu_s:.3f} s) within rtol {INFER_RTOL}, atol "
        f"{INFER_ATOL} x max|out| (max err {float(err.max()):.3e} of max|out| "
        f"{float(np.abs(cpu).max()):.3f}); argmax differs at {int(differ.sum())} voxels, "
        f"all at margins within it", flush=True)

  # X7: one dispatch of the campaign against its bound and cuDNN's batched call
  consts = model.device_params()
  p = spec.patch_shape
  batch = torch.from_numpy(np.stack([
    _to_device_layout(cut[x:x + p[0], 0:p[1], 0:p[2]].astype(np.float32))
    for x in (0, 48, 96, 144)])).to(dev)
  widths = (spec.in_channels,) + tuple(spec.hidden) + (spec.out_channels,)
  voxels = batch.shape[0] * int(np.prod(p))
  nbytes = 4 * voxels * sum(widths)
  flops = 2 * 27 * voxels * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
  bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS

  def batched():
    with torch.inference_mode(), conv_flags():
      return torch.func.functional_call(model.module, consts, (batch,))

  run = lambda: model.apply(consts, batch)  # noqa: E731
  if not torch.equal(run(), run()):
    fail("X7: two runs of one dispatch differ")
  x7 = {
    "name": "X7 convnet3d", "replaces": X7_REPLACES,
    "case": f"one dispatch: {batch.shape[0]} patches {tuple(batch.shape[1:])}, "
            f"widths {widths}, float32, TF32 off",
    "launches_per_task": -(-INFER_PATCHES // INFER_BATCH),
    "ms": cuda_ms(run, reps=20), "device_ms": profiled_device_ms(run, torch),
    "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    "library_ms": cuda_ms(batched, reps=20),
  }
  del batch
  torch.cuda.empty_cache()

  # the card's busy share over one task
  one = list(create_inference_tasks(src, f"file://{root}/infer_traced", model_path,
                                    bounds=Bbox((0, 0, 0), (256, 256, 64))))
  telemetry.reset()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    LocalTaskQueue(parallel=1).insert(one)
    wall = time.perf_counter() - t0
  busy = traced_device_us(prof) / 1e6
  if not busy > 0:
    fail("infer: the trace shows no work on the card")
  print(f"infer traced task: wall {wall:.3f} s, card busy {busy:.4f} s (traced; idle "
        f"{100 * (1 - busy / wall):.2f}%), stages (s) "
        f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  print(f"infer: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return x7


# ---------------------------------------------------------------------------
# batched and paged execution

# (layer of phase 3, cutout shape, batch size, mips the chunk guard allows,
# through the command line); the second run is `image downsample --batched`
# at the command line's defaults
BATCHED_RUNS = [
  ("image", (1024, 1024, 64), 8, 3, False),
  ("image", (256, 256, 64), 8, 1, True),
  ("segmentation", (512, 512, 64), 8, 2, False),
  ("ragged_image", (256, 256, 64), 8, 2, False),
]
PAGE = 32  # the default page edge (IGNEOUS_PAGE_SHAPE) and pages a round
X5_REPLACES = "igneous_tpu/parallel/paged.py:163"  # _make_page_kernel (XLA)


def link_layer(src: str, dst: str) -> None:
  """A new layer at ``dst``: ``src``'s mip-0 chunk files hard-linked (the
  batched runs only read them) and its info cut to mip 0."""
  import os

  info = json.load(open(os.path.join(src, "info")))
  info["scales"] = info["scales"][:1]
  key = info["scales"][0]["key"]
  os.makedirs(os.path.join(dst, key))
  for name in os.listdir(os.path.join(src, key)):
    os.link(os.path.join(src, key, name), os.path.join(dst, key, name))
  with open(os.path.join(dst, "info"), "w") as f:
    json.dump(info, f)


def same_files(a: str, b: str, keep=lambda name: True) -> int:
  """Fails unless directories ``a`` and ``b`` hold the same files (of the
  names ``keep`` accepts) with the same bytes; returns how many."""
  import os

  names = sorted(filter(keep, os.listdir(a)))
  other = sorted(filter(keep, os.listdir(b)))
  if names != other:
    fail(f"{a} and {b} hold other files ({len(names)} against {len(other)})")
  for n in names:
    with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
      if fa.read() != fb.read():
        fail(f"{a}/{n} differs from {b}/{n}")
  return len(names)


def grid_counts(size, shape):
  """(full cutouts, edge cutouts, pages of the edge cutouts) of a layer's
  grid at cutout ``shape`` (x, y, z), with PAGE^3 pages."""
  full = edge = pages = 0
  for x in range(0, size[0], shape[0]):
    for y in range(0, size[1], shape[1]):
      for z in range(0, size[2], shape[2]):
        ext = [min(s, n - o) for s, n, o in zip(shape, size, (x, y, z))]
        if ext == list(shape):
          full += 1
        else:
          edge += 1
          pages += int(np.prod([-(-e // PAGE) for e in ext]))
  return full, edge, pages


def stage_split(snap) -> dict:
  return {k: round(v["seconds"], 4) for k, v in snap.items()}


def batched_downsample_phase(root, cp, torch, dev):
  """Phase 3's layers again through ``batched_downsample`` (and once
  through ``image downsample --batched``) into new layers that share their
  mip 0: per run its wall, dispatches, launches and stage split; a
  profiler trace of the first run for the card's busy share; every
  produced chunk and the scales of the info equal to phase 3's solo
  output."""
  import contextlib
  import io
  import os
  import re

  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.cli import main as cli_main
  from igneous_tpu_torch.parallel.batch_runner import batched_downsample
  from torch.profiler import ProfilerActivity, profile

  for i, (name, shape, batch, mips, via_cli) in enumerate(BATCHED_RUNS):
    src, dst = os.path.join(root, name), os.path.join(root, f"{name}_batched{i}")
    link_layer(src, dst)
    size = [int(v) for v in Volume(f"file://{src}").meta.volume_size(0)]
    full, edge, pages = grid_counts(size, shape)
    rounds = -(-pages // PAGE)
    full_dispatches = -(-full // batch)
    telemetry.reset()
    before = dict(cp.LAUNCHES)
    prof = profile(activities=[ProfilerActivity.CUDA]) if i == 0 else contextlib.nullcontext()
    with prof:
      t0 = time.perf_counter()
      if via_cli:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
          rc = cli_main(["image", "downsample", f"file://{dst}", "--batched"])
        m = re.fullmatch(r"batched: (\d+) cutouts in (\d+) dispatches, (\d+) edge "
                         r"cutouts via the task path\n", out.getvalue())
        if rc != 0 or m is None:
          fail(f"batched {name}: the command line said {out.getvalue()!r} (rc {rc})")
        stats = {"batched_cutouts": int(m[1]), "dispatches": int(m[2]),
                 "edge_cutouts": int(m[3]), "paged_cutouts": edge}
        summary = out.getvalue().strip()
      else:
        stats = batched_downsample(f"file://{dst}", num_mips=5, shape=shape, batch_size=batch)
        summary = json.dumps(stats)
      wall = time.perf_counter() - t0
    launched = {k: cp.LAUNCHES[k] - before[k] for k in cp.LAUNCHES}
    busy = ""
    if i == 0:
      us = traced_device_us(prof)
      if not us > 0:
        fail(f"batched {name}: the trace shows no work on the card")
      busy = f", card busy {us / 1e6:.4f} s (traced; idle {100 * (1 - us / 1e6 / wall):.2f}%)"
    print(f"batched {name} at {shape[0]}x{shape[1]}x{shape[2]}, batch {batch}: wall "
          f"{wall:.3f} s, {summary}, launches {json.dumps(launched)}{busy}, stages (s) "
          f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
    want = {"batched_cutouts": full, "edge_cutouts": 0, "paged_cutouts": edge,
            "dispatches": full_dispatches + rounds}
    if any(stats[k] != v for k, v in want.items()):
      fail(f"batched {name}: stats {stats}, expected {want}")
    if launched["pyramid2x2x1"] != full_dispatches:
      fail(f"batched {name}: pyramid2x2x1 launched {launched['pyramid2x2x1']} times "
           f"for {full_dispatches} full-cutout dispatches")
    if launched["pool2x2x1"] != rounds * mips:
      fail(f"batched {name}: pool2x2x1 launched {launched['pool2x2x1']} times for "
           f"{rounds} page rounds of {mips} levels")
    solo, got = Volume(f"file://{src}").info, Volume(f"file://{dst}").info
    if got["scales"] != solo["scales"][: mips + 1]:
      fail(f"batched {name}: the info's scales differ from the solo run's")
    n = sum(same_files(os.path.join(src, s["key"]), os.path.join(dst, s["key"]))
            for s in got["scales"][1:])
    print(f"batched {name}: {n} chunk files of mips 1-{mips} equal to phase 3's solo "
          f"output byte for byte", flush=True)


# ---------------------------------------------------------------------------
# the staged pipeline and the passthrough transfer

# (layer of phase 3, memory_target, tasks, task shape, mips the chunk guard
# allows): the grid of phase 3c's first batched run, and of its
# segmentation run
PIPELINED_RUNS = [
  ("image", 2**27, 16, (1024, 1024, 64), 3),
  ("segmentation", 2**28, 16, (512, 512, 64), 2),
]
# (source layer, compress): phase 3b's cseg layer (gzip chunks) and phase
# 3's image, whose mip 0 is stored uncompressed
PASSTHROUGH_RUNS = [("segmentation_cseg", "gzip"), ("image", None)]


def pipeline_line(snap: dict, gauges: dict, counters: dict) -> str:
  """The stage split of a stream: thread-seconds of the pools' stages, the
  caller's waits, the prefetch buffer's stalls and high-water bytes, the
  chunk cache's hits and misses."""
  waits = {k: round(snap[k]["seconds"], 4) for k in (
    "pipeline.download_wait_s", "pipeline.upload_join_s",
    "pipeline.prefetch.producer_stall_s") if k in snap}
  stages = {k: round(v["seconds"], 4) for k, v in snap.items()
            if not k.startswith("pipeline.")}
  cache = {k: counters.get(f"chunk_cache.{k}", 0) for k in ("hits", "misses", "evicted")}
  high = int(gauges.get("pipeline.prefetch.bytes", 0))
  return (f"stages (thread-s) {json.dumps(stages)}, caller waits (s) {json.dumps(waits)}, "
          f"prefetch high-water {high} bytes, chunk cache {json.dumps(cache)}")


def pipelined_phase(root, cp, cc, ce, torch, dev):
  """Phase 3's image and segmentation as 16-task streams through
  ``create_downsampling_tasks`` -> ``LocalTaskQueue`` into new layers that
  share phase 3's mip 0, once with ``IGNEOUS_PIPELINE=off`` (the serial
  loop) and once at the default (the staged pipeline): per run its wall,
  stage split, the caller's waits, the prefetch buffer's stalls and
  high-water bytes and the chunk cache's counts; pyramid2x2x1 once a task
  (counts set to 0 just before each run); the runner's stats; every chunk
  and the info's scales equal to phase 3's solo output. Then the
  passthrough: phase 3b's cseg layer and phase 3's image copied with
  ``skip_downsamples`` into new layers of the same chunking and encoding,
  every chunk file byte for byte the source's, every chunk moved
  verbatim and no kernel launched; then the same copies down the decode
  route (``IGNEOUS_TRANSFER_PASSTHROUGH=off``; the cseg layer's once more
  with ``IGNEOUS_CHUNK_CACHE=off``), with the same bytes. Returns the
  pooling kernels' launches in the pipelined runs."""
  import os

  from igneous_tpu_torch import Volume, chunk_cache, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_downsampling_tasks, create_transfer_tasks

  t_phase = time.perf_counter()
  pipelined = {k: 0 for k in cp.LAUNCHES}
  walls = {}
  for name, target, ntasks, shape, mips in PIPELINED_RUNS:
    src = os.path.join(root, name)
    for mode in ("serial", "pipelined"):
      dst = os.path.join(root, f"{name}_{mode}")
      link_layer(src, dst)
      tasks = list(create_downsampling_tasks(f"file://{dst}", mip=0, num_mips=mips,
                                             memory_target=target))
      if len(tasks) != ntasks or [int(v) for v in tasks[0].shape] != list(shape):
        fail(f"pipelined {name}: planned {len(tasks)} tasks of {tasks[0].shape}")
      if mode == "serial":
        os.environ["IGNEOUS_PIPELINE"] = "off"
      telemetry.reset()
      chunk_cache.clear()
      for key in cp.LAUNCHES:
        cp.LAUNCHES[key] = 0
      queue = LocalTaskQueue(parallel=1)
      t0 = time.perf_counter()
      try:
        queue.insert(tasks)
      finally:
        os.environ.pop("IGNEOUS_PIPELINE", None)
      wall = time.perf_counter() - t0
      launched = dict(cp.LAUNCHES)
      walls[(name, mode)] = wall
      print(f"pipelined {name} {mode}: {ntasks} tasks of {shape[0]}x{shape[1]}x{shape[2]}, "
            f"{mips} mips, wall {wall:.3f} s, stats {json.dumps(queue.pipeline_stats)}, "
            f"launches {json.dumps(launched)}, "
            f"{pipeline_line(telemetry.snapshot(), telemetry.gauges(), telemetry.counters())}",
            flush=True)
      if queue.completed != ntasks:
        fail(f"pipelined {name} {mode}: {queue.completed} of {ntasks} tasks completed")
      if launched["pyramid2x2x1"] != ntasks or launched["pool2x2x1"] != 0:
        fail(f"pipelined {name} {mode}: launches {launched}, expected pyramid2x2x1 "
             f"once for each of {ntasks} tasks")
      if mode == "pipelined":
        want = {"executed": ntasks, "staged": ntasks, "solo": 0, "failed": 0,
                "drained": False}
        if queue.pipeline_stats != want:
          fail(f"pipelined {name}: runner stats {queue.pipeline_stats}, expected {want}")
        for key, n in launched.items():
          pipelined[key] += n
      solo, got = Volume(f"file://{src}").info, Volume(f"file://{dst}").info
      if got["scales"] != solo["scales"][: mips + 1]:
        fail(f"pipelined {name} {mode}: the info's scales differ from phase 3's")
      n = sum(same_files(os.path.join(src, sc["key"]), os.path.join(dst, sc["key"]))
              for sc in got["scales"][1:])
      print(f"pipelined {name} {mode}: {n} chunk files of mips 1-{mips} equal to phase "
            f"3's solo output byte for byte", flush=True)
    print(f"pipelined {name}: serial {walls[(name, 'serial')]:.3f} s, pipelined "
          f"{walls[(name, 'pipelined')]:.3f} s", flush=True)

  for name, compress in PASSTHROUGH_RUNS:
    src = f"file://{root}/{name}"
    key = Volume(src).meta.key(0)
    routes = [("passthrough", {}), ("decode", {"IGNEOUS_TRANSFER_PASSTHROUGH": "off"})]
    if compress is not None:
      routes.append(("decode_nocache", {"IGNEOUS_TRANSFER_PASSTHROUGH": "off",
                                        "IGNEOUS_CHUNK_CACHE": "off"}))
    for route, env in routes:
      dest = f"{root}/{name}_{route}"
      tasks = list(create_transfer_tasks(src, f"file://{dest}", skip_downsamples=True,
                                         compress=compress))
      os.environ.update(env)
      telemetry.reset()
      chunk_cache.clear()
      for counts in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES):
        for k in counts:
          counts[k] = 0
      queue = LocalTaskQueue(parallel=1)
      t0 = time.perf_counter()
      try:
        queue.insert(tasks)
      finally:
        for k in env:
          os.environ.pop(k, None)
      wall = time.perf_counter() - t0
      counters = telemetry.counters()
      moved = {k: counters.get(f"transfer.passthrough.{k}", 0)
               for k in ("chunks", "verbatim", "recompressed", "bytes")}
      n = same_files(os.path.join(root, name, key), os.path.join(dest, key))
      print(f"passthrough {name} {route}: {len(tasks)} tasks, wall {wall:.3f} s, "
            f"moved {json.dumps(moved)}, stats {json.dumps(queue.pipeline_stats)}, "
            f"{pipeline_line(telemetry.snapshot(), telemetry.gauges(), counters)}; "
            f"{n} chunk files byte for byte the source's", flush=True)
      if any(any(c.values()) for c in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES)):
        fail(f"passthrough {name} {route}: a kernel launched on a copy with no pyramid")
      want = n if route == "passthrough" else 0
      if moved["verbatim"] != want or moved["chunks"] != want:
        fail(f"passthrough {name} {route}: moved {moved}, expected {want} chunks verbatim")
  print(f"pipelined: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return pipelined


def page_kernel_program(root, cp, torch, dev):
  """X5, the page kernel (``parallel.paged.page_pyramid``: three
  clamp-gathers and one ``pool2x2x1`` a level) on the first round of the
  ragged layer's corner cutout (232x232x64 at the ragged run's cutout
  shape, 2 levels): kernel time from
  the profiler, time between CUDA events, the plain version's (the same
  with ``pool2x2x1_plain``), equal outputs, and the bytes bound (pages in
  and out once)."""
  import torch.nn.functional as F

  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.parallel import paged

  vol = Volume(f"file://{root}/ragged_image")
  size = vol.meta.volume_size(0)
  shape = next(r[1] for r in BATCHED_RUNS if r[0] == "ragged_image")
  img = vol.download(Bbox([(s - 1) // c * c for s, c in zip(size, shape)], size))
  t = torch.from_numpy(img.transpose(3, 2, 1, 0)).to(dev)
  Z, Y, X = t.shape[1:]
  padded = F.pad(t, (0, (-X) % PAGE, 0, (-Y) % PAGE, 0, (-Z) % PAGE))
  pages = paged.to_pages(padded, (PAGE,) * 3)[:PAGE]
  exts = []
  for oz in range(0, Z, PAGE):
    for oy in range(0, Y, PAGE):
      for ox in range(0, X, PAGE):
        exts.append((min(PAGE, Z - oz), min(PAGE, Y - oy), min(PAGE, X - ox)))
  ext = torch.tensor(exts[:PAGE], dtype=torch.int64, device=dev)
  factors = ((2, 2, 1), (2, 2, 1))
  fn = lambda: paged.page_pyramid(pages, ext, factors, "average", False)  # noqa: E731
  outs = fn()
  real = cp.pool2x2x1
  cp.pool2x2x1 = cp.pool2x2x1_plain
  try:
    plain = lambda: paged.page_pyramid(pages, ext, factors, "average", False)  # noqa: E731
    refs = plain()
    plain_ms = cuda_ms(plain, reps=20)
  finally:
    cp.pool2x2x1 = real
  err = max_abs_err(outs, refs)
  if err > TOLERANCE:
    fail(f"X5 page kernel: differs from its plain version (max abs err {err})")
  nbytes = pages.numel() + sum(o.numel() for o in outs)
  return {
    "name": "X5 page_pyramid", "replaces": X5_REPLACES,
    "case": f"{PAGE} pages of the ragged layer's corner cutout, uint8 average, 2 levels",
    "launches_per_round": {"pool2x2x1": len(factors)},
    "ms": cuda_ms(fn, reps=20), "device_ms": profiled_device_ms(fn, torch),
    "plain_ms": plain_ms, "max_abs_err": err,
    "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
  }


def batched_ccl_phase(root, cc, torch, dev):
  """``batched_ccl_faces`` (``paged_ccl`` in rounds of 32 pages) over phase
  4's segmentation layer, against the task path's pass 1
  (``create_ccl_face_tasks``): its wall and the task path's, dispatches,
  ``tile_resolve`` launches (once per page round), stage split, and every
  face file equal byte for byte. Returns tile_resolve's launches."""
  import os
  import shutil

  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.parallel.batch_runner import batched_ccl_faces
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_ccl_face_tasks

  name = "ccl_segmentation"
  src = f"file://{root}/{name}"
  faces = os.path.join(root, name, "ccl", "0", "faces")
  shutil.rmtree(os.path.join(root, name, "ccl"), ignore_errors=True)
  tasks = list(create_ccl_face_tasks(src, shape=CCL_TASK_SHAPE))
  bounds = Volume(src).meta.bounds(0)
  pages = 0
  for t in tasks:
    cut = Bbox.intersection(Bbox(t.offset, t.offset + t.shape + 1), bounds)
    pages += int(np.prod([-(-int(s) // PAGE) for s in cut.size3()]))
  rounds = -(-pages // PAGE)  # one group: every task in one batch of 8
  for key in cc.LAUNCHES:
    cc.LAUNCHES[key] = 0
  telemetry.reset()
  t0 = time.perf_counter()
  stats = batched_ccl_faces(src, shape=CCL_TASK_SHAPE)
  wall = time.perf_counter() - t0
  launched = cc.LAUNCHES["tile_resolve"]
  stages = stage_split(telemetry.snapshot())
  batched = os.path.join(root, "faces_batched")
  shutil.move(faces, batched)
  telemetry.reset()
  t0 = time.perf_counter()
  LocalTaskQueue(parallel=1).insert(create_ccl_face_tasks(src, shape=CCL_TASK_SHAPE))
  task_wall = time.perf_counter() - t0
  n = same_files(batched, faces)
  print(f"batched ccl {name}: batched_ccl_faces wall {wall:.3f} s ({json.dumps(stats)}, "
        f"{pages} pages in {rounds} rounds, tile_resolve launches {launched}), task path "
        f"pass 1 wall {task_wall:.3f} s; {n} face files equal byte for byte; stages (s) "
        f"batched {json.dumps(stages)}, task path "
        f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  if stats != {"batched_cutouts": len(tasks), "edge_cutouts": 0, "dispatches": 1}:
    fail(f"batched ccl: stats {stats} for {len(tasks)} tasks")
  if launched != rounds:
    fail(f"batched ccl: tile_resolve launched {launched} times for {rounds} page rounds")
  shutil.rmtree(os.path.join(root, name, "ccl"))
  return launched


def batched_skeleton_phase(root, ce, edt_ops, torch, dev):
  """``edt_batch`` on phase 6's two skeleton cutouts cut to their common
  shape, and ``paged_edt`` on the whole cutouts (padded to page
  multiples), each bit for bit the solo ``edt``, with walls, launches
  and peak memory; then ``batched_skeleton_forge`` over the layer's two
  default tasks into a second skeleton directory, its fragments and
  spatial files equal byte for byte to phase 6's. Returns edt_pass's
  launches."""
  import os

  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.parallel.batch_runner import batched_skeleton_forge
  from igneous_tpu_torch.parallel.paged import paged_edt
  from igneous_tpu_torch.task_creation import create_skeletonizing_tasks

  path = f"file://{root}/skeleton_segmentation"
  sdir = Volume(path).info["skeletons"]
  tasks = list(create_skeletonizing_tasks(path, parallel=SKEL_TRACE_THREADS))
  labels = [t.prepare_labels(Volume(path))[0] for t in tasks]
  anis = (8.0, 8.0, 40.0)
  launches = 0
  common = tuple(min(s) for s in zip(*(l.shape for l in labels)))
  crops = np.stack([l[: common[0], : common[1], : common[2]] for l in labels])
  for what, fn, items in (
    ("edt_batch", lambda: edt_ops.edt_batch(crops, anis, black_border=True), crops),
    ("paged_edt", lambda: paged_edt(labels, anis), labels),
  ):
    ce.LAUNCHES["edt_pass"] = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fields = fn()
    wall = time.perf_counter() - t0
    launched = ce.LAUNCHES["edt_pass"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    for lab, field in zip(items, fields):
      if not np.array_equal(field, edt_ops.edt(lab, anis, black_border=True)):
        fail(f"{what}: a field differs from the solo edt of its cutout")
    print(f"batched edt {what}: {len(items)} cutouts {[l.shape for l in items]}, wall "
          f"{wall:.3f} s, edt_pass launches {launched}, peak {peak:.2f} GB, bit for bit "
          f"the solo edt", flush=True)
    if launched != 3:
      fail(f"{what}: edt_pass launched {launched} times, not 3")
    launches += launched
    del fields

  ce.LAUNCHES["edt_pass"] = 0
  telemetry.reset()
  t0 = time.perf_counter()
  stats = batched_skeleton_forge(path, skel_dir="skeletons_batched", parallel=SKEL_TRACE_THREADS)
  wall = time.perf_counter() - t0
  launched = ce.LAUNCHES["edt_pass"]
  a, b = os.path.join(root, "skeleton_segmentation", sdir), os.path.join(
    root, "skeleton_segmentation", "skeletons_batched")
  # all but the merged skeletons, which phase 6's merge wrote (named by label)
  frags = same_files(a, b, keep=lambda n: not n.split(".")[0].isdigit())
  print(f"batched skeleton forge: wall {wall:.3f} s, {json.dumps(stats)}, edt_pass "
        f"launches {launched}, {frags} fragment and spatial files equal to phase 6's byte "
        f"for byte, stages (s) {json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  if stats != {"batched_cutouts": len(tasks), "solo_cutouts": 0, "dispatches": 1}:
    fail(f"batched skeleton forge: stats {stats} for {len(tasks)} tasks")
  if launched != 3:
    fail(f"batched skeleton forge: edt_pass launched {launched} times, not 3")
  return launches + launched


def entry_phase(cp, torch, dev):
  """The port's ``entry()`` once on the card, equal to the plain pyramid;
  returns pyramid2x2x1's launches (one)."""
  from igneous_tpu_torch.entry import FACTORS, entry
  from igneous_tpu_torch.ops.pooling import _pyramid_impl

  before = cp.LAUNCHES["pyramid2x2x1"]
  fn, (x,) = entry()
  outs = fn(x)
  torch.cuda.synchronize()
  launched = cp.LAUNCHES["pyramid2x2x1"] - before
  refs = _pyramid_impl(torch.from_numpy(x).to(dev), FACTORS, "average", False)
  err = max_abs_err(outs, refs)
  print(f"entry: {len(outs)} mips {[tuple(o.shape) for o in outs]}, pyramid2x2x1 "
        f"launches {launched}, max abs err against the plain pyramid {err}", flush=True)
  if err > TOLERANCE or launched != 1:
    fail(f"entry: max abs err {err}, pyramid2x2x1 launches {launched}")
  return launched


def load_copy(alias: str, path: str):
  """Import another copy of the igneous_tpu_torch package (a directory,
  for example one unpacked from an earlier commit with ``git archive``)
  under the name ``alias``; returns its (_build, cuda_ccl, cuda_pooling,
  cuda_edt).
  Its kernels build from its own csrc/ into its own build/."""
  import importlib
  import importlib.util
  import os

  spec = importlib.util.spec_from_file_location(
    alias, os.path.join(path, "__init__.py"), submodule_search_locations=[path]
  )
  if spec is None:
    fail(f"--baseline {alias}={path}: no package there")
  pkg = importlib.util.module_from_spec(spec)
  sys.modules[alias] = pkg
  spec.loader.exec_module(pkg)
  return tuple(importlib.import_module(f"{alias}.ops.{m}")
               for m in ("_build", "cuda_ccl", "cuda_pooling", "cuda_edt"))


def main() -> int:
  import argparse

  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument(
    "--mesh-simplify-threads", type=int, default=MESH_SIMPLIFY_THREADS, metavar="N",
    help="simplification threads of each mesh task (the forge's "
         "--simplify-parallel; 1 is its default)",
  )
  parser.add_argument(
    "--baseline", action="append", default=[], metavar="NAME=DIR",
    help="time the kernels of another copy of the package (DIR holds its "
         "__init__.py) against this checkout's, in turns on the same card, "
         "and check that their outputs agree; runs the build and kernel "
         "phases only and prints no result line",
  )
  args = parser.parse_args()
  try:
    import torch
  except ImportError:
    fail("torch is not installed")
  if not torch.cuda.is_available():
    fail("no CUDA device: chip_smoke drives the port on the GPU only")
  try:
    from igneous_tpu_torch import set_device
    from igneous_tpu_torch.ops import _build, ccl as ccl_ops
    from igneous_tpu_torch.ops import cuda_ccl as cc, cuda_pooling as cp
    from igneous_tpu_torch.ops import cuda_edt as ce, edt as edt_ops
  except ImportError as e:
    fail(f"igneous_tpu_torch is not importable here ({e}); run from the repo root")

  t_all = time.perf_counter()
  dev = set_device("cuda")
  print(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}", flush=True)

  copies = [(spec.split("=", 1)[0], load_copy(*spec.split("=", 1)))
            for spec in args.baseline]
  t0 = time.perf_counter()
  sources = ("pooling", "ccl", "edt")
  builds = [(b, name) for b in [_build] + [c[0] for _, c in copies] for name in sources]
  # the host libraries of the mesh and skeleton paths and the codec (g++)
  host_libs = ("simplify", "dijkstra", "fggraph", "cseg")
  builds += [(_build, name) for name in host_libs]
  with ThreadPoolExecutor(len(builds)) as pool:
    # one compiler per source, together
    list(pool.map(lambda job: job[0].build(job[1]), builds))
  print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
  for name in sources + host_libs:
    log = _build.BUILD_LOG[name]
    print(f"build {name}: {log['seconds']:.1f} s", flush=True)
    for line in log["ptxas"].splitlines():
      if "Used" in line or "spill" in line:
        print(f"ptxas {name}: {line.strip()}")

  cases = kernel_phase(cp, torch, dev, [(k, c[2]) for k, c in copies])
  ccl_cases = ccl_kernel_phase(cc, ccl_ops, torch, dev, [(k, c[1]) for k, c in copies])
  edt_cases = edt_kernel_phase(ce, edt_ops, torch, dev, [(k, c[3]) for k, c in copies])
  if copies:
    print(f"wall: {time.perf_counter() - t_all:.1f} s")
    print(card_line())
    print("compared with " + ", ".join(args.baseline) + "; e2e phases not run")
    return 0
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    launches = e2e_phase(root, cp, torch, dev)
    codec_phase(root)
    xfer_launches = xfer_e2e_phase(root, cp, torch, dev)
    # the batched phase: its own counts, set to 0 just before each part
    t_phase = time.perf_counter()
    for counts in (cc.LAUNCHES, cp.LAUNCHES, ce.LAUNCHES):
      for key in counts:
        counts[key] = 0
    batched_downsample_phase(root, cp, torch, dev)
    batched_launches = dict(cp.LAUNCHES)
    batched_launches["pyramid2x2x1"] += entry_phase(cp, torch, dev)
    if any(cc.LAUNCHES.values()) or any(ce.LAUNCHES.values()):
      fail("batched: the CCL or EDT kernels ran on the batched downsample path")
    # measured after the counts were read: its launches are no path's
    x5 = page_kernel_program(root, cp, torch, dev)
    t_batched = time.perf_counter() - t_phase
    pipelined_launches = pipelined_phase(root, cp, cc, ce, torch, dev)
    x7 = inference_phase(root, cp, cc, ce, torch, dev)
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    launches["tile_resolve"] = ccl_e2e_phase(root, cc, cp, torch, dev)
    t_phase = time.perf_counter()
    batched_launches["tile_resolve"] = batched_ccl_phase(root, cc, torch, dev)
    t_batched += time.perf_counter() - t_phase
  for counts in (cc.LAUNCHES, cp.LAUNCHES, ce.LAUNCHES):
    for key in counts:
      counts[key] = 0
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    programs = mesh_e2e_phase(root, torch, dev,
                              simplify_threads=args.mesh_simplify_threads)
  if any(cc.LAUNCHES.values()) or any(cp.LAUNCHES.values()) or any(ce.LAUNCHES.values()):
    fail("mesh: the pooling, CCL or EDT kernels ran on the mesh path")
  for counts in (cc.LAUNCHES, cp.LAUNCHES):
    for key in counts:
      counts[key] = 0
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    launches["edt_pass"] = skeleton_e2e_phase(root, ce, edt_ops, torch, dev)
    if any(cc.LAUNCHES.values()) or any(cp.LAUNCHES.values()):
      fail("skeleton: the pooling or CCL kernels ran on the skeleton path")
    t_phase = time.perf_counter()
    batched_launches["edt_pass"] = batched_skeleton_phase(root, ce, edt_ops, torch, dev)
    t_batched += time.perf_counter() - t_phase
  print(f"batched: phase wall {t_batched:.1f} s", flush=True)
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    x6 = morphology_phase(root, cp, cc, ce, torch, dev)
  programs += [x5, x6, x7]

  kernels = []
  replaces = {
    "pyramid2x2x1": "igneous_tpu/ops/pallas_pooling.py:114",
    "pool2x2x1": "igneous_tpu/ops/pallas_pooling.py:95",
  }
  for name in ("pyramid2x2x1", "pool2x2x1"):
    first = next(c for c in cases if c["kernel"] == name)  # the main-path case
    kernels.append({
      "name": name, "route": "cuda",
      "source": "igneous_tpu_torch/csrc/pooling.cu",
      "replaces": replaces[name], "launches": launches[name],
      "launches_xfer": xfer_launches[name],
      "launches_batched": batched_launches[name],
      "launches_pipelined": pipelined_launches[name],
      "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == name),
      "ms": first["ms"], "plain_ms": first["plain_ms"],
      "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
      "library_ms": None, "case": first["case"],
    })
  first = ccl_cases[0]  # the main path's mask case
  kernels.append({
    "name": "tile_resolve", "route": "cuda",
    "source": "igneous_tpu_torch/csrc/ccl.cu",
    "replaces": "igneous_tpu/ops/pallas_ccl.py:118",
    "launches": launches["tile_resolve"],
    "launches_batched": batched_launches["tile_resolve"],
    "max_abs_err": max(c["max_abs_err"] for c in ccl_cases),
    "ms": first["ms"], "plain_ms": first["plain_ms"],
    "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
    "library_ms": None, "case": first["case"],
  })
  first = edt_cases[0]  # the default skeleton task's field
  kernels.append({
    "name": "edt_pass", "route": "cuda",
    "source": "igneous_tpu_torch/csrc/edt.cu",
    "replaces": EDT_REPLACES, "launches": launches["edt_pass"],
    "launches_batched": batched_launches["edt_pass"],
    "max_abs_err": max(c["max_abs_err"] for c in edt_cases),
    "ms": first["ms"], "plain_ms": first["plain_ms"],
    "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
    "library_ms": None, "case": first["case"],
  })
  print(f"wall: {time.perf_counter() - t_all:.1f} s")
  print(card_line())
  print(json.dumps({"programs": programs}))
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": torch.cuda.get_device_name(0),
    "count": torch.cuda.device_count(),
  }}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
