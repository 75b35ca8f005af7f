"""Drive igneous_tpu_torch's downsample, transfer, connected-components,
meshing and skeleton paths on one NVIDIA GPU and check them.

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
  4. e2e ccl: two file:// layers through ccl_auto (the four passes on a
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
  6. e2e skeleton: a 1024x512x512 uint64 layer of 300 neurite-like tubes
     (radius 3-12 voxels along random polylines, about 10% foreground,
     ids above 2^32 and 2^63, many across x = 512) through
     create_skeletonizing_tasks -> LocalTaskQueue -> SkeletonTask (two
     512^3 tasks with every default, 8 tracing threads) and
     create_unsharded_skeleton_merge_tasks; each task's wall, stage split,
     label and vertex counts, the card's busy time from a profiler trace
     and its peak memory; edt_pass must launch three times a task (the
     counts set to 0 before) and the other kernels not at all; every tube
     component across x = 512 one connected merged skeleton; the first
     task's EDT field equal to the plain version's (run on the card) bit
     for bit, and 32 of its labels (seed 1) plus its largest skeletonized
     to the same bytes on the card and on the CPU route, and equal to the
     written fragments;
  7. the card's name and power limit, the programs line, the kernels
     line, and the result.

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
  # name, shape (x, y, z), dtype, ccl_auto options; the mask layer runs at
  # half its depth (4 tasks of 448x448x224) so that the whole script,
  # mesh phase included, stays near half its time limit
  ("ccl_mask", (896, 896, 224), "uint8", {"threshold_gte": 128}),
  ("ccl_segmentation", (896, 448, 448), "uint64", {}),
]


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
      data = blobs(shape, 16, 1500, rng, torch, dev)
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

SKEL_SHAPE = (1024, 512, 512)  # (x, y, z): two tasks of the default 512^3
SKEL_TUBES = 300
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
    dust_threshold=task.dust_threshold, parallel=SKEL_TRACE_THREADS,
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
    fail(f"skeleton: expected 2 tasks of 512^3, planned {len(tasks)}")
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
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    launches["tile_resolve"] = ccl_e2e_phase(root, cc, cp, torch, dev)
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
