"""Where the clahe kernel spends its time, and what its design choices
buy: csrc/clahe.cu and copies of it with one choice undone, each timed on
the card pass by pass.

    python3 -m igneous_tpu_torch.tools.clahe_variants

Builds, under build/clahe_variants/, csrc/clahe.cu as it is ("as is") and
one copy a variant:
  - "dsmem adds": each block of a 16-bit LUT cluster reads half the tile
    and adds every value into the owning block's bins, the other block's
    through distributed shared memory (the as-is blocks each read the
    whole tile and count their own half);
  - "default carveout": the gathering blend without the least
    shared-memory carveout (so less L1 for its LUT gathers);
  - "unstaged": 8-bit blends gather their LUTs from device memory, not
    from the floats staged in shared memory.
On chip_smoke.py's phase 2 inputs (the smooth 2304x2304x64 cutout as
uint8 and uint16, a 1030x1030x16 uint16 stack, constant stacks), each
copy's launch is timed as a whole (device time, CUDA-graph replay) and by
kernel (torch.profiler, the mean of 5 launches), in turns (each copy in
order, then in reverse). Every copy's output must equal clahe_plain's.
Prints one JSON line an input and the card's name and power limit. Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build, clahe as clahe_ops, cuda_clahe

GRID = (8, 8)
INPUTS = ("uint8 cutout 2304x2304x64", "uint16 cutout 2304x2304x64", "uint16 1030x1030x16",
          "uint8 constant 2304x2304x64", "uint16 constant 2304x2304x16, clip 0")

# (variant, [(text of csrc/clahe.cu, its replacement)])
VARIANTS = {
  "dsmem adds": [
    ("""  tile_pixels<uint16_t, W>(in + (int64_t)plane * rows * cols, rows, cols, ty, tx, th, tw,
                           tid, kThreads16, [&](int v, int n) {
                             if ((v >> 15) == rank) atomicAdd(&hist[v & (kHalf - 1)], n);
                           });
  __syncthreads();""",
     """  int* peer = cluster.map_shared_rank(hist, rank ^ 1);
  cluster.sync();
  tile_pixels<uint16_t, W>(in + (int64_t)plane * rows * cols, rows, cols, ty, tx, th, tw,
                           rank * kThreads16 + tid, 2 * kThreads16, [&](int v, int n) {
                             if ((v >> 15) == rank) {
                               atomicAdd(&hist[v & (kHalf - 1)], n);
                             } else {
                               atomicAdd(&peer[v & (kHalf - 1)], n);
                             }
                           });
  cluster.sync();"""),
  ],
  "default carveout": [
    ("""      : allow_shared(clahe_blend<T, H, W, kStaged>,
                     cudaFuncAttributePreferredSharedMemoryCarveout, 0, done);""",
     """      : cudaSuccess;"""),
  ],
  "unstaged": [
    ("const bool staged = (int64_t)", "const bool staged = false && (int64_t)"),
  ],
}


def variant_source(text: str, edits) -> str:
  for old, new in edits:
    if text.count(old) != 1:
      raise RuntimeError(f"csrc/clahe.cu no longer holds the text this variant edits: {old[:60]!r}")
    text = text.replace(old, new)
  return text


def build_variants() -> dict:
  """{name: a ctypes library bound as ops/cuda_clahe binds csrc/clahe.cu}."""
  main = cuda_clahe._lib()
  libs = {"as is": main}
  out_dir = _build.BUILD_DIR / "clahe_variants"
  out_dir.mkdir(parents=True, exist_ok=True)
  text = (_build.CSRC_DIR / "clahe.cu").read_text()
  jobs = []
  for name, edits in VARIANTS.items():
    stem = name.replace(" ", "_")
    src = out_dir / f"{stem}.cu"
    src.write_text(variant_source(text, edits))
    so = out_dir / f"lib{stem}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
    jobs.append((name, so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
  for name, so, proc in jobs:
    if proc.wait() != 0:
      raise RuntimeError(f"nvcc failed for the {name!r} variant:\n{proc.stderr.read()}")
    lib = ctypes.CDLL(str(so))
    lib.igt_clahe.argtypes = main.igt_clahe.argtypes
    lib.igt_clahe.restype = ctypes.c_int
    lib.igt_error_string.argtypes = [ctypes.c_int]
    lib.igt_error_string.restype = ctypes.c_char_p
    libs[name] = lib
  return libs


def inputs(dev):
  """chip_smoke.py's phase 2 planes: its smooth surrogate (seed 14) as
  uint8 and, with random low bytes, as uint16; (P, C, R) C-contiguous."""
  sys.path.insert(0, str(_build.PKG_DIR.parent))
  import chip_smoke

  rng = np.random.default_rng(14)
  img = chip_smoke.smooth_image((2304, 2304, 64), rng, torch, dev)
  img16 = img.astype(np.uint16) * np.uint16(257)
  img16 += rng.integers(0, 257, img16.shape, dtype=np.uint16)
  u8 = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 1, 0))).to(dev)
  u16 = torch.from_numpy(np.ascontiguousarray(img16.transpose(2, 1, 0))).to(dev)
  return chip_smoke, [
    (INPUTS[0], u8, 40.0), (INPUTS[1], u16, 40.0),
    (INPUTS[2], u16[:16, :1030, :1030].contiguous(), 40.0),
    (INPUTS[3], torch.full_like(u8, 77), 40.0),
    (INPUTS[4], torch.from_numpy(np.full((16, 2304, 2304), 40000, np.uint16)).to(dev), 0.0),
  ]


def kernel_ms(fn) -> dict:
  """Device ms of each kernel of one launch: torch.profiler over 5."""
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
      fn()
    torch.cuda.synchronize()
  out = {}
  for e in prof.key_averages():
    for name in ("clahe_lut8", "clahe_lut16", "clahe_blend"):
      if name in e.key:
        out[name] = out.get(name, 0.0) + e.device_time_total / 5 / 1e3
  return out


def main() -> int:
  if not torch.cuda.is_available():
    print("clahe_variants needs a CUDA card", file=sys.stderr)
    return 1
  dev = torch.device("cuda")
  libs = build_variants()
  chip_smoke, cases = inputs(dev)
  for label, x, clip in cases:
    def run(lib, x=x, clip=clip):
      cuda_clahe._LIB = lib
      return cuda_clahe.launch(x, clip, GRID)

    ref = clahe_ops.clahe_plain(x.permute(2, 1, 0), clip, GRID).permute(2, 1, 0).contiguous()
    record = {"case": label}
    order = list(libs) + list(reversed(libs))
    times = {name: [] for name in libs}
    for name in order:
      out = run(libs[name])
      torch.cuda.synchronize()
      if not torch.equal(out.view(torch.uint8), ref.view(torch.uint8)):
        raise RuntimeError(f"{label}: the {name!r} build differs from clahe_plain")
      times[name].append(chip_smoke.device_ms(lambda n=name: run(libs[n])))
    for name in libs:
      record[name] = {"ms": float(np.mean(times[name])),
                      "kernels_ms": kernel_ms(lambda n=name: run(libs[n]))}
    cuda_clahe._LIB = libs["as is"]
    print(json.dumps(record), flush=True)
  print(chip_smoke.card_line())
  return 0


if __name__ == "__main__":
  sys.exit(main())
