"""Where tile_resolve spends its time: the kernel of csrc/ccl.cu cut after
each of its steps, timed on the card.

    python3 -m igneous_tpu_torch.tools.ccl_stage_costs

Builds four copies of csrc/ccl.cu under build/stage_costs/: "load+store"
(each tile loaded into shared memory and stored back), "+runs" (step 1),
"+unions" (steps 1 and 2, the parents stored as they stand) and the whole
kernel, and times each (device time, CUDA-graph replay) on the four 449^3
cases of chip_smoke.py in the default tile, in turns (a, b, c, d, d, c, b,
a). The differences between neighbouring copies are the steps' costs.
Prints one JSON line a case and the card's name and power limit. Needs a
CUDA card and nvcc; the cut copies' outputs are not the contract's and
are not checked.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import _build, ccl as ccl_ops, cuda_ccl

STEPS = ("    // 1. runs along x", "    // 2. every foreground voxel unites",
         "    // 3. the heads find their roots")
CUTS = ("load+store", "+runs", "+unions", "whole")


def cut_source(text: str, keep: int) -> str:
  """The kernel source with the loops of steps after ``keep`` skipped and,
  below the whole kernel, the labels (keep 0) or the parents stored."""
  if keep == 3:
    return text
  for step in range(len(STEPS), keep, -1):
    a = text.index("#pragma unroll 1", text.index(STEPS[step - 1]))
    e = text.index("\n    __syncthreads();", a)
    text = text[:a] + "if (false) {\n" + text[a:e] + "\n    }" + text[e:]
  store = text.index("reinterpret_cast<int4*>(dst)[q] =")
  end = text.index(";", text.index("par[p.w]", store))
  value = "reinterpret_cast<const int4*>(lab)[q]" if keep == 0 else "p"
  return text[:store] + f"reinterpret_cast<int4*>(dst)[q] = {value}" + text[end:]


def build_cut(keep: int) -> ctypes.CDLL:
  out_dir = _build.BUILD_DIR / "stage_costs"
  out_dir.mkdir(parents=True, exist_ok=True)
  src = out_dir / f"ccl_cut{keep}.cu"
  src.write_text(cut_source((_build.CSRC_DIR / "ccl.cu").read_text(), keep))
  lib = out_dir / f"libccl_cut{keep}.so"
  proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
  so = ctypes.CDLL(str(lib))
  so.igt_tile_resolve.argtypes = cuda_ccl._lib().igt_tile_resolve.argtypes
  so.igt_tile_resolve.restype = ctypes.c_int
  return so


def launcher(so, labt: torch.Tensor, conn: int):
  out = torch.empty_like(labt)
  T, tz, ty, tx = labt.shape
  fixed = int(cuda_ccl.fixed_instance((tz, ty, tx), labt.data_ptr(), out.data_ptr()))

  def run():
    rc = so.igt_tile_resolve(labt.data_ptr(), out.data_ptr(), T, tz, ty, tx, conn,
                             fixed, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
      raise RuntimeError(f"tile_resolve cut failed: CUDA error {rc}")
  return run


def main() -> int:
  import chip_smoke as cs

  if not torch.cuda.is_available():
    raise SystemExit("ccl_stage_costs needs a CUDA card")
  dev = torch.device("cuda")
  libs = [build_cut(keep) for keep in range(4)]
  n = cs.CCL_CUTOUT
  rng = np.random.default_rng(1)  # the cases of chip_smoke.ccl_kernel_phase
  mask = cs.smooth_image((n, n, n), rng, torch, dev) >= 128
  mask = torch.from_numpy(np.ascontiguousarray(mask.transpose(2, 1, 0))).to(dev).to(torch.int32)
  g = torch.Generator(device=dev).manual_seed(2)
  dense = torch.randint(1, 4, (n, n, n), dtype=torch.int32, device=dev, generator=g)
  cases = [("mask of the smooth image >= 128", mask, 6), ("dense multilabel, 3 labels", dense, 6),
           ("serpentine tube", cs.serpentine(n, torch, dev), 6),
           ("dense multilabel, 3 labels, connectivity 26", dense, 26)]
  for label, vol, conn in cases:
    labt = ccl_ops.to_tiles(vol, ccl_ops._DEFAULT_TILE_CUDA)[0]
    times = {c: [] for c in CUTS}
    for cut, so in list(zip(CUTS, libs)) + list(zip(CUTS, libs))[::-1]:
      times[cut].append(cs.device_ms(launcher(so, labt, conn)))
    print(json.dumps({"case": label, "tiles": list(labt.shape),
                      "ms": {c: sum(v) / len(v) for c, v in times.items()}}), flush=True)
  print(cs.card_line())
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
