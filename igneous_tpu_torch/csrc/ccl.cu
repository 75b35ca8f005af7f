// Block-local connected-components resolve of CCL tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernel tile_resolve (igneous_tpu/ops/pallas_ccl.py:118,
// body _resolve_kernel :68 and _seg_cummin_doubling :44).
//
// Contract (the Pallas kernel's): labt is (T, tz, ty, tx) int32 dense
// labels, C-contiguous. Two voxels of one tile connect iff their labels are
// equal and nonzero and they are neighbours under 6/18/26-connectivity
// inside the tile. Every foreground voxel gets the local flat index
// (z*ty*tx + y*tx + x) of the minimum voxel of its tile-component; a
// background voxel keeps its own index.
//
// Design. The TPU kernel iterates rolls (a doubling segmented cummin along
// each axis, then a neighbour-min) until the tile stops changing, because
// Mosaic lowers neither gathers nor atomics. Hopper has fast shared-memory
// atomics, and the fixpoint is unique (each component's minimum index), so
// here each tile is resolved in one pass of a lock-free union-find in
// shared memory:
//   1. load the tile's labels into shared memory;
//   2. point every foreground voxel at the first voxel of its run of equal
//      labels along x within its warp's 32 voxels (a warp ballot), so the
//      runs are joined without atomics and every chain starts short;
//   3. for every foreground voxel and every other neighbour offset of the
//      lexicographically negative half of neighbor_offsets(connectivity)
//      (each unordered pair once) that lies inside the tile with an equal
//      label, unite the two: find both roots and hang the larger root under
//      the smaller with atomicMin, retrying from the value found when
//      another thread linked that root first. A pair is skipped when the
//      voxel's left neighbour has the same label and the same offset from
//      it does too: those voxels' own pair joins the same two runs;
//   4. after a barrier, the first voxel of every run finds its root; after
//      another, every voxel writes the root of its run's first voxel.
// Every write to parent[] points at a smaller index (during the unions, by
// atomicMin), so parent[i] <= i holds throughout and the root of every set is
// its minimum index: the output does not depend on the order in which the
// atomics land. (This is the union of Playne and Hawick, IEEE TPDS 2018.)
//
// Blocks are persistent: the grid fills the card once and each block walks
// tiles (one block per tile would spend its time starting blocks).
//
// Bound: a handful of integer operations and shared-memory accesses per
// voxel and neighbour; device memory sees each label read once and each
// root written once, so the least time is 8 bytes a voxel over the memory
// rate.
//
// C interface (bound with ctypes): the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use

// The root of x. No path compression while unions are in flight: a plain
// write could undo a link another thread just made.
__device__ __forceinline__ int find_root(const int* par, int x) {
  const volatile int* vp = par;
  int p = vp[x];
  while (p != x) {
    x = p;
    p = vp[x];
  }
  return x;
}

__device__ __forceinline__ void unite(int* par, int a, int b) {
  while (true) {
    a = find_root(par, a);
    b = find_root(par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&par[b], a);
    if (old == b) return;  // b was still a root: linked under a
    b = old;               // b was linked meanwhile: unite a with its parent
  }
}

// DEGREE: the largest |dz|+|dy|+|dx| of a neighbour (1, 2, 3 for 6-, 18-
// and 26-connectivity).
template <int DEGREE>
__global__ void __launch_bounds__(kThreads)
tile_resolve_kernel(const int32_t* __restrict__ labt, int32_t* __restrict__ out,
                    int64_t tiles, int tz, int ty, int tx) {
  extern __shared__ int smem[];
  const int n = tz * ty * tx;
  const int tyx = ty * tx;
  const int lane = threadIdx.x & 31;  // kThreads is a multiple of 32, so a
                                      // warp holds 32 consecutive voxels
  int* lab = smem;
  int* par = smem + n;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int32_t* src = labt + t * n;
    for (int i = threadIdx.x; i < n; i += kThreads) lab[i] = __ldg(src + i);
    __syncthreads();
    // runs along x: every foreground voxel points straight at the first
    // voxel of its run within its warp's 32 voxels (a ballot of the run
    // breaks), so chains start short and the -x pairs need no union
    for (int base = 0; base < n; base += kThreads) {  // every lane runs each step
      const int i = base + threadIdx.x;
      const bool valid = i < n;
      const int l = valid ? lab[i] : 0;
      const bool brk = valid && (lane == 0 || i % tx == 0 || lab[i - 1] != l);
      const unsigned breaks =
          __ballot_sync(0xffffffffu, brk) & (0xffffffffu >> (31 - lane));
      if (valid) par[i] = l != 0 ? i - lane + (31 - __clz(breaks)) : i;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int l = lab[i];
      if (l == 0) continue;
      const int z = i / tyx;
      const int r = i - z * tyx;
      const int y = r / tx;
      const int x = r - y * tx;
      const bool left = x > 0 && lab[i - 1] == l;
      if (left && lane == 0) unite(par, i, i - 1);  // a run crossing warps
      // offsets (dz, dy, dx) with linear index (dz+1)*9 + (dy+1)*3 + (dx+1)
      // below 13, the centre, are exactly the lexicographically negative
      // half; 12 is (0, 0, -1), the runs above
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        const int dz = k / 9 - 1, dy = (k / 3) % 3 - 1, dx = k % 3 - 1;
        if ((dz != 0) + (dy != 0) + (dx != 0) > DEGREE) continue;
        const int zz = z + dz, yy = y + dy, xx = x + dx;
        if (zz < 0 || yy < 0 || yy >= ty || xx < 0 || xx >= tx) continue;
        const int j = i + dz * tyx + dy * tx + dx;
        if (lab[j] != l) continue;
        // already joined: i's left neighbour is in i's run, it joins the
        // voxel left of j at the same offset, and that voxel is in j's run
        if (left && xx > 0 && lab[j - 1] == l) continue;
        unite(par, i, j);
      }
    }
    __syncthreads();
    // no unions run now. Only the first voxel of a run was ever a root, so
    // the others still point at it: the first voxels find their roots (and
    // keep them), then every voxel reads its root two steps up
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int l = lab[i];
      if (l != 0 && (lane == 0 || i % tx == 0 || lab[i - 1] != l))
        par[i] = find_root(par, i);
    }
    __syncthreads();
    int32_t* dst = out + t * n;
    for (int i = threadIdx.x; i < n; i += kThreads)
      dst[i] = lab[i] != 0 ? par[par[i]] : i;
    __syncthreads();  // the next tile reuses the shared buffers
  }
}

template <int DEGREE>
cudaError_t launch(const void* labt, void* out, int64_t tiles, int tz, int ty,
                   int tx, cudaStream_t stream) {
  const int64_t n = (int64_t)tz * ty * tx;
  if (tz < 1 || ty < 1 || tx < 1 || 8 * n > kSmemLimit)
    return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  const size_t smem = 8 * (size_t)n;  // labels and parents, int32 each
  const void* kernel = reinterpret_cast<const void*>(&tile_resolve_kernel<DEGREE>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = tiles < resident ? tiles : resident;
  tile_resolve_kernel<DEGREE><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(labt), static_cast<int32_t*>(out), tiles,
      tz, ty, tx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* igt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int igt_tile_resolve(const void* labt, void* out, int64_t tiles, int tz,
                     int ty, int tx, int connectivity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (connectivity) {
    case 6: return launch<1>(labt, out, tiles, tz, ty, tx, s);
    case 18: return launch<2>(labt, out, tiles, tz, ty, tx, s);
    case 26: return launch<3>(labt, out, tiles, tz, ty, tx, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
