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
// Bound. Device memory sees each label read once and each root written
// once, so the least time is 8 bytes a voxel over the memory rate; a copy
// of this kernel that only loads each tile into shared memory and stores
// it back reaches 84% of that bound (NVIDIA H100 80GB HBM3, 700 W; see
// PERF.md). What holds the kernel back on this card is the union-find in
// shared memory: chains of dependent shared-memory loads and atomics, one
// chain per union, whose latency the SM hides only with many warps.
//
// Design. The TPU kernel iterates rolls (a doubling segmented cummin along
// each axis, then a neighbour-min) until the tile stops changing, because
// Mosaic lowers neither gathers nor atomics. The fixpoint is unique (each
// component's minimum index), so here one block resolves a tile in one
// pass of a lock-free union-find in shared memory (labels and parents,
// int32 each: 64 KB for a (16, 16, 32) tile). Blocks are persistent and
// walk tiles. Per tile:
//   1. every foreground voxel points at the first voxel of its run of equal
//      labels along x within its warp's 32 voxels, the run's head (a warp
//      ballot of the run breaks);
//   2. every foreground voxel works out its joins, the neighbours of the
//      lexicographically negative half it must unite with (below), and
//      unites with them;
//   3. every head finds its root; then every foreground voxel reads its
//      root two steps up (itself or its head, then the root), background
//      its own index.
//
// The first version of this kernel (union-find without compression, a
// union for nearly every matching neighbour pair, runtime tile extents)
// ran at 0.6-22% of the bytes bound. What this version does about each of
// its costs:
//   a. Integer division on every voxel. The kernel is a template on the
//      tile shape; the default (16, 16, 32) and the other shapes the tile
//      sweep times, (8, 16, 64) and (8, 16, 32), have instances with the
//      extents known at compile time, so every index splits with shifts and
//      loads and stores move 16 bytes a thread. Any other shape, or tensors
//      not 16-byte aligned, take the instance with runtime extents (TZ = 0)
//      of the same source; the wrapper picks the instance.
//   b. Finds without compression. Every find of step 2 halves the path it
//      walks (each node it passes is pointed at its grandparent). The finds
//      start from the parents of the two voxels, never from the voxels: a
//      voxel that is not its run's head is then written by nothing and
//      keeps pointing at its head, so step 3 walks from the heads only.
//   c. Redundant unions. A voxel unites with one neighbouring run once.
//      Within one neighbouring row (dz, dy) the offsets dx = -1, 0, +1 hit
//      three consecutive voxels j-1, j, j+1. When j matches, j-1 and j+1
//      lie in j's run when they match, so only j is joined. When the
//      voxel's left neighbour i-1 is in its run, i-1's own joins (or those
//      of the run before it) already cover j-1 and j, so i joins only j+1,
//      and only when j does not match. A row that offers dx = 0 only
//      (6-connectivity, and the (-1, +-1) rows at 18) joins j unless i-1
//      and j-1 both match. At 26-connectivity this leaves about half the
//      unions of one per matching pair.
//   d. Load, resolve and store one after another. A bulk asynchronous copy
//      (cp.async.bulk on an mbarrier) of the next tile, overlapped with the
//      unions, was measured and gained nothing against plain loads: it
//      needs the joins held in registers meanwhile, which took 64 registers
//      a thread and two blocks an SM, and the other resident blocks hide
//      the loads already. What paid instead was occupancy: the steps are
//      loops that are not unrolled, the joins are recomputed from the
//      labels in shared memory, and the kernel is compiled for three blocks
//      of 512 threads an SM (at most 40 registers, no spills): 1.9-2.9x
//      faster, in one run on the card, than the same design with the steps
//      unrolled and the joins kept in registers (PERF.md, Findings).
//
// Why the output depends neither on the order in which the atomics land
// nor on the compression. In step 2 every write to parent[] is one of two
// kinds.
//   - A link: atomicCAS(&parent[b], b, a) with a < b, which succeeds only
//     while b is a root; a failed link re-finds both roots and retries.
//   - A halving step of a find: parent[x] = parent[parent[x]] for a node x
//     found not to be a root. A node that is not a root never becomes one
//     again, and only halving steps write to it, each with an ancestor of
//     x (an ancestor stays an ancestor, as nodes only move up within their
//     tree). So halving moves a node up its own tree, never out of it.
// Hence (i) parent[i] <= i throughout (a link hangs the larger root under
// the smaller, an ancestor is smaller than its descendant), so the root of
// every tree is its minimum index; (ii) trees only ever merge, and every
// union returns once its two voxels share a root, so after the barrier
// that ends step 2 the trees are exactly the tile's components, whatever
// the order of the atomics and the writes. In step 3 no link happens and
// the heads' walks only read; each head's own thread then stores its root
// (a write of an ancestor again), so after the next barrier every head's
// parent is its component's minimum and each voxel reads it two steps up:
// the output is the unique fixpoint. (The union is that of Playne and
// Hawick, IEEE TPDS 2018; a link that only replaces a root, with halving
// beside it, is that of Jayanti and Tarjan's concurrent set union.)
//
// C interface (bound with ctypes): the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use
constexpr int kBlocksPerSm = 3;  // registers for three (16, 16, 32) blocks an SM
constexpr unsigned kFull = 0xffffffffu;
// A voxel's joins are a 13-bit mask: bit b unites it with its neighbour at
// offset (dz, dy, dx), b = (dz+1)*9 + (dy+1)*3 + (dx+1), which is below 13
// exactly for the lexicographically negative half. Bits 0..11 are the
// rows r = b/3 of (dz, dy) = (-1,-1), (-1,0), (-1,1), (0,-1) with
// dx = b%3 - 1; bit 12 is (0, 0, -1), the left neighbour, joined only when
// a run crosses into another warp (the ballot links the rest of a run).

// The root of x, halving the path on the way: every node passed that is
// not a root is pointed at its grandparent (see the note above).
__device__ __forceinline__ int find_root(int* par, int x) {
  volatile int* vp = par;
  int p = vp[x];
  while (p != x) {
    const int g = vp[p];
    if (g == p) return p;
    vp[x] = g;
    x = g;
    p = vp[x];
  }
  return x;
}

// The root of x, read only: step 3, where every head's parent has to end
// as its root, walks without halving (a halving write could replace a
// root another thread has just stored with an ancestor below it).
__device__ __forceinline__ int root_of(const int* par, int x) {
  const volatile int* vp = par;
  int p = vp[x];
  while (p != x) {
    x = p;
    p = vp[x];
  }
  return x;
}

// Unite the sets of a and b; returns the root the two share at the end.
__device__ __forceinline__ int unite(int* par, int a, int b) {
  while (true) {
    a = find_root(par, a);
    b = find_root(par, b);
    if (a == b) return a;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(&par[b], b, a) == b) return a;  // b was still a root
  }
}

// The joins of foreground voxel i, label l, at (z, y, x); `left` says that
// its left neighbour is in its run, `lane0` that it is its warp's first.
template <int DEGREE>
__device__ __forceinline__ unsigned joins(const int* lab, int i, int l,
                                          bool left, bool lane0, int z, int y,
                                          int x, int ty, int tx, int tyx) {
  unsigned bits = left && lane0 ? 1u << 12 : 0u;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int dz = r < 3 ? -1 : 0;
    const int dy = r < 3 ? r - 1 : -1;
    const int deg = (dz != 0) + (dy != 0);  // degree of the row's dx = 0
    if (deg > DEGREE) continue;
    if (z + dz < 0 || y + dy < 0 || y + dy >= ty) continue;
    const int j = i + dz * tyx + dy * tx;  // the row's dx = 0 neighbour
    const bool c0 = lab[j] == l;
    if (deg == DEGREE) {  // the row offers dx = 0 only
      if (c0 && !(left && lab[j - 1] == l)) bits |= 1u << (3 * r + 1);
    } else if (left) {  // i-1 joined j-1 and j already
      if (!c0 && x + 1 < tx && lab[j + 1] == l) bits |= 1u << (3 * r + 2);
    } else if (c0) {  // j-1 and j+1 are in j's run when they match
      bits |= 1u << (3 * r + 1);
    } else {
      if (x > 0 && lab[j - 1] == l) bits |= 1u << (3 * r);
      if (x + 1 < tx && lab[j + 1] == l) bits |= 1u << (3 * r + 2);
    }
  }
  return bits;
}

// Unite voxel i with each of its joins. The finds start from the parents
// of i and of the neighbour, never from the voxels themselves: a voxel that
// is not the first of its run is then written by nothing, and keeps
// pointing at that first voxel, its run's head, to the end.
__device__ __forceinline__ void unite_joins(int* par, int i, unsigned bits,
                                            int tx, int tyx) {
  int a = par[i];
  while (bits) {
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
    const int r = b / 3;
    const int row = b == 12 ? 0 : (r < 3 ? -tyx + (r - 1) * tx : -tx);
    a = unite(par, a, par[i + row + (b - 3 * r - 1)]);
  }
}

// TZ, TY, TX: the tile shape, or 0 for the instance that takes it at run
// time. DEGREE: the largest |dz|+|dy|+|dx| of a neighbour (1, 2, 3 for 6-,
// 18- and 26-connectivity).
template <int TZ, int TY, int TX, int DEGREE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tile_resolve_kernel(const int32_t* __restrict__ labt, int32_t* __restrict__ out,
                    int64_t tiles, int rtz, int rty, int rtx) {
  constexpr bool kFixed = TZ > 0;
  constexpr int kVoxels = TZ * TY * TX;
  static_assert(kVoxels % kThreads == 0, "whole steps of the block");
  extern __shared__ __align__(16) int smem[];
  const int tz = kFixed ? TZ : rtz, ty = kFixed ? TY : rty,
            tx = kFixed ? TX : rtx;
  const int tyx = ty * tx, n = tz * tyx;
  // a step is kThreads consecutive voxels, so the warp of a thread holds
  // 32 consecutive voxels in every step
  const int steps = kFixed ? kVoxels / kThreads : (n + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31;
  int* lab = smem;
  int* par = smem + n;

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    if constexpr (kFixed) {
      const int4* src = reinterpret_cast<const int4*>(labt + t * kVoxels);
      for (int q = threadIdx.x; q < kVoxels / 4; q += kThreads)
        reinterpret_cast<int4*>(lab)[q] = __ldg(src + q);
    } else {
      const int32_t* src = labt + t * n;
      for (int i = threadIdx.x; i < n; i += kThreads) lab[i] = __ldg(src + i);
    }
    __syncthreads();
    // 1. runs along x: every foreground voxel points at its run's head
    // (the steps are not unrolled: unrolled, they hold more registers than
    // three blocks an SM leave, and the kernel is bound by latency, so it
    // needs the resident warps more than the instruction-level parallelism)
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {  // every lane runs every step
      const int i = k * kThreads + threadIdx.x;
      const int l = kFixed || i < n ? lab[i] : 0;
      const bool left = l != 0 && i % tx > 0 && lab[i - 1] == l;
      const unsigned heads =
          __ballot_sync(kFull, lane == 0 || !left) & (kFull >> (31 - lane));
      if (kFixed || i < n) par[i] = l != 0 ? i - lane + (31 - __clz(heads)) : -1;
    }
    __syncthreads();
    // 2. every foreground voxel unites with its joins
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {
      const int i = k * kThreads + threadIdx.x;
      const int l = kFixed || i < n ? lab[i] : 0;
      if (l == 0) continue;
      const int x = i % tx;
      const bool left = x > 0 && lab[i - 1] == l;
      unite_joins(par, i,
                  joins<DEGREE>(lab, i, l, left, lane == 0, i / tyx,
                                (i / tx) % ty, x, ty, tx, tyx),
                  tx, tyx);
    }
    __syncthreads();
    // 3. the heads find their roots; then every foreground voxel reads its
    // root two steps up (itself or its head, then the root), background
    // its own index
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {
      const int i = k * kThreads + threadIdx.x;
      const int l = kFixed || i < n ? lab[i] : 0;
      if (l != 0 && (lane == 0 || !(i % tx > 0 && lab[i - 1] == l)))
        par[i] = root_of(par, i);
    }
    __syncthreads();
    int32_t* dst = out + t * n;
    if constexpr (kFixed) {
      for (int q = threadIdx.x; q < kVoxels / 4; q += kThreads) {
        const int4 p = reinterpret_cast<const int4*>(par)[q];
        const int i = 4 * q;
        reinterpret_cast<int4*>(dst)[q] =
            make_int4(p.x < 0 ? i : par[p.x], p.y < 0 ? i + 1 : par[p.y],
                      p.z < 0 ? i + 2 : par[p.z], p.w < 0 ? i + 3 : par[p.w]);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int p = par[i];
        dst[i] = p < 0 ? i : par[p];
      }
    }
    __syncthreads();  // the next tile reuses both buffers
  }
}

template <int TZ, int TY, int TX, int DEGREE>
cudaError_t launch(const void* labt, void* out, int64_t tiles, int tz, int ty,
                   int tx, cudaStream_t stream) {
  const int64_t n = (int64_t)tz * ty * tx;
  if (tz < 1 || ty < 1 || tx < 1 || 8 * n > kSmemLimit)
    return cudaErrorInvalidValue;
  if (TZ > 0 && (tz != TZ || ty != TY || tx != TX ||
                 reinterpret_cast<uintptr_t>(labt) % 16 ||
                 reinterpret_cast<uintptr_t>(out) % 16))
    return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  const size_t smem = 8 * (size_t)n;  // labels and parents, int32 each
  const void* kernel =
      reinterpret_cast<const void*>(&tile_resolve_kernel<TZ, TY, TX, DEGREE>);
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
  tile_resolve_kernel<TZ, TY, TX, DEGREE>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          static_cast<const int32_t*>(labt), static_cast<int32_t*>(out), tiles,
          tz, ty, tx);
  return cudaGetLastError();
}

template <int DEGREE>
cudaError_t dispatch(const void* labt, void* out, int64_t tiles, int tz, int ty,
                     int tx, int fixed, cudaStream_t s) {
  if (!fixed) return launch<0, 0, 0, DEGREE>(labt, out, tiles, tz, ty, tx, s);
  if (tz == 16 && ty == 16 && tx == 32)
    return launch<16, 16, 32, DEGREE>(labt, out, tiles, tz, ty, tx, s);
  if (tz == 8 && ty == 16 && tx == 64)
    return launch<8, 16, 64, DEGREE>(labt, out, tiles, tz, ty, tx, s);
  if (tz == 8 && ty == 16 && tx == 32)
    return launch<8, 16, 32, DEGREE>(labt, out, tiles, tz, ty, tx, s);
  return cudaErrorInvalidValue;  // no fixed-shape instance of this tile
}

}  // namespace

extern "C" {

const char* igt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fixed: 1 for the instance compiled for this tile shape (the wrapper's
// FIXED_TILES, 16-byte aligned tensors), 0 for the runtime-shape instance.
int igt_tile_resolve(const void* labt, void* out, int64_t tiles, int tz,
                     int ty, int tx, int connectivity, int fixed,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (connectivity) {
    case 6: return dispatch<1>(labt, out, tiles, tz, ty, tx, fixed, s);
    case 18: return dispatch<2>(labt, out, tiles, tz, ty, tx, fixed, s);
    case 26: return dispatch<3>(labt, out, tiles, tz, ty, tx, fixed, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
