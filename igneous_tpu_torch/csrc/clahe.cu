// Contrast-limited adaptive histogram equalisation (CLAHE) of a stack of
// 8- or 16-bit planes for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs CLAHE on the host through
// OpenCV (igneous_tpu/tasks/contrast.py, CLAHETask, cv2.createCLAHE(...)
// .apply on each z plane), and the card's machine has no OpenCV. The
// kernels below compute OpenCV's CLAHE::apply bit for bit:
//
//   clahe_lut8   one block a (plane, tile): the tile's histogram over the
//                padded plane, the clip and the redistribution of the
//                clipped count, the prefix sum and the 256-entry LUT;
//   clahe_lut16  one cluster of two blocks a (plane, tile): the same for
//                65536 bins, each block holding half of them;
//   clahe_blend  one block a (plane, window of rows, run of columns): the
//                bilinear blend of the LUTs of the four nearest tiles at
//                each voxel's value.
//
// Layout: the planes are (P, C, R), C-contiguous, R fastest: a Volume's
// (z, y, x) cutout, whose plane rows (OpenCV's y) are the Volume's x and
// whose columns (OpenCV's x) are its y. The padded plane that the LUTs come
// from is never stored: a read past the last row or column reflects
// (BORDER_REFLECT_101) into the plane, and only the tiles that reach the
// pad take that path. The wrapper (igneous_tpu_torch/ops/cuda_clahe.py)
// computes the padding, the tile sizes, the clip limit and the LUT scale
// exactly as OpenCV does, and the blend's weight tables: for each row
// (ty1, ty2, ya, 1 - ya) and each column (tx1, tx2, xa, 1 - xa), with
// OpenCV's float32 ops, once per geometry. So the per-voxel path holds no
// integer division and no weight arithmetic.
//
// Exactness: every float product and sum is an explicit __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc cannot contract a pair into an FMA, and the
// roundings are half to even, as cvRound: __float2int_rn in the LUT pass,
// the same rounding through a float add in the blend (round_small). The
// histogram, the clip and the prefix sum are integer work, exact in any
// order. A LUT entry becomes a float as (2^23 + v) - 2^23, exact.
//
// Design against what bounds it. The least time is the planes' bytes in
// and out over the memory rate (the LUTs, 256 bytes a (plane, tile) for
// 8-bit planes and 128 KiB for 16-bit ones, are written once and gathered
// by the blend besides). Each pass reads the stack once.
//   - Loads and stores are 16 bytes a thread wherever a plane's rows are a
//     multiple of 16 bytes and the tensors start 16-byte aligned (as
//     PyTorch allocates them); other planes take one element a thread,
//     still coalesced.
//   - Histograms: each warp of an 8-bit LUT block adds into its own
//     256-bin sub-histogram in shared memory; a vector of equal values is
//     one atomic, and so is a warp of them (a constant region).
//   - 16-bit histograms (65536 int32 bins, 256 KiB) do not fit one block:
//     a cluster of two blocks holds 32768 bins each (128 KiB of dynamic
//     shared memory), one block an SM. Both read the whole tile (the
//     second read hits L2) and each counts its own half: on the 16-bit
//     task cutout that took 1.595 ms where adding half the tile into both
//     halves through distributed shared memory took 2.972 (NVIDIA H100
//     80GB HBM3, 700.00 W; igneous_tpu_torch/tools/clahe_variants.py,
//     which builds and times such variants of this file). The clipped
//     count and the first half's total cross through distributed shared
//     memory; each block then scans its half, a warp 1024 consecutive bins
//     32 at a time with shuffles, and writes its half of the LUT with
//     coalesced stores. Counts stay 32-bit: one bin can hold a whole tile.
//   - The blend: a block takes 128 rows of 256 columns and stages their
//     weight rows in shared memory; a warp's lanes take 16 columns, two
//     16-byte vectors down each (16 rows of 8-bit, 8 of 16-bit voxels a
//     vector), so that the voxels of a gather are a small patch of
//     neighbours with alike values. 8-bit LUTs of the block's tiles are
//     staged in shared memory as floats; 16-bit ones (8 MiB a plane at
//     grid 8) are gathered through L1, with the kernel's shared-memory
//     carveout at its least so that L1 holds most of what a block gathers
//     (4.720 against 7.212 ms with the default carveout, on the 16-bit
//     cutout's blend; the same tool and card).
//
// Memory: the entry point runs the planes in batches of `batch`, the LUT
// pass of a batch then its blend, so the LUTs take `batch` planes' worth
// whatever the stack's depth; there is no other scratch.
//
// C interface (bound with ctypes): the entry point launches the kernels on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // clahe_lut8 and clahe_blend
constexpr int kWarps = kThreads / 32;
constexpr int kThreads16 = 1024;    // clahe_lut16
constexpr int kHalf = 32768;        // bins a block of clahe_lut16
constexpr int kBlendRows = 128;     // rows a blend block
constexpr int kBlendCols = 256;     // columns a blend block
constexpr int kStageBytes = 64 << 10;  // staged float LUTs of a blend block, at most

enum DType { kU8 = 0, kU16 = 1 };

// OpenCV's borderInterpolate for BORDER_REFLECT_101 (dcb|abcd|cba),
// looping for a border wider than the plane
__device__ __forceinline__ int reflect101(int p, int len) {
  if (len == 1) return 0;
  while ((unsigned)p >= (unsigned)len) {
    p = p < 0 ? -p : 2 * len - 2 - p;
  }
  return p;
}

// W elements of T as one load and one store (16 bytes, or one element)
template <typename T, int W>
union Vec {
  static_assert(W == 1 || W * sizeof(T) == 16, "a vector is 16 bytes or one element");
  typename std::conditional<W == 1, T, uint4>::type v;
  T e[W];
};

// whether a vector's elements are all equal
template <typename T, int W>
__device__ __forceinline__ bool all_equal(const Vec<T, W>& x) {
  if constexpr (W == 1) {
    return true;
  } else {
    const unsigned s = (unsigned)x.e[0] * (sizeof(T) == 1 ? 0x01010101u : 0x00010001u);
    return x.v.x == s && x.v.y == s && x.v.z == s && x.v.w == s;
  }
}

// (2^23 + v) - 2^23: a LUT entry as a float, exact for v < 2^23
__device__ __forceinline__ float small_to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f);
}

// rint(x) (half to even, as __float2int_rn) for 0 <= x < 2^22, as
// (x + 1.5 * 2^23) - (1.5 * 2^23) in the float's bits. A blend lies in
// [0, bins - 1] up to a rounding of its weights (a convex sum of LUT
// entries), so it needs no clamp: it rounds into that range.
__device__ __forceinline__ int round_small(float x) {
  return __float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000;
}

// The pixels of tile (ty, tx) of the padded plane at `src`, each handed to
// add(value, count), by thread `first` of `stride` threads. A vector of
// equal values is one call, and so are the vectors of a warp that all hold
// one value (a constant region). Three flat lists of work items, each
// with one division an item and none a pixel:
//   - the tile's rows inside the plane, column by column, as W-element
//     vectors (columns start W-aligned: rows % W == 0);
//   - the rows of each column before the first and after the last vector;
//   - the padded rows past the plane, reflected (the last tile row only).
// A column past the plane reflects to its mirror (the last tile column).
template <typename T, int W, typename Add>
__device__ __forceinline__ void tile_pixels(const T* __restrict__ src, int rows, int cols,
                                            int ty, int tx, int th, int tw, int first,
                                            int stride, Add add) {
  const int r0 = ty * th;
  const int rin = max(min(r0 + th, rows) - r0, 0);
  const int head = W > 1 ? min((W - r0 % W) % W, rin) : 0;
  const int nv = (rin - head) / W;
  const int ht = rin - nv * W;  // head and tail
  auto column = [&](int lc) {
    const int c = tx * tw + lc;
    return (int64_t)(c < cols ? c : reflect101(c, cols)) * rows;
  };
  if (nv > 0) {
    // every lane of a warp runs the same iterations (first - lane and
    // stride are a warp's), so that the warp can vote
    const int lane = threadIdx.x & 31;
    const int n = tw * nv;
    for (int base = first - lane; base < n; base += stride) {
      const int k = base + lane;
      Vec<T, W> x;
      int v0 = -1;
      bool same = false;
      if (k < n) {
        const int lc = k / nv;
        const int v = k - lc * nv;
        x.v = *reinterpret_cast<const decltype(x.v)*>(src + column(lc) + r0 + head + v * W);
        v0 = x.e[0];
        same = all_equal<T, W>(x);
      }
      // (the shuffle outside the &&: every lane must take part)
      const int first_value = __shfl_sync(0xffffffffu, v0, 0);
      if (__all_sync(0xffffffffu, same && v0 == first_value)) {
        if (lane == 0) add(v0, 32 * W);
      } else if (same) {
        add(v0, W);
      } else if (k < n) {
#pragma unroll
        for (int j = 0; j < W; ++j) add(x.e[j], 1);
      }
    }
  }
  if (ht > 0) {
    const int n = tw * ht;
    for (int k = first; k < n; k += stride) {
      const int lc = k / ht;
      const int j = k - lc * ht;
      const int r = j < head ? r0 + j : r0 + nv * W + j;
      add(src[column(lc) + r], 1);
    }
  }
  const int p0 = max(r0, rows);
  const int np = r0 + th - p0;
  if (np > 0) {
    const int n = tw * np;
    for (int k = first; k < n; k += stride) {
      const int lc = k / np;
      const int r = reflect101(p0 + k - lc * np, rows);
      add(src[column(lc) + r], 1);
    }
  }
}

// inclusive scan of x across a warp
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ int lut_value(int cum, float lut_scale, int hmax) {
  const int v = __float2int_rn(__fmul_rn((float)cum, lut_scale));
  return min(max(v, 0), hmax);
}

// grid (gy * gx, planes of the batch); lut: (planes, gy, gx, 256)
template <int W>
__global__ void __launch_bounds__(kThreads)
clahe_lut8(const uint8_t* __restrict__ in, uint8_t* __restrict__ lut, int rows, int cols,
           int gy, int gx, int th, int tw, int limit, float lut_scale) {
  __shared__ int hist[kWarps][256];
  __shared__ int part[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, plane = blockIdx.y;
  const int ty = tile / gx, tx = tile - ty * gx;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) hist[w][tid] = 0;
  __syncthreads();

  int* mine = hist[warp];
  tile_pixels<uint8_t, W>(in + (int64_t)plane * rows * cols, rows, cols, ty, tx, th, tw,
                          tid, kThreads,
                          [&](int v, int n) { atomicAdd(&mine[v], n); });
  __syncthreads();

  // thread i holds bin i
  int h = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) h += hist[w][tid];
  if (limit > 0) {
    const int excess = max(h - limit, 0);
    h -= excess;
    const int s = warp_sum(excess);
    if (lane == 0) part[warp] = s;
    __syncthreads();
    int clipped = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) clipped += part[w];
    __syncthreads();
    // every bin gets clipped / 256; the residual goes one a bin to bins
    // 0, step, 2 step, ... while it lasts
    const int batch = clipped >> 8;
    const int residual = clipped & 255;
    const int step = residual ? max(256 / residual, 1) : 1;
    h += batch + (residual && tid % step == 0 && tid / step < residual);
  }
  const int x = warp_scan(h, lane);
  if (lane == 31) part[warp] = x;
  __syncthreads();
  int offset = 0;
  for (int w = 0; w < warp; ++w) offset += part[w];
  lut[((int64_t)plane * gy * gx + tile) * 256 + tid] = (uint8_t)lut_value(x + offset, lut_scale, 255);
}

// grid (2 * gy * gx, planes of the batch) in clusters of two; block rank r
// of a cluster owns bins [r * 32768, r * 32768 + 32768) of the tile;
// dynamic shared memory: 32768 int32; lut: (planes, gy, gx, 65536)
template <int W>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads16, 1)
clahe_lut16(const uint16_t* __restrict__ in, uint16_t* __restrict__ lut, int rows, int cols,
            int gy, int gx, int th, int tw, int limit, float lut_scale) {
  extern __shared__ int hist[];
  __shared__ int part[2][32];
  __shared__ int shared_sums[2];  // this block's clipped count and clipped total
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x >> 1, plane = blockIdx.y;
  const int ty = tile / gx, tx = tile - ty * gx;

  int4* h4 = reinterpret_cast<int4*>(hist);
  for (int i = tid; i < kHalf / 4; i += kThreads16) h4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // each block reads the whole tile (the second read of a tile hits L2)
  // and counts the values of its own half
  tile_pixels<uint16_t, W>(in + (int64_t)plane * rows * cols, rows, cols, ty, tx, th, tw,
                           tid, kThreads16, [&](int v, int n) {
                             if ((v >> 15) == rank) atomicAdd(&hist[v & (kHalf - 1)], n);
                           });
  __syncthreads();

  // clip at the limit; the clipped count and the clipped total of each half
  int excess = 0, total = 0;
  for (int i = tid; i < kHalf; i += kThreads16) {
    int h = hist[i];
    if (limit > 0 && h > limit) {
      excess += h - limit;
      h = limit;
      hist[i] = h;
    }
    total += h;
  }
  excess = warp_sum(excess);
  total = warp_sum(total);
  if (lane == 0) {
    part[0][warp] = excess;
    part[1][warp] = total;
  }
  __syncthreads();
  if (warp == 0) {
    const int e = warp_sum(part[0][lane]);
    const int t = warp_sum(part[1][lane]);
    if (lane == 0) {
      shared_sums[0] = e;
      shared_sums[1] = t;
    }
  }
  cluster.sync();
  const int* theirs = cluster.map_shared_rank(shared_sums, rank ^ 1);
  const int clipped = shared_sums[0] + theirs[0];
  const int first_total = rank == 0 ? shared_sums[1] : theirs[1];
  // every bin gets clipped / 65536 (`batch`); the residual goes one a bin
  // to bins 0, step, 2 step, ... while it lasts: here the ones in this half
  const int batch = clipped >> 16;
  const int residual = clipped & 65535;
  const int step = residual ? max(65536 / residual, 1) : 1;
  const int lo = rank * kHalf;
  const int k0 = (lo + step - 1) / step;
  const int k1 = residual ? min(residual, (lo + kHalf + step - 1) / step) : 0;
  for (int k = k0 + tid; k < k1; k += kThreads16) hist[k * step - lo] += 1;
  // the second half's prefix sums start at the first half's total
  int offset = 0;
  if (rank == 1) {
    const int bumps = residual ? min(residual, (kHalf + step - 1) / step) : 0;
    offset = first_total + batch * kHalf + bumps;
  }
  __syncthreads();

  // warp w scans bins [w * 1024, w * 1024 + 1024), 32 at a time
  const int base = warp * (kHalf / 32);
  int s = 0;
  for (int j = 0; j < kHalf / 32; j += 32) s += hist[base + j + lane] + batch;
  s = warp_sum(s);
  if (lane == 0) part[0][warp] = s;
  __syncthreads();
  for (int w = 0; w < warp; ++w) offset += part[0][w];
  uint16_t* out = lut + ((int64_t)plane * gy * gx + tile) * 65536 + lo + base;
  for (int j = 0; j < kHalf / 32; j += 32) {
    const int x = warp_scan(hist[base + j + lane] + batch, lane);
    out[j + lane] = (uint16_t)lut_value(offset + x, lut_scale, 65535);
    offset += __shfl_sync(0xffffffffu, x, 31);
  }
  // the other block may still read shared_sums
  cluster.sync();
}

// grid (row blocks * column blocks, planes of the batch): a block blends
// kBlendRows rows of kBlendCols columns. rowt: (rows, 4) int32 of (ty1,
// ty2, ya bits, ya1 bits), colt: (cols, 4) of (tx1, tx2, xa bits, xa1
// bits). A warp's lanes take LR vectors down each of LC columns (32 bytes
// a column), so that the voxels of one load, and of each gather, are a
// small patch of the plane: neighbours, whose values and tiles are alike.
// kStaged: the LUTs of the block's tiles, (stage_y, stage_x) at most, as
// floats in dynamic shared memory (8-bit planes), else gathered from
// `lut`.
template <typename T, int H, int W, bool kStaged>
__global__ void __launch_bounds__(kThreads)
clahe_blend(const T* __restrict__ in, const T* __restrict__ lut, T* __restrict__ out,
            const int4* __restrict__ rowt, const int4* __restrict__ colt, int rows, int cols,
            int gy, int gx, int row_blocks, int stage_y, int stage_x) {
  constexpr int LR = W * sizeof(T) >= 32 ? 1 : 32 / (W * (int)sizeof(T));
  constexpr int LC = 32 / LR;
  constexpr int RI = kBlendRows / (LR * W);  // vectors a thread down a column
  __shared__ int4 srow[kBlendRows];
  extern __shared__ float slut[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int plane = blockIdx.y;
  const int r0 = (blockIdx.x % row_blocks) * kBlendRows;
  const int c0 = (blockIdx.x / row_blocks) * kBlendCols;
  const int nr = min(kBlendRows, rows - r0), nc = min(kBlendCols, cols - c0);
  const T* plut = lut + (int64_t)plane * gy * gx * H;
  // the block's tiles: ty1 of its first row to ty2 of its last, tx1 of its
  // first column to tx2 of its last (each monotone)
  const int ty_lo = kStaged ? rowt[r0].x : 0;
  const int tx_lo = kStaged ? colt[c0].x : 0;
  const int row_lut = (kStaged ? stage_x : gx) * H;  // LUT entries of a tile row
  for (int i = tid; i < nr; i += kThreads) {
    int4 e = rowt[r0 + i];
    e.x = (e.x - ty_lo) * row_lut;
    e.y = (e.y - ty_lo) * row_lut;
    srow[i] = e;
  }
  if (kStaged) {
    const int sy = rowt[r0 + nr - 1].y - ty_lo + 1;
    const int sx = colt[c0 + nc - 1].y - tx_lo + 1;
    if (sy > stage_y || sx > stage_x) __trap();  // the host's bound is wrong
    for (int t = warp; t < sy * sx; t += kWarps) {
      const int y = t / sx, x = t - y * sx;
      const T* from = plut + ((int64_t)(ty_lo + y) * gx + tx_lo + x) * H;
      float* to = slut + (y * stage_x + x) * H;
      for (int v = lane; v < H; v += 32) to[v] = small_to_float(from[v]);
    }
  }
  __syncthreads();

  const T* L = kStaged ? nullptr : plut;
  const int rl = lane % LR;
  const int nvec = nr / W;  // rows % W == 0 on the vector path
  for (int c = warp * LC + lane / LR; c < nc; c += kWarps * LC) {
    const int4 ce = colt[c0 + c];
    const int x1 = (ce.x - tx_lo) * H, x2 = (ce.y - tx_lo) * H;
    const float xa = __int_as_float(ce.z), xa1 = __int_as_float(ce.w);
    const int64_t at = ((int64_t)plane * cols + c0 + c) * rows + r0;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int v = rl + i * LR;
      if (v < nvec) {
        Vec<T, W> x, y;
        x.v = *reinterpret_cast<const decltype(x.v)*>(in + at + v * W);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int4 e = srow[v * W + j];
          const int val = x.e[j];
          float l11, l12, l21, l22;
          if (kStaged) {
            l11 = slut[e.x + x1 + val];
            l12 = slut[e.x + x2 + val];
            l21 = slut[e.y + x1 + val];
            l22 = slut[e.y + x2 + val];
          } else {
            l11 = small_to_float(__ldg(L + e.x + x1 + val));
            l12 = small_to_float(__ldg(L + e.x + x2 + val));
            l21 = small_to_float(__ldg(L + e.y + x1 + val));
            l22 = small_to_float(__ldg(L + e.y + x2 + val));
          }
          const float top = __fadd_rn(__fmul_rn(l11, xa1), __fmul_rn(l12, xa));
          const float bottom = __fadd_rn(__fmul_rn(l21, xa1), __fmul_rn(l22, xa));
          const float res = __fadd_rn(__fmul_rn(top, __int_as_float(e.w)),
                                      __fmul_rn(bottom, __int_as_float(e.z)));
          y.e[j] = (T)round_small(res);
        }
        *reinterpret_cast<decltype(y.v)*>(out + at + v * W) = y.v;
      }
    }
  }
}

// once per device: a kernel's shared-memory attribute
template <typename K>
cudaError_t allow_shared(K kernel, cudaFuncAttribute attr, int value, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, attr, value);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int H, int W, bool kStaged>
cudaError_t blend(const T* src, const T* lut, T* dst, const int4* rowt, const int4* colt,
                  int64_t pb, int rows, int cols, int gy, int gx, int stage_y, int stage_x,
                  cudaStream_t s) {
  const int row_blocks = (rows + kBlendRows - 1) / kBlendRows;
  const int64_t grid = (int64_t)row_blocks * ((cols + kBlendCols - 1) / kBlendCols);
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  const int smem = kStaged ? stage_y * stage_x * H * (int)sizeof(float) : 0;
  static bool done[64];
  // staged: room for the LUTs; gathered: the most L1 for the gathers
  cudaError_t err = kStaged
      ? allow_shared(clahe_blend<T, H, W, kStaged>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes, done)
      : allow_shared(clahe_blend<T, H, W, kStaged>,
                     cudaFuncAttributePreferredSharedMemoryCarveout, 0, done);
  if (err != cudaSuccess) return err;
  clahe_blend<T, H, W, kStaged><<<dim3((unsigned)grid, (unsigned)pb), kThreads, smem, s>>>(
      src, lut, dst, rowt, colt, rows, cols, gy, gx, row_blocks, stage_y, stage_x);
  return cudaGetLastError();
}

template <int W>
cudaError_t lut_pass16(const uint16_t* src, uint16_t* lut, int64_t pb, int rows, int cols,
                       int gy, int gx, int th, int tw, int limit, float lut_scale,
                       cudaStream_t s) {
  static bool done[64];
  const int smem = kHalf * (int)sizeof(int);
  cudaError_t err =
      allow_shared(clahe_lut16<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem, done);
  if (err != cudaSuccess) return err;
  clahe_lut16<W><<<dim3(2u * gy * gx, (unsigned)pb), kThreads16, smem, s>>>(
      src, lut, rows, cols, gy, gx, th, tw, limit, lut_scale);
  return cudaGetLastError();
}

template <int W>
cudaError_t run8(const uint8_t* in, uint8_t* out, uint8_t* lut, const int4* rowt,
                 const int4* colt, int64_t planes, int64_t batch, int rows, int cols, int gy,
                 int gx, int th, int tw, int limit, float lut_scale, cudaStream_t s) {
  // the tile rows a block can touch: ty2 of its last row less ty1 of its
  // first is at most (kBlendRows - 1) / th + 1, and one more where a float32
  // tile position rounds across a whole tile; the same across the columns
  const int stage_y = min(gy, (kBlendRows - 1) / th + 4);
  const int stage_x = min(gx, (kBlendCols - 1) / tw + 4);
  const bool staged = (int64_t)stage_y * stage_x * 256 * sizeof(float) <= kStageBytes;
  const int64_t plane_size = (int64_t)rows * cols;
  for (int64_t p0 = 0; p0 < planes; p0 += batch) {
    const int64_t pb = planes - p0 < batch ? planes - p0 : batch;
    const uint8_t* src = in + p0 * plane_size;
    clahe_lut8<W><<<dim3((unsigned)(gy * gx), (unsigned)pb), kThreads, 0, s>>>(
        src, lut, rows, cols, gy, gx, th, tw, limit, lut_scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = staged ? blend<uint8_t, 256, W, true>(src, lut, out + p0 * plane_size, rowt, colt,
                                                 pb, rows, cols, gy, gx, stage_y, stage_x, s)
                 : blend<uint8_t, 256, W, false>(src, lut, out + p0 * plane_size, rowt, colt,
                                                  pb, rows, cols, gy, gx, 0, 0, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int W>
cudaError_t run16(const uint16_t* in, uint16_t* out, uint16_t* lut, const int4* rowt,
                  const int4* colt, int64_t planes, int64_t batch, int rows, int cols, int gy,
                  int gx, int th, int tw, int limit, float lut_scale, cudaStream_t s) {
  const int64_t plane_size = (int64_t)rows * cols;
  for (int64_t p0 = 0; p0 < planes; p0 += batch) {
    const int64_t pb = planes - p0 < batch ? planes - p0 : batch;
    const uint16_t* src = in + p0 * plane_size;
    cudaError_t err = lut_pass16<W>(src, lut, pb, rows, cols, gy, gx, th, tw, limit,
                                    lut_scale, s);
    if (err != cudaSuccess) return err;
    err = blend<uint16_t, 65536, W, false>(src, lut, out + p0 * plane_size, rowt, colt, pb,
                                           rows, cols, gy, gx, 0, 0, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* igt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 uint8 (256 bins), 1 uint16 (65536 bins). in, out: (planes, cols,
// rows) C-contiguous, 16-byte aligned for the vector path; the planes go in
// batches of `batch` (at most 65535); lut: (batch, gy, gx, bins) of the
// input's type; rowt: (rows, 4) int32, colt: (cols, 4) int32, the blend's
// weight tables. th, tw: the tile's rows and columns of the padded plane;
// limit: the clip limit in counts, 0 for no clip; lut_scale = (bins - 1) /
// (th * tw), a float32 division.
int igt_clahe(int dtype, const void* in, void* out, void* lut, const void* rowt,
              const void* colt, int64_t planes, int64_t batch, int rows, int cols, int gy,
              int gx, int th, int tw, int limit, float lut_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || (int64_t)gy * gx > 0x7fffffff / 2)
    return (int)cudaErrorInvalidValue;
  const int size = dtype == kU8 ? 1 : 2;
  const bool vec = (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (int64_t)rows * size % 16 == 0;
  const int4* rt = static_cast<const int4*>(rowt);
  const int4* ct = static_cast<const int4*>(colt);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kU8) {
    auto i = static_cast<const uint8_t*>(in);
    auto o = static_cast<uint8_t*>(out);
    auto l = static_cast<uint8_t*>(lut);
    err = vec ? run8<16>(i, o, l, rt, ct, planes, batch, rows, cols, gy, gx, th, tw, limit,
                         lut_scale, s)
              : run8<1>(i, o, l, rt, ct, planes, batch, rows, cols, gy, gx, th, tw, limit,
                        lut_scale, s);
  } else if (dtype == kU16) {
    if ((int64_t)gy * gx * 65536 > 0x7fffffff) return (int)cudaErrorInvalidValue;
    auto i = static_cast<const uint16_t*>(in);
    auto o = static_cast<uint16_t*>(out);
    auto l = static_cast<uint16_t*>(lut);
    err = vec ? run16<8>(i, o, l, rt, ct, planes, batch, rows, cols, gy, gx, th, tw, limit,
                         lut_scale, s)
              : run16<1>(i, o, l, rt, ct, planes, batch, rows, cols, gy, gx, th, tw, limit,
                         lut_scale, s);
  }
  return (int)err;
}

}  // extern "C"
