// Contrast-limited adaptive histogram equalisation (CLAHE) of a stack of
// 8- or 16-bit planes for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs CLAHE on the host through
// OpenCV (igneous_tpu/tasks/contrast.py, CLAHETask, cv2.createCLAHE(...)
// .apply on each z plane), and the card's machine has no OpenCV. The two
// kernels below compute OpenCV's CLAHE::apply bit for bit:
//
//   clahe_lut    one block per (plane, tile) slot, striding over the slots
//                when the grid is smaller: the tile's histogram over the
//                padded plane, the clip and the redistribution of the
//                clipped count, the prefix sum and the LUT;
//   clahe_blend  one thread per voxel: the bilinear blend of the LUTs of the
//                four nearest tiles at the voxel's value.
//
// Layout: the planes are (P, C, R), C-contiguous, R fastest: a Volume's
// (z, y, x) cutout, whose plane rows (OpenCV's y) are the Volume's x and
// whose columns (OpenCV's x) are its y. The padded plane that the LUTs come
// from is never stored: a read past the last row or column reflects
// (BORDER_REFLECT_101) into the plane. The wrapper
// (igneous_tpu_torch/ops/cuda_clahe.py) computes the padding, the tile
// sizes, the clip limit and the two float32 scales exactly as OpenCV does.
//
// Exactness: every float product and sum is an explicit __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc cannot contract a pair into an FMA, and the
// roundings are __float2int_rn (half to even, as cvRound). The histogram,
// the clip and the prefix sum are integer work, exact in any order.
//
// Bound: the LUT pass reads the padded plane once, the blend reads the
// plane and writes it once; a handful of operations a voxel, so both are
// memory-bound: the least time is the plane's bytes in and out over the
// card's memory rate (the LUTs, 256 entries a tile for 8-bit planes, stay
// in L2). A 16-bit histogram (65536 bins, 256 KiB of int32) does not fit
// one block's shared memory: it lives in a device scratch of the wrapper's,
// one slice a block of a grid of a few blocks a multiprocessor, each block
// reusing its slice for the slots it strides over; its atomics go to L2.
//
// Memory: the entry point runs the planes in batches of `batch`, the LUT
// pass of a batch then its blend, so the LUTs take `batch` planes' worth
// (a 16-bit plane's LUTs are gy * gx * 128 KiB) whatever the stack's depth.
//
// C interface (bound with ctypes): the entry point launches the kernels on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Slot = plane * gy * gx + ty * gx + tx over the `slots` (plane, tile)
// pairs of a batch; block b takes slots b, b + gridDim.x, ... H bins; each
// thread owns H / kThreads consecutive bins for the scan.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
clahe_lut(const T* __restrict__ in, T* __restrict__ lut, int* __restrict__ scratch,
          int64_t slots, int rows, int cols, int gy, int gx, int th, int tw,
          int limit, float lut_scale) {
  constexpr int B = H / kThreads;
  constexpr bool kShared = H <= 4096;
  __shared__ int smem_hist[kShared ? H : 1];
  __shared__ int part[kThreads];
  int* hist = kShared ? smem_hist : scratch + (int64_t)blockIdx.x * H;
  const int tid = threadIdx.x;
  // the loop's bounds are the block's own, so every thread takes every
  // __syncthreads() of the body
  for (int64_t slot = blockIdx.x; slot < slots; slot += gridDim.x) {
    const int64_t plane = slot / (gy * gx);
    const int tile = (int)(slot - plane * gy * gx);
    const int ty = tile / gx, tx = tile - ty * gx;

    for (int i = tid; i < H; i += kThreads) hist[i] = 0;
    __syncthreads();

    // the histogram of the tile of the padded plane, row index fastest so
    // that a warp reads consecutive bytes
    const T* src = in + plane * rows * cols;
    const int total = th * tw;
    for (int k = tid; k < total; k += kThreads) {
      const int lc = k / th, lr = k - lc * th;
      const int r = reflect101(ty * th + lr, rows);
      const int c = reflect101(tx * tw + lc, cols);
      atomicAdd(&hist[src[(int64_t)c * rows + r]], 1);
    }
    __syncthreads();

    const int i0 = tid * B;
    if (limit > 0) {
      // clip at the limit, count what was clipped (bins interleaved across
      // the threads, so that a warp's accesses are consecutive)
      int excess = 0;
      for (int i = tid; i < H; i += kThreads) {
        const int h = hist[i];
        if (h > limit) {
          excess += h - limit;
          hist[i] = limit;
        }
      }
      part[tid] = excess;
      __syncthreads();
      for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (tid < s) part[tid] += part[tid + s];
        __syncthreads();
      }
      const int clipped = part[0];
      __syncthreads();
      // every bin gets clipped / H; the residual goes one a bin to bins
      // 0, step, 2 step, ... while it lasts
      const int batch = clipped / H;
      const int residual = clipped - batch * H;
      const int step = residual ? max(H / residual, 1) : 1;
      for (int i = tid; i < H; i += kThreads) {
        hist[i] += batch + (residual && i % step == 0 && i / step < residual);
      }
      __syncthreads();
    }

    // inclusive prefix sum: each thread its own bins, then a scan of the
    // threads' totals
    int run = 0;
    for (int i = i0; i < i0 + B; ++i) {
      run += hist[i];
      hist[i] = run;
    }
    part[tid] = run;
    __syncthreads();
    for (int s = 1; s < kThreads; s <<= 1) {
      const int add = tid >= s ? part[tid - s] : 0;
      __syncthreads();
      part[tid] += add;
      __syncthreads();
    }
    const int offset = part[tid] - run;
    T* out = lut + slot * H;
    for (int i = i0; i < i0 + B; ++i) {
      const int v = __float2int_rn(__fmul_rn((float)(hist[i] + offset), lut_scale));
      out[i] = (T)min(max(v, 0), H - 1);
    }
    // the next slot zeroes the histogram and the partial sums
    __syncthreads();
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
clahe_blend(const T* __restrict__ in, const T* __restrict__ lut, T* __restrict__ out,
            int64_t n, int rows, int cols, int gy, int gx, float inv_th,
            float inv_tw) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int r = (int)(i % rows);
    const int64_t pc = i / rows;
    const int c = (int)(pc % cols);
    const int64_t plane = pc / cols;

    const float tyf = __fsub_rn(__fmul_rn((float)r, inv_th), 0.5f);
    int ty1 = (int)floorf(tyf);
    const float ya = __fsub_rn(tyf, (float)ty1);
    const float ya1 = __fsub_rn(1.0f, ya);
    const int ty2 = min(ty1 + 1, gy - 1);
    ty1 = max(ty1, 0);

    const float txf = __fsub_rn(__fmul_rn((float)c, inv_tw), 0.5f);
    int tx1 = (int)floorf(txf);
    const float xa = __fsub_rn(txf, (float)tx1);
    const float xa1 = __fsub_rn(1.0f, xa);
    const int tx2 = min(tx1 + 1, gx - 1);
    tx1 = max(tx1, 0);

    const int v = in[i];
    const T* l1 = lut + (plane * gy + ty1) * gx * (int64_t)H;
    const T* l2 = lut + (plane * gy + ty2) * gx * (int64_t)H;
    const float l11 = l1[(int64_t)tx1 * H + v], l12 = l1[(int64_t)tx2 * H + v];
    const float l21 = l2[(int64_t)tx1 * H + v], l22 = l2[(int64_t)tx2 * H + v];
    const float top = __fadd_rn(__fmul_rn(l11, xa1), __fmul_rn(l12, xa));
    const float bottom = __fadd_rn(__fmul_rn(l21, xa1), __fmul_rn(l22, xa));
    const float res = __fadd_rn(__fmul_rn(top, ya1), __fmul_rn(bottom, ya));
    out[i] = (T)min(max(__float2int_rn(res), 0), H - 1);
  }
}

template <typename T, int H>
int launch(const void* in, void* out, void* lut, void* scratch, int64_t planes,
           int64_t batch, int64_t lut_blocks, int rows, int cols, int gy, int gx,
           int th, int tw, int limit, float lut_scale, float inv_th, float inv_tw,
           cudaStream_t s) {
  if (batch < 1 || lut_blocks < 1 || lut_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t plane_size = (int64_t)rows * cols;
  for (int64_t p0 = 0; p0 < planes; p0 += batch) {
    const int64_t pb = planes - p0 < batch ? planes - p0 : batch;
    const int64_t slots = pb * gy * gx;
    const T* src = static_cast<const T*>(in) + p0 * plane_size;
    T* dst = static_cast<T*>(out) + p0 * plane_size;
    const unsigned grid = (unsigned)(slots < lut_blocks ? slots : lut_blocks);
    clahe_lut<T, H><<<grid, kThreads, 0, s>>>(
        src, static_cast<T*>(lut), static_cast<int*>(scratch), slots, rows, cols, gy,
        gx, th, tw, limit, lut_scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t n = pb * plane_size;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int64_t blocks = want < 132 * 32 ? want : 132 * 32;  // grid-stride beyond
    clahe_blend<T, H><<<(unsigned)blocks, kThreads, 0, s>>>(
        src, static_cast<const T*>(lut), dst, n, rows, cols, gy, gx, inv_th, inv_tw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

const char* igt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 uint8 (256 bins), 1 uint16 (65536 bins). in, out: (planes, cols,
// rows) C-contiguous; the planes go in batches of `batch`; lut: (batch, gy,
// gx, bins) of the input's type; lut_blocks: the LUT pass's grid at most
// (the slots of a batch, when fewer); scratch: (lut_blocks, 65536) int32
// for uint16, unused for uint8. th, tw: the tile's rows and columns of the
// padded plane; limit: the clip limit in counts, 0 for no clip;
// lut_scale = (bins - 1) / (th * tw), inv_th = 1 / th, inv_tw = 1 / tw,
// each a float32 division.
int igt_clahe(int dtype, const void* in, void* out, void* lut, void* scratch,
              int64_t planes, int64_t batch, int64_t lut_blocks, int rows, int cols,
              int gy, int gx, int th, int tw, int limit, float lut_scale,
              float inv_th, float inv_tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kU8)
    return launch<uint8_t, 256>(in, out, lut, scratch, planes, batch, lut_blocks, rows,
                                cols, gy, gx, th, tw, limit, lut_scale, inv_th, inv_tw,
                                s);
  if (dtype == kU16)
    return launch<uint16_t, 65536>(in, out, lut, scratch, planes, batch, lut_blocks,
                                   rows, cols, gy, gx, th, tw, limit, lut_scale, inv_th,
                                   inv_tw, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
