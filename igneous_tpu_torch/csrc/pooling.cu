// 2x2x1 average / mode pooling kernels for Hopper (sm_90a).
//
// Layout: every tensor is (c, z, y, x), C-contiguous, x fastest. The (c, z)
// axes never mix, so both kernels see a stack of P = c*z planes of Y x X.
//
// Both kernels compute exactly what igneous_tpu/ops/pallas_pooling.py
// computes, bit for bit:
//   average: int32 sum of the 4 window values, then floor((s + 2) / 4),
//            written as an arithmetic shift (C's '/' truncates toward zero
//            and would be wrong for negative int16 sums);
//   mode:    the majority of the 4 values, ties to the earliest position in
//            the order (y0,x0), (y0,x1), (y1,x0), (y1,x1) -- the score
//            count*4 - position, taken only when strictly greater.
// Mode compares the words directly at every width, 64-bit labels included;
// equality distributes over the hi/lo split the TPU needed, so the bits
// returned are the same.
//
// Bound: both kernels do a handful of integer operations per byte, so they
// are memory-bound: the least time is (bytes read + bytes written) divided
// by the card's memory bandwidth.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;

enum Method { kAverage = 0, kMode = 1 };
enum DType { kU8 = 0, kI8 = 1, kU16 = 2, kI16 = 3, kU32 = 4, kU64 = 5 };

template <typename T>
struct AvgOp {
  __device__ __forceinline__ static T pool(T a, T b, T c, T d) {
    int s = (int)a + (int)b + (int)c + (int)d + 2;
    return (T)(s >> 2);  // floor division by 4 (arithmetic shift)
  }
};

template <typename T>
struct ModeOp {
  __device__ __forceinline__ static T pool(T a, T b, T c, T d) {
    int ab = a == b, ac = a == c, ad = a == d;
    int bc = b == c, bd = b == d, cd = c == d;
    int sa = (1 + ab + ac + ad) * 4;
    int sb = (1 + ab + bc + bd) * 4 - 1;
    int sc = (1 + ac + bc + cd) * 4 - 2;
    int sd = (1 + ad + bd + cd) * 4 - 3;
    T best = a;
    int best_s = sa;
    if (sb > best_s) { best_s = sb; best = b; }
    if (sc > best_s) { best_s = sc; best = c; }
    if (sd > best_s) { best = d; }
    return best;
  }
};

// ---------------------------------------------------------------------------
// Single 2x2x1 step.
//
// Replaces the TPU kernel _pool_zlast (igneous_tpu/ops/pallas_pooling.py:95,
// bodies _avg_kernel / _mode_kernel). The TPU version pads the input on the
// host (edge-replicate) to tile multiples; here a read past an odd edge is
// clamped to the last row or column, which for factor 2 is exactly that
// padding. Memory-bound: each input byte is read once (the 2x2 windows do
// not overlap) and each output written once.
//
// The first version gave each thread one output voxel a row: four one-
// element loads, one one-element store and a 64-bit division a row, which
// kept it near a third of its bound on uint8. Here each thread takes a
// chunk of V bytes of both input rows of its windows with one vector load
// each, and writes the V/2 bytes of outputs with one vector store (the
// model is the fused walk's level 1). V is 16, 8 or 4, the widest that the
// row length in bytes and the pointers allow (the wrapper picks it); V = 0
// is the element-wise path of the same kernel for rows that allow none,
// odd widths among them, one output a thread with the edge clamped. Rows
// are indexed in 32 bits and only the row's base offset is 64-bit; an
// even Y needs no division at all (output row r reads input rows 2r and
// 2r+1). Blocks are (bx, by) threads, bx the chunks of a row rounded up
// to a power of two (at most kThreads), by = kThreads / bx rows; grid.x
// covers a row and grid.y, sized to fill the card once, strides over the
// P*OY output rows.
template <int B>
struct Bytes;  // an unsigned word of B bytes
template <> struct Bytes<16> { using T = uint4; };
template <> struct Bytes<8> { using T = uint2; };
template <> struct Bytes<4> { using T = uint32_t; };
template <> struct Bytes<2> { using T = uint16_t; };

template <typename T, typename Op, int V>
__global__ void __launch_bounds__(kThreads)
pool2x2x1_kernel(const T* __restrict__ in, T* __restrict__ out, int rows,
                 int Y, int X, int OY, int OX, int chunks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const int stride = gridDim.y * blockDim.y;
#pragma unroll 4
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < rows;
       row += stride) {
    int64_t y0 = 2 * (int64_t)row, y1 = y0 + 1;  // input rows, over all planes
    if (Y & 1) {
      const int p = row / OY, oy = row - p * OY;
      y0 = (int64_t)p * Y + 2 * oy;
      y1 = 2 * oy + 1 < Y ? y0 + 1 : y0;
    }
    const T* r0 = in + y0 * X;
    const T* r1 = in + y1 * X;
    if constexpr (V > 0) {
      constexpr int per = V / sizeof(T), half = per / 2;
      using In = typename Bytes<V>::T;
      using Out = typename Bytes<V / 2>::T;
      union { In u; T v[per]; } a, b;
      a.u = reinterpret_cast<const In*>(r0)[c];
      b.u = reinterpret_cast<const In*>(r1)[c];
      union { Out u; T v[half]; } o;
#pragma unroll
      for (int k = 0; k < half; ++k)
        o.v[k] = Op::pool(a.v[2 * k], a.v[2 * k + 1], b.v[2 * k], b.v[2 * k + 1]);
      reinterpret_cast<Out*>(out + (int64_t)row * OX)[c] = o.u;
    } else {
      const int x0 = 2 * c, x1 = min(x0 + 1, X - 1);
      out[(int64_t)row * OX + c] = Op::pool(r0[x0], r0[x1], r1[x0], r1[x1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Fused L-level 2x2x1 pyramid.
//
// Replaces the TPU kernel _pyramid_zlast (igneous_tpu/ops/pallas_pooling.py:114,
// body _pyramid_kernel), which walks every mip of one VMEM-resident block.
// Here the work is cut into S x S tiles of one (c, z) plane (S = T * 2^L)
// and each block walks tiles. Level 1 of a tile is computed straight from
// device memory, each thread reading two 16-byte words (one from each input
// row of its windows) where alignment allows, and goes to its output tensor
// and to shared memory; levels 2..L then walk in shared memory,
// ping-ponging between a (S/2)^2 and a (S/4)^2 buffer, each level's outputs
// going straight to its output tensor. Nothing crosses between blocks.
// Memory-bound: each input byte is read once for all L levels, so the
// kernel moves the input once plus the outputs (1/3 of the input at most)
// once.
//
// Preconditions (checked by the wrapper): Y and X are multiples of 2^L, so
// every tile extent is a multiple of 2^L and no level ever goes odd.
struct OutPtrs {
  void* p[kMaxLevels];
};

// One S x S tile of one plane: level 1 from device memory, levels 2..L in
// shared memory. Ends with every thread past a barrier, so the caller may
// reuse the buffers for the next tile.
template <typename T, typename Op>
__device__ __forceinline__ void pyramid_tile(
    const T* __restrict__ in, const OutPtrs& outs, int levels, int64_t Y,
    int64_t X, int S, int tile, int tiles_y, int tiles_x, int vec, T* buf1,
    T* buf2) {
  const int s1 = S / 2;
  const int tx = tile % tiles_x;
  const int ty = (tile / tiles_x) % tiles_y;
  const int64_t p = tile / (tiles_x * tiles_y);
  const int64_t y0 = (int64_t)ty * S;
  const int64_t x0 = (int64_t)tx * S;
  int h = (int)min((int64_t)S, Y - y0) / 2;  // level-1 tile extents
  int w = (int)min((int64_t)S, X - x0) / 2;
  int64_t ly = Y / 2, lx = X / 2;
  const T* src = in + (p * Y + y0) * X + x0;
  T* o1 = reinterpret_cast<T*>(outs.p[0]) + (p * ly + y0 / 2) * lx + x0 / 2;

  if (vec) {
    // one 16-byte word from each of the two input rows gives `half`
    // outputs, stored as one 8-byte word; the wrapper checked that rows,
    // the tile origin and the pointers are 16-byte aligned
    constexpr int per = 16 / sizeof(T);
    constexpr int half = per / 2;
    const int wv = w / half;
    const int64_t xv = X / per;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < h * wv; i += blockDim.x) {
      const int r = i / wv, c = i - r * wv;
      union { uint4 u; T v[per]; } a, b;
      a.u = s4[(2 * r) * xv + c];
      b.u = s4[(2 * r + 1) * xv + c];
      union { uint2 u; T v[half]; } o;
#pragma unroll
      for (int k = 0; k < half; ++k)
        o.v[k] = Op::pool(a.v[2 * k], a.v[2 * k + 1], b.v[2 * k], b.v[2 * k + 1]);
      reinterpret_cast<uint2*>(o1 + r * lx)[c] = o.u;
      reinterpret_cast<uint2*>(buf1 + r * s1)[c] = o.u;
    }
  } else {
    for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w;
      const T* s0 = src + (2 * r) * X + 2 * c;
      const T v = Op::pool(s0[0], s0[1], s0[X], s0[X + 1]);
      o1[r * lx + c] = v;
      buf1[r * s1 + c] = v;
    }
  }
  __syncthreads();

  T* cur = buf1;
  T* nxt = buf2;
  int cstride = s1;
  for (int l = 1; l < levels; ++l) {
    h >>= 1;
    w >>= 1;
    ly >>= 1;
    lx >>= 1;
    const int nstride = S >> (l + 1);
    T* o = reinterpret_cast<T*>(outs.p[l]) + (p * ly + (y0 >> (l + 1))) * lx +
           (x0 >> (l + 1));
    for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w;
      const T* s0 = cur + (2 * r) * cstride + 2 * c;
      const T v = Op::pool(s0[0], s0[1], s0[cstride], s0[cstride + 1]);
      nxt[r * nstride + c] = v;
      o[(int64_t)r * lx + c] = v;
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
    cstride = nstride;
  }
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
pyramid2x2x1_kernel(const T* __restrict__ in, OutPtrs outs, int levels,
                    int64_t Y, int64_t X, int S, int tiles, int tiles_y,
                    int tiles_x, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf1 = reinterpret_cast<T*>(smem_raw);  // (S/2)^2: levels 1, 3, 5, ...
  T* buf2 = buf1 + (S / 2) * (S / 2);        // (S/4)^2: levels 2, 4, ...
  // persistent blocks: the grid fills the card once and each block walks
  // tiles, so the cost of starting a block and of the thin deep levels is
  // spread over many tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    pyramid_tile<T, Op>(in, outs, levels, Y, X, S, tile, tiles_y, tiles_x,
                        vec, buf1, buf2);
}

// Blocks of `kernel` the card holds at once (SMs x resident blocks per SM).
cudaError_t resident_blocks(const void* kernel, size_t smem, int64_t* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  *out = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename T, typename Op, int V>
cudaError_t launch_pool_v(const void* in, void* out, int64_t P, int64_t Y,
                          int64_t X, cudaStream_t stream) {
  const int64_t OY = (Y + 1) / 2, OX = (X + 1) / 2;
  const int64_t rows = P * OY;
  const int64_t chunks = V > 0 ? X * (int64_t)sizeof(T) / V : OX;
  if (rows > 0x7fffffffLL || Y > 0x7fffffffLL || X > 0x7fffffffLL)
    return cudaErrorInvalidValue;  // rows and columns are indexed in 32 bits
  if (V > 0 && (X * (int64_t)sizeof(T)) % V != 0) return cudaErrorInvalidValue;
  if (rows * OX == 0) return cudaSuccess;
  int bx = 1;
  while (bx < chunks && bx < kThreads) bx *= 2;
  const int by = kThreads / bx;
  const int64_t gx = (chunks + bx - 1) / bx;
  int64_t resident = 0;
  cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(&pool2x2x1_kernel<T, Op, V>), 0, &resident);
  if (err != cudaSuccess) return err;
  int64_t gy = resident / gx;
  const int64_t need = (rows + by - 1) / by;
  gy = gy < 1 ? 1 : (gy > need ? need : (gy > 65535 ? 65535 : gy));
  pool2x2x1_kernel<T, Op, V><<<dim3((unsigned)gx, (unsigned)gy),
                               dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), (int)rows, (int)Y,
      (int)X, (int)OY, (int)OX, (int)chunks);
  return cudaGetLastError();
}

// vec: the bytes of a row each thread reads at once, 16, 8 or 4 (at least
// two elements), or 0 for the element-wise path.
template <typename T, typename Op>
cudaError_t launch_pool(const void* in, void* out, int64_t P, int64_t Y,
                        int64_t X, int vec, cudaStream_t stream) {
  switch (vec) {
    case 0: return launch_pool_v<T, Op, 0>(in, out, P, Y, X, stream);
    case 4:
      if constexpr (sizeof(T) <= 2)
        return launch_pool_v<T, Op, 4>(in, out, P, Y, X, stream);
      break;
    case 8:
      if constexpr (sizeof(T) <= 4)
        return launch_pool_v<T, Op, 8>(in, out, P, Y, X, stream);
      break;
    case 16: return launch_pool_v<T, Op, 16>(in, out, P, Y, X, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename Op>
cudaError_t launch_pyramid(const void* in, void* const* outs, int levels,
                           int64_t P, int64_t Y, int64_t X, int S, int vec,
                           cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || S < (1 << levels) ||
      S % (1 << levels) != 0 || Y % (1 << levels) != 0 ||
      X % (1 << levels) != 0)
    return cudaErrorInvalidValue;
  if (vec && (S * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  if (P * Y * X == 0) return cudaSuccess;
  OutPtrs o;
  for (int l = 0; l < kMaxLevels; ++l) o.p[l] = l < levels ? outs[l] : nullptr;
  const int64_t tiles_y = (Y + S - 1) / S, tiles_x = (X + S - 1) / S;
  const int64_t tiles = P * tiles_y * tiles_x;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * ((size_t)(S / 2) * (S / 2) + (size_t)(S / 4) * (S / 4));
  const void* kernel = reinterpret_cast<const void*>(&pyramid2x2x1_kernel<T, Op>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int64_t resident = 0;
  if (err == cudaSuccess) err = resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return err;
  const int64_t blocks = tiles < resident ? tiles : resident;
  pyramid2x2x1_kernel<T, Op><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(in), o, levels, Y, X, S, (int)tiles, (int)tiles_y,
      (int)tiles_x, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* igt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// method: 0 average, 1 mode. dtype: 0 u8, 1 i8, 2 u16, 3 i16, 4 u32, 5 u64
// (mode compares words, so signed 32/64-bit labels pass as u32/u64).
// vec: see launch_pool.
int igt_pool2x2x1(int method, int dtype, const void* in, void* out, int64_t P,
                  int64_t Y, int64_t X, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IGT_POOL(T, OP) launch_pool<T, OP<T>>(in, out, P, Y, X, vec, s)
  if (method == kAverage) {
    switch (dtype) {
      case kU8: return IGT_POOL(uint8_t, AvgOp);
      case kI8: return IGT_POOL(int8_t, AvgOp);
      case kU16: return IGT_POOL(uint16_t, AvgOp);
      case kI16: return IGT_POOL(int16_t, AvgOp);
    }
  } else if (method == kMode) {
    switch (dtype) {
      case kU8: case kI8: return IGT_POOL(uint8_t, ModeOp);
      case kU16: case kI16: return IGT_POOL(uint16_t, ModeOp);
      case kU32: return IGT_POOL(uint32_t, ModeOp);
      case kU64: return IGT_POOL(uint64_t, ModeOp);
    }
  }
#undef IGT_POOL
  return cudaErrorInvalidValue;
}

int igt_pyramid2x2x1(int method, int dtype, const void* in, void* const* outs,
                     int levels, int64_t P, int64_t Y, int64_t X, int S,
                     int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IGT_PYR(T, OP) \
  launch_pyramid<T, OP<T>>(in, outs, levels, P, Y, X, S, vec, s)
  if (method == kAverage) {
    switch (dtype) {
      case kU8: return IGT_PYR(uint8_t, AvgOp);
      case kI8: return IGT_PYR(int8_t, AvgOp);
      case kU16: return IGT_PYR(uint16_t, AvgOp);
      case kI16: return IGT_PYR(int16_t, AvgOp);
    }
  } else if (method == kMode) {
    switch (dtype) {
      case kU8: case kI8: return IGT_PYR(uint8_t, ModeOp);
      case kU16: case kI16: return IGT_PYR(uint16_t, ModeOp);
      case kU32: return IGT_PYR(uint32_t, ModeOp);
      case kU64: return IGT_PYR(uint64_t, ModeOp);
    }
  }
#undef IGT_PYR
  return cudaErrorInvalidValue;
}

}  // extern "C"
