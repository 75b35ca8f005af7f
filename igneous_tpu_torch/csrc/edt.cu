// One axis pass of the multilabel anisotropic squared Euclidean distance
// transform, for Hopper (sm_90a).
//
// Replaces igneous_tpu/ops/edt.py's device program _edt_sq_kernel (its
// _axis_pass: _edge_term and _envelope_pass, edt.py:56-194 and 227-253),
// with the semantics of the JAX package's host path,
// igneous_tpu/native/csrc/edt.cpp:32-85 line_pass, bit for bit: per run of
// equal labels along a line, the edge term min(dl, dr)^2 w^2 in double,
// then (passes after the first) the Felzenszwalb-Huttenlocher lower
// envelope of the run's parabolas in double, the stack reset at each run,
// values at or above 5e19 skipped, cast to float32 only where it is less
// than the edge term. Labels are compared by raw 32- or 64-bit equality.
//
// Layout: a contiguous 3-d tensor cut into lines along the pass's
// dimension; line l starts at (l / inner) * n * inner + l % inner and
// steps by inner (the product of the dimensions after the pass's).
//
// Bound: bytes. Each label is read once and each value read once and
// written once a pass. The FP64 work is a few divisions and a few adds
// and multiplies a voxel (chip_smoke.py's edt_fp64_ops counts them), below
// the bytes at the card's FP64 rate. What keeps a thread-per-line scan
// above it is state and scatter: per-line stacks in device memory (20
// bytes a position, 2.73 GB a pass at 515^3) and the loads of threads that
// drift apart within a warp. This design:
//
// * A block of 128 threads owns 128 lines, a thread a line. It stages the
//   run starts of its lines in shared memory as a bitmask (bit p set where
//   the label at p differs from the one at p - 1, and at p = 0), laid out
//   [word][line] so that every thread's words fall in its own bank. On a
//   strided axis (inner > 1) each thread stages its own line and a warp's
//   32 loads at one position are 32 neighbouring elements. On the
//   contiguous axis (inner == 1) a warp stages one line at a time, 32
//   neighbouring positions a load, the run starts from a ballot.
// * Each thread then walks its line with one position loop (q = 0..n-1,
//   run starts read from the bitmask), in step with the warp's other
//   lines: first the build of every run's stack, then the queries. A
//   warp's value loads and output stores at one position are neighbours
//   on a strided axis; only the pops and the queries' advances diverge.
// * A stack entry is one bit: the stack of a run is the set of its
//   positions whose bit is set in a second bitmask, in position order. A
//   pop clears the top's bit; the entry below is the highest set bit
//   under it and at or after the run's start. Registers hold the top and
//   the entry below it. A height is recomputed from the value (one
//   __ddiv_rn), re-read from device memory, where the build has just read
//   it (L1 or L2); a bound Z from the two neighbouring entries: Z[k] is a
//   function of entries k-1 and k alone, computed by the same operations
//   in the same order as when entry k was pushed, and entries below the
//   top never change, so the recomputed double is the stored one. Every
//   run's final stack stays in the bitmask for the query loop, which
//   advances through a run's entries with the next set bit.
// * So a line costs n/4 bytes of shared memory (136 at n = 515: ten
//   blocks, 40 warps, an SM, a number the registers set). Staging the
//   values in shared memory as well (4n bytes a line) saves the re-reads
//   but leaves three warps an SM, and measured several times slower on the
//   skeleton task's field (PERF.md). The queries advance linearly: a
//   binary search over the entries would recompute two heights and a
//   bound per probe, where the linear advance takes at most one such step
//   a position in all (a run's advances are fewer than its entries).
// * The first pass along the contiguous axis (inner == 1, edge term only,
//   the first of every EDT) has its own kernel: each warp takes a line,
//   finds its run starts with ballots and writes the edge term of 32
//   neighbouring positions a store, the run's ends found from the bitmask
//   and from two per-word carries.
// * Lines whose bitmasks would not fit in a block's 227 KB of shared
//   memory (n above 7264 after the first pass; cuda_edt.py's smem_bytes)
//   take the long-line kernel: one thread a line, run by run, stacks in
//   device scratch laid out [slot][line]. The wrapper chooses it from the
//   shape before the launch.
//
// Rounding: every product or sum that is not of integers is an explicit
// round-to-nearest intrinsic (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn),
// so that nvcc cannot contract it into a fused multiply-add that the host
// path does not do. Products of integers (q*q, dq*dq, d*d) are exact in
// double and are formed in integers first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float INFF = 1e20f;
constexpr double FAR = 1e30;
constexpr int LB = 128;  // lines (threads) of a block of the line kernel
constexpr int ROW_WARPS = 4;  // warps (lines) of a block of the edge-row kernel
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // shared memory one block may use (227 KB)

// The edge term of position q in the run [a, b1) of a line of n.
__device__ __forceinline__ float edge_term(int q, int a, int b1, int n, double w2) {
  const double dl = (a > 0) ? (double)(q - a + 1) : FAR;
  const double dr = (b1 < n) ? (double)(b1 - q) : FAR;
  const double d = dl < dr ? dl : dr;
  const double e = (d < 1e29) ? __dmul_rn(d * d, w2) : (double)INFF;
  return (float)((double)INFF < e ? (double)INFF : e);
}

// The bound between stack entries (v0, h0) and (v1, h1), v0 < v1, as the
// push of v1 computed it: ((h1 + v1^2) - (h0 + v0^2)) / (2 (v1 - v0)).
__device__ __forceinline__ double bound(int v0, double h0, int v1, double h1) {
  return __ddiv_rn(__dsub_rn(__dadd_rn(h1, (double)((long long)v1 * v1)),
                             __dadd_rn(h0, (double)((long long)v0 * v0))),
                   (double)(2LL * (v1 - v0)));
}

// The lowest set bit above p and below lim of a bitmask of words LB apart,
// or -1.
__device__ __forceinline__ int next_bit(const uint32_t* s, int p, int lim) {
  const int x = p + 1;
  if (x >= lim) return -1;
  int w = x >> 5;
  uint32_t m = s[w * LB] & (FULL << (x & 31));
  const int last = (lim - 1) >> 5;
  while (m == 0) {
    if (++w > last) return -1;
    m = s[w * LB];
  }
  const int r = (w << 5) + __ffs(m) - 1;
  return r < lim ? r : -1;
}

// The highest set bit below v and at or above lo, or -1.
__device__ __forceinline__ int prev_bit(const uint32_t* s, int v, int lo) {
  if (v <= lo) return -1;
  int w = v >> 5;
  uint32_t m = (v & 31) ? (s[w * LB] & ((1u << (v & 31)) - 1u)) : 0u;
  const int first = lo >> 5;
  while (m == 0) {
    if (--w < first) return -1;
    m = s[w * LB];
  }
  const int r = (w << 5) + 31 - __clz(m);
  return r >= lo ? r : -1;
}

// The line kernel: LB lines a block, one thread a line. Shared memory:
// the run starts [W][LB] words, then (after the first pass) the stacks
// [W][LB] words, W = ceil(n / 32).
template <typename LabT, bool FIRST>
__global__ void __launch_bounds__(LB)
edt_lines_kernel(const LabT* __restrict__ lab, const float* __restrict__ val_in,
                 float* __restrict__ val_out, long long lines, int n,
                 long long inner, double w2) {
  extern __shared__ uint32_t smem[];
  const int W = (n + 31) >> 5;
  uint32_t* chg = smem;
  uint32_t* stk = chg + W * LB;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const long long line0 = (long long)blockIdx.x * LB;
  const long long line = line0 + t;
  const bool live = line < lines;
  const long long base = live ? (line / inner) * n * inner + line % inner : 0;

  if (inner == 1) {
    // a warp stages one line at a time, 32 neighbouring positions a load
    for (int i = warp; i < LB && line0 + i < lines; i += LB / 32) {
      const LabT* lb = lab + (line0 + i) * n;
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        const int p = (w << 5) + lane;
        const bool c = p < n && (p == 0 || lb[p] != lb[p - 1]);
        const uint32_t bits = __ballot_sync(FULL, c);
        if (lane == 0) {
          chg[w * LB + i] = bits;
          if (!FIRST) stk[w * LB + i] = 0u;
        }
      }
    }
  } else if (live) {
    // each thread stages its own line; the warp's loads are neighbours
    const LabT* lb = lab + base;
    LabT prev = lb[0];
    for (int w = 0; w < W; ++w) {
      uint32_t bits = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int p = (w << 5) + j;
        if (p < n) {
          const LabT x = lb[(long long)p * inner];
          if (p == 0 || x != prev) bits |= 1u << j;
          prev = x;
        }
      }
      chg[w * LB + t] = bits;
      if (!FIRST) stk[w * LB + t] = 0u;
    }
  }
  __syncthreads();
  if (!live) return;

  const uint32_t* C = chg + t;
  uint32_t* S = stk + t;
  const float* vin = val_in + base;
  float* vout = val_out + base;
  const double skip = (double)INFF * 0.5;
  // the value at position p of this thread's line (read-only here)
  auto value = [&](int p) -> double { return (double)__ldg(vin + (long long)p * inner); };

  if (!FIRST) {
    // build: every run's stack, as set bits; registers hold the top (v1,
    // h1, its bound z1) and the entry below it (v0, h0)
    int a = 0, v1 = -1, v0 = -1;
    double h1 = 0.0, h0 = 0.0, z1 = -FAR;
    uint32_t cw = 0u;
    for (int q = 0; q < n; ++q) {
      if ((q & 31) == 0) cw = C[(q >> 5) * LB];
      if ((cw >> (q & 31)) & 1u) {
        a = q;
        v1 = -1;
      }
      double fq = value(q);
      if (fq >= skip) continue;
      fq = __ddiv_rn(fq, w2);
      const double fq_q2 = __dadd_rn(fq, (double)((long long)q * q));
      double s = -FAR;
      while (v1 >= 0) {
        s = __ddiv_rn(__dsub_rn(fq_q2, __dadd_rn(h1, (double)((long long)v1 * v1))),
                      (double)(2LL * (q - v1)));
        if (!(s <= z1)) break;
        S[(v1 >> 5) * LB] &= ~(1u << (v1 & 31));  // pop the top
        v1 = v0;
        h1 = h0;
        if (v1 >= 0) {
          v0 = prev_bit(S, v1, a);
          if (v0 >= 0) {
            h0 = __ddiv_rn(value(v0), w2);
            z1 = bound(v0, h0, v1, h1);
          } else {
            z1 = -FAR;
          }
        }
      }
      if (v1 < 0) s = -FAR;
      S[(q >> 5) * LB] |= 1u << (q & 31);  // push q
      v0 = v1;
      h0 = h1;
      v1 = q;
      h1 = fq;
      z1 = s;
    }
  }

  // queries and output: the run [a, b1) of q from the run starts; after
  // the first pass the run's entry j (vj, hj) and the next one (vn, hn)
  // with the bound zn between them
  int a = 0, b1 = n, vj = -1, vn = -1;
  double hj = 0.0, hn = 0.0, zn = 0.0;
  uint32_t cw = 0u;
  for (int q = 0; q < n; ++q) {
    if ((q & 31) == 0) cw = C[(q >> 5) * LB];
    if ((cw >> (q & 31)) & 1u) {
      a = q;
      const int r = next_bit(C, q, n);
      b1 = r < 0 ? n : r;
      if (!FIRST) {
        vj = next_bit(S, a - 1, b1);
        vn = -1;
        if (vj >= 0) {
          hj = __ddiv_rn(value(vj), w2);
          vn = next_bit(S, vj, b1);
          if (vn >= 0) {
            hn = __ddiv_rn(value(vn), w2);
            zn = bound(vj, hj, vn, hn);
          }
        }
      }
    }
    float out = edge_term(q, a, b1, n, w2);
    if (!FIRST && vj >= 0) {
      while (vn >= 0 && zn < (double)q) {
        vj = vn;
        hj = hn;
        vn = next_bit(S, vj, b1);
        if (vn >= 0) {
          hn = __ddiv_rn(value(vn), w2);
          zn = bound(vj, hj, vn, hn);
        }
      }
      const long long dq = q - vj;
      const double env = __dmul_rn(__dadd_rn(hj, (double)(dq * dq)), w2);
      if (env < (double)out) out = (float)env;
    }
    vout[(long long)q * inner] = out;
  }
}

// The first pass along the contiguous axis (edge term only): a warp a
// line. Shared memory per warp: the line's run starts (W words) and, per
// word, the last run start in the words before it (W ints).
template <typename LabT>
__global__ void __launch_bounds__(ROW_WARPS * 32)
edt_edge_rows_kernel(const LabT* __restrict__ lab, float* __restrict__ val_out,
                     long long lines, int n, double w2) {
  extern __shared__ uint32_t smem[];
  const int W = (n + 31) >> 5;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  uint32_t* bits = smem + warp * 2 * W;
  int* before = reinterpret_cast<int*>(bits + W);
  const long long line = (long long)blockIdx.x * ROW_WARPS + warp;
  if (line >= lines) return;  // the whole warp: no block-wide barrier follows
  const LabT* lb = lab + line * n;
  float* out = val_out + line * n;
  int last = 0;  // position 0 starts a run
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const int p = (w << 5) + t;
    const bool c = p < n && (p == 0 || lb[p] != lb[p - 1]);
    const uint32_t b = __ballot_sync(FULL, c);
    if (t == 0) {
      bits[w] = b;
      before[w] = last;
    }
    if (b) last = (w << 5) + 31 - __clz(b);
  }
  __syncwarp();
  const uint32_t upto = (t == 31) ? FULL : ((2u << t) - 1u);  // bits 0..t
  int next = n;  // the first run start in the words after w
  for (int w = W - 1; w >= 0; --w) {
    const uint32_t b = bits[w];
    const int p = (w << 5) + t;
    if (p < n) {
      const uint32_t lo = b & upto, hi = b & ~upto;
      const int a = lo ? (w << 5) + 31 - __clz(lo) : before[w];
      const int b1 = hi ? (w << 5) + __ffs(hi) - 1 : next;
      out[p] = edge_term(p, a, b1, n, w2);
    }
    if (b) next = (w << 5) + __ffs(b) - 1;
  }
}

// The long-line kernel: one thread a line, the stacks (positions v,
// heights h, bounds z) in device scratch laid out [slot][line], so that
// threads at the same slot touch neighbouring addresses.
template <typename LabT>
__global__ void __launch_bounds__(128)
edt_long_kernel(const LabT* __restrict__ lab, const float* __restrict__ val_in,
                float* __restrict__ val_out, int* __restrict__ vbuf,
                double* __restrict__ hbuf, double* __restrict__ zbuf,
                long long lines, long long n, long long inner, double w2,
                int first) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= lines) return;
  const long long base = (line / inner) * n * inner + line % inner;
  const LabT* lb = lab + base;
  const float* vin = val_in + base;
  float* vout = val_out + base;
  int* V = vbuf + line;
  double* H = hbuf + line;
  double* Z = zbuf + line;
  const double skip = (double)INFF * 0.5;

  long long a = 0;
  while (a < n) {
    const LabT lv = lb[a * inner];
    long long b = a;
    while (b + 1 < n && lb[(b + 1) * inner] == lv) ++b;

    long long k = -1;
    if (!first) {
      for (long long q = a; q <= b; ++q) {
        double fq = (double)vin[q * inner];
        if (fq >= skip) continue;
        fq = __ddiv_rn(fq, w2);
        const double fq_q2 = __dadd_rn(fq, (double)(q * q));
        double s = -FAR;
        while (k >= 0) {
          const long long vq = V[k * lines];
          s = __ddiv_rn(__dsub_rn(fq_q2, __dadd_rn(H[k * lines], (double)(vq * vq))),
                        (double)(2 * (q - vq)));
          if (s <= Z[k * lines]) {
            --k;
          } else {
            break;
          }
        }
        if (k < 0) s = -FAR;
        ++k;
        V[k * lines] = (int)q;
        H[k * lines] = fq;
        Z[k * lines] = s;
        Z[(k + 1) * lines] = FAR;
      }
    }

    long long j = 0;
    for (long long q = a; q <= b; ++q) {
      const double dl = (a > 0) ? (double)(q - a + 1) : FAR;
      const double dr = (b < n - 1) ? (double)(b + 1 - q) : FAR;
      const double d = dl < dr ? dl : dr;
      const double e = (d < 1e29) ? __dmul_rn(d * d, w2) : (double)INFF;
      float out = (float)((double)INFF < e ? (double)INFF : e);
      if (k >= 0) {
        while (j < k && Z[(j + 1) * lines] < (double)q) ++j;
        const long long dq = q - V[j * lines];
        const double env = __dmul_rn(__dadd_rn(H[j * lines], (double)(dq * dq)), w2);
        if (env < (double)out) out = (float)env;
      }
      vout[q * inner] = out;
    }
    a = b + 1;
  }
}

// Dynamic shared memory of a launch of the kernels above (the formula of
// cuda_edt.py's smem_bytes).
size_t smem_bytes(long long n, long long inner, int first) {
  const size_t W = (size_t)((n + 31) / 32);
  if (inner == 1 && first) return (size_t)ROW_WARPS * 2 * W * 4;
  return W * LB * 4 * (first ? 1 : 2);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename LabT>
int launch(const LabT* lab, const float* val_in, float* val_out, long long lines,
           long long n, long long inner, double w2, int first, int* occupancy,
           void* stream) {
  const size_t bytes = smem_bytes(n, inner, first);
  if (bytes > SMEM_MAX || n > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (inner == 1 && first) {
    auto k = edt_edge_rows_kernel<LabT>;
    cudaError_t err = allow_smem(k, bytes);
    if (err != cudaSuccess) return (int)err;
    if (occupancy) {
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, k,
                                                                ROW_WARPS * 32, bytes);
    }
    k<<<(unsigned)((lines + ROW_WARPS - 1) / ROW_WARPS), ROW_WARPS * 32, bytes, st>>>(
        lab, val_out, lines, (int)n, w2);
    return (int)cudaGetLastError();
  }
  auto k = first ? edt_lines_kernel<LabT, true> : edt_lines_kernel<LabT, false>;
  cudaError_t err = allow_smem(k, bytes);
  if (err != cudaSuccess) return (int)err;
  if (occupancy) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, k, LB, bytes);
  }
  k<<<(unsigned)((lines + LB - 1) / LB), LB, bytes, st>>>(lab, val_in, val_out, lines,
                                                         (int)n, inner, w2);
  return (int)cudaGetLastError();
}

template <typename LabT>
int launch_long(const LabT* lab, const float* val_in, float* val_out, int* vbuf,
                double* hbuf, double* zbuf, long long lines, long long n,
                long long inner, double w2, int first, void* stream) {
  const int threads = 128;
  const long long blocks = (lines + threads - 1) / threads;
  edt_long_kernel<LabT><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      lab, val_in, val_out, vbuf, hbuf, zbuf, lines, n, inner, w2, first);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int edt_pass_i32(const int32_t* lab, const float* val_in,
                            float* val_out, long long lines, long long n,
                            long long inner, double w2, int first,
                            void* stream) {
  return launch<int32_t>(lab, val_in, val_out, lines, n, inner, w2, first, nullptr,
                         stream);
}

extern "C" int edt_pass_i64(const int64_t* lab, const float* val_in,
                            float* val_out, long long lines, long long n,
                            long long inner, double w2, int first,
                            void* stream) {
  return launch<int64_t>(lab, val_in, val_out, lines, n, inner, w2, first, nullptr,
                         stream);
}

// Resident blocks per SM of the launch edt_pass_i64 would make for a pass
// of lines of n with this inner stride, or minus a CUDA error.
extern "C" int edt_pass_blocks_per_sm(long long n, long long inner, int first) {
  int blocks = -1;
  const int rc = launch<int64_t>(nullptr, nullptr, nullptr, 0, n, inner, 1.0, first,
                                 &blocks, nullptr);
  return rc == 0 ? blocks : -rc;
}

extern "C" int edt_pass_long_i32(const int32_t* lab, const float* val_in,
                                 float* val_out, int* vbuf, double* hbuf,
                                 double* zbuf, long long lines, long long n,
                                 long long inner, double w2, int first,
                                 void* stream) {
  return launch_long<int32_t>(lab, val_in, val_out, vbuf, hbuf, zbuf, lines, n,
                              inner, w2, first, stream);
}

extern "C" int edt_pass_long_i64(const int64_t* lab, const float* val_in,
                                 float* val_out, int* vbuf, double* hbuf,
                                 double* zbuf, long long lines, long long n,
                                 long long inner, double w2, int first,
                                 void* stream) {
  return launch_long<int64_t>(lab, val_in, val_out, vbuf, hbuf, zbuf, lines, n,
                              inner, w2, first, stream);
}
