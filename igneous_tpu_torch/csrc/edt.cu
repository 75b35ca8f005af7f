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
// cast to float32 only where it is less than the edge term. Labels are
// compared by raw 32- or 64-bit equality.
//
// Layout: a contiguous 3-d tensor cut into lines along the pass's
// dimension; line l starts at (l / inner) * n * inner + l % inner and
// steps by inner (the product of the dimensions after the pass's). One
// thread per line. Where inner > 1, neighbouring threads take neighbouring
// lines, so their label and value loads coalesce; the pass along the
// contiguous dimension (inner == 1) puts neighbouring threads n elements
// apart. The per-line stacks (positions v, heights h, bounds z) live in
// device scratch laid out [slot][line], so that threads at the same slot
// touch neighbouring addresses.
//
// Bound: bytes. The labels are read once and the values read once and
// written once a pass; the double-precision work per voxel is a few tens
// of operations, far below the card's FP64 rate. This simple design also
// moves the stacks through device memory (up to 20 bytes a voxel pushed,
// and their pops and queries), which is what keeps it above that bound.
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

template <typename LabT>
__global__ void __launch_bounds__(128)
edt_pass_kernel(const LabT* __restrict__ lab, const float* __restrict__ val_in,
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
    const LabT L = lb[a * inner];
    long long b = a;
    while (b + 1 < n && lb[(b + 1) * inner] == L) ++b;

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

template <typename LabT>
int launch(const LabT* lab, const float* val_in, float* val_out, int* vbuf,
           double* hbuf, double* zbuf, long long lines, long long n,
           long long inner, double w2, int first, void* stream) {
  const int threads = 128;
  const long long blocks = (lines + threads - 1) / threads;
  edt_pass_kernel<LabT><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      lab, val_in, val_out, vbuf, hbuf, zbuf, lines, n, inner, w2, first);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int edt_pass_i32(const int32_t* lab, const float* val_in,
                            float* val_out, int* vbuf, double* hbuf,
                            double* zbuf, long long lines, long long n,
                            long long inner, double w2, int first,
                            void* stream) {
  return launch<int32_t>(lab, val_in, val_out, vbuf, hbuf, zbuf, lines, n,
                         inner, w2, first, stream);
}

extern "C" int edt_pass_i64(const int64_t* lab, const float* val_in,
                            float* val_out, int* vbuf, double* hbuf,
                            double* zbuf, long long lines, long long n,
                            long long inner, double w2, int first,
                            void* stream) {
  return launch<int64_t>(lab, val_in, val_out, vbuf, hbuf, zbuf, lines, n,
                         inner, w2, first, stream);
}
