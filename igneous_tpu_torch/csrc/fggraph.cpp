// The port's copy of igneous_tpu/native/csrc/fggraph.cpp (the same code;
// "the numpy version" below is the JAX package's,
// igneous_tpu/ops/skeletonize.py).
//
// 26-connected foreground-graph CSR construction for the TEASAR trace.
//
// The numpy version (ops/skeletonize.py _foreground_graph) assembles 13
// directional boolean slices, concatenates COO triples, converts to CSR
// and symmetrizes with `g + g.T` — ~20% of the skeleton forge wall on
// blob fixtures (BASELINE.md round-5 profile). This builds the final
// symmetric CSR directly in two passes over the voxel grid.
//
// Conventions match the numpy version exactly:
//   * node ids = C-order scan positions of foreground voxels;
//   * edge weight = (pdrf[a] + pdrf[b]) * 0.5 * physical step length;
//   * optional voxel_graph (uint32 direction bitfields): the edge for
//     positive-lex delta p between voxels (a, a+p) exists iff bit
//     bits[p] is set at a (the lower voxel) — the kimimaro movement
//     constraint the graphene autapse fix uses.

#include <cstdint>
#include <cstring>

namespace {

struct Dir {
  int dx, dy, dz;
  double len;
  int bit;       // voxel_graph bit for the positive-lex form
  bool positive; // is (dx,dy,dz) the positive-lex form?
};

} // namespace

extern "C" {

// Pass 1: per-node neighbor counts -> indptr (n+1), returns nnz.
// Pass 2 (fill=1): fill indices (int32) + weights (double) using indptr.
// idx: int64 per-voxel node id (-1 = background), C-order (z fastest).
int64_t ig_fggraph(
  int64_t nx, int64_t ny, int64_t nz,
  const int64_t* idx,
  const float* pdrf,
  const uint32_t* vg,            // nullable
  const int8_t* deltas,          // 13 x 3 positive-lex deltas
  const double* step_len,        // 13 physical lengths
  const int32_t* bits,           // 13 voxel_graph bits
  int64_t n,                     // number of foreground nodes
  int64_t* indptr,               // n+1
  int32_t* indices,              // nnz (fill pass)
  double* weights,               // nnz (fill pass)
  int32_t fill
) {
  Dir dirs[26];
  for (int k = 0; k < 13; ++k) {
    dirs[k] = Dir{deltas[3 * k], deltas[3 * k + 1], deltas[3 * k + 2],
                  step_len[k], bits[k], true};
    dirs[13 + k] = Dir{-deltas[3 * k], -deltas[3 * k + 1],
                       -deltas[3 * k + 2], step_len[k], bits[k], false};
  }
  const int64_t sy = nz, sx = ny * nz;
  if (!fill) {
    for (int64_t i = 0; i <= n; ++i) indptr[i] = 0;
  }
  // nodes are visited exactly once, in node-id order (ids are assigned
  // by the same C-order scan), so a local write cursor starting at
  // indptr[node] fills each CSR row completely without extra state
  for (int64_t x = 0; x < nx; ++x) {
    for (int64_t y = 0; y < ny; ++y) {
      const int64_t base = x * sx + y * sy;
      for (int64_t z = 0; z < nz; ++z) {
        const int64_t a = base + z;
        const int64_t ia = idx[a];
        if (ia < 0) continue;
        int64_t w = fill ? indptr[ia] : 0;
        for (int k = 0; k < 26; ++k) {
          const Dir& d = dirs[k];
          const int64_t ux = x + d.dx, uy = y + d.dy, uz = z + d.dz;
          if (ux < 0 || ux >= nx || uy < 0 || uy >= ny ||
              uz < 0 || uz >= nz) continue;
          const int64_t b = ux * sx + uy * sy + uz;
          const int64_t ib = idx[b];
          if (ib < 0) continue;
          if (vg) {
            const int64_t src = d.positive ? a : b;
            if (((vg[src] >> d.bit) & 1u) == 0) continue;
          }
          if (!fill) {
            indptr[ia + 1]++;
          } else {
            indices[w] = (int32_t)ib;
            weights[w] = (double)(pdrf[a] + pdrf[b]) * 0.5 * d.len;
            ++w;
          }
        }
      }
    }
  }
  if (!fill) {
    int64_t acc = 0;
    for (int64_t i = 1; i <= n; ++i) {
      acc += indptr[i];
      indptr[i] = acc;
    }
    return acc;
  }
  return 0;
}

} // extern "C"
