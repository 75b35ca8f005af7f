// Native compressed_segmentation codec core.
//
// The reference pipeline links the compressed-segmentation C++ library via
// cloud-volume (SURVEY.md §2.3 "compression/codec stack"); this is the
// equivalent native hot path for igneous_tpu, produced and consumed through
// igneous_tpu/cseg.py. The bitstream matches the pure-numpy implementation
// exactly (including the share-previous-table rule) so either side can
// decode the other's output.
//
// Build: g++ -O3 -shared -fPIC -o libcseg.so cseg.cpp  (see native/__init__.py)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

int pick_bits(int n_distinct) {
  static const int valid[] = {0, 1, 2, 4, 8, 16, 32};
  int need = 0;
  while ((1 << need) < n_distinct) need++;
  for (int b : valid)
    if (b >= need) return b;
  return -1;
}

// encode one channel: img is an (sx, sy, sz) array with ELEMENT strides
// (stx, sty, stz) — any layout (C, Fortran, sliced views). Voxels inside
// a block are enumerated x-fastest regardless of memory layout (the
// format fixes the traversal; strides only change where we read).
template <typename T>
std::vector<uint32_t> encode_channel(const T* img, int sx, int sy, int sz,
                                     int64_t stx, int64_t sty, int64_t stz,
                                     int bx, int by, int bz) {
  const int gx = (sx + bx - 1) / bx;
  const int gy = (sy + by - 1) / by;
  const int gz = (sz + bz - 1) / bz;
  const int64_t nblocks = (int64_t)gx * gy * gz;
  const int words_per_entry = sizeof(T) == 8 ? 2 : 1;

  std::vector<uint32_t> headers(nblocks * 2, 0);
  std::vector<uint32_t> body;
  body.reserve(nblocks * 4);

  std::vector<T> prev_table;
  uint32_t prev_table_offset = 0;

  std::vector<T> vals;
  std::vector<T> table;
  std::vector<uint32_t> idx;

  int64_t bi = 0;
  for (int z0 = 0; z0 < gz * bz; z0 += bz) {
    for (int y0 = 0; y0 < gy * by; y0 += by) {
      for (int x0 = 0; x0 < gx * bx; x0 += bx) {
        const int cx = x0 + bx > sx ? sx - x0 : bx;
        const int cy = y0 + by > sy ? sy - y0 : by;
        const int cz = z0 + bz > sz ? sz - z0 : bz;
        const int n = cx * cy * cz;

        // gather block voxels, x fastest
        vals.clear();
        vals.reserve(n);
        for (int dz = 0; dz < cz; dz++) {
          for (int dy = 0; dy < cy; dy++) {
            const T* row =
                img + (int64_t)(z0 + dz) * stz + (int64_t)(y0 + dy) * sty +
                (int64_t)x0 * stx;
            for (int dx = 0; dx < cx; dx++)
              vals.push_back(row[(int64_t)dx * stx]);
          }
        }

        // sorted distinct table + per-voxel index (matches np.unique order)
        table = vals;
        std::sort(table.begin(), table.end());
        table.erase(std::unique(table.begin(), table.end()), table.end());
        idx.clear();
        idx.reserve(n);
        for (const T v : vals) {
          const auto it = std::lower_bound(table.begin(), table.end(), v);
          idx.push_back((uint32_t)(it - table.begin()));
        }

        const int bits = pick_bits((int)table.size());
        if (bits < 0) return {};  // cannot happen for <= 2^32 distinct

        uint32_t table_offset;
        if (!prev_table.empty() && prev_table == table) {
          table_offset = prev_table_offset;
        } else {
          table_offset = (uint32_t)(2 * nblocks + body.size());
          for (const T v : table) {
            body.push_back((uint32_t)(v & 0xFFFFFFFFu));
            if (words_per_entry == 2)
              body.push_back((uint32_t)(((uint64_t)v) >> 32));
          }
          prev_table = table;
          prev_table_offset = table_offset;
        }
        if (table_offset >= (1u << 24)) return {};

        const uint32_t values_offset = (uint32_t)(2 * nblocks + body.size());
        if (bits > 0) {
          const int vals_per_word = 32 / bits;
          const int nwords = (n + vals_per_word - 1) / vals_per_word;
          for (int w = 0; w < nwords; w++) {
            uint32_t packed = 0;
            for (int k = 0; k < vals_per_word; k++) {
              const int i = w * vals_per_word + k;
              if (i < n) packed |= idx[i] << (k * bits);
            }
            body.push_back(packed);
          }
        }

        headers[2 * bi] = table_offset | ((uint32_t)bits << 24);
        headers[2 * bi + 1] = values_offset;
        bi++;
      }
    }
  }

  std::vector<uint32_t> out;
  out.reserve(headers.size() + body.size());
  out.insert(out.end(), headers.begin(), headers.end());
  out.insert(out.end(), body.begin(), body.end());
  return out;
}

template <typename T>
int decode_channel(const uint32_t* words, int64_t nwords, int sx, int sy,
                   int sz, int bx, int by, int bz, T* out) {
  const int gx = (sx + bx - 1) / bx;
  const int gy = (sy + by - 1) / by;
  const int gz = (sz + bz - 1) / bz;
  const int words_per_entry = sizeof(T) == 8 ? 2 : 1;

  int64_t bi = 0;
  for (int z0 = 0; z0 < gz * bz; z0 += bz) {
    for (int y0 = 0; y0 < gy * by; y0 += by) {
      for (int x0 = 0; x0 < gx * bx; x0 += bx) {
        if (2 * bi + 1 >= nwords) return 1;
        const uint32_t w0 = words[2 * bi];
        const uint32_t w1 = words[2 * bi + 1];
        const int bits = (int)(w0 >> 24);
        const int64_t table_offset = (int64_t)(w0 & 0xFFFFFF);
        const int64_t values_offset = (int64_t)w1;
        const int cx = x0 + bx > sx ? sx - x0 : bx;
        const int cy = y0 + by > sy ? sy - y0 : by;
        const int cz = z0 + bz > sz ? sz - z0 : bz;
        const int n = cx * cy * cz;

        int i = 0;
        for (int dz = 0; dz < cz; dz++) {
          for (int dy = 0; dy < cy; dy++) {
            for (int dx = 0; dx < cx; dx++, i++) {
              uint32_t index = 0;
              if (bits > 0) {
                const int vals_per_word = 32 / bits;
                const int64_t w = values_offset + i / vals_per_word;
                if (w >= nwords) return 2;
                const int shift = (i % vals_per_word) * bits;
                const uint32_t mask =
                    bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
                index = (words[w] >> shift) & mask;
              }
              const int64_t t = table_offset + (int64_t)index * words_per_entry;
              if (t + words_per_entry - 1 >= nwords) return 3;
              T v = (T)words[t];
              if (words_per_entry == 2)
                v |= (T)(((uint64_t)words[t + 1]) << 32);
              out[(int64_t)(x0 + dx) * sy * sz + (int64_t)(y0 + dy) * sz +
                  (z0 + dz)] = v;
            }
          }
        }
        bi++;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns number of uint32 words written to *out (malloc'd; caller frees
// with cseg_free), or 0 on failure.
int64_t cseg_encode_channel_strided(const void* img, int is64, int sx,
                                    int sy, int sz, int64_t stx, int64_t sty,
                                    int64_t stz, int bx, int by, int bz,
                                    uint32_t** out) {
  std::vector<uint32_t> enc =
      is64 ? encode_channel<uint64_t>((const uint64_t*)img, sx, sy, sz, stx,
                                      sty, stz, bx, by, bz)
           : encode_channel<uint32_t>((const uint32_t*)img, sx, sy, sz, stx,
                                      sty, stz, bx, by, bz);
  if (enc.empty() && (int64_t)sx * sy * sz > 0) {
    const int gx = (sx + bx - 1) / bx, gy = (sy + by - 1) / by,
              gz = (sz + bz - 1) / bz;
    if ((int64_t)gx * gy * gz > 0) return 0;  // genuine failure
  }
  *out = (uint32_t*)std::malloc(enc.size() * 4);
  if (!*out) return 0;
  std::memcpy(*out, enc.data(), enc.size() * 4);
  return (int64_t)enc.size();
}

void cseg_free(uint32_t* p) { std::free(p); }

int cseg_decode_channel(const uint32_t* words, int64_t nwords, int is64,
                        int sx, int sy, int sz, int bx, int by, int bz,
                        void* out) {
  return is64 ? decode_channel<uint64_t>(words, nwords, sx, sy, sz, bx, by, bz,
                                         (uint64_t*)out)
              : decode_channel<uint32_t>(words, nwords, sx, sy, sz, bx, by, bz,
                                         (uint32_t*)out);
}
}
