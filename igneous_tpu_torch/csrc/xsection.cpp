// Exact plane∩cube cross-section area — the xs3d-equivalent hot loop.
//
// ops/cross_section.py computes per-vertex slice areas by clipping a
// covering quad against each voxel cube (Sutherland-Hodgman, 6 planes)
// and summing shoelace areas. The numpy formulation pays fancy-indexing
// overhead on tiny (≤10-vertex) polygons; this is the same algorithm as
// scalar C++ with fixed-size stack arrays, numerically IDENTICAL to the
// Python twin (same 1e-9 inside tolerance, clamped interpolation, exact
// landing on the wall) so the equivalence test can require exactness.
//
// The reference outsources this inner loop to the xs3d C++ package
// (SURVEY.md §2.3; /root/reference/igneous/tasks/skeleton.py:449).

#include <cmath>
#include <cstdint>

namespace {

struct V3 {
  double x, y, z;
};

static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 mul(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
static inline double dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
static inline double comp(V3 a, int axis) {
  return axis == 0 ? a.x : (axis == 1 ? a.y : a.z);
}
static inline void setcomp(V3 &a, int axis, double v) {
  if (axis == 0) a.x = v;
  else if (axis == 1) a.y = v;
  else a.z = v;
}

// clip polygon (n verts) against sign*(p[axis]-bound) <= 0; returns new n
static int clip_one(const V3 *in, int n, V3 *out, int axis, double sign,
                    double bound) {
  int m = 0;
  for (int k = 0; k < n; ++k) {
    const int j = (k + 1 < n) ? k + 1 : 0;
    const V3 vi = in[k], vj = in[j];
    const double di = sign * (comp(vi, axis) - bound);
    const double dj = sign * (comp(vj, axis) - bound);
    const bool ini = di <= 1e-9, inj = dj <= 1e-9;
    if (ini) out[m++] = vi;
    if (ini != inj) {
      double t = di / (di - dj);
      if (t < 0.0) t = 0.0;
      if (t > 1.0) t = 1.0;
      V3 pt = add(vi, mul(sub(vj, vi), t));
      setcomp(pt, axis, bound);  // exact landing on the wall
      out[m++] = pt;
    }
  }
  return m;
}

}  // namespace

extern "C" double xs_plane_cubes_area(
    const long long *vox_idx, long long K, const double *v_phys,
    const double *t_unit, const double *anis) {
  const V3 v = {v_phys[0], v_phys[1], v_phys[2]};
  const V3 t = {t_unit[0], t_unit[1], t_unit[2]};
  const V3 a = {anis[0], anis[1], anis[2]};

  // plane basis (matches _plane_basis: e = unit on argmin |t| axis)
  int mi = 0;
  double mv = std::fabs(t.x);
  if (std::fabs(t.y) < mv) { mi = 1; mv = std::fabs(t.y); }
  if (std::fabs(t.z) < mv) { mi = 2; }
  V3 e = {0, 0, 0};
  setcomp(e, mi, 1.0);
  V3 u = cross(t, e);
  const double un = std::sqrt(dot(u, u));
  u = mul(u, 1.0 / un);
  const V3 w = cross(t, u);

  const double s = std::sqrt(dot(a, a));  // covers any cube cross-section
  const V3 su_pw = mul(add(u, w), s);
  const V3 su_mw = mul(sub(u, w), s);

  double total = 0.0;
  V3 poly[2][16];
  for (long long c = 0; c < K; ++c) {
    const V3 center = {vox_idx[3 * c + 0] * a.x, vox_idx[3 * c + 1] * a.y,
                       vox_idx[3 * c + 2] * a.z};
    const V3 lo = sub(center, mul(a, 0.5));
    const double d_c = dot(sub(center, v), t);
    const V3 p_rel = sub(sub(center, mul(t, d_c)), lo);
    poly[0][0] = add(p_rel, su_pw);
    poly[0][1] = add(p_rel, su_mw);
    poly[0][2] = sub(p_rel, su_pw);
    poly[0][3] = sub(p_rel, su_mw);
    int n = 4, cur = 0;
    for (int axis = 0; axis < 3 && n >= 3; ++axis) {
      n = clip_one(poly[cur], n, poly[1 - cur], axis, -1.0, 0.0);
      cur = 1 - cur;
      if (n < 3) break;
      n = clip_one(poly[cur], n, poly[1 - cur], axis, 1.0, comp(a, axis));
      cur = 1 - cur;
    }
    if (n < 3) continue;
    // shoelace: 0.5 * | sum_i (v_i - v_0) x (v_{i+1} - v_0) |
    V3 acc = {0, 0, 0};
    const V3 *p = poly[cur];
    for (int i = 1; i + 1 < n; ++i) {
      acc = add(acc, cross(sub(p[i], p[0]), sub(p[i + 1], p[0])));
    }
    total += 0.5 * std::sqrt(dot(acc, acc));
  }
  return total;
}
