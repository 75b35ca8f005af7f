// Error-bounded greedy QEM edge-collapse mesh simplification.
//
// Capability equivalent of the reference's zmesh `simplify`
// (reference igneous/tasks/mesh/mesh.py:371-383) and pyfqmr LOD
// reduction (reference igneous/tasks/mesh/multires.py:308-359): a
// Garland-Heckbert quadric error metric driven by a min-heap of edge
// collapses, with
//   * area-weighted face-plane quadrics,
//   * border-edge constraint quadrics (perpendicular penalty planes),
//   * optimal vertex placement (3x3 solve, endpoint/midpoint fallback),
//   * manifold-pinch (link condition) and normal-flip rejection,
//   * a physical-units error bound: collapsing stops once the cheapest
//     remaining collapse's area-weighted quadric cost exceeds max_error^2.
//
// Exposed as a C ABI for the ctypes loader in native/__init__.py.
// Deterministic: no threads, no randomness; heap ties break on vertex ids.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <queue>
#include <algorithm>
#include <unordered_map>

namespace {

// symmetric 4x4 quadric, upper triangle:
// [0]=xx [1]=xy [2]=xz [3]=xd [4]=yy [5]=yd... laid out:
//   0:aa 1:ab 2:ac 3:ad 4:bb 5:bc 6:bd 7:cc 8:cd 9:dd
struct Quadric {
  double m[10];
  void zero() { std::memset(m, 0, sizeof(m)); }
  void add_plane(double a, double b, double c, double d, double w) {
    m[0] += w * a * a; m[1] += w * a * b; m[2] += w * a * c; m[3] += w * a * d;
    m[4] += w * b * b; m[5] += w * b * c; m[6] += w * b * d;
    m[7] += w * c * c; m[8] += w * c * d;
    m[9] += w * d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; i++) m[i] += o.m[i]; }
  double eval(double x, double y, double z) const {
    return m[0]*x*x + 2*m[1]*x*y + 2*m[2]*x*z + 2*m[3]*x
         + m[4]*y*y + 2*m[5]*y*z + 2*m[6]*y
         + m[7]*z*z + 2*m[8]*z
         + m[9];
  }
  // minimize: solve [A|b] from the gradient; false if near-singular
  bool optimal(double out[3]) const {
    const double a00 = m[0], a01 = m[1], a02 = m[2];
    const double a11 = m[4], a12 = m[5], a22 = m[7];
    const double b0 = -m[3], b1 = -m[6], b2 = -m[8];
    const double c00 = a11 * a22 - a12 * a12;
    const double c01 = a02 * a12 - a01 * a22;
    const double c02 = a01 * a12 - a02 * a11;
    const double det = a00 * c00 + a01 * c01 + a02 * c02;
    double scale = std::fabs(a00) + std::fabs(a01) + std::fabs(a02)
                 + std::fabs(a11) + std::fabs(a12) + std::fabs(a22);
    if (std::fabs(det) <= 1e-10 * scale * scale * scale + 1e-300) return false;
    const double c11 = a00 * a22 - a02 * a02;
    const double c12 = a01 * a02 - a00 * a12;
    const double c22 = a00 * a11 - a01 * a01;
    out[0] = (c00 * b0 + c01 * b1 + c02 * b2) / det;
    out[1] = (c01 * b0 + c11 * b1 + c12 * b2) / det;
    out[2] = (c02 * b0 + c12 * b1 + c22 * b2) / det;
    return true;
  }
};

struct HeapEntry {
  double cost;
  int v0, v1;
  uint32_t g0, g1;  // vertex generations at push time (lazy invalidation)
  double px, py, pz;
};
struct HeapCmp {
  bool operator()(const HeapEntry& a, const HeapEntry& b) const {
    if (a.cost != b.cost) return a.cost > b.cost;
    if (a.v0 != b.v0) return a.v0 > b.v0;
    return a.v1 > b.v1;
  }
};

struct Simplifier {
  int64_t nv, nf;
  std::vector<double> pos;           // 3*nv
  std::vector<Quadric> Q;            // per-vertex accumulated quadric
  std::vector<int> faces;            // 3*nf (rewritten in place on collapse)
  std::vector<uint8_t> face_alive;
  std::vector<uint8_t> vert_alive;
  std::vector<uint32_t> gen;         // bumped on every change to a vertex
  std::vector<std::vector<int>> inc; // vertex -> incident face ids
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
  int64_t live_faces;
  // epoch-marking scratch for O(deg) neighbor dedup / intersection
  // (replaces per-pop sort+unique+set_intersection, the run()-loop cost
  // center at ~60k collapses/sec before)
  std::vector<uint32_t> mark;
  uint32_t epoch = 0;

  void init(const float* v, int64_t nv_, const uint32_t* f, int64_t nf_,
            int preserve_border) {
    nv = nv_; nf = nf_;
    pos.resize(3 * nv);
    for (int64_t i = 0; i < 3 * nv; i++) pos[i] = v[i];
    faces.resize(3 * nf);
    for (int64_t i = 0; i < 3 * nf; i++) faces[i] = (int)f[i];
    face_alive.assign(nf, 1);
    vert_alive.assign(nv, 1);
    gen.assign(nv, 0);
    Q.assign(nv, Quadric());
    for (auto& q : Q) q.zero();
    inc.assign(nv, {});
    live_faces = 0;

    // Pass 1: connectivity, undirected edge usage (border detection), and
    // the mean face area. Plane weights are area/mean_area so quadric
    // costs stay in length^2 units regardless of the mesh's physical
    // resolution — max_error^2 is then a meaningful bound at any voxel
    // size (a raw area weighting made the bound ~zero collapses for
    // nm-scale meshes and far too loose for sub-voxel ones).
    std::unordered_map<uint64_t, int> edge_faces;
    edge_faces.reserve(nf * 3);
    double area_sum = 0.0;
    int64_t area_count = 0;
    for (int64_t t = 0; t < nf; t++) {
      int a = faces[3*t], b = faces[3*t+1], c = faces[3*t+2];
      if (a == b || b == c || a == c) { face_alive[t] = 0; continue; }
      live_faces++;
      inc[a].push_back((int)t);
      inc[b].push_back((int)t);
      inc[c].push_back((int)t);
      double n[3], area2;
      face_normal(t, n, area2);
      if (area2 >= 1e-30) {
        area_sum += 0.5 * std::sqrt(area2);
        area_count++;
      }
      for (int k = 0; k < 3; k++) {
        int u = faces[3*t+k], w = faces[3*t+(k+1)%3];
        uint64_t key = ekey(u, w);
        edge_faces[key]++;
      }
    }
    const double mean_area =
        (area_count > 0) ? (area_sum / area_count) : 1.0;
    const double wnorm = (mean_area > 1e-30) ? (1.0 / mean_area) : 1.0;

    // Pass 2: accumulate normalized-area-weighted plane quadrics.
    for (int64_t t = 0; t < nf; t++) {
      if (!face_alive[t]) continue;
      double n[3], area2;
      face_normal(t, n, area2);
      if (area2 < 1e-30) continue;
      double area = 0.5 * std::sqrt(area2);
      double inv = 1.0 / std::sqrt(area2);
      double nx = n[0]*inv, ny = n[1]*inv, nz = n[2]*inv;
      int a = faces[3*t];
      double d = -(nx*pos[3*a] + ny*pos[3*a+1] + nz*pos[3*a+2]);
      for (int k = 0; k < 3; k++) {
        int vtx = faces[3*t+k];
        Q[vtx].add_plane(nx, ny, nz, d, area * wnorm);
      }
    }

    // border constraint: for every edge used by exactly one face, add a
    // heavy plane through the edge perpendicular to that face so the open
    // boundary (e.g. a chunk wall) cannot drift
    if (preserve_border) {
      for (int64_t t = 0; t < nf; t++) {
        if (!face_alive[t]) continue;
        double n[3], area2;
        face_normal(t, n, area2);
        if (area2 < 1e-30) continue;
        double ninv = 1.0 / std::sqrt(area2);
        for (int k = 0; k < 3; k++) {
          int u = faces[3*t+k], w = faces[3*t+(k+1)%3];
          auto it = edge_faces.find(ekey(u, w));
          if (it == edge_faces.end() || it->second != 1) continue;
          double ex = pos[3*w] - pos[3*u];
          double ey = pos[3*w+1] - pos[3*u+1];
          double ez = pos[3*w+2] - pos[3*u+2];
          // perpendicular plane normal = edge x face-normal
          double bx = ey * n[2]*ninv - ez * n[1]*ninv;
          double by = ez * n[0]*ninv - ex * n[2]*ninv;
          double bz = ex * n[1]*ninv - ey * n[0]*ninv;
          double bl = std::sqrt(bx*bx + by*by + bz*bz);
          if (bl < 1e-20) continue;
          bx /= bl; by /= bl; bz /= bl;
          double bd = -(bx*pos[3*u] + by*pos[3*u+1] + bz*pos[3*u+2]);
          double elen2 = ex*ex + ey*ey + ez*ez;
          // heavy relative to the ~O(1) normalized interior weights
          double wgt = 1e3 * elen2 * wnorm;
          Q[u].add_plane(bx, by, bz, bd, wgt);
          Q[w].add_plane(bx, by, bz, bd, wgt);
        }
      }
    }

    // seed the heap with every unique edge
    for (auto& kv : edge_faces) {
      int u = (int)(kv.first >> 32), w = (int)(kv.first & 0xffffffffu);
      push_edge(u, w);
    }
  }

  static uint64_t ekey(int u, int w) {
    if (u > w) std::swap(u, w);
    return ((uint64_t)(uint32_t)u << 32) | (uint32_t)w;
  }

  void face_normal(int64_t t, double n[3], double& len2) const {
    const int a = faces[3*t], b = faces[3*t+1], c = faces[3*t+2];
    const double* pa = &pos[3*a];
    const double* pb = &pos[3*b];
    const double* pc = &pos[3*c];
    double ux = pb[0]-pa[0], uy = pb[1]-pa[1], uz = pb[2]-pa[2];
    double vx = pc[0]-pa[0], vy = pc[1]-pa[1], vz = pc[2]-pa[2];
    n[0] = uy*vz - uz*vy; n[1] = uz*vx - ux*vz; n[2] = ux*vy - uy*vx;
    len2 = n[0]*n[0] + n[1]*n[1] + n[2]*n[2];
  }

  void candidate(int u, int w, double p[3], double& cost) const {
    Quadric Qe = Q[u];
    Qe.add(Q[w]);
    if (!Qe.optimal(p)) {
      // fallback: best of endpoints + midpoint
      const double* pu = &pos[3*u];
      const double* pw = &pos[3*w];
      double mid[3] = {(pu[0]+pw[0])/2, (pu[1]+pw[1])/2, (pu[2]+pw[2])/2};
      double cu = Qe.eval(pu[0], pu[1], pu[2]);
      double cw = Qe.eval(pw[0], pw[1], pw[2]);
      double cm = Qe.eval(mid[0], mid[1], mid[2]);
      if (cu <= cw && cu <= cm) { p[0]=pu[0]; p[1]=pu[1]; p[2]=pu[2]; cost = cu; }
      else if (cw <= cm)        { p[0]=pw[0]; p[1]=pw[1]; p[2]=pw[2]; cost = cw; }
      else                      { p[0]=mid[0]; p[1]=mid[1]; p[2]=mid[2]; cost = cm; }
    } else {
      cost = Qe.eval(p[0], p[1], p[2]);
    }
    if (cost < 0) cost = 0;  // numerical noise
  }

  void push_edge(int u, int w) {
    if (!vert_alive[u] || !vert_alive[w] || u == w) return;
    double p[3], cost;
    candidate(u, w, p, cost);
    heap.push({cost, u, w, gen[u], gen[w], p[0], p[1], p[2]});
  }

  // vertices adjacent to v over live faces (deduplicated via epoch
  // marks, O(deg); order is incidence order — the heap comparator is
  // total on (cost, v0, v1) so push order never changes pop order)
  void neighbors(int v, std::vector<int>& out) {
    out.clear();
    if (mark.size() != (size_t)nv) mark.assign(nv, 0);
    if (epoch == 0xffffffffu) {  // wrap: clear stale marks
      mark.assign(nv, 0);
      epoch = 0;
    }
    uint32_t e = ++epoch;
    for (int t : inc[v]) {
      if (!face_alive[t]) continue;
      for (int k = 0; k < 3; k++) {
        int u = faces[3*t+k];
        if (u != v && mark[u] != e) {
          mark[u] = e;
          out.push_back(u);
        }
      }
    }
  }

  // |neighbors(v0) ∩ neighbors(v1)| without materializing either set
  // sorted: mark v0's neighborhood, scan v1's
  int64_t shared_neighbors(int v0, int v1, std::vector<int>& nb_v) {
    neighbors(v0, nb_v);
    uint32_t e = epoch;  // nb_v's marks
    int64_t shared = 0;
    for (int t : inc[v1]) {
      if (!face_alive[t]) continue;
      for (int k = 0; k < 3; k++) {
        int u = faces[3*t+k];
        if (u != v1 && mark[u] == e) {
          mark[u] = 0;  // count each shared vertex once
          shared++;
        }
      }
    }
    return shared;
  }

  // would moving vertex v to p flip or squash any of its live faces that
  // do not contain the disappearing vertex `other`?
  bool flips(int v, int other, const double p[3]) const {
    for (int t : inc[v]) {
      if (!face_alive[t]) continue;
      int a = faces[3*t], b = faces[3*t+1], c = faces[3*t+2];
      if (a == other || b == other || c == other) continue;  // dies anyway
      double n0[3], l0;
      face_normal(t, n0, l0);
      // recompute with v at p
      double pa[3] = {pos[3*a], pos[3*a+1], pos[3*a+2]};
      double pb[3] = {pos[3*b], pos[3*b+1], pos[3*b+2]};
      double pc[3] = {pos[3*c], pos[3*c+1], pos[3*c+2]};
      double* tgt = (a == v) ? pa : (b == v) ? pb : pc;
      tgt[0] = p[0]; tgt[1] = p[1]; tgt[2] = p[2];
      double ux = pb[0]-pa[0], uy = pb[1]-pa[1], uz = pb[2]-pa[2];
      double vx = pc[0]-pa[0], vy = pc[1]-pa[1], vz = pc[2]-pa[2];
      double n1[3] = {uy*vz - uz*vy, uz*vx - ux*vz, ux*vy - uy*vx};
      double l1 = n1[0]*n1[0] + n1[1]*n1[1] + n1[2]*n1[2];
      if (l1 < 1e-24) return true;  // squashed to zero area
      double dot = n0[0]*n1[0] + n0[1]*n1[1] + n0[2]*n1[2];
      if (l0 >= 1e-24 && dot <= 0) return true;  // flipped
    }
    return false;
  }

  // collapse w into v at position p
  void collapse(int v, int w, const double p[3]) {
    pos[3*v] = p[0]; pos[3*v+1] = p[1]; pos[3*v+2] = p[2];
    Q[v].add(Q[w]);
    for (int t : inc[w]) {
      if (!face_alive[t]) continue;
      int* fv = &faces[3*t];
      bool has_v = (fv[0] == v || fv[1] == v || fv[2] == v);
      if (has_v) {
        face_alive[t] = 0;
        live_faces--;
      } else {
        for (int k = 0; k < 3; k++) if (fv[k] == w) fv[k] = v;
        inc[v].push_back(t);
      }
    }
    inc[w].clear();
    inc[w].shrink_to_fit();
    vert_alive[w] = 0;
    gen[v]++;
    gen[w]++;
    // drop dead faces from v's incidence so it cannot grow unboundedly
    auto& iv = inc[v];
    iv.erase(std::remove_if(iv.begin(), iv.end(),
                            [&](int t) { return !face_alive[t]; }),
             iv.end());
    std::sort(iv.begin(), iv.end());
    iv.erase(std::unique(iv.begin(), iv.end()), iv.end());
  }

  void run(int64_t target_faces, double max_error) {
    const double max_cost = (max_error > 0) ? max_error * max_error : -1.0;
    std::vector<int> nb_v;
    while (live_faces > target_faces && !heap.empty()) {
      HeapEntry e = heap.top();
      heap.pop();
      if (!vert_alive[e.v0] || !vert_alive[e.v1]) continue;
      if (gen[e.v0] != e.g0 || gen[e.v1] != e.g1) continue;  // stale
      // error bound: the quadric cost is the area-weighted sum of squared
      // point-plane distances, so max_error^2 caps the collapse once the
      // represented surface patch deviates ~max_error physical units
      if (max_cost >= 0 && e.cost > max_cost) break;
      // link condition: the common neighborhood of (v0,v1) must be
      // exactly the apex vertices of the faces the edge bounds; extra
      // shared neighbors mean the collapse would pinch the surface
      int64_t shared = shared_neighbors(e.v0, e.v1, nb_v);
      int edge_face_count = 0;
      for (int t : inc[e.v0]) {
        if (!face_alive[t]) continue;
        int a = faces[3*t], b = faces[3*t+1], c = faces[3*t+2];
        bool hasw = (a == e.v1 || b == e.v1 || c == e.v1);
        if (hasw) edge_face_count++;
      }
      if (shared > edge_face_count) continue;
      double p[3] = {e.px, e.py, e.pz};
      if (flips(e.v0, e.v1, p) || flips(e.v1, e.v0, p)) continue;
      collapse(e.v0, e.v1, p);
      // refresh the surviving vertex's edge candidates
      neighbors(e.v0, nb_v);
      for (int u : nb_v) push_edge(e.v0, u);
    }
  }

  void emit(float* vout, uint32_t* fout, int64_t* out_nv, int64_t* out_nf) {
    std::vector<int64_t> remap(nv, -1);
    int64_t cv = 0;
    for (int64_t i = 0; i < nv; i++) {
      if (!vert_alive[i]) continue;
      // only emit vertices still referenced by a live face
      bool used = false;
      for (int t : inc[i]) if (face_alive[t]) { used = true; break; }
      if (!used) continue;
      remap[i] = cv;
      vout[3*cv]   = (float)pos[3*i];
      vout[3*cv+1] = (float)pos[3*i+1];
      vout[3*cv+2] = (float)pos[3*i+2];
      cv++;
    }
    int64_t cf = 0;
    for (int64_t t = 0; t < nf; t++) {
      if (!face_alive[t]) continue;
      int a = faces[3*t], b = faces[3*t+1], c = faces[3*t+2];
      if (a == b || b == c || a == c) continue;
      if (remap[a] < 0 || remap[b] < 0 || remap[c] < 0) continue;
      fout[3*cf]   = (uint32_t)remap[a];
      fout[3*cf+1] = (uint32_t)remap[b];
      fout[3*cf+2] = (uint32_t)remap[c];
      cf++;
    }
    *out_nv = cv;
    *out_nf = cf;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Output buffers must hold nv*3 floats / nf*3
// uint32 (simplification never grows a mesh).
int igsimp_simplify(
    const float* verts, int64_t nv,
    const uint32_t* faces, int64_t nf,
    int64_t target_faces, double max_error, int preserve_border,
    float* verts_out, uint32_t* faces_out,
    int64_t* out_nv, int64_t* out_nf) {
  if (nv <= 0 || nf <= 0) { *out_nv = 0; *out_nf = 0; return 0; }
  Simplifier s;
  s.init(verts, nv, faces, nf, preserve_border);
  s.run(target_faces < 4 ? 4 : target_faces, max_error);
  s.emit(verts_out, faces_out, out_nv, out_nf);
  return 0;
}

}  // extern "C"
