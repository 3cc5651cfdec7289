// Quadric edge-collapse mesh decimation (Garland-Heckbert quadrics with a
// threshold-sweep schedule), the native counterpart of the reference's
// offline decimator (mesh_simplify.py: SymetricMatrix quadrics, edge-collapse
// loop with threshold 1e-9*(iter+3)^aggressiveness, flip prevention, boundary
// detection, compaction) and of gpytoolbox.decimate's role in the live SF3D
// path (sf3d/models/mesh.py:195-199).
//
// Sequential edge-collapse is inherently ordered work, which is why this
// lives in host C++ rather than XLA. Exposed via a C ABI for ctypes.
//
// Build: geometry/native/__init__.py (g++ -O3 -shared -fPIC, on first use).

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {
inline bool profile_enabled() {
  static int on = -1;
  if (on < 0) on = std::getenv("SCULPTMATE_DECIMATE_PROFILE") ? 1 : 0;
  return on;
}
inline double now_ms() {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
}  // namespace

namespace {

// quadric coefficient precision: float halves the memory traffic of the
// dominant random-access passes (the algorithm is cache-miss-bound on one
// core); positions and plane computation stay double. Rebuild with
// -DSCULPTMATE_QREAL=double to restore full-precision quadrics.
#ifndef SCULPTMATE_QREAL
#define SCULPTMATE_QREAL float
#endif
typedef SCULPTMATE_QREAL qreal;

struct SymMat {
  // symmetric 4x4, 10 coefficients
  qreal m[10];
  SymMat() { std::memset(m, 0, sizeof(m)); }
  SymMat(double a, double b, double c, double d) {
    m[0] = (qreal)(a * a); m[1] = (qreal)(a * b); m[2] = (qreal)(a * c);
    m[3] = (qreal)(a * d);
    m[4] = (qreal)(b * b); m[5] = (qreal)(b * c); m[6] = (qreal)(b * d);
    m[7] = (qreal)(c * c); m[8] = (qreal)(c * d);
    m[9] = (qreal)(d * d);
  }
  SymMat operator+(const SymMat& o) const {
    SymMat r;
    for (int i = 0; i < 10; i++) r.m[i] = m[i] + o.m[i];
    return r;
  }
  void operator+=(const SymMat& o) {
    for (int i = 0; i < 10; i++) m[i] += o.m[i];
  }
  double det(int a11, int a12, int a13, int a21, int a22, int a23, int a31,
             int a32, int a33) const {
    // evaluate in double regardless of storage precision: the 3x3 dets
    // cancel heavily and drive the collapse-point solve
    return (double)m[a11] * m[a22] * m[a33] + (double)m[a13] * m[a21] * m[a32] +
           (double)m[a12] * m[a23] * m[a31] - (double)m[a13] * m[a22] * m[a31] -
           (double)m[a11] * m[a23] * m[a32] - (double)m[a12] * m[a21] * m[a33];
  }
};

struct Vec3 {
  double x, y, z;
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  double norm() const { return std::sqrt(x * x + y * y + z * z); }
  Vec3 normalized() const {
    double n = norm();
    return n > 1e-30 ? Vec3{x / n, y / n, z / n} : Vec3{0, 0, 0};
  }
};

struct Vec3f {
  float x, y, z;
};

// 44-byte hot struct (vs 70 with double err/normal): the sweep and the
// per-iteration compaction stream every triangle, so this is bandwidth on
// the single host core. float errs only order candidates against the sweep
// threshold; the collapse-point solve stays double in calculate_error.
struct Triangle {
  int v[3];
  float err[4];
  Vec3f n;
  bool deleted, dirty;
};

struct Vertex {
  Vec3 p;
  int tstart, tcount;
  SymMat q;
  bool border;
};

void accumulate_normals(const float* verts, int64_t nv, const int32_t* faces,
                        int64_t nf, float* out_normals);

// packed (tid << 2 | corner): half the ref-array traffic of {int,int}
typedef uint32_t VRef;
inline VRef make_ref(uint32_t tid, uint32_t corner) { return (tid << 2) | corner; }
inline uint32_t ref_tid(VRef r) { return r >> 2; }
inline uint32_t ref_corner(VRef r) { return r & 3u; }

struct Simplifier {
  std::vector<Triangle> triangles;
  std::vector<Vertex> vertices;
  std::vector<VRef> refs;
  // cumulative deleted count at the last compaction (update_mesh's
  // skip-compact heuristic compares deletions since then, not since start)
  int compacted_deleted_ = 0;

  double vertex_error(const SymMat& q, double x, double y, double z) const {
    return q.m[0] * x * x + 2 * q.m[1] * x * y + 2 * q.m[2] * x * z +
           2 * q.m[3] * x + q.m[4] * y * y + 2 * q.m[5] * y * z +
           2 * q.m[6] * y + q.m[7] * z * z + 2 * q.m[8] * z + q.m[9];
  }

  // Bulk-ordering error: float arithmetic throughout (2x the AVX throughput
  // of the double path). Only ORDERS candidate edges against the sweep
  // threshold — a float-cancellation misestimate merely shifts an edge to a
  // different sweep; the collapse-time placement solve (calculate_error)
  // stays double and the flip veto still guards quality.
  float error_only(int id_v1, int id_v2) const {
    const qreal* a = vertices[id_v1].q.m;
    const qreal* b = vertices[id_v2].q.m;
    float m0 = (float)(a[0] + b[0]), m1 = (float)(a[1] + b[1]),
          m2 = (float)(a[2] + b[2]), m3 = (float)(a[3] + b[3]),
          m4 = (float)(a[4] + b[4]), m5 = (float)(a[5] + b[5]),
          m6 = (float)(a[6] + b[6]), m7 = (float)(a[7] + b[7]),
          m8 = (float)(a[8] + b[8]), m9 = (float)(a[9] + b[9]);
    auto verr = [&](float x, float y, float z) {
      return m0 * x * x + 2 * m1 * x * y + 2 * m2 * x * z + 2 * m3 * x +
             m4 * y * y + 2 * m5 * y * z + 2 * m6 * y + m7 * z * z +
             2 * m8 * z + m9;
    };
    bool border = vertices[id_v1].border && vertices[id_v2].border;
    float det = m0 * m4 * m7 + m2 * m1 * m5 + m1 * m5 * m2 -
                m2 * m4 * m2 - m0 * m5 * m5 - m1 * m1 * m7;
    if (det != 0.0f && !border) {
      float inv = 1.0f / det;
      float x = -inv * (m1 * (m5 * m8 - m7 * m6) - m2 * (m4 * m8 - m5 * m6) +
                        m3 * (m4 * m7 - m5 * m5));
      float y = inv * (m0 * (m5 * m8 - m7 * m6) - m2 * (m1 * m8 - m2 * m6) +
                       m3 * (m1 * m7 - m2 * m5));
      float z = -inv * (m0 * (m4 * m8 - m5 * m6) - m1 * (m1 * m8 - m2 * m6) +
                        m3 * (m1 * m5 - m2 * m4));
      return verr(x, y, z);
    }
    const Vec3& p1 = vertices[id_v1].p;
    const Vec3& p2 = vertices[id_v2].p;
    float e1 = verr((float)p1.x, (float)p1.y, (float)p1.z);
    float e2 = verr((float)p2.x, (float)p2.y, (float)p2.z);
    float e3 = verr((float)((p1.x + p2.x) * 0.5), (float)((p1.y + p2.y) * 0.5),
                    (float)((p1.z + p2.z) * 0.5));
    return std::fmin(e1, std::fmin(e2, e3));
  }

  double calculate_error(int id_v1, int id_v2, Vec3& p_result) const {
    SymMat q = vertices[id_v1].q + vertices[id_v2].q;
    bool border = vertices[id_v1].border && vertices[id_v2].border;
    double error;
    double det = q.det(0, 1, 2, 1, 4, 5, 2, 5, 7);
    if (det != 0 && !border) {
      p_result.x = -1.0 / det * q.det(1, 2, 3, 4, 5, 6, 5, 7, 8);
      p_result.y = 1.0 / det * q.det(0, 2, 3, 1, 5, 6, 2, 7, 8);
      p_result.z = -1.0 / det * q.det(0, 1, 3, 1, 4, 6, 2, 5, 8);
      error = vertex_error(q, p_result.x, p_result.y, p_result.z);
    } else {
      const Vec3& p1 = vertices[id_v1].p;
      const Vec3& p2 = vertices[id_v2].p;
      Vec3 p3 = (p1 + p2) * 0.5;
      double e1 = vertex_error(q, p1.x, p1.y, p1.z);
      double e2 = vertex_error(q, p2.x, p2.y, p2.z);
      double e3 = vertex_error(q, p3.x, p3.y, p3.z);
      error = std::fmin(e1, std::fmin(e2, e3));
      if (error == e1) p_result = p1;
      else if (error == e2) p_result = p2;
      else p_result = p3;
    }
    return error;
  }

  bool flipped(const Vec3& p, int i1, const Vertex& v0,
               std::vector<bool>& deleted) const {
    for (int k = 0; k < v0.tcount; k++) {
      const Triangle& t = triangles[ref_tid(refs[v0.tstart + k])];
      if (t.deleted) continue;
      int s = (int)ref_corner(refs[v0.tstart + k]);
      int id1 = t.v[(s + 1) % 3];
      int id2 = t.v[(s + 2) % 3];
      if (id1 == i1 || id2 == i1) {  // face collapses onto the edge
        deleted[k] = true;
        continue;
      }
      // sqrt-free forms of the reference tests (one sqrt total instead of
      // three normalized()): |d1n.d2n| > 0.999  <=>  (d1.d2)^2 > 0.999^2
      // l1 l2;  n_unit.t.n < 0.2  <=>  (d1 x d2).t.n < 0.2 |d1 x d2|
      Vec3 d1 = vertices[id1].p - p;
      Vec3 d2 = vertices[id2].p - p;
      double l1 = d1.dot(d1), l2 = d2.dot(d2);
      if (l1 < 1e-60 || l2 < 1e-60) return true;  // collapsed edge
      double dd = d1.dot(d2);
      if (dd * dd > 0.998001 * l1 * l2) return true;  // degenerate sliver
      Vec3 n = d1.cross(d2);
      deleted[k] = false;
      double ndot = n.x * t.n.x + n.y * t.n.y + n.z * t.n.z;
      if (ndot < 0.2 * std::sqrt(n.dot(n))) return true;  // flip
    }
    return false;
  }

  void update_triangles(int i0, const Vertex& v, const std::vector<bool>& deleted,
                        int& deleted_triangles) {
    for (int k = 0; k < v.tcount; k++) {
      VRef r = refs[v.tstart + k];
      Triangle& t = triangles[ref_tid(r)];
      if (t.deleted) continue;
      if (deleted[k]) {
        t.deleted = true;
        deleted_triangles++;
        continue;
      }
      t.v[ref_corner(r)] = i0;
      // errors are NOT recomputed here: dirty triangles are skipped for the
      // rest of this sweep anyway, so their errors are refreshed ONCE in the
      // next update_mesh (with the final post-sweep quadrics) instead of
      // once per incident collapse — ~2x less error math per sweep
      t.dirty = true;
      refs.push_back(r);
    }
  }

  void update_mesh(int iteration, int deleted_triangles) {
    if (iteration > 0) {
      // Few deletions SINCE THE LAST COMPACTION (early sweeps on a gentle
      // ratio, or the trickle after the jumpstart): refresh the dirty errors
      // in place and keep the triangle array + refs as-is — compacting 1.3M
      // triangles to discard 2% costs more than the skips it saves, and
      // refs/tids stay valid precisely because we DON'T move triangles.
      // Refs growth is bounded by the sweep appends (~2x the collapsed
      // vertices' lists), fine for the handful of iterations the jumpstart
      // schedule runs. (Comparing the CUMULATIVE count would disable the
      // skip forever after the first compaction.)
      bool skip_compact =
          (size_t)(deleted_triangles - compacted_deleted_) * 4 <
              triangles.size() &&
          refs.size() < refs.capacity();
      if (skip_compact) {
        for (auto& t : triangles) {
          if (t.deleted || !t.dirty) continue;
          for (int j = 0; j < 3; j++)
            t.err[j] = error_only(t.v[j], t.v[(j + 1) % 3]);
          t.err[3] = std::fmin(t.err[0], std::fmin(t.err[1], t.err[2]));
          t.dirty = false;
        }
        return;  // refs untouched => still consistent
      }
      // ONE fused stream: compact the alive triangles, refresh the errors of
      // the dirty ones (deferred from the sweep's collapses), clear dirty
      size_t dst = 0;
      for (size_t i = 0; i < triangles.size(); i++) {
        if (triangles[i].deleted) continue;
        Triangle& t = triangles[dst];
        t = triangles[i];
        if (t.dirty) {
          for (int j = 0; j < 3; j++)
            t.err[j] = error_only(t.v[j], t.v[(j + 1) % 3]);
          t.err[3] = std::fmin(t.err[0], std::fmin(t.err[1], t.err[2]));
          t.dirty = false;
        }
        dst++;
      }
      triangles.resize(dst);
      compacted_deleted_ = deleted_triangles;
    }

    if (iteration == 0) {
      double q0 = now_ms();
      for (auto& v : vertices) v.q = SymMat();
      for (auto& t : triangles) {
        Vec3 p[3] = {vertices[t.v[0]].p, vertices[t.v[1]].p, vertices[t.v[2]].p};
        Vec3 n = (p[1] - p[0]).cross(p[2] - p[0]).normalized();
        t.n = {(float)n.x, (float)n.y, (float)n.z};
        SymMat plane(n.x, n.y, n.z, -n.dot(p[0]));
        for (int j = 0; j < 3; j++) vertices[t.v[j]].q += plane;
      }
      double q1 = now_ms();
      for (auto& t : triangles) {
        for (int j = 0; j < 3; j++)
          t.err[j] = error_only(t.v[j], t.v[(j + 1) % 3]);
        t.err[3] = std::fmin(t.err[0], std::fmin(t.err[1], t.err[2]));
      }
      if (profile_enabled())
        std::fprintf(stderr, "[decimate]   init: quadrics %.1f ms errors %.1f ms\n",
                     q1 - q0, now_ms() - q1);
    }

    // rebuild refs
    for (auto& v : vertices) { v.tstart = 0; v.tcount = 0; }
    for (auto& t : triangles)
      for (int j = 0; j < 3; j++) vertices[t.v[j]].tcount++;
    int tstart = 0;
    for (auto& v : vertices) { v.tstart = tstart; tstart += v.tcount; v.tcount = 0; }
    refs.resize(triangles.size() * 3);
    for (size_t i = 0; i < triangles.size(); i++) {
      const Triangle& t = triangles[i];
      for (int j = 0; j < 3; j++) {
        Vertex& v = vertices[t.v[j]];
        refs[v.tstart + v.tcount] = make_ref((uint32_t)i, (uint32_t)j);
        v.tcount++;
      }
    }

    if (iteration == 0) {  // border detection
      // Per-vertex signed-hash accumulators instead of the reference's
      // O(sum deg^2) scans or a 3F-entry edge table: each directed edge
      // (a,b) adds a strong 64-bit hash of its undirected key to BOTH
      // endpoint accumulators, signed by direction. Paired edges cancel
      // exactly, so a vertex accumulator is nonzero iff some incident edge
      // is unpaired (a border/non-manifold edge) — up to astronomically
      // unlikely hash cancellation. Working set = one u64 per vertex
      // (LLC-resident), one stream over the triangles.
      auto mix = [](uint64_t key) {
        key ^= key >> 33; key *= 0xFF51AFD7ED558CCDull;
        key ^= key >> 33; key *= 0xC4CEB9FE1A85EC53ull;
        return key ^ (key >> 33);
      };
      std::vector<uint64_t> acc(vertices.size(), 0);
      for (auto& t : triangles) {
        for (int j = 0; j < 3; j++) {
          uint32_t a = (uint32_t)t.v[j], b = (uint32_t)t.v[(j + 1) % 3];
          uint64_t key = a < b ? ((uint64_t)a << 32) | b : ((uint64_t)b << 32) | a;
          uint64_t h = mix(key);
          uint64_t s = (a < b) ? h : (uint64_t)(-(int64_t)h);
          acc[a] += s;
          acc[b] += s;
        }
      }
      for (size_t i = 0; i < vertices.size(); i++)
        vertices[i].border = acc[i] != 0;
    }
  }

  // Pick the starting sweep threshold from the initial edge-error
  // distribution so the FIRST sweep already reaches for the target
  // removal count, instead of ramping through several near-empty sweeps
  // (the reference schedule 1e-9*(iter+3)^a spends its first iterations
  // collapsing ~0.3% of a lattice mesh). A successful collapse deletes
  // ~2 triangles; aim at ~60% of the needed collapses in sweep one
  // (vetoes and dirty-marking absorb the rest across later sweeps).
  double jumpstart_threshold(int target_count) {
    size_t alive = 0;
    for (auto& t : triangles) alive += !t.deleted;
    double removals = (double)alive - (double)target_count;
    if (removals <= 0) return 0.0;
    size_t want = (size_t)(removals * 0.5 * 0.6);
    if (want < 16) return 0.0;
    // stride-8 sample: the want-quantile of a 160K+ sample is within noise
    // of the exact order statistic, at 1/8 the copy + nth_element cost
    std::vector<float> errs;
    errs.reserve(triangles.size() / 8 + 1);
    for (size_t i = 0; i < triangles.size(); i += 8)
      if (!triangles[i].deleted) errs.push_back(triangles[i].err[3]);
    size_t w = want / 8;
    if (errs.size() < 64) return 0.0;
    if (w >= errs.size()) w = errs.size() - 1;
    std::nth_element(errs.begin(), errs.begin() + w, errs.end());
    return (double)errs[w];
  }

  void simplify(int target_count, double aggressiveness) {
    // deleted/dirty are initialized false by the entry point; iteration>0
    // update_mesh clears dirty in its fused compact+refresh stream
    int deleted_triangles = 0;
    std::vector<bool> deleted0, deleted1;
    int triangle_count = (int)triangles.size();
    double thr_floor = 0.0;
    // collapses append ~2x the collapsed vertices' ref lists; reserve so the
    // sweep never reallocates the 3F-element base array mid-loop
    refs.reserve(triangles.size() * 3 * 2);

    for (int iteration = 0; iteration < 100; iteration++) {
      if (triangle_count - deleted_triangles <= target_count) break;
      double t0 = now_ms();
      update_mesh(iteration, deleted_triangles);
      double t1 = now_ms();
      if (iteration == 0)
        thr_floor = jumpstart_threshold(target_count);

      double threshold = std::fmax(
          thr_floor * std::pow(8.0, double(iteration)),
          1e-9 * std::pow(double(iteration + 3), aggressiveness));

      for (size_t ti = 0; ti < triangles.size(); ti++) {
        Triangle& t = triangles[ti];
        if (t.err[3] > threshold || t.deleted || t.dirty) continue;
        for (int j = 0; j < 3; j++) {
          if (t.err[j] >= threshold) continue;
          int i0 = t.v[j];
          int i1 = t.v[(j + 1) % 3];
          Vertex& v0 = vertices[i0];
          Vertex& v1 = vertices[i1];
          if (v0.border != v1.border) continue;

          Vec3 p;
          calculate_error(i0, i1, p);
          deleted0.resize(v0.tcount);
          deleted1.resize(v1.tcount);
          if (flipped(p, i1, v0, deleted0)) continue;
          if (flipped(p, i0, v1, deleted1)) continue;

          v0.p = p;
          v0.q += v1.q;
          int tstart = (int)refs.size();
          update_triangles(i0, v0, deleted0, deleted_triangles);
          update_triangles(i0, v1, deleted1, deleted_triangles);
          int tcount = (int)refs.size() - tstart;
          v0.tstart = tstart;
          v0.tcount = tcount;
          break;
        }
        if (triangle_count - deleted_triangles <= target_count) break;
      }
      if (profile_enabled()) {
        std::fprintf(
            stderr,
            "[decimate] iter %d: update %.1f ms sweep %.1f ms  alive %d/%d thr %.3g\n",
            iteration, t1 - t0, now_ms() - t1,
            triangle_count - deleted_triangles, triangle_count, threshold);
      }
    }
  }

  // Compact straight into the caller's output buffers: alive triangles are
  // renumbered in first-use vertex order and only positions survive (the
  // quadric/ref state dies with the Simplifier) — one stream, no struct
  // copies. If out_normals is non-null, area-weighted vertex normals
  // (the ``Mesh._compute_vertex_normal`` semantics: face-cross scatter,
  // zero-normal fallback +z, normalized) are accumulated in the same
  // stream — ~free here vs a separate host numpy bincount pass.
  void compact_into(float* out_verts, int64_t* out_nv, int32_t* out_faces,
                    int64_t* out_nf, float* out_normals) {
    double c0 = now_ms();
    std::vector<int32_t> vmap(vertices.size(), -1);
    int32_t next = 0;
    int64_t nf = 0;
    for (auto& t : triangles) {
      if (t.deleted) continue;
      for (int j = 0; j < 3; j++) {
        int32_t id = t.v[j];
        if (vmap[id] < 0) {
          vmap[id] = next;
          const Vec3& p = vertices[id].p;
          out_verts[3 * next] = (float)p.x;
          out_verts[3 * next + 1] = (float)p.y;
          out_verts[3 * next + 2] = (float)p.z;
          next++;
        }
        out_faces[3 * nf + j] = vmap[id];
      }
      nf++;
    }
    *out_nv = next;
    *out_nf = nf;
    if (out_normals) accumulate_normals(out_verts, next, out_faces, nf, out_normals);
    if (profile_enabled())
      std::fprintf(stderr, "[decimate]   compact+out: %.1f ms\n", now_ms() - c0);
  }
};

}  // namespace

namespace {

// Area-weighted vertex normals with ``Mesh._compute_vertex_normal``
// semantics (face-cross scatter, zero-normal fallback +z, normalized);
// double accumulators match the numpy f64 bincount path.
void accumulate_normals(const float* verts, int64_t nv, const int32_t* faces,
                        int64_t nf, float* out_normals) {
  std::vector<double> acc(3 * (size_t)nv, 0.0);
  for (int64_t i = 0; i < nf; i++) {
    const int32_t* f = faces + 3 * i;
    Vec3 p0{verts[3 * f[0]], verts[3 * f[0] + 1], verts[3 * f[0] + 2]};
    Vec3 p1{verts[3 * f[1]], verts[3 * f[1] + 1], verts[3 * f[1] + 2]};
    Vec3 p2{verts[3 * f[2]], verts[3 * f[2] + 1], verts[3 * f[2] + 2]};
    Vec3 n = (p1 - p0).cross(p2 - p0);  // area-weighted (unnormalized)
    for (int j = 0; j < 3; j++) {
      acc[3 * (size_t)f[j]] += n.x;
      acc[3 * (size_t)f[j] + 1] += n.y;
      acc[3 * (size_t)f[j] + 2] += n.z;
    }
  }
  for (int64_t i = 0; i < nv; i++) {
    double nx = acc[3 * (size_t)i], ny = acc[3 * (size_t)i + 1],
           nz = acc[3 * (size_t)i + 2];
    double len2 = nx * nx + ny * ny + nz * nz;
    float* n = out_normals + 3 * i;
    if (len2 <= 1e-20) {
      n[0] = 0.0f; n[1] = 0.0f; n[2] = 1.0f;
    } else {
      double inv = 1.0 / std::sqrt(len2);
      n[0] = (float)(nx * inv);
      n[1] = (float)(ny * inv);
      n[2] = (float)(nz * inv);
    }
  }
}

}  // namespace

extern "C" {

// Standalone vertex normals (same semantics as the decimator's fused
// output): for paths that keep the mesh as-is (e.g. the snap-weld already
// hit the vertex budget) but still need normals without a numpy pass.
void mesh_vertex_normals(const float* verts, int64_t nv, const int32_t* faces,
                         int64_t nf, float* out_normals) {
  accumulate_normals(verts, nv, faces, nf, out_normals);
}

// Returns actual output counts via out_nv/out_nf. Output buffers must be
// sized for the input (decimation never grows the mesh).
// out_normals may be null; when given it receives area-weighted vertex
// normals of the output mesh (3 floats per output vertex).
void quadric_decimate(const float* verts, int64_t nv, const int32_t* faces,
                      int64_t nf, double target_ratio, double aggressiveness,
                      float* out_verts, int64_t* out_nv, int32_t* out_faces,
                      int64_t* out_nf, float* out_normals) {
  double e0 = now_ms();
  Simplifier s;
  s.vertices.resize(nv);
  for (int64_t i = 0; i < nv; i++) {
    s.vertices[i].p = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  }
  s.triangles.resize(nf);
  for (int64_t i = 0; i < nf; i++) {
    for (int j = 0; j < 3; j++) s.triangles[i].v[j] = faces[3 * i + j];
    s.triangles[i].deleted = false;
    s.triangles[i].dirty = false;
  }
  int target = (int)(nf * target_ratio);
  if (target < 4) target = 4;
  s.simplify(target, aggressiveness);
  s.compact_into(out_verts, out_nv, out_faces, out_nf, out_normals);
  if (profile_enabled())
    std::fprintf(stderr, "[decimate]   total C: %.1f ms\n", now_ms() - e0);
}

}  // extern "C"
