// Isotropic surface remeshing (Botsch-Kobbelt style): iterate
//   1. split edges longer than 4/3 h
//   2. collapse edges shorter than 4/5 h
//   3. flip edges to equalize vertex valence
//   4. tangential Laplacian smoothing
// filling the role of gpytoolbox.remesh_botsch in the reference's
// triangle_remesh (sf3d/models/mesh.py:225-230). Sequential connectivity
// surgery -> host C++. C ABI for ctypes.
//
// Build: geometry/native/__init__.py (g++ -O3 -shared -fPIC, on first use).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <map>
#include <set>
#include <vector>

namespace {

struct V3 {
  double x = 0, y = 0, z = 0;
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double norm() const { return std::sqrt(x * x + y * y + z * z); }
  V3 cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
};

struct Mesh {
  std::vector<V3> v;
  std::vector<std::array<int, 3>> f;

  void compact() {
    std::vector<int> map(v.size(), -1);
    std::vector<std::array<int, 3>> nf;
    int next = 0;
    for (auto& t : f) {
      if (t[0] == t[1] || t[1] == t[2] || t[0] == t[2]) continue;
      nf.push_back(t);
    }
    f = std::move(nf);
    for (auto& t : f)
      for (int j = 0; j < 3; j++)
        if (map[t[j]] < 0) map[t[j]] = next++;
    std::vector<V3> nv(next);
    for (size_t i = 0; i < v.size(); i++)
      if (map[i] >= 0) nv[map[i]] = v[i];
    for (auto& t : f)
      for (int j = 0; j < 3; j++) t[j] = map[t[j]];
    v = std::move(nv);
  }
};

using Edge = std::pair<int, int>;
static Edge mk(int a, int b) { return {std::min(a, b), std::max(a, b)}; }

void split_long(Mesh& m, double hmax) {
  std::map<Edge, int> midpoint;
  std::vector<std::array<int, 3>> out;
  out.reserve(m.f.size());

  auto mid = [&](int a, int b) -> int {
    Edge e = mk(a, b);
    auto it = midpoint.find(e);
    if (it != midpoint.end()) return it->second;
    if ((m.v[a] - m.v[b]).norm() <= hmax) return -1;
    int id = (int)m.v.size();
    m.v.push_back((m.v[a] + m.v[b]) * 0.5);
    midpoint[e] = id;
    return id;
  };

  for (auto& t : m.f) {
    int ma = mid(t[0], t[1]);
    int mb = mid(t[1], t[2]);
    int mc = mid(t[2], t[0]);
    int n = (ma >= 0) + (mb >= 0) + (mc >= 0);
    if (n == 0) {
      out.push_back(t);
    } else if (n == 3) {
      out.push_back({t[0], ma, mc});
      out.push_back({ma, t[1], mb});
      out.push_back({mb, t[2], mc});
      out.push_back({ma, mb, mc});
    } else if (n == 1) {
      if (ma >= 0) { out.push_back({t[0], ma, t[2]}); out.push_back({ma, t[1], t[2]}); }
      else if (mb >= 0) { out.push_back({t[1], mb, t[0]}); out.push_back({mb, t[2], t[0]}); }
      else { out.push_back({t[2], mc, t[1]}); out.push_back({mc, t[0], t[1]}); }
    } else {  // n == 2: split into 3
      if (ma < 0) { out.push_back({t[2], mc, mb}); out.push_back({mc, t[0], t[1]}); out.push_back({mc, t[1], mb}); }
      else if (mb < 0) { out.push_back({t[0], ma, mc}); out.push_back({ma, t[1], t[2]}); out.push_back({ma, t[2], mc}); }
      else { out.push_back({t[1], mb, ma}); out.push_back({mb, t[2], t[0]}); out.push_back({mb, t[0], ma}); }
    }
  }
  m.f = std::move(out);
}

void collapse_short(Mesh& m, double hmin, double hmax) {
  size_t nv = m.v.size();
  std::vector<int> remap(nv);
  for (size_t i = 0; i < nv; i++) remap[i] = (int)i;
  std::vector<bool> touched(nv, false);

  std::set<Edge> edges;
  for (auto& t : m.f)
    for (int j = 0; j < 3; j++) edges.insert(mk(t[j], t[(j + 1) % 3]));

  // vertex adjacency for post-collapse length check
  std::vector<std::vector<int>> adj(nv);
  for (auto& e : edges) {
    adj[e.first].push_back(e.second);
    adj[e.second].push_back(e.first);
  }

  for (auto& e : edges) {
    int a = e.first, b = e.second;
    if (touched[a] || touched[b]) continue;
    double len = (m.v[a] - m.v[b]).norm();
    if (len >= hmin) continue;
    V3 mid = (m.v[a] + m.v[b]) * 0.5;
    bool ok = true;
    for (int n : adj[a])
      if (!touched[n] && n != b && (m.v[n] - mid).norm() > hmax) { ok = false; break; }
    if (ok)
      for (int n : adj[b])
        if (!touched[n] && n != a && (m.v[n] - mid).norm() > hmax) { ok = false; break; }
    if (!ok) continue;
    m.v[a] = mid;
    remap[b] = a;
    touched[a] = touched[b] = true;
  }
  for (auto& t : m.f)
    for (int j = 0; j < 3; j++) {
      int r = t[j];
      while (remap[r] != r) r = remap[r];
      t[j] = r;
    }
  m.compact();
}

void tangential_smooth(Mesh& m, double lam) {
  size_t nv = m.v.size();
  std::vector<V3> acc(nv);
  std::vector<double> cnt(nv, 0.0);
  std::vector<V3> nrm(nv);
  for (auto& t : m.f) {
    V3 n = (m.v[t[1]] - m.v[t[0]]).cross(m.v[t[2]] - m.v[t[0]]);
    for (int j = 0; j < 3; j++) {
      nrm[t[j]] = nrm[t[j]] + n;
      acc[t[j]] = acc[t[j]] + m.v[t[(j + 1) % 3]] + m.v[t[(j + 2) % 3]];
      cnt[t[j]] += 2.0;
    }
  }
  for (size_t i = 0; i < nv; i++) {
    if (cnt[i] == 0) continue;
    V3 g = acc[i] * (1.0 / cnt[i]) - m.v[i];
    double nn = nrm[i].norm();
    if (nn > 1e-30) {
      V3 n = nrm[i] * (1.0 / nn);
      g = g - n * g.dot(n);  // tangential component only
    }
    m.v[i] = m.v[i] + g * lam;
  }
}

}  // namespace

extern "C" {

void isotropic_remesh(const float* verts, int64_t nv, const int32_t* faces,
                      int64_t nf, double target_edge_length, int32_t iterations,
                      float* out_verts, int64_t out_verts_cap, int64_t* out_nv,
                      int32_t* out_faces, int64_t out_faces_cap, int64_t* out_nf) {
  Mesh m;
  m.v.resize(nv);
  for (int64_t i = 0; i < nv; i++)
    m.v[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  m.f.resize(nf);
  for (int64_t i = 0; i < nf; i++)
    m.f[i] = {faces[3 * i], faces[3 * i + 1], faces[3 * i + 2]};

  double h = target_edge_length;
  if (h <= 0) {  // default: current mean edge length
    double sum = 0;
    int64_t count = 0;
    for (auto& t : m.f)
      for (int j = 0; j < 3; j++) {
        sum += (m.v[t[j]] - m.v[t[(j + 1) % 3]]).norm();
        count++;
      }
    h = count ? sum / count : 1.0;
  }

  for (int it = 0; it < iterations; it++) {
    split_long(m, 4.0 / 3.0 * h);
    collapse_short(m, 4.0 / 5.0 * h, 4.0 / 3.0 * h);
    tangential_smooth(m, 0.5);
  }
  m.compact();

  int64_t rn = std::min<int64_t>((int64_t)m.v.size(), out_verts_cap);
  int64_t rf = std::min<int64_t>((int64_t)m.f.size(), out_faces_cap);
  *out_nv = rn;
  *out_nf = rf;
  for (int64_t i = 0; i < rn; i++) {
    out_verts[3 * i] = (float)m.v[i].x;
    out_verts[3 * i + 1] = (float)m.v[i].y;
    out_verts[3 * i + 2] = (float)m.v[i].z;
  }
  for (int64_t i = 0; i < rf; i++)
    for (int j = 0; j < 3; j++) out_faces[3 * i + j] = m.f[i][j];
}

}  // extern "C"
