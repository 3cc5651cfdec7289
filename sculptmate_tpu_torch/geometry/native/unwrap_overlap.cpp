// UV-atlas overlap resolution: the role of the reference's closed-source
// uv_unwrapper.dll (assign_faces_uv_to_atlas_index, unwrap.py:144-175).
//
// For each cube-face slice: paint faces back-to-front into a max-depth
// buffer (conservative bbox coverage); a face stays primary if it wins the
// depth contest at its own centroid texel, is demoted to the overlap slice
// (+6) otherwise, and to the individual-squares pool (12) when occluded
// again. Sequential painter's loop -> host C++.
//
// Build: geometry/native/__init__.py (g++ -O3 -shared -fPIC, on first use).

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <numeric>
#include <vector>

extern "C" {

// face_uv: (nf, 3, 2) floats in [0,1] per slice-local frame
// depth:   (nf,) float, higher = closer to the cube face
// face_index: (nf,) int64 in 0..5 (cube face assignment)
// out: (nf,) int64 atlas index (0..5, +6 overlap, 12 leftovers)
void assign_faces_uv_to_atlas_index(
    const float* face_uv, const float* depth, const int64_t* face_index,
    int64_t nf, int32_t depth_res, int64_t* out) {
  const int R = depth_res;
  std::vector<float> buf_depth((size_t)R * R);
  std::vector<int64_t> buf_id((size_t)R * R);

  std::vector<int64_t> members;
  std::vector<int64_t> order;

  for (int64_t f = 0; f < nf; f++) out[f] = face_index[f];

  for (int g = 0; g < 6; g++) {
    members.clear();
    for (int64_t f = 0; f < nf; f++)
      if (face_index[f] == g) members.push_back(f);
    if (members.size() <= 1) continue;

    // two rounds: primary slice, then overlap slice
    for (int round = 0; round < 2; round++) {
      std::fill(buf_depth.begin(), buf_depth.end(), -1e30f);
      std::fill(buf_id.begin(), buf_id.end(), -1);

      order.assign(members.begin(), members.end());
      std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return depth[a] < depth[b];  // back to front
      });

      // depth tolerance: faces of the same surface patch sit at nearly the
      // same depth; only genuinely occluded faces (behind by > eps) demote
      float dmin = 1e30f, dmax = -1e30f;
      for (int64_t f : members) {
        dmin = std::min(dmin, depth[f]);
        dmax = std::max(dmax, depth[f]);
      }
      float eps = 0.02f * std::max(dmax - dmin, 1e-6f);

      for (int64_t f : order) {
        const float* uv = face_uv + 6 * f;
        float ax = uv[0] * R, ay = uv[1] * R;
        float bx = uv[2] * R, by = uv[3] * R;
        float cx = uv[4] * R, cy = uv[5] * R;
        float umin = std::min({ax, bx, cx}), umax = std::max({ax, bx, cx});
        float vmin = std::min({ay, by, cy}), vmax = std::max({ay, by, cy});
        int x0 = std::clamp((int)umin, 0, R - 1);
        int x1 = std::clamp((int)std::ceil(umax) + 1, 1, R);
        int y0 = std::clamp((int)vmin, 0, R - 1);
        int y1 = std::clamp((int)std::ceil(vmax) + 1, 1, R);
        float d = depth[f];
        float d1x = bx - ax, d1y = by - ay;
        float d2x = cx - ax, d2y = cy - ay;
        float det = d1x * d2y - d1y * d2x;
        float adet = std::fabs(det);
        for (int y = y0; y < y1; y++)
          for (int x = x0; x < x1; x++) {
            // exact point-in-triangle at the texel center (conservative
            // bbox painting spuriously occluded neighbors' centroids)
            float px = x + 0.5f - ax, py = y + 0.5f - ay;
            if (adet > 1e-12f) {
              float w1 = (px * d2y - py * d2x) / det;
              float w2 = (d1x * py - d1y * px) / det;
              if (w1 < -0.05f || w2 < -0.05f || w1 + w2 > 1.05f) continue;
            }
            size_t i = (size_t)y * R + x;
            if (buf_depth[i] < d) {
              buf_depth[i] = d;
              buf_id[i] = f;
            }
          }
      }

      std::vector<int64_t> losers;
      for (int64_t f : members) {
        const float* uv = face_uv + 6 * f;
        float cu = (uv[0] + uv[2] + uv[4]) / 3.0f;
        float cv = (uv[1] + uv[3] + uv[5]) / 3.0f;
        int x = std::clamp((int)(cu * R), 0, R - 1);
        int y = std::clamp((int)(cv * R), 0, R - 1);
        size_t i = (size_t)y * R + x;
        if (buf_id[i] != f && buf_depth[i] > depth[f] + eps) losers.push_back(f);
      }
      if (losers.empty()) break;
      for (int64_t f : losers) out[f] = (round == 0) ? g + 6 : 12;
      members = std::move(losers);
      if (round == 1) break;
    }
  }
}

}  // extern "C"
