// Host-side reconstruction of the marching-tetrahedra wire format.
//
// Counterpart of mc_wire.cpp for the SF3D path (geometry/marching_tets.py):
// the device ships the PADDED-lattice occupancy bitmask (Np^3 bits, Np =
// ceil(N/8)*8, z-minor little-endian) plus per-cut-edge DEFORMED vertex
// positions quantized to uint16 over [-1/res, 1 + 1/res] (positions depend on
// the learned vertex-offset field, so unlike MC's t they cannot be recomputed
// from occupancy alone). Faces and vertex ids are pure Freudenthal-table
// logic on the occupancy field, rebuilt here bit-parallel:
//
//   - 7 edge-class cut words (one XOR + shift per 64 lattice edges)
//   - vertex ids: popcount prefix sums per 8-bit segment in BLOCK-MAJOR
//     order (class, 8^3 block, in-block x/y/z) — order version 2, matching
//     the device's per-block-prefix numbering (_mt_vertex_side_wire);
//     ``mt_wire_order_version`` lets Python reject a stale binary
//   - cubes: a 64-cell activity word (any corner pair differs) from 8 corner
//     words; only set bits are visited; each active cube evaluates its 6
//     tets' 4-bit cases
//
// Tables (edge class/anchor per tet-edge slot, per-tet 16-case tri table)
// are passed in from Python (geometry/mt_tables.py) so this file holds no
// generated data. Conventions mirror marching_tets.py exactly.
//
// Build: geometry/native/__init__.py (g++ -O3 -shared -fPIC, on first use).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// the 7 edge direction classes, fixed order (mt_tables.EDGE_DIRS)
static const int DIRS[7][3] = {
    {1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

struct TGrid {
    int N;   // real lattice points per axis
    int Np;  // padded (multiple of 8)
    int nw;  // 64-bit words per z-row of the padded grid
    int ns;  // 8-bit segments per z-row (Np/8)
    std::vector<uint64_t> occ;
    std::vector<uint64_t> cut[7];
    // exclusive vid prefix per 8-z byte segment, scanned in BLOCK-MAJOR
    // order (class, block bi/bj/bk, in-block ox/oy; one segment per bk) —
    // matches the device's _mt_vertex_side_wire numbering (order version 2)
    std::vector<uint32_t> pre8[7];

    inline size_t w(int i, int j, int z) const {
        return ((size_t)i * Np + j) * nw + z;
    }
    inline size_t seg(int i, int j, int s) const {
        return ((size_t)i * Np + j) * ns + s;
    }
    inline uint8_t cut_byte(int d, int i, int j, int s) const {
        return (uint8_t)(cut[d][w(i, j, s >> 3)] >> ((s & 7) * 8));
    }
};

static void load_occ(TGrid &g, const uint8_t *occ_bytes) {
    const int row_bytes = g.Np / 8;
    g.occ.assign((size_t)g.Np * g.Np * g.nw, 0);
    for (int i = 0; i < g.Np; ++i)
        for (int j = 0; j < g.Np; ++j) {
            const uint8_t *src = occ_bytes + ((size_t)i * g.Np + j) * row_bytes;
            std::memcpy(&g.occ[g.w(i, j, 0)], src, row_bytes);
        }
}

static inline uint64_t shifted(const uint64_t *row, int z, int nw) {
    uint64_t v = row[z] >> 1;
    if (z + 1 < nw) v |= row[z + 1] << 63;
    return v;
}

// mask of word bits with z-bit index < lim
static inline uint64_t zmask(int z, int lim) {
    long rem = (long)lim - (long)z * 64;
    if (rem <= 0) return 0;
    if (rem >= 64) return ~0ull;
    return (~0ull) >> (64 - rem);
}

static void build_cuts(TGrid &g) {
    const int N = g.N, Np = g.Np, nw = g.nw;
    for (int d = 0; d < 7; ++d) g.cut[d].assign(g.occ.size(), 0);
    for (int d = 0; d < 7; ++d) {
        const int dx = DIRS[d][0], dy = DIRS[d][1], dz = DIRS[d][2];
        for (int i = 0; i < N - dx; ++i)
            for (int j = 0; j < N - dy; ++j) {
                const uint64_t *self = &g.occ[g.w(i, j, 0)];
                const uint64_t *nbr = &g.occ[g.w(i + dx, j + dy, 0)];
                for (int z = 0; z < nw; ++z) {
                    uint64_t other = dz ? shifted(nbr, z, nw) : nbr[z];
                    g.cut[d][g.w(i, j, z)] =
                        (self[z] ^ other) & zmask(z, N - dz);
                }
            }
    }
}

static uint32_t build_prefix(TGrid &g) {
    // block-major scan: (class, block bi/bj/bk, in-block ox/oy); each 8^3
    // block spans exactly one 8-bit z segment per (ox, oy) row
    const int nb = g.Np / 8;
    uint32_t run = 0;
    for (int d = 0; d < 7; ++d) {
        g.pre8[d].resize((size_t)g.Np * g.Np * g.ns);
        for (int bi = 0; bi < nb; ++bi)
            for (int bj = 0; bj < nb; ++bj)
                for (int bk = 0; bk < nb; ++bk)
                    for (int ox = 0; ox < 8; ++ox)
                        for (int oy = 0; oy < 8; ++oy) {
                            const int i = bi * 8 + ox, j = bj * 8 + oy;
                            g.pre8[d][g.seg(i, j, bk)] = run;
                            run += (uint32_t)__builtin_popcount(
                                g.cut_byte(d, i, j, bk));
                        }
    }
    return run;
}

static inline uint32_t vid_of(const TGrid &g, int d, int i, int j, int k) {
    const int s = k >> 3;
    uint8_t below = g.cut_byte(d, i, j, s) & (uint8_t)((1u << (k & 7)) - 1);
    return g.pre8[d][g.seg(i, j, s)] + (uint32_t)__builtin_popcount(below);
}

} // namespace

extern "C" {

// Vertex-numbering convention of this binary (must match the device wire
// packer): 1 = flat z-order, 2 = block-major. Python refuses a binary
// whose order version differs from its own.
int mt_wire_order_version(void) { return 2; }

// Count reconstructed faces (per-tet cases over active cubes).
// tri_count: (6*16,) int32. Returns -1 on bad arguments.
long long mt_wire_count_faces(const uint8_t *occ_bytes, int N, int Np,
                              const int32_t *tri_count) {
    if (Np % 8 != 0 || Np < N || N < 2) return -1;
    TGrid g;
    g.N = N; g.Np = Np; g.nw = (Np + 63) / 64; g.ns = Np / 8;
    load_occ(g, occ_bytes);

    long long nf = 0;
    const int nw = g.nw;
    for (int i = 0; i < N - 1; ++i)
        for (int j = 0; j < N - 1; ++j) {
            const uint64_t *r00 = &g.occ[g.w(i, j, 0)];
            const uint64_t *r10 = &g.occ[g.w(i + 1, j, 0)];
            const uint64_t *r01 = &g.occ[g.w(i, j + 1, 0)];
            const uint64_t *r11 = &g.occ[g.w(i + 1, j + 1, 0)];
            for (int z = 0; z < nw; ++z) {
                uint64_t c[8];
                c[0] = r00[z]; c[1] = r10[z]; c[2] = r01[z]; c[3] = r11[z];
                c[4] = shifted(r00, z, nw); c[5] = shifted(r10, z, nw);
                c[6] = shifted(r01, z, nw); c[7] = shifted(r11, z, nw);
                uint64_t any = 0, all = ~0ull;
                for (int q = 0; q < 8; ++q) { any |= c[q]; all &= c[q]; }
                uint64_t active = (any & ~all) & zmask(z, N - 1);
                while (active) {
                    int b = __builtin_ctzll(active);
                    active &= active - 1;
                    // corner bit layout: occ8 bit (ox + 2*oy + 4*oz); the
                    // per-tet corner mapping arrives appended after the 96
                    // tri counts: tri_count[96 + t*4 + v] = corner index
                    int occ8 = 0;
                    for (int q = 0; q < 8; ++q)
                        occ8 |= (int)((c[q] >> b) & 1) << q;
                    for (int t = 0; t < 6; ++t) {
                        int cs = 0;
                        for (int v = 0; v < 4; ++v) {
                            int corner = tri_count[96 + t * 4 + v];
                            cs |= ((occ8 >> corner) & 1) << v;
                        }
                        nf += tri_count[t * 16 + cs];
                    }
                }
            }
        }
    return nf;
}

// Rebuild the mesh. Positions arrive as 3x uint16 (lo||hi<<8) quantized over
// [-1/res, 1+1/res] in lattice-unit coordinates (res = N-1).
// Tables: tri_count (6*16 + 6*4,) int32 (counts ++ per-tet corner indices),
// tri_table (6*16*2*3,) int32 edge slots, edge_class (6*6,) int32,
// edge_anchor (6*6*3,) int32.
// weld: merge vertices whose quantized u16 position triples are identical
// (the device's snap_eps puts snapped vertices EXACTLY on the shared
// deformed lattice point, so the triples match bit-for-bit), drop the
// triangles that degenerate under the merge, and compact the surviving
// vertices. *out_nv receives the surviving vertex count (== nv when weld
// is 0 or out_nv is null and weld untaken).
// Returns faces written, -1 bad args, -2 vertex-count mismatch, -3 overflow.
static long long build_impl(
    const uint8_t *occ_bytes, int N, int Np,
    const uint8_t *px_lo, const uint8_t *px_hi,
    const uint8_t *py_lo, const uint8_t *py_hi,
    const uint8_t *pz_lo, const uint8_t *pz_hi,
    long long nv,
    const int32_t *tri_count, const int32_t *tri_table,
    const int32_t *edge_class, const int32_t *edge_anchor,
    long long max_out_faces,
    float *out_verts, int32_t *out_faces,
    int weld, long long *out_nv) {
    if (Np % 8 != 0 || Np < N || N < 2) return -1;
    TGrid g;
    g.N = N; g.Np = Np; g.nw = (Np + 63) / 64; g.ns = Np / 8;
    load_occ(g, occ_bytes);
    build_cuts(g);
    if ((long long)build_prefix(g) != nv) return -2;

    const float res = (float)(N - 1);
    const float lo = -1.0f / res;
    const float range = 1.0f + 2.0f / res;

    // -- vertices in BLOCK-MAJOR vid order --------------------------------
    // the position payload carries everything; the loop only needs to
    // count set bits in the same order the device numbered them
    long long v = 0;
    const int nb = g.Np / 8;
    for (int d = 0; d < 7; ++d)
        for (int bi = 0; bi < nb; ++bi)
            for (int bj = 0; bj < nb; ++bj)
                for (int bk = 0; bk < nb; ++bk)
                    for (int ox = 0; ox < 8; ++ox)
                        for (int oy = 0; oy < 8; ++oy) {
                            const int i = bi * 8 + ox, j = bj * 8 + oy;
                            int c = __builtin_popcount(
                                g.cut_byte(d, i, j, bk));
                            for (int q = 0; q < c; ++q) {
                                out_verts[3 * v + 0] =
                                    lo + range * (float)(px_lo[v] | (px_hi[v] << 8)) / 65535.0f;
                                out_verts[3 * v + 1] =
                                    lo + range * (float)(py_lo[v] | (py_hi[v] << 8)) / 65535.0f;
                                out_verts[3 * v + 2] =
                                    lo + range * (float)(pz_lo[v] | (pz_hi[v] << 8)) / 65535.0f;
                                ++v;
                            }
                        }
    if (v != nv) return -2;

    // -- weld map: vid -> first vid with the same quantized position -------
    std::vector<int32_t> remap;
    if (weld && nv > 0) {
        remap.resize((size_t)nv);
        size_t cap = 64;
        while (cap < (size_t)nv * 2) cap <<= 1;
        std::vector<int64_t> table(cap, -1);
        auto key_of = [&](long long q) -> uint64_t {
            uint64_t x = (uint64_t)(px_lo[q] | (px_hi[q] << 8));
            uint64_t y = (uint64_t)(py_lo[q] | (py_hi[q] << 8));
            uint64_t z = (uint64_t)(pz_lo[q] | (pz_hi[q] << 8));
            return x | (y << 16) | (z << 32);
        };
        auto mix = [](uint64_t k) {
            k ^= k >> 33; k *= 0xFF51AFD7ED558CCDull;
            k ^= k >> 33; k *= 0xC4CEB9FE1A85EC53ull;
            return k ^ (k >> 33);
        };
        for (long long q = 0; q < nv; ++q) {
            uint64_t key = key_of(q);
            size_t h = (size_t)mix(key) & (cap - 1);
            for (;;) {
                int64_t slot = table[h];
                if (slot < 0) { table[h] = q; remap[(size_t)q] = (int32_t)q; break; }
                if (key_of(slot) == key) { remap[(size_t)q] = remap[(size_t)slot]; break; }
                h = (h + 1) & (cap - 1);
            }
        }
    }

    // -- faces -------------------------------------------------------------
    long long nf = 0;
    const int nw = g.nw;
    for (int i = 0; i < N - 1; ++i)
        for (int j = 0; j < N - 1; ++j) {
            const uint64_t *r00 = &g.occ[g.w(i, j, 0)];
            const uint64_t *r10 = &g.occ[g.w(i + 1, j, 0)];
            const uint64_t *r01 = &g.occ[g.w(i, j + 1, 0)];
            const uint64_t *r11 = &g.occ[g.w(i + 1, j + 1, 0)];
            for (int z = 0; z < nw; ++z) {
                uint64_t c[8];
                c[0] = r00[z]; c[1] = r10[z]; c[2] = r01[z]; c[3] = r11[z];
                c[4] = shifted(r00, z, nw); c[5] = shifted(r10, z, nw);
                c[6] = shifted(r01, z, nw); c[7] = shifted(r11, z, nw);
                uint64_t any = 0, all = ~0ull;
                for (int q = 0; q < 8; ++q) { any |= c[q]; all &= c[q]; }
                uint64_t active = (any & ~all) & zmask(z, N - 1);
                while (active) {
                    int b = __builtin_ctzll(active);
                    active &= active - 1;
                    int k = z * 64 + b;
                    int occ8 = 0;
                    for (int q = 0; q < 8; ++q)
                        occ8 |= (int)((c[q] >> b) & 1) << q;
                    for (int t = 0; t < 6; ++t) {
                        int cs = 0;
                        for (int vtx = 0; vtx < 4; ++vtx) {
                            int corner = tri_count[96 + t * 4 + vtx];
                            cs |= ((occ8 >> corner) & 1) << vtx;
                        }
                        int nt = tri_count[t * 16 + cs];
                        for (int s = 0; s < nt; ++s) {
                            if (nf >= max_out_faces) return -3;
                            int32_t ids[3];
                            for (int cc = 0; cc < 3; ++cc) {
                                int se = tri_table[((t * 16 + cs) * 2 + s) * 3 + cc];
                                int dcl = edge_class[t * 6 + se];
                                int ai = i + edge_anchor[(t * 6 + se) * 3 + 0];
                                int aj = j + edge_anchor[(t * 6 + se) * 3 + 1];
                                int ak = k + edge_anchor[(t * 6 + se) * 3 + 2];
                                ids[cc] = (int32_t)vid_of(g, dcl, ai, aj, ak);
                            }
                            if (weld) {
                                ids[0] = remap[ids[0]];
                                ids[1] = remap[ids[1]];
                                ids[2] = remap[ids[2]];
                                if (ids[0] == ids[1] || ids[1] == ids[2] ||
                                    ids[0] == ids[2])
                                    continue;  // degenerate under the merge
                            }
                            out_faces[3 * nf + 0] = ids[0];
                            out_faces[3 * nf + 1] = ids[1];
                            out_faces[3 * nf + 2] = ids[2];
                            ++nf;
                        }
                    }
                }
            }
        }

    if (weld && nv > 0) {
        // -- compact: keep only face-referenced vertices, renumber in vid
        // order (monotone => in-place forward move is safe) ----------------
        std::vector<uint8_t> used((size_t)nv, 0);
        for (long long f = 0; f < 3 * nf; ++f) used[(size_t)out_faces[f]] = 1;
        std::vector<int32_t> newid((size_t)nv);
        int32_t next = 0;
        for (long long q = 0; q < nv; ++q) {
            newid[(size_t)q] = next;
            if (used[(size_t)q]) {
                out_verts[3 * next + 0] = out_verts[3 * q + 0];
                out_verts[3 * next + 1] = out_verts[3 * q + 1];
                out_verts[3 * next + 2] = out_verts[3 * q + 2];
                ++next;
            }
        }
        for (long long f = 0; f < 3 * nf; ++f)
            out_faces[f] = newid[(size_t)out_faces[f]];
        if (out_nv) *out_nv = next;
    } else if (out_nv) {
        *out_nv = nv;
    }
    return nf;
}

long long mt_wire_build(
    const uint8_t *occ_bytes, int N, int Np,
    const uint8_t *px_lo, const uint8_t *px_hi,
    const uint8_t *py_lo, const uint8_t *py_hi,
    const uint8_t *pz_lo, const uint8_t *pz_hi,
    long long nv,
    const int32_t *tri_count, const int32_t *tri_table,
    const int32_t *edge_class, const int32_t *edge_anchor,
    long long max_out_faces,
    float *out_verts, int32_t *out_faces) {
    return build_impl(occ_bytes, N, Np, px_lo, px_hi, py_lo, py_hi, pz_lo,
                      pz_hi, nv, tri_count, tri_table, edge_class, edge_anchor,
                      max_out_faces, out_verts, out_faces, 0, nullptr);
}

// Welding variant (see build_impl). *out_nv receives the compacted vertex
// count; the returned face count excludes degenerate (welded-away) faces.
long long mt_wire_build_weld(
    const uint8_t *occ_bytes, int N, int Np,
    const uint8_t *px_lo, const uint8_t *px_hi,
    const uint8_t *py_lo, const uint8_t *py_hi,
    const uint8_t *pz_lo, const uint8_t *pz_hi,
    long long nv,
    const int32_t *tri_count, const int32_t *tri_table,
    const int32_t *edge_class, const int32_t *edge_anchor,
    long long max_out_faces,
    float *out_verts, int32_t *out_faces, long long *out_nv) {
    return build_impl(occ_bytes, N, Np, px_lo, px_hi, py_lo, py_hi, pz_lo,
                      pz_hi, nv, tri_count, tri_table, edge_class, edge_anchor,
                      max_out_faces, out_verts, out_faces, 1, out_nv);
}

} // extern "C"
