"""Kernels of one version of the port at the main paths' shapes, on one
card: K3, K4 and K10 on the Lean asset, K5 at SF3D's 161^3 lattice, K6,
K7, K8, K9 and K11 on the full-width SF3D asset, K12 at the add-on's
frontend shapes, and design variants.

    python3 scripts/kernel_compare.py [--root DIR] [--kernels K3,K4,K5,K6,K7,K8,K9,K10,K11,K12]
                                      [--csrc DIR] [--variants]

Imports ``sculptmate_tpu_torch`` from ``--root`` (default: this checkout;
point it at an unpacked older commit to compare two versions in one call)
and the checks of this checkout's ``chip_smoke.py``. ``--csrc`` builds the
kernels from another directory of sources (a copy of ``csrc/`` with one
design step taken out, say). For each kernel asked for it prints the
``chip_smoke.py`` check lines (times, the plain version's, bounds) and its
split by kernel name under torch.profiler (``chip_smoke.device_split``):

- K3 (``check_mc_wire``, ``K3_split``) and K10 (``check_marching_cubes``,
  ``K10_split``) on the default ``TSR``'s (seed 0) Lean asset, as
  ``chip_smoke.lean_scene`` makes it; K4 (``check_triplane_points``) there
  too, per Lean asset (wire vertices) and per render view (8.39 M samples);
- K5 (``check_grid_multihead``, ``K5_split``: one ``SF3D.query_lattice``,
  the ``sf3d.grid`` span, with its launches) with the default ``SF3D``'s
  (seed 0) heads, on random codes. A tree whose ``grid_multihead`` packs
  the weights inside each call is timed on the same launch with the
  weights packed before (``kernel_alone_shim``), so ``ms`` is the kernel
  alone on both trees;
- K6 (``check_points``: 512^2 points of random codes with the default
  ``SF3D``'s (seed 0) features and perturb-normal heads, and the asset's
  512^2 bake texels with its codes; ``K6_split``: one
  ``SF3D._surface_query``, the ``sf3d.texel_query`` span, with its
  launches), K7 (``check_mt_wire``, ``K7_split``: its 161^3 sdf and
  offsets), K8 (``check_raster``: the bake at 512^2, the two unwrap
  rasters at 1024^2 and a ragged 100^2; ``K8_split``: one bake raster)
  K9 (``check_unwrap``, ``K9_split``: one ``unwrap_core`` with every
  launch and copy of the call) and K11 (``check_marching_tets``,
  ``K11_split``: its 161^3 sdf and offsets) on the default ``SF3D``'s asset as
  ``chip_smoke.sf3d_scene`` makes it. A tree without K6's one-pass planes relayout is timed on its
  own two-pass relayout (``planes_relayout_shim``);
- K12 (``check_pil_resample``): its four steps at the add-on's shapes
  beside their plain versions and byte bounds, and ``preprocess_image`` on
  a 1024^2 photo with the full u2net (seed 0), card path against host path
  (bytes, launch counts, host ms a request);
- with ``--variants``, kernels rebuilt (``kernels.sources_from``) from
  copies of this checkout's sources with edits (``edit_copy``; a CPU test
  checks that every edit still applies), each held to its plain version:
  one ``k4_step`` line per design step of K4 on the render view
  (``K4_STEPS``: the later steps taken out again; ``wgmma``: f32 taps, SiLU
  as an exp and a divide, a ring of two slots handed back only after a
  pair's last layer, so a warpgroup's next pair is gathered only once its
  own products are done; ``+ overlapped gather``: four slots handed back
  after the first layer; ``+ tanh SiLU``; ``+ bf16 taps``, the kernel as it
  is), one ``k4_variant`` line per variant of K4 on the render view
  (``K4_VARIANTS``: one side of the hand-over idle, other numbers of
  warpgroups or loads at once) and one ``k10_variant`` line per variant of
  K10 at 256^3 (``K10_VARIANTS``: more blocks per SM, and the face pass
  recomputing each cell's case from the level in place of reading the
  classify pass's case byte), one ``k6_variant`` line per variant of K6
  (``K6_VARIANTS``: one side of its hand-over idle; at the scattered
  points and at the asset's texels) and one ``k7_variant`` line per
  variant of K7 (``K7_VARIANTS``: the count loading its halo two blocks
  ahead) and one ``k11_variant`` line per variant of K11 (``K11_VARIANTS``:
  its face pass in blocks of 512, its classify at more resident blocks, and
  the rows past the counts zeroed by two fills over the whole capacity in
  place of its tail pass).

``--time-only`` times K5 alone whatever its output (``k5_time``), for a
``--csrc`` copy that is wrong by design: one side of the ring idle, the
SiLU or the stores left out, which split the kernel's time.

Needs a CUDA card. Parent and change in turns, in one process each on
the same card: ``for r in _archive/parent . . _archive/parent; do python3
scripts/kernel_compare.py --root $r --kernels K3,K5; done``.
"""

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def setting(name, value):
    """An edit to triplane_points.cu that sets one of its constants."""
    def edit(src):
        out, n = re.subn(rf"constexpr (int|bool) {name} = [^;]+;", rf"constexpr \1 {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"constant {name} is not once in triplane_points.cu")
        return out
    return ("triplane_points.cu", edit)


def text(name, old, new):
    """An edit that replaces text found once in csrc/<name>."""
    def edit(src):
        if src.count(old) != 1:
            raise RuntimeError(f"edit text is not once in {name}")
        return src.replace(old, new)
    return (name, edit)


# (step, edits, f32 taps): each step's edits to take the later steps out of
# the sources again
EXACT_SILU = text(
    "hopper.cuh",
    """    uint32_t t, r;
    asm("tanh.approx.bf16x2 %0, %1;\\n" : "=r"(t) : "r"(h));
    asm("fma.rn.bf16x2 %0, %1, %2, %1;\\n" : "=r"(r) : "r"(h), "r"(t));
    return r;""",
    """    const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162 *>(&h);
    const float x0 = 2.f * __low2float(hv), x1 = 2.f * __high2float(hv);
    return pack_bf16(__fdiv_rn(x0, 1.f + __expf(-x0)), __fdiv_rn(x1, 1.f + __expf(-x1)));""",
)
LATE_RELEASE = [
    setting("NSTAGE", 2),
    text("triplane_points.cu", "            if (l == 0) mbar_arrive(empty + 8 * s);\n", ""),
    text("triplane_points.cu",
         "        store_tile(out, q * PAIR + TP, o1, bs + OUT_BIAS, density_bias, N, warp, g, c);\n",
         "        store_tile(out, q * PAIR + TP, o1, bs + OUT_BIAS, density_bias, N, warp, g, c);\n"
         "        mbar_arrive(empty + 8 * s);\n"),
]
K10_VARIANTS = [
    ("as it is", []),
    ("classify and face passes at 4 blocks of 512 per SM (32 registers)", [
        text("marching_cubes.cu", "__global__ void __launch_bounds__(CELLS) mc_classify(",
             "__global__ void __launch_bounds__(CELLS, 4) mc_classify("),
        text("marching_cubes.cu", "__global__ void __launch_bounds__(CELLS) mc_faces(",
             "__global__ void __launch_bounds__(CELLS, 4) mc_faces("),
    ]),
    ("classify and face passes at 3 blocks of 512 per SM (40 registers)", [
        text("marching_cubes.cu", "__global__ void __launch_bounds__(CELLS) mc_classify(",
             "__global__ void __launch_bounds__(CELLS, 3) mc_classify("),
        text("marching_cubes.cu", "__global__ void __launch_bounds__(CELLS) mc_faces(",
             "__global__ void __launch_bounds__(CELLS, 3) mc_faces("),
    ]),
    ("face pass recomputes the case from the level (no case bytes)", [
        text("marching_cubes.cu", "        cases[(size_t)blk * CELLS + t] = (uint8_t)cs;\n", ""),
        text("marching_cubes.cu", "mc_faces<<<fgrid, CELLS, smem, st>>>(static_cast<const uint8_t *>(cases),",
             "mc_faces<<<fgrid, CELLS, smem, st>>>(reinterpret_cast<const uint8_t *>(lv),"),
        text("marching_cubes.cu", "        const int cs = cases[(size_t)blk * CELLS + t], ntri = tab[cs];\n",
             "        const float *lvr = reinterpret_cast<const float *>(cases);\n"
             "        const size_t p = ((size_t)i * RY + j) * RZ + k;\n"
             "        int cs = 0;\n"
             "        if (i + 1 < RX && j + 1 < RY && k + 1 < RZ)\n"
             "            for (int c = 0; c < 8; ++c)\n"
             "                cs |= (lvr[p + ((c & 1) ? (size_t)RY * RZ : 0) + (((c >> 1) & 1) ? RZ : 0) + ((c >> 2) & 1)]"
             " > 0.f) << c;\n"
             "        const int ntri = tab[cs];\n"),
    ]),
]
K4_STEPS = [
    ("wgmma", [EXACT_SILU] + LATE_RELEASE, True),
    ("+ overlapped gather", [EXACT_SILU], True),
    ("+ tanh SiLU", [], True),
    ("+ bf16 taps", [], False),
]
# what holds K4 back: the kernel as it is, with one side of the hand-over
# idle (its output is wrong, only its time counts), and with other numbers
# of producer and consumer warpgroups
PRODUCERS_ALONE = text("triplane_points.cu", "        mbar_wait(full + 8 * s, (uint32_t)((n / NSTAGE) & 1));\n",
                       "        mbar_wait(full + 8 * s, (uint32_t)((n / NSTAGE) & 1));\n"
                       "        if (N > 0) {\n            mbar_arrive(empty + 8 * s);\n            continue;\n"
                       "        }\n")
CONSUMERS_ALONE = text("triplane_points.cu", "        if (p < N) {\n", "        if (p < 0) {\n")
K4_VARIANTS = [
    ("as it is", []),
    ("producers alone", [PRODUCERS_ALONE]),
    ("consumers alone", [CONSUMERS_ALONE]),
    ("bf16 taps one chunk at a time", [setting("GATHER_CHUNKS", 1)]),
    ("bf16 taps three chunks at a time", [setting("GATHER_CHUNKS", 3)]),
    ("1 producer, 2 consumer warpgroups", [setting("PRODUCERS", 1), setting("PRODUCER_REGS", 56)]),
    ("1 producer, 3 consumer warpgroups", [setting("PRODUCERS", 1), setting("CONSUMERS", 3), setting("NSTAGE", 3),
                                            setting("PRODUCER_REGS", 56)]),
    ("1 producer, 3 consumer warpgroups: consumers alone",
     [setting("PRODUCERS", 1), setting("CONSUMERS", 3), setting("NSTAGE", 3), setting("PRODUCER_REGS", 56),
      CONSUMERS_ALONE]),
]

# what holds K6 back: the kernel as it is, and with one side of the hand-over
# idle (its output is wrong, only its time counts)
K6_VARIANTS = [
    ("as it is", []),
    ("producers alone", [text("points_multihead.cu",
                              "        mbar_wait(full + 8 * s, (uint32_t)((n / NSTAGE) & 1));\n",
                              "        mbar_wait(full + 8 * s, (uint32_t)((n / NSTAGE) & 1));\n"
                              "        if (N > 0) {\n            mbar_arrive(empty + 8 * s);\n            continue;\n"
                              "        }\n")]),
    ("consumers alone", [text("points_multihead.cu", "        if (p < N) {\n", "        if (p < 0) {\n")]),
]
# K7's count pass loading each block's halo two blocks ahead in place of one
K7_VARIANTS = [
    ("as it is", []),
    ("count loads its halo two blocks ahead", [
        text("marching_tets.cu", "    float next[HALO_LOADS];\n    load(0, next);\n",
             "    float ahead[2][HALO_LOADS];\n    load(0, ahead[0]);\n    if (nb > 1) load(1, ahead[1]);\n"),
        text("marching_tets.cu", "(next[r] > 0.f ? INSIDE : OUTSIDE)",
             "(((bz & 1) ? ahead[1][r] : ahead[0][r]) > 0.f ? INSIDE : OUTSIDE)"),
        text("marching_tets.cu", "        if (bz + 1 < nb) load(bz + 1, next);\n",
             "        if (bz + 2 < nb) {\n            if (bz & 1) load(bz + 2, ahead[1]);\n"
             "            else load(bz + 2, ahead[0]);\n        }\n"),
    ]),
]
# the staging of a K11 face block's words in shared memory: rows bi .. bi + 8
# and bj .. bj + 8 of each class, and along z the word of bk and, where bk +
# 8 starts the next one, that word
STAGE_WORDS = """        unsigned bits[STAGE_LOADS];
        int base[STAGE_LOADS];
#pragma unroll
        for (int q = 0; q < STAGE_LOADS; ++q) {
            const int e = t + q * FACE_THREADS, r = e >> 1;
            const int ly = r % HALO, lx = (r / HALO) % HALO, c = r / (HALO * HALO);
            const int w = (bk >> 5) + (e & 1);
            bits[q] = 0u;
            base[q] = 0;
            if (e < STAGED && bi + lx < Np && bj + ly < Np && w < nwords && ((e & 1) == 0 || (bk & 31) + BS == 32)) {
                const int g = ((c * Np + bi + lx) * Np + bj + ly) * nwords + w;
                bits[q] = cutbits[g];
                base[q] = word_base[g];
            }
        }
#pragma unroll
        for (int q = 0; q < STAGE_LOADS; ++q)
            if (t + q * FACE_THREADS < STAGED) {
                sbits[t + q * FACE_THREADS] = bits[q];
                sbase[t + q * FACE_THREADS] = base[q];
            }
"""
FIRST_FACES = "        // the cubes' first faces: a scan of the threads' triangle counts,\n"
# K11's face pass in blocks of 512 threads (a cube each, as its first
# version) and of 128, and staging its words in shared memory; its classify
# and vertex passes at more resident blocks (32 registers); and its rows
# past the counts zeroed by two fills over the whole capacity before the
# launch (as the kernel's callers did before its tail pass) in place of the
# tail pass: (variant, edits, fills)
K11_VARIANTS = [
    ("as it is", [], False),
    ("face pass in blocks of 512 threads", [
        text("marching_tets.cu", "constexpr int FACE_THREADS = 256;", "constexpr int FACE_THREADS = 512;"),
    ], False),
    ("face pass in blocks of 128 threads", [
        text("marching_tets.cu", "constexpr int FACE_THREADS = 256;", "constexpr int FACE_THREADS = 128;"),
    ], False),
    ("classify at 4 blocks of 512 per SM (32 registers)", [
        text("marching_tets.cu", "__global__ void __launch_bounds__(CELLS) mt_classify(",
             "__global__ void __launch_bounds__(CELLS, 4) mt_classify("),
    ], False),
    ("vertex pass at 8 blocks of 256 per SM (32 registers)", [
        text("marching_tets.cu", "__global__ void __launch_bounds__(K11_VERT_THREADS) mt_verts(",
             "__global__ void __launch_bounds__(K11_VERT_THREADS, 8) mt_verts("),
    ], False),
    ("two fills over the whole capacity in place of the tail pass", [
        text("marching_tets.cu", "    mt_tails<<<tgrid, TAIL_THREADS, 0, st>>>(",
             "    if (0) mt_tails<<<tgrid, TAIL_THREADS, 0, st>>>("),
    ], True),
    ("face pass staging its corners' words in shared memory (7 x 9 x 9 rows)", [
        text("marching_tets.cu", "    __shared__ int first[CELLS];",
             "    constexpr int STAGED = NCLS * HALO * HALO * 2;\n"
             "    constexpr int STAGE_LOADS = (STAGED + FACE_THREADS - 1) / FACE_THREADS;\n"
             "    __shared__ unsigned sbits[STAGED];\n    __shared__ int sbase[STAGED];\n"
             "    __shared__ int first[CELLS];"),
        text("marching_tets.cu", FIRST_FACES, STAGE_WORDS + FIRST_FACES),
        text("marching_tets.cu", "const int g = ((cls * Np + i) * Np + j) * nwords + (k >> 5);",
             "const int g = ((cls * HALO + i - bi) * HALO + j - bj) * 2 + (k >> 5) - (bk >> 5);"),
        text("marching_tets.cu", "= word_base[g] + __popc(cutbits[g]", "= sbase[g] + __popc(sbits[g]"),
    ], False),
    # wrong by design, for its time alone: the vertices without the offsets'
    # tanh
    ("vertex pass without the offsets' tanh (time only)", [
        text("marching_tets.cu",
             "const float c0 = deformed(idx0[a], offs[a], p0, inv_res), c1 = deformed(idx1[a], offs[a], p1, inv_res);",
             "const float c0 = offs[a][p0], c1 = offs[a][p1];"),
    ], False),
]


def edit_copy(csrc, edits, dst):
    """A copy of the kernel sources in ``csrc`` at ``dst``, with each
    (file, edit) of ``edits`` applied in order."""
    shutil.copytree(csrc, dst, ignore=shutil.ignore_patterns("_build"))
    for name, edit in edits:
        path = os.path.join(dst, name)
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(edit(src))


def k4_steps(smoke, tsr, lean, steps, key):
    import torch

    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.runtime import kernels

    g = torch.Generator(device="cuda").manual_seed(4)  # check_triplane_points' inputs
    weights = [(smoke.K4_WEIGHT_GAIN * w, smoke.K5_BIAS_STD * torch.randn(b.shape, device="cuda", generator=g))
               for w, b in tsr.decoder_weights()]
    spec = tsr.grid_spec(2, torch.bfloat16)
    codes = torch.randn(3, tsr.config.upsample_out_channels, 64, 64, device="cuda", generator=g).to(torch.bfloat16)
    pts = lean["render_pts"]
    ref = dg.triplane_points_plain(codes, weights, *pts, spec)
    ref = torch.cat([ref[:1], ref[1:2].log(), ref[2:]])
    limits = [smoke.K4_SPREAD_SHARE * (ref[k] - ref[k].mean()).abs().max().item() for k in range(5)]
    _, W, bias = dg.pack_triplane_inputs(codes, weights)
    root = os.path.join(kernels.BUILD_DIR, key)
    shutil.rmtree(root, ignore_errors=True)
    for i, (step, edits, f32_taps) in enumerate(steps):
        csrc = os.path.join(root, str(i))
        edit_copy(kernels.CSRC, edits, csrc)
        planes = codes.float() if f32_taps else codes
        packed = (dg.pack_triplane_planes(planes), W, bias)
        with kernels.sources_from(csrc):
            out = dg.triplane_points(codes, weights, *pts, spec, packed=packed)
            got = torch.cat([out[:1], out[1:2].log(), out[2:]])
            errs = [(got[k] - ref[k]).abs().max().item() for k in range(5)]
            ok = all(e <= lim for e, lim in zip(errs, limits)) and bool(torch.isfinite(out).all())
            ms = smoke.cuda_ms(lambda: dg.triplane_points(codes, weights, *pts, spec, packed=packed), iters=5)
            spills = [line.strip() for line in kernels.ptxas_report("triplane_points").splitlines()
                      if re.search(r"[1-9]\d* bytes spill", line)]
        print(json.dumps({key: step, "points": pts[0].numel(), "taps": "f32" if f32_taps else "bf16",
                          "ms": ms, "max_abs_err_per_output": errs, "limit_per_output": limits,
                          "check_passed": ok, "ptxas_spills": spills}), flush=True)


def k10_variants(smoke, lean):
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.runtime import kernels

    level = lean["level"]
    ref = mc.marching_cubes_plain(level, 1 << 20, 1 << 21)
    root = os.path.join(kernels.BUILD_DIR, "k10_variants")
    shutil.rmtree(root, ignore_errors=True)
    for i, (variant, edits) in enumerate(K10_VARIANTS):
        csrc = os.path.join(root, str(i))
        edit_copy(kernels.CSRC, edits, csrc)
        with kernels.sources_from(csrc):
            got = mc.marching_cubes(level, 1 << 20, 1 << 21)
            differ = sum(int((getattr(got, k) != getattr(ref, k)).sum()) for k in mc.MCResult._fields[:10])
            ms = smoke.cuda_ms(lambda: mc.marching_cubes(level, 1 << 20, 1 << 21), iters=10)
            split = smoke.k10_split(lean)
            spills = [line.strip() for line in kernels.ptxas_report("marching_cubes").splitlines()
                      if re.search(r"[1-9]\d* bytes spill", line)]
        print(json.dumps({"k10_variant": variant, "ms": ms, "entries_differing": differ,
                          "split_ms": split["kernels_ms"], "ptxas_spills": spills}), flush=True)


def k6_variants(smoke, sf3d, scene):
    """K6 rebuilt from each of K6_VARIANTS: its time alone at
    ``check_points``' 262 144 scattered points (N(0, K5_BIAS_STD) biases)
    and at the asset's bake texels with the model's heads, and its largest
    error against the plain version at the scattered points."""
    import torch

    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.runtime import kernels

    g = torch.Generator(device="cuda").manual_seed(0)  # check_points' inputs
    heads = [[(w, smoke.K5_BIAS_STD * torch.randn(b.shape, device="cuda", generator=g)) for w, b in layers]
             for layers in sf3d.texel_head_weights().values()]
    spec = sf3d.grid_spec(torch.bfloat16)
    codes = torch.randn(3, sf3d.config.upsample_out_channels, 384, 384, device="cuda", generator=g).to(torch.bfloat16)
    pts = [(torch.rand(512 * 512, device="cuda", generator=g) * 2 - 1) * spec.radius for _ in range(3)]
    texels, main_codes = scene["texels"], scene["codes"][0]
    main_heads = list(sf3d.texel_head_weights().values())
    ref = dg.points_multihead_plain(codes, heads, *pts, spec)
    root = os.path.join(kernels.BUILD_DIR, "k6_variants")
    shutil.rmtree(root, ignore_errors=True)
    for i, (variant, edits) in enumerate(K6_VARIANTS):
        csrc = os.path.join(root, str(i))
        edit_copy(kernels.CSRC, edits, csrc)
        with kernels.sources_from(csrc):
            packed = dg.pack_points_inputs(codes, heads)
            packed_main = dg.pack_points_inputs(main_codes, main_heads)
            err = (dg.points_multihead(codes, heads, *pts, spec, packed=packed) - ref).abs().max().item()
            ms = smoke.cuda_ms(lambda: dg.points_multihead(codes, heads, *pts, spec, packed=packed), iters=10)
            ms_texels = smoke.cuda_ms(
                lambda: dg.points_multihead(main_codes, main_heads, *texels, spec, packed=packed_main), iters=10)
        print(json.dumps({"k6_variant": variant, "ms": ms, "asset_texels_ms": ms_texels, "max_abs_err": err}),
              flush=True)


def k7_variants(smoke, scene):
    """K7 rebuilt from each of K7_VARIANTS: its time and split at the
    asset's 161^3 lattice (snap_eps 0.2), and whether its wire equals the
    plain version's."""
    import torch

    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.runtime import kernels

    inputs, res = scene["mt"], scene["mt_res"]
    ref = mt.mt_wire_device_plain(*inputs, res, 1 << 21, 0.2)
    root = os.path.join(kernels.BUILD_DIR, "k7_variants")
    shutil.rmtree(root, ignore_errors=True)
    for i, (variant, edits) in enumerate(K7_VARIANTS):
        csrc = os.path.join(root, str(i))
        edit_copy(kernels.CSRC, edits, csrc)
        with kernels.sources_from(csrc):
            equal = bool(torch.equal(mt.mt_wire_device(*inputs, res, 1 << 21, 0.2), ref))
            ms = smoke.cuda_ms(lambda: mt.mt_wire_device(*inputs, res, 1 << 21, 0.2), iters=10)
            split = smoke.device_split("k7_variant_split", variant,
                                       lambda: mt.mt_wire_device(*inputs, res, 1 << 21, 0.2))
        print(json.dumps({"k7_variant": variant, "ms": ms, "byte_equal": equal, "split_ms": split["kernels_ms"]}),
              flush=True)


def k11_variants(smoke, scene):
    """K11 rebuilt from each of K11_VARIANTS: its time and split at the
    asset's 161^3 lattice (the smoke's capacities), whether it equals the
    plain version in every entry, and ptxas' registers and spills. A
    variant with ``fills`` zeroes both outputs in full before each launch
    (its time and split include them)."""
    import torch

    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.runtime import kernels

    inputs, res, mv, mf = scene["mt"], scene["mt_res"], 1 << 21, 1 << 22
    ref = mt.marching_tets_plain(*inputs, res, mv, mf)
    root = os.path.join(kernels.BUILD_DIR, "k11_variants")
    shutil.rmtree(root, ignore_errors=True)
    for i, (variant, edits, fills) in enumerate(K11_VARIANTS):
        csrc = os.path.join(root, str(i))
        edit_copy(kernels.CSRC, edits, csrc)

        def run():
            if fills:
                torch.zeros((3, mv), dtype=torch.float32, device="cuda")
                torch.zeros((3, mf), dtype=torch.int32, device="cuda")
            return mt.marching_tets(*inputs, res, mv, mf)

        with kernels.sources_from(csrc):
            got = run()
            # the fills zero other tensors than the outputs, whose rows past
            # the counts a variant without the tail pass leaves as they were:
            # the rows under the counts and the counters compare
            live = {"v": int(ref.num_verts), "f": int(ref.num_faces)}
            differ = sum(int((getattr(got, k)[: live[k[0]]] != getattr(ref, k)[: live[k[0]]]).sum()) if k[0] in live
                         else int(getattr(got, k) != getattr(ref, k)) for k in mt.MTResult._fields)
            ms = smoke.cuda_ms(run, iters=10)
            split = smoke.device_split("k11_variant_split", variant, run)
            report = kernels.ptxas_report("marching_tets").splitlines()
        print(json.dumps({"k11_variant": variant, "ms": ms, "entries_differing": differ,
                          "split_ms": split["kernels_ms"],
                          "ptxas": [ln.strip() for ln in report if re.search(r"registers|[1-9]\d* bytes spill", ln)]}),
              flush=True)


def k5_time(smoke, sf3d):
    """K5 alone at 161^3 on ``check_grid_multihead``'s inputs, timed whatever
    its output, beside its error per channel and the check's limit: for
    kernels built from a copy of the sources that is wrong by design (one
    side of the ring idle, the SiLU left out), whose time splits the
    kernel's."""
    import dataclasses

    import torch

    from sculptmate_tpu_torch.ops import density_grid as dg

    g = torch.Generator(device="cuda").manual_seed(0)
    heads = [[(w, smoke.K5_BIAS_STD * torch.randn(b.shape, device="cuda", generator=g)) for w, b in layers]
             for layers in sf3d.lattice_head_weights().values()]
    spec = dataclasses.replace(sf3d.grid_spec(torch.bfloat16), resolution=161, slab=7)
    codes = torch.randn(3, sf3d.config.upsample_out_channels, 384, 384, device="cuda", generator=g)
    A, B, C = dg.multihead_partials(codes.to(torch.bfloat16), heads, dg.lattice_coords_tets(160, "cuda"), spec)
    packed = dg.pack_multihead_weights(heads, "cuda")
    out = dg.grid_multihead(A, B, C, heads, spec, packed=packed)
    ref = dg.grid_multihead_plain(A, B, C, heads, spec)
    errs = [(out[k] - ref[k]).abs().max().item() for k in range(len(ref))]
    limits = [smoke.K5_SPREAD_SHARE * (ref[k] - ref[k].mean()).abs().max().item() for k in range(len(ref))]
    ms = smoke.cuda_ms(lambda: dg.grid_multihead(A, B, C, heads, spec, packed=packed), iters=10)
    print(json.dumps({"k5_time": "K5 alone at 161^3", "ms": ms, "max_abs_err_per_channel": errs,
                      "limit_per_channel": limits, "check_passed": all(e <= lim for e, lim in zip(errs, limits))}),
          flush=True)


def kernel_alone_shim():
    """On a tree whose ``grid_multihead`` packs K5's weights inside every
    call (no ``packed`` argument), give it one that takes them packed, so
    that the check times the same launch alone on both trees."""
    import inspect

    import torch

    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.runtime import kernels

    orig = dg.grid_multihead
    if "packed" in inspect.signature(orig).parameters:
        return

    def grid_multihead(A, B, C, heads, spec, packed=None):
        if packed is None:
            return orig(A, B, C, heads, spec)
        R, k_total = A.shape[0], sum(w[-1][0].shape[1] for w in heads)
        out = torch.empty((k_total, R, R, R), dtype=torch.float32, device=A.device)
        err = dg._multihead_lib()(
            A.data_ptr(), B.data_ptr(), C.data_ptr(), packed[0].data_ptr(), packed[1].data_ptr(), out.data_ptr(),
            R, k_total, torch.cuda.get_device_properties(A.device).multi_processor_count,
            torch.cuda.current_stream(A.device).cuda_stream)
        kernels.check(err, "grid_multihead_fwd")
        orig.launches += 1
        return out

    grid_multihead.launches = 0
    dg.grid_multihead = grid_multihead


def planes_relayout_shim():
    """On a tree without K6's one-pass planes relayout (``points_planes``),
    whose K6 lays its planes out inside each call in two PyTorch passes
    (cast, then a channels-last copy), give ``check_points`` those two
    passes under the new names, so that ``relayout_ms`` times the tree's
    own relayout."""
    import torch

    from sculptmate_tpu_torch.ops import density_grid as dg

    if hasattr(dg, "points_planes"):
        return

    def points_planes(triplane):
        return triplane.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()

    points_planes.launches = 0
    dg.points_planes = dg.points_planes_plain = points_planes


KERNELS = {"K3": "marching_cubes", "K4": "triplane_points", "K5": "grid_multihead", "K6": "points_multihead",
           "K7": "marching_tets", "K8": "raster_winner", "K9": "uv_unwrap", "K10": "marching_cubes",
           "K11": "marching_tets", "K12": "pil_resample"}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--kernels", default="K3,K4,K5,K6,K7,K8,K9,K10,K11,K12")
    p.add_argument("--csrc", default=None, help="build the kernels from these sources")
    p.add_argument("--variants", action="store_true")
    p.add_argument("--time-only", action="store_true",
                   help="K5: time the kernel whatever its output (a copy of the sources wrong by design)")
    args = p.parse_args()
    wanted = [k.strip() for k in args.kernels.split(",") if k.strip()]
    if not wanted or any(k not in KERNELS for k in wanted):
        p.error(f"--kernels takes some of {sorted(KERNELS)}")
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import contextlib

    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"# card: {card}; root {os.path.abspath(args.root)}; kernels {','.join(wanted)}"
          + (f"; sources {os.path.abspath(args.csrc)}" if args.csrc else ""), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sculptmate_tpu_torch.runtime import kernels

    failed = []
    with kernels.sources_from(os.path.abspath(args.csrc)) if args.csrc else contextlib.nullcontext():
        for name in sorted({KERNELS[k] for k in wanted}):
            try:
                kernels.build(name)
            except RuntimeError as e:
                print(f"# build failed: {e}", flush=True)
                return 1
            for line in kernels.ptxas_report(name).splitlines():
                if any(w in line for w in ("registers", "spill", "wgmma", "Compiling entry")):
                    print(f"#   {name}: {line.strip()}", flush=True)
        phases = []
        if {"K3", "K4", "K10"} & set(wanted):
            from sculptmate_tpu_torch.pipelines.generate import TripoGenerator

            gen = TripoGenerator()
            if gen.initiate_model(device="cuda") != 0:
                raise RuntimeError("TripoGenerator.initiate_model failed")
            lean = smoke.lean_scene(gen.model)
            lean_phases = {"K3": [("K3", lambda: smoke.check_mc_wire(lean)),
                                  ("K3 split", lambda: smoke.k3_split(lean))],
                           "K4": [("K4", lambda: smoke.check_triplane_points(gen.model, lean))],
                           "K10": [("K10", lambda: smoke.check_marching_cubes(lean)),
                                   ("K10 split", lambda: smoke.k10_split(lean))]}
            phases = [ph for k in ("K3", "K4", "K10") if k in wanted for ph in lean_phases[k]]
        if "K5" in wanted:
            from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator

            fast = Fast3DGenerator()
            if fast.initiate_model(device="cuda") != 0:
                raise RuntimeError("Fast3DGenerator.initiate_model failed")
            kernel_alone_shim()
            g = torch.Generator(device="cuda").manual_seed(0)
            codes = torch.randn(3, fast.model.config.upsample_out_channels, 384, 384, device="cuda",
                                generator=g).to(torch.bfloat16)
            if args.time_only:
                phases.append(("K5 time", lambda: k5_time(smoke, fast.model)))
            else:
                phases += [("K5", lambda: smoke.check_grid_multihead(g, fast.model)),
                           ("K5 split", lambda: smoke.k5_split(fast.model, codes))]
        if {"K6", "K7", "K8", "K9", "K11"} & set(wanted):
            from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator

            fast6 = Fast3DGenerator()
            if fast6.initiate_model(device="cuda") != 0:
                raise RuntimeError("Fast3DGenerator.initiate_model failed")
            with torch.no_grad():
                smoke.randomize_modulations(fast6.model, torch.Generator(device="cuda").manual_seed(0))
            planes_relayout_shim()
            sf3d_scene = smoke.sf3d_scene(fast6)
            g6 = torch.Generator(device="cuda").manual_seed(0)
            if "K6" in wanted:
                phases += [("K6", lambda: smoke.check_points(g6, fast6.model, sf3d_scene)),
                           ("K6 split", lambda: smoke.k6_split(fast6.model, sf3d_scene["codes"][0]))]
            if "K7" in wanted:
                phases += [("K7", lambda: smoke.check_mt_wire(sf3d_scene)),
                           ("K7 split", lambda: smoke.k7_split(sf3d_scene))]
            if "K8" in wanted:
                phases += [("K8", lambda: smoke.check_raster(sf3d_scene)),
                           ("K8 split", lambda: smoke.k8_split(sf3d_scene))]
            if "K9" in wanted:
                phases += [("K9", lambda: smoke.check_unwrap(sf3d_scene)),
                           ("K9 split", lambda: smoke.k9_split(sf3d_scene))]
            if "K11" in wanted:
                phases += [("K11", lambda: smoke.check_marching_tets(sf3d_scene)),
                           ("K11 split", lambda: smoke.k11_split(sf3d_scene))]
        if "K12" in wanted:
            from sculptmate_tpu_torch.frontend.matting import U2NetMatting

            phases.append(("K12", lambda: smoke.check_pil_resample(U2NetMatting(seed=0, device="cuda"))))
        if args.variants and "K4" in wanted:
            phases += [("K4 steps", lambda: k4_steps(smoke, gen.model, lean, K4_STEPS, "k4_step")),
                       ("K4 variants", lambda: k4_steps(
                           smoke, gen.model, lean, [(v, e, False) for v, e in K4_VARIANTS], "k4_variant"))]
        if args.variants and "K6" in wanted:
            phases.append(("K6 variants", lambda: k6_variants(smoke, fast6.model, sf3d_scene)))
        if args.variants and "K7" in wanted:
            phases.append(("K7 variants", lambda: k7_variants(smoke, sf3d_scene)))
        if args.variants and "K11" in wanted:
            phases.append(("K11 variants", lambda: k11_variants(smoke, sf3d_scene)))
        if args.variants and "K10" in wanted:
            phases.append(("K10 variants", lambda: k10_variants(smoke, lean)))
        for phase, fn in phases:
            try:
                fn()
            except (AssertionError, RuntimeError) as e:
                print(f"# {phase} failed: {e}", flush=True)
                failed.append(phase)
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
