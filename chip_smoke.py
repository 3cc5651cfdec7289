"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Environment and build: the card (``nvidia-smi`` name and power limit),
   torch and CUDA versions, and every kernel in ``sculptmate_tpu_torch/csrc``
   built from source with ``nvcc`` (timed), with each kernel's registers
   and spills as ``ptxas`` reports them (any spill fails the run). TF32 is
   switched off for matmuls and convolutions so the f32 checks compare
   full-precision math.
2. Kernel checks at the main path's shapes and at ragged ones (K1 at
   B=2, Nq=129, Nk=77, H=3, and at head dim 88: SingleStreamTransformer's
   27 648 tokens x 16 heads, the ragged shape, and in f32; K2 at R = 64
   and 100): each kernel against its
   plain PyTorch version on the same inputs, with its time, the plain
   version's time, a library yardstick where one exists, the least time the
   card could take (bound) and the ratios ms / library ms and bound / ms.
   The Lean kernels run on the main path's asset (``lean_scene``: its
   codes, threshold and 256^3 level): K4 (``csrc/triplane_points.cu``) at
   its ~0.6 M wire vertices, at render view 0's 8.39 M samples and at a
   ragged N partly outside the box; K3 and K10 (``csrc/marching_cubes.cu``)
   byte- and entry-equal at its level, at a ragged 64 x 72 x 80 lattice and
   at undersized capacities, K3 also at a 72 x 80 x 96 lattice whose block
   counts end in a partial scan tile; the ``K3_split`` and ``K10_split``
   lines (one call each under torch.profiler, ``device_split``). K7
   (``csrc/marching_tets.cu``) byte-equal on the full-width SF3D asset's
   161^3 lattice (snap_eps 0.2 and 0), on a ragged res = 37 lattice with a
   surface on its faces, on a res = 100 lattice whose 15 379 block counts
   span eight scan tiles and at an undersized capacity, and the
   ``K7_split`` line. K11 (``marching_tets_fwd``, in the same source)
   entry-equal to its plain version on the asset's 161^3 lattice, the
   ragged res = 37 lattice, the res = 100 lattice and at a third of the
   asset's counts, and the ``K11_split`` line.
   Then each check is run on kernels rebuilt with a planted fault
   (``PLANTED_FAULTS``), and must fail every one of them. Then F1: one Lean
   and one SF3D encode with the encoders' weights stored in bf16 once,
   against the same seeded weights kept in f32 under autocast: cast ops,
   copy kernels and device time under the profiler, codes bit-equal.
3. The Lean main path at full width (default ``TSRConfig``: ViT-B/16,
   16 x 1024 backbone, 256^3 grid) with seeded random weights: one asset
   through ``TripoGenerator`` with the launch counters (K1, K2, K4, K10, and
   K3, which must not run: on the card the default path builds the faces
   with K10) read around it, then a warm-up and three timed assets through
   the same calls
   (``scene_codes`` -> ``extract_mesh``); a narrow model on the card
   against the same model on the CPU, its codes and (bf16) its render.
   Then the render path: one ``TSR.render_views`` at the defaults (8 views,
   256^2, 128 samples) with the K1 and K4 counters, its views checked and
   one written as PNG, three timed renders (``render_sec``) and a profile
   (``tsr.render*`` spans); and the packed path: one asset's
   ``extract_mesh(mode="packed", has_vertex_color=True)`` with the K2, K4
   and K10 counters, held to ``mode="wire"`` on the same codes (counts,
   positions at the same lattice edge, triangles, colors), three timed
   assets (``packed_sec_per_asset`` beside the main path's
   ``sec_per_asset``), one
   ``AssetFarm`` packed batch of 2, and a profile.
4. Frontend checks: a narrow u2net (``SMALL_CONFIG``) at 64^2 on the card
   against the same weights on the CPU; the full u2net at 320^2 on the card
   (finite, masks in [0, 1]); ``preprocess_batch_device`` on the card
   against the CPU on the same RGBA. K12 (``csrc/pil_resample.cu``): its
   four wrappers on card tensors at the add-on's shapes (a 1024^2 photo to
   320^2, the mask back with its bbox, the ~1364^2 Lean square to 1024^2,
   the ~1203^2 Pro RGBA square) byte-equal to their plain versions, each
   timed beside the plain version and its byte bound; then
   ``preprocess_image`` on a 1024^2 add-on photo with the full u2net on the
   card, Lean and Pro, K12's launch counts read around each call (2/2/2/0
   and 2/2/0/1), the bytes equal to the host path's with the same session,
   a Lean call with no session (the add-on panel's) counted, and the host
   ms of a request on both paths. Then the session zoo at full width
   (``session_zoo`` lines): each session from ``new_session`` on its device
   method at its input size (u2netp, u2net_human_seg, silueta at 320^2,
   ISNet at 1024^2, the cloth session's class map at 768^2, SAM ViT-B's
   encode and a point and a box decode, one ViT-H encode), finite masks in
   [0, 1], ms per image; a narrow ISNet and a tiny SAM card vs CPU. Then
   the SAM cutout (``sam_cutout_path``): ``sam_segment`` with a box prompt
   on a 640 x 480 uint8 image through seeded ViT-B on the card, timed per
   image, its mask held against the same call on the CPU, then
   ``image_preprocess_sam`` on the cutout where PIL is installed (a line
   says it was skipped where it is not).
5. The serving path at full width: ``AssetFarm.generate_batch_rgba`` on
   eight raw 512^2 RGBA images with full-u2net matting, the fused
   preprocess, encode and 256^3 extraction with vertex colors; one batch
   with the launch counters read around it (it is also the warm-up), then
   three timed batches, and every mesh checked (K10 on every asset, K3 on
   none).
6. The asynchronous contract: the dispatch half of three in-flight assets
   (the farm's front, then ``extract_mesh_async``) under
   ``torch.cuda.set_sync_debug_mode("error")``, so any host sync fails the
   run (K10 and K4 dispatch there); then their waits.
7. Profiles: one asset (``tsr.*`` spans) and one farm chunk (``farm.*``
   and ``tsr.*`` spans), each with the device's idle share and each span's
   device launches.
8. SF3D checks: K5 (``csrc/grid_multihead.cu``) against its plain version
   at R = 161 with the full-width SF3D decoder and at a ragged R = 33 and
   65, its weights packed once (``ms`` the kernel alone, beside
   ``weights_pack_ms``), and the ``K5_split`` line (one
   ``SF3D.query_lattice``, the ``sf3d.grid`` span, by kernel name, with its
   launches), K1 at SF3D's six attention shapes (in phase 2's check), and a
   narrow SF3D (64-wide heads, nonzero AdaLN modulations) on the card
   against the same weights on the CPU: scene codes and the raw lattice
   query. The texture
   kernels, checked before phase 2's planted faults and under their own:
   K8 (``csrc/raster_winner.cu`` on ``csrc/raster.cuh``) bit-equal to its
   plain version at the full-width asset's bake (512^2, face ids) and both
   unwrap rasters (1024^2, depth keys, margin 0.05), at a ragged 100^2
   with oversized faces, and in its unwrap form (corners, keys and winner
   of both rounds from K9's state), and the ``K8_split`` line (one bake
   raster); K6 (``csrc/points_multihead.cu``) at 512^2 scattered points
   with the full-width decoder's features and perturb-normal heads and at
   the asset's own 512^2 bake texels with the model's heads, its planes'
   one-pass relayout equal to its plain version, and the ``K6_split`` line
   (one ``SF3D._surface_query``); K9 (``csrc/uv_unwrap.cu``) on the
   full-width asset's mesh and on layered sheets (round 1's depth range,
   the pool over five scan tiles), and the ``K9_split`` line (one
   ``unwrap_core``: every launch and copy of the call).
9. The SF3D path at full width (default ``SF3DConfig``: DINOv2-L, 96^2
   triplane tokens, 1 792 latents, 4 x 3 blocks, 40 x 384^2 codes, R = 160)
   with seeded random weights and nonzero modulations, untextured (its
   unwrap on K9): one asset through
   ``Fast3DGenerator.generate_mesh(enable_texture=False)`` with the launch
   counters read around it, then a warm-up and three timed assets through
   ``SF3D.run_image`` (``sf3d_sec_per_asset`` and its stage split), every
   mesh checked; then a profile of one asset (``sf3d.*`` spans). Then the
   same textured (the fused unwrap and bake at 512^2): one
   ``Fast3DGenerator.generate_mesh()`` asset with the counters (K1 = 68,
   K5, K6, K9, K8 >= 3) and a GLB of three images, three timed assets
   (``sf3d_textured_sec_per_asset``), every mesh and map checked, and a
   profile; the dispatch of two in-flight ``unwrap_bake_async`` calls under
   ``torch.cuda.set_sync_debug_mode("error")``; one ``SF3DFarm`` batch of
   four textured assets (``sf3d_farm_sec_per_asset``) and a profile of a
   batch of two (``sf3d_farm.*`` and ``sf3d.*`` spans). The untextured and
   textured assets and the farm batch count K7's launches. Then SF3D from
   its checkpoint directory: the full-width weights written as an F16
   ``model.safetensors`` (and ``config.yaml`` where ``yaml`` imports),
   ``Fast3DGenerator().initiate_model(dir)`` timed, and one untextured
   asset equal to that of a model given the same weights directly.
   Then the packed SF3D extraction (``sf3d_packed_path``): one
   ``SF3D._extract_packed_mesh`` on the asset's codes with K11's counter,
   held to the wire extraction of the same codes at snap_eps 0 (counts,
   positions within a u16 step at the same cut edge, triangles as sets),
   and three timed assets of each (encode + extraction). Then SF3D's
   unused backbone modules (``dead_upstream_path`` lines): a
   ``SingleStreamTransformer`` at its class defaults over 27 648 tokens
   (K1 at head dim 88, 32 launches) and ``TriplaneAttention`` full at res
   96 (K1) and masked at res 32 (plain), bf16, timed; narrow versions of
   both card vs CPU in f32. ``marching_cubes_host`` on the card (K10)
   against the CPU on a ragged 37 x 45 x 50 level, at its default
   capacities and at capacities it retries past.
10. The multi-device paths (``multi_device_path``) on a mesh of four
   shards, ``cuda:0`` four times on one card (one card each where there
   are four): the Lean asset's code extracted at 512^3 over sp = 4 x-slabs
   at the Lean threshold itself (``sharded_extract``: K2 and K10 four
   launches each, held to the mesh of K2 and K10 on the whole lattice as
   it comes: vertex count, vertices on the same cut edges within one f32
   ulp, directed edges, faces), its wire form (K3 four launches, the same
   mesh within a u16 t step, the same triangles), and
   ``sharded_density_grid`` against the whole lattice's density, each
   timed with its peak bytes; a planted weld that merges every exact
   duplicate, which the check must fail, and both welds timed on the
   same shards; K3 and K10 (with its vertices' edges) at a shard's padded slab equal to their plain versions and
   timed; ``AssetFarm`` over (dp 2, tp 2) on four
   raw RGBA images with matting and colors (K1 = 4 x (12 + 32 x 2)), its
   codes against the one-device farm's and an f32 encode over the tp
   group against the unsplit one; ``SF3DFarm`` over (dp 2, tp 2) on two
   textured assets (K7 twice), its codes against the unsplit encode.
11. The Blender add-on (``addon_path``) with ``tests/fake_bpy.py``
   installed as bpy: the panel's ``GenerationWorker`` run on the
   full-width Lean and textured Pro generators (at the scenes'
   thresholds), the kernels' counters read around each, the fake scene's
   objects, color layer, UV layer and images checked, and the generation
   and ``import_mesh`` seconds printed (``addon_path_sec``); bpy is
   removed afterwards.
12. One ``{"kernels": [...]}`` line (K1's and K2's launches counted on the
   serving batch and K1's times summed over a Lean asset, as before the
   SF3D path; K1's SF3D launches and sums under ``sf3d_*`` keys, its
   head-dim-88 time at SingleStreamTransformer's shape under ``d88_*``
   keys and the dead-upstream runs' launches in ``launches_by_path``; K5's
   launches counted on the untextured SF3D asset; K6's, K8's and K9's on
   the textured one; K3's, K4's and K10's on the TripoGenerator asset, K4's per
   path beside them; K10's on the packed asset; K7's on the untextured SF3D
   asset, per path beside them; K11's on the packed SF3D extraction; K12's
   on one Lean ``preprocess_image``, per button beside them), then
   the card line, then
   the result line ``{"ok": true, "device": {...}}`` last.

It needs one CUDA card and exits non-zero without one, printing no result.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# K1 in bf16 is held to an f32 reference on the same bf16 inputs. The kernel
# rounds its output to bf16 (half an ulp, at most 2^-8 of |o|) and P to bf16
# before P V. With randn q, k, v at D = 64 the outputs have std
# sqrt(e / Nk): 0.01 at 27648 keys, 0.03-0.05 at 1025-3072, where they reach
# ~0.5. Each shape's limit is one bf16 ulp of its largest reference output
# (K1_BF16_ULP x max |ref|), and never more than K1_BF16_LIMIT: the errors
# measured on the card stay under 3e-3 x max |ref| at every shape, and
# dropping one 128-key tile of 27648 moves the worst output by ~1e-2
K1_BF16_ULP = 2.0**-7
K1_BF16_LIMIT = 4e-3
K1_F32_LIMIT = 1e-5
# K2 is held on the decoder's output d before the exp, within this share of
# the spread max |d - mean d| of the plain version: the kernel and the plain
# version differ by bf16 rounding, about one ulp of d
K2_SPREAD_SHARE = 0.1
# K5 likewise, on each raw output channel (density, then the 3 vertex
# offsets) against that channel's spread
K5_SPREAD_SHARE = 0.1
# The K5 checks give every bias of the two heads (first, hidden and output
# layer) N(0, K5_BIAS_STD) values: the module zero-initialises them, and a
# checkpoint's are not zero
K5_BIAS_STD = 0.5

# K6 is held on each raw output channel (albedo features, then the
# perturbed normal) within this share of its spread, as K5; its checks give
# every bias of both heads N(0, K5_BIAS_STD) values
K6_SPREAD_SHARE = 0.1
# K8 must give the plain version's winner on every texel (the same products
# and sums, each rounded on its own; atomicMin is order-independent)
# K9 is held, given its own slice angles (the one sum whose order differs),
# to the CPU tests' limits: the same atlas index on K9_ATLAS_SHARE of the
# faces and UVs within K9_UV_LIMIT where it agrees. Its angles (cos, sin)
# are held to the plain version's own within K9_ANGLE_LIMIT: a slice sums
# ~10^5 f32 tangents, in blocks here and by atomics there, and an angle off
# by e turns the slice's UVs by at most about e, under K9_UV_LIMIT
K9_ATLAS_SHARE = 0.999
K9_UV_LIMIT = 1e-4
K9_ANGLE_LIMIT = 1e-4
# K4 is held on each output (d, exp(d + bias), then the three colors) within
# this share of the output's spread, as K6; exp(d + bias) on its log, as K2
# is held on d before the exp (one bf16 ulp of d moves the exp by up to 12 %
# where d reaches 16). Its checks scale the decoder's
# fan-in weights by K4_WEIGHT_GAIN and give it N(0, K5_BIAS_STD) biases: at
# the fan-in scale nine SiLU layers shrink the point's part of the output
# ~200x (spread 0.03 on d), so every point would give nearly the same output
# and a dropped tap would hide under one bf16 ulp; at 1.5 d spreads ~0.5
K4_SPREAD_SHARE = 0.1
K4_WEIGHT_GAIN = 1.5
# K4 with the main path's decoder as it is (fan-in scale, zero biases) on the
# Lean asset's codes at its vertices: there a tenth of d's spread is about
# the plain bf16 version's own rounding error, which the tanh SiLU's other
# rounding may pass. So that case holds each output within K4_NOISE_FACTOR
# times that error (the plain version in bf16 against the same function in
# f32 on the same bf16 weights and codes): a kernel no less accurate than
# the plain version is within twice it of the plain version
K4_NOISE_FACTOR = 2.0
# K3 must give its plain version's wire byte for byte and the same vertex
# positions; K10 every position, face and counter of its plain version
# A narrow model's render on the card (K4, bf16) against the CPU's (plain
# K4, bf16) from the same codes, on views in [0, 1]
RENDER_LIMIT = 0.02
# K1's check case at SingleStreamTransformer's shape (head dim 88)
SST_CASE = "single-stream transformer (16 x 88)"
# The narrow card-vs-CPU checks of the new paths (f32, TF32 off): within
# this share of max |CPU output|, as the u2net's
CARD_CPU_SHARE = 1e-4
# SAM's 8-bit cutout masks, card against CPU: they agree but where a mask
# logit lies within float noise of 0 (the CPU tests' limit against the JAX
# package): at most this share of the pixels more than 1 apart
SAM_MASK_SHARE = 0.01

# Deliberate faults, each one edit to a kernel source, that the kernel
# checks must fail: (name, kernel, text, replacement[, file]), the file
# csrc/<kernel>.cu unless another is named
PLANTED_FAULTS = (
    ("K1 skips the last key tile", "flash_attn",
     # (at least one tile: with none, the consumers would wait forever)
     "const int ntiles = (Nk + BKV - 1) / BKV;", "const int ntiles = max(1, (Nk - 1) / BKV);"),
    ("K1 masks the whole ragged key tail", "flash_attn",
     "const bool v0 = col < Nk, v1 = col + 1 < Nk;",
     "const bool v0 = col < (Nk & ~(BKV - 1)), v1 = col + 1 < (Nk & ~(BKV - 1));"),
    ("K1 drops the rescale of O when the running max moves", "flash_attn",
     "acc[4 * n] *= al[0]; acc[4 * n + 1] *= al[0]; acc[4 * n + 2] *= al[1]; acc[4 * n + 3] *= al[1];", ";"),
    # at D = 88 the tensor maps' extent (D) zero-fills columns 88-95: with the
    # padded width there, they load the next head's first columns
    ("K1's pad columns are not zeroed at D = 88", "flash_attn",
     "const cuuint64_t width = D;", "const cuuint64_t width = T::DP;"),
    ("K1 takes its scale from the padded D", "flash_attn",
     "const float scale = (float)(1.0 / sqrt((double)D));",
     "const float scale = (float)(1.0 / sqrt((double)((D + 15) / 16 * 16)));"),
    ("K2 reads B[i, k] for B[k, i]", "density_grid",
     "sb[2] = {rowb, (cuuint64_t)RX * ROW_BYTES}", "sb[2] = {(cuuint64_t)RX * ROW_BYTES, rowb}"),
    # B is (R, RX, 64): the lattice's row stride R reads other slabs' rows
    ("K2 reads B with the lattice's stride R, not the slab's RX", "density_grid",
     "sb[2] = {rowb, (cuuint64_t)RX * ROW_BYTES}", "sb[2] = {rowb, planeb}"),
    ("K2 drops the first layer (h1 = 0)", "density_grid",
     "a[kc][half * 2 + rr] = silu_of_half(*reinterpret_cast<uint32_t *>(&hv));", "a[kc][half * 2 + rr] = 0u;"),
    ("K2 takes the next layer's weight stage", "density_grid",
     "desc_sw128(sw + l * W_LAYER_BYTES)", "desc_sw128(sw + ((l + 1) % L) * W_LAYER_BYTES)"),
    ("K5 reads B[i, k] for B[k, i]", "grid_multihead",
     "strides[2] = {rowb, planeb}", "strides[2] = {planeb, rowb}"),
    ("K5 gives head 1 head 0's hidden weights", "grid_multihead",
     "dw1 = desc_sw128(sw + W_LAYER_BYTES)", "dw1 = desc_sw128(sw)"),
    ("K5 takes head 0's output tile for head 1", "grid_multihead",
     "issue_k64(o, f, h ? dout1 : dout0, true);", "issue_k64(o, f, dout0, true);"),
    ("K5 gives head 1 head 0's hidden bias", "grid_multihead",
     "bias_rows(d, bs + h * HW, c);", "bias_rows(d, bs, c);"),
    ("K5 drops the output bias", "grid_multihead",
     "        bias_rows(oa, bout, c);\n        bias_rows(ob, bout, c);\n",
     "        for (int n = 0; n < 4; ++n) oa[n] = ob[n] = 0.f;\n"),
    ("K5's consumers read the next ring slot's rows", "grid_multihead",
     "const uint32_t slot = smem_u32(ring + s * SLOT_BYTES);",
     "const uint32_t slot = smem_u32(ring + ((s + 1) % NSTAGE) * SLOT_BYTES);"),
    ("K5's second consumer reads the first one's B rows", "grid_multihead",
     "slot + (wg * HEADS + h) * BOX_BYTES", "slot + h * BOX_BYTES"),
    # in raster.cuh: K8's warp-balanced raster, which both its bake form and
    # its unwrap form (launched inside K9) run; held to K8's check, whose
    # unwrap-form cases run the unwrap form alone
    ("K8 keeps the highest key (atomicMax)", "raster_winner",
     "atomicMin(winner + texel, key);", "atomicMax(winner + texel, key);", "raster.cuh"),
    ("K8's bbox drops its last row", "raster_winner",
     "const int h = yhi - ylo + 1;", "const int h = yhi - ylo;", "raster.cuh"),
    ("K8's candidate search gives a lane the next face's terms", "raster_winner",
     "const int k = __popc(at & ((2u << lane) - 1u));", "const int k = __popc(at & ((4u << lane) - 1u));",
     "raster.cuh"),
    ("K8's warp skips a face's last candidate row", "raster_winner",
     "return covers ? fc.w * h : 0;", "return covers ? fc.w * (h - 1) : 0;", "raster.cuh"),
    ("K8's unwrap loader skips the lo/hi normalisation", "raster_winner",
     "        normalised(uv, F, f, s, stats, uc, vc);\n        const float gx = (float)(s % 4), gy = (float)(s / 4);\n#pragma",
     "        for (int k = 0; k < 3; ++k) uc[k] = uv[k * F + f], vc[k] = uv[(3 + k) * F + f];\n"
     "        const float gx = (float)(s % 4), gy = (float)(s / 4);\n#pragma", "uv_unwrap.cu"),
    ("K6 drops the last bilinear tap", "points_multihead",
     "for (int t = 0; t < 4; ++t) {\n#pragma unroll\n            for (int mm = 0; mm < G; ++mm) {",
     "for (int t = 0; t < 3; ++t) {\n#pragma unroll\n            for (int mm = 0; mm < G; ++mm) {"),
    ("K6's perturb head takes the features head's hidden weights", "points_multihead",
     "desc_sw128(sw + HID_OFF + (h * LAYERS + l) * W_LAYER_BYTES)", "desc_sw128(sw + HID_OFF + l * W_LAYER_BYTES)"),
    ("K6's consumers read the next ring slot", "points_multihead",
     "const uint32_t t0 = sring + s * SLOT_BYTES;", "const uint32_t t0 = sring + ((s + 1) % NSTAGE) * SLOT_BYTES;"),
    ("K6's perturb head takes the features head's output tile", "points_multihead",
     "dout1 = desc_sw128(sw + OUT_OFF + 8 * ROW_BYTES)", "dout1 = desc_sw128(sw + OUT_OFF)"),
    ("K6 drops the halved hidden biases", "points_multihead",
     "for (int i = threadIdx.x; i < NBIAS; i += THREADS) bs[i] = bias[i];",
     "for (int i = threadIdx.x; i < NBIAS; i += THREADS) bs[i] = i >= HEADS * HW && i < OUT_BIAS ? 0.f : bias[i];"),
    ("K6's planes relayout swaps two points' channels", "points_multihead",
     "for (int i = 0; i < VEC; ++i) tile[(xv + i) * C + ch] = to_bf16(v[i]);",
     "for (int i = 0; i < VEC; ++i) tile[((xv + i) ^ 1) * C + ch] = to_bf16(v[i]);"),
    ("K9's depth key is not inverted (the nearest face wins)", "uv_unwrap",
     "key = ~sortable(depth[f]);", "key = sortable(depth[f]);"),
    ("K9 skips the slice rotation", "uv_unwrap",
     "const float ca = angles[s], sa = angles[6 + s];", "const float ca = 1.f, sa = 0.f;"),
    ("K9's round-1 depth range is over all faces", "uv_unwrap",
     "if (!vis) hidden_slice = s;", "hidden_slice = s;"),
    ("K9's last-block epilogue sums one row short", "uv_unwrap",
     "for (int r = from + chain; r < to; r += CHAINS)", "for (int r = from + chain; r < to - 1; r += CHAINS)"),
    ("K9's pool prefix leaves out the earlier scan tiles", "uv_unwrap",
     "const int rank = pool_base[f >> 5] + __popc(",
     "const int rank = pool_base[f >> 5] - pool_base[(f >> 5) / MS_TILE * MS_TILE] + __popc("),
    ("K4 drops the last bilinear tap", "triplane_points",
     "for (int t = 0; t < 4; ++t) {\n#pragma unroll\n            for (int mm = 0; mm < G; ++mm) {",
     "for (int t = 0; t < 3; ++t) {\n#pragma unroll\n            for (int mm = 0; mm < G; ++mm) {"),
    ("K4 gives hidden layer l + 1 layer l's weights", "triplane_points",
     "desc_sw128(sw + HID_OFF + l * W_LAYER_BYTES)",
     "desc_sw128(sw + HID_OFF + (l > 0 ? l - 1 : 0) * W_LAYER_BYTES)"),
    ("K4 drops the output bias", "triplane_points",
     "const float v = bf16_round(add(o[2 * rr + e], bout[ch]));", "const float v = bf16_round(o[2 * rr + e]);"),
    ("K3 takes the next block's base", "marching_cubes",
     "int id = vbase[ab] + incl - cnt;", "int id = vbase[min(ab + 1, 3 * NB - 1)] + incl - cnt;"),
    ("K3 takes its block's scanned base one scan tile early", "marching_cubes",
     "int id = vbase[ab] + incl - cnt;", "int id = vbase[max(ab - MS_TILE, 0)] + incl - cnt;"),
    ("K3's emit leaves out the block's earlier mask words", "marching_cubes",
     "int id = vbase[ab] + incl - cnt;", "int id = vbase[ab];"),
    ("K3 truncates t instead of rounding it", "marching_cubes",
     "const int u = __float2int_rn(__fmul_rn(t, 65535.f));", "const int u = (int)__fmul_rn(t, 65535.f);"),
    ("K10 swaps a face's winding", "marching_cubes",
     "const int le = tri[(cs * maxtri + s) * 3 + c];", "const int le = tri[(cs * maxtri + s) * 3 + (3 - c) % 3];"),
    ("K10's face corners leave out their word's base", "marching_cubes",
     "int id = word_base[w3];", "int id = 0;"),
    # the vertices' edges, by which the sharded extraction welds its seams
    ("K10's vertex edges leave out their axis", "marching_cubes",
     "edges[id] = (long long)a * RX * RY * RZ + (long long)(p0 + k);", "edges[id] = (long long)(p0 + k);"),
    # the x limit of a slab (the sharded extraction): the halo row's cells
    # and x-cut edges must emit nothing
    ("K10's x limit is off by one (<=)", "marching_cubes",
     "const bool xc = xi && i < xlimit;", "const bool xc = xi && i <= xlimit;"),
    ("K3's x-cut mask ignores the x limit", "marching_cubes",
     "const bool xcut = xi && i < xlimit;", "const bool xcut = xi;"),
    # in scan.cuh: the multi-block scan, which K3, K7 and K10 launch (held
    # to K3's and K10's checks)
    ("K10's scan looks back past its predecessor", "marching_cubes",
     "for (int pred = gt - 1;;) {", "for (int pred = max(gt - 2, first);;) {", "scan.cuh"),
    ("K7's class 6 takes (1, 1, 0) for its step", "marching_tets",
     "STEP_Z = 0b1110100u", "STEP_Z = 0b0110100u"),
    ("K7's domain mask drops its z test", "marching_tets",
     "hi < N && hj < N && hk < N ? (next[r] > 0.f ? INSIDE : OUTSIDE) : PAST",
     "hi < N && hj < N ? (next[r] > 0.f ? INSIDE : OUTSIDE) : PAST"),
    ("K7 ignores snap_eps", "marching_tets",
     "t = t < w.eps_lo ? 0.f : (t > w.eps_hi ? 1.f : t);", "t = t;"),
    ("K7's emit takes the next block's base", "marching_tets",
     "int id = vbase[cb] + incl - cnt;", "int id = vbase[min(cb + 1, NCLS * NB - 1)] + incl - cnt;"),
    ("K7's emit leaves out the block's earlier mask words", "marching_tets",
     "int id = vbase[cb] + incl - cnt;", "int id = vbase[cb];"),
    ("K7's class base misses the earlier classes' totals", "marching_tets",
     "int id = vbase[cb] + incl - cnt;", "int id = vbase[cb] - vbase[c * NB] + incl - cnt;"),
    ("K7's count reads its own block's halo again, not the next one's", "marching_tets",
     "if (bz + 1 < nb) load(bz + 1, next);", "if (bz + 1 < nb) load(bz, next);"),
    # K11, in the same source: corner 7 (1, 1, 1) ends every tet's chain
    ("K11's cube byte drops its last corner", "marching_tets",
     "for (int c = 0; c < 8; ++c)\n            cube |=", "for (int c = 0; c < 7; ++c)\n            cube |="),
    ("K11's face bases past the first scan tile are one off", "marching_tets",
     "fb = fbase[next];", "fb = fbase[next] + (next >= MS_TILE ? 1 : 0);"),
    ("K11's face corners leave out their word's base", "marching_tets",
     "= word_base[g] + __popc(cutbits[g]", "= __popc(cutbits[g]"),
    ("K11's edge end takes its start's offset", "marching_tets",
     "c1 = deformed(idx1[a], offs[a], p1, inv_res);", "c1 = deformed(idx1[a], offs[a], p0, inv_res);"),
    # the z-split classify: a segment past the first starts from the first's halo
    ("K11's z-segments load the first segment's halo", "marching_tets",
     "k0 = bz0 * BS;", "k0 = 0;"),
    ("K11's vertex walk ranks a lane one bit low in its word", "marching_tets",
     "const int q = nth_bit(bj, v - ej);", "const int q = nth_bit(bj, max(v - ej - 1, 0));"),
    # a cube without faces shares its first face with the next cube
    ("K11's face search stops short of a cube's first face", "marching_tets",
     "if (first[u + s] <= r) u += s;", "if (first[u + s] < r) u += s;"),
    ("K11's face corners drop their x step", "marching_tets",
     "const int i = bi + ox + (a & 1),", "const int i = bi + ox,"),
)
# Cases a planted fault must fail among the others: the last key tile is
# 1/216 of the keys at SF3D's fuse-in, the shape where dropping it moves
# the outputs least; the multi-block scan's fault must fail both of its
# kernels (a lattice of two scan tiles or fewer does not show it); K9's
# round-1 depth range and its pool's scan tiles show on the layered sheets,
# whose hidden faces span a tenth of the depth range and fill the pool over
# five scan tiles; each fault of K11's z-split classify, balanced vertex
# walk, face search and corner addressing names one case where it shows
PLANTED_MUST_FAIL = {"K1 skips the last key tile": ("sf3d fuse-in",),
                     "K2 reads B with the lattice's stride R, not the slab's RX":
                         ("density grid slab 129x512x512", "density grid slab 33x64x64"),
                     "K10's x limit is off by one (<=)": ("K10 Lean slab 136x256x256, x limit 128",),
                     "K3's x-cut mask ignores the x limit": ("K3 Lean slab 136x256x256, x limit 128",),
                     "K1's pad columns are not zeroed at D = 88": ("single-stream transformer",),
                     "K1 takes its scale from the padded D": ("single-stream transformer", "ragged batched d88 f32"),
                     "K10's scan looks back past its predecessor": ("K3 Lean asset 256^3", "K10 Lean asset 256^3"),
                     "K7's class base misses the earlier classes' totals": ("multi-tile res 100",),
                     "K11's face bases past the first scan tile are one off": ("K11 multi-tile res 100",),
                     "K11's z-segments load the first segment's halo": ("K11 SF3D asset 161^3:",),
                     "K11's vertex walk ranks a lane one bit low in its word": ("K11 multi-tile res 100",),
                     "K11's face search stops short of a cube's first face":
                         ("K11 SF3D asset 161^3, a third of the capacities",),
                     "K11's face corners drop their x step": ("K11 ragged res 37",),
                     "K9's round-1 depth range is over all faces": ("layered sheets",),
                     "K9's pool prefix leaves out the earlier scan tiles": ("layered sheets",)}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warmup=3, graph=True):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events). With
    ``graph`` the calls are captured once in a CUDA graph and replayed, so
    the time is the device's alone, without the host's dispatch between
    launches; without it they are launched back to back from the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(iters):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_environment():
    from sculptmate_tpu_torch.runtime import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"# card: {card}")
    log(f"# python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    import importlib.util

    log(f"# yaml imports: {importlib.util.find_spec('yaml') is not None}; "
        f"safetensors imports: {importlib.util.find_spec('safetensors') is not None}")
    t0 = time.perf_counter()
    per_kernel = kernels.build_all()
    log(f"# built {sorted(per_kernel)} in {time.perf_counter() - t0:.2f} s (parallel nvcc; per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(per_kernel.items())) + ")")
    spills = []
    for name in sorted(per_kernel):
        for line in kernels.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"#   {name}: {line.strip()}")
            if re.search(r"[1-9]\d* bytes spill", line):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError("ptxas reports spills: " + "; ".join(spills))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("# TF32 off for matmuls and cuDNN convolutions: f32 checks compare full-precision math")
    return card


def check_attention(g, timed=True):
    """K1 at the three attention shapes of the Lean path and the six of the
    SF3D path in bf16, a ragged batched case, at 8 heads at the six
    backbone shapes that the tp = 2 farms split (Lean attn1 and attn2, SF3D
    fuse-in, fuse-out, latent self and cross), and once in f32, against
    the plain version (each shape's limit from its reference, as set out
    above); at head dim 88 at SingleStreamTransformer's shape (16 heads over
    3 x 96^2 tokens), at the ragged batched shape, and in f32. Every case is
    checked and printed before a failure raises. With ``timed``, each
    passing case also gets its time, the plain version's, SDPA's (yardstick
    only) and its bound, summed per asset of each path; the head-dim-88
    shape's row is returned apart."""
    from sculptmate_tpu_torch.ops.attention import dot_product_attention_plain, flash_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention  # yardstick only
    # (name, B, Nq, Nk, H, launches per Lean asset, per SF3D asset, dtype,
    # scale of v[, head dim: 64 unless given]). With 77 (or 50) keys the
    # outputs reach ~1.5, where half a bf16 ulp alone is 3.9e-3: v at half
    # scale keeps |o| < 1, as at the main path's shapes
    cases = [
        ("backbone attn1", 1, 3072, 3072, 16, 16, 0, torch.bfloat16, 1.0),
        ("backbone attn2", 1, 3072, 1025, 16, 16, 0, torch.bfloat16, 1.0),
        ("vit self-attention", 1, 1025, 1025, 12, 12, 0, torch.bfloat16, 1.0),
        ("sf3d fuse-in (latents over triplane)", 1, 3089, 27648, 16, 0, 4, torch.bfloat16, 1.0),
        ("sf3d fuse-out (triplane over latents)", 1, 27648, 3089, 16, 0, 4, torch.bfloat16, 1.0),
        ("sf3d latent self-attention", 1, 3089, 3089, 16, 0, 12, torch.bfloat16, 1.0),
        ("sf3d latent cross-attention", 1, 3089, 1297, 16, 0, 12, torch.bfloat16, 1.0),
        ("sf3d dinov2-large", 1, 1297, 1297, 16, 0, 24, torch.bfloat16, 1.0),
        ("sf3d clip vit-b/32", 1, 50, 50, 12, 0, 12, torch.bfloat16, 0.5),
        ("ragged batched", 2, 129, 77, 3, 0, 0, torch.bfloat16, 0.5),
        # one tp shard of the (dp 2, tp 2) farms (8 of the 16 heads) at each
        # backbone shape they split: checked, not timed (their launches are
        # multi_device_path's)
        *((f"{name}, tp shard (8 heads)", 1, Nq, Nk, 8, 0, 0, torch.bfloat16, 1.0) for name, Nq, Nk in (
            ("backbone attn1", 3072, 3072), ("backbone attn2", 3072, 1025),
            ("sf3d fuse-in", 3089, 27648), ("sf3d fuse-out", 27648, 3089),
            ("sf3d latent self-attention", 3089, 3089), ("sf3d latent cross-attention", 3089, 1297))),
        ("backbone attn2 f32", 1, 3072, 1025, 16, 0, 0, torch.float32, 1.0),
        (SST_CASE, 1, 27648, 27648, 16, 0, 0, torch.bfloat16, 1.0, 88),
        ("ragged batched d88", 2, 129, 77, 3, 0, 0, torch.bfloat16, 0.5, 88),
        ("ragged batched d88 f32", 2, 129, 77, 3, 0, 0, torch.float32, 0.5, 88),
        ("d88 f32 (1025 x 1025 x 4)", 1, 1025, 1025, 4, 0, 0, torch.float32, 1.0, 88),
    ]
    totals = {path: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0} for path in ("lean", "sf3d")}
    # bound ms per path and per kind (bytes or operations): the per-asset
    # bound is bound by the kind that holds most of it
    worst, worst_share, bound_by, failures, d88 = 0.0, 0.0, {"lean": {}, "sf3d": {}}, [], None
    for name, B, Nq, Nk, H, lean_n, sf3d_n, dt, v_scale, *head_dim in cases:
        D = head_dim[0] if head_dim else 64
        q = torch.randn(B, Nq, H, D, device="cuda", generator=g).to(dt)
        k = torch.randn(B, Nk, H, D, device="cuda", generator=g).to(dt)
        v = (v_scale * torch.randn(B, Nk, H, D, device="cuda", generator=g)).to(dt)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = dot_product_attention_plain(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        max_ref = ref.abs().max().item()
        limit = min(K1_BF16_LIMIT, K1_BF16_ULP * max_ref) if dt == torch.bfloat16 else K1_F32_LIMIT
        line = {"check": "K1", "case": name, "shape": [B, Nq, Nk, H, D], "dtype": str(dt).split(".")[-1],
                "max_abs_err": err, "limit": limit, "max_abs_ref": max_ref}
        if not (torch.isfinite(out).all() and err <= limit):
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: max_abs_err {err} > {limit}")
            continue
        if dt == torch.bfloat16:
            worst, worst_share = max(worst, err), max(worst_share, err / limit)
        if not timed or "tp shard" in name:
            log(json.dumps({**line, "check_passed": True}))
            continue
        esize = 2 if dt == torch.bfloat16 else 4
        bound, by = bound_ms(4 * B * H * Nq * Nk * D, esize * B * H * D * (2 * Nq + 2 * Nk),
                             PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS)
        row = {
            "ms": cuda_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": cuda_ms(lambda: dot_product_attention_plain(q, k, v), iters=5, graph=False),
            "bound_ms": bound,
            "library_ms": cuda_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))),
        }
        log(json.dumps({**line, "check_passed": True, **row, "bound_by": by,
                        "launches_per_asset": {"lean": lean_n, "sf3d": sf3d_n},
                        "ms_over_library": row["ms"] / row["library_ms"], "bound_share": bound / row["ms"]}))
        if name == SST_CASE:
            d88 = {**row, "bound_by": by}
        for path, n in (("lean", lean_n), ("sf3d", sf3d_n)):
            if n:
                bound_by[path][by] = bound_by[path].get(by, 0.0) + n * bound
                for key in totals[path]:
                    totals[path][key] += n * row[key]
    if failures:
        raise AssertionError("K1 " + "; ".join(failures))
    # worst bf16 error and error over limit; per-asset sums and what bounds
    # them, per path; the head-dim-88 row
    return ((worst, worst_share), totals, {path: max(b, key=b.get, default=None) for path, b in bound_by.items()},
            d88)


def sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return 1e6 * float(out.split()[0])


def check_density(g, tsr, timed=True):
    """K2 at R = 256 (the main path's grid), 64 (the threshold grid) and 100
    (a ragged k tail), and on x-slabs: 129 x 512 x 512 (a shard of the
    512^3 extraction over sp = 4, the last one, its halo row clamped) and a
    ragged 33 x 64 x 64, each slab's B held at the front of a
    whole-lattice-sized buffer, so that a kernel reading B with the
    lattice's row stride reads wrong rows, not past the allocation. With
    the main path's decoder (fan-in normal weights, zero biases, as
    ``TSRModule.reset_parameters`` makes them) on random unit-scale codes,
    held on d before the exp (see K2_SPREAD_SHARE). Every case is checked
    and printed before a failure raises; with ``timed``, R = 256 also gets
    its time, the plain version's, its bound and floors."""
    from sculptmate_tpu_torch.ops import density_grid as dg

    weights = tsr.decoder_weights()
    L = len(weights) - 2
    result, failures = None, []
    for R, RX in ((256, 256), (64, 64), (100, 100), (512, 129), (64, 33)):
        spec = tsr.grid_spec(R, torch.bfloat16)
        codes = torch.randn(3, tsr.config.upsample_out_channels, 64, 64, device="cuda", generator=g)
        cx = None
        if RX != R:  # the last shard's rows, its halo clamped to the lattice's last row
            rows = torch.clamp(R - RX + 1 + torch.arange(RX, device="cuda"), max=R - 1)
            cx = 2.0 * rows.float() / (R - 1) - 1.0
        A, B, C = dg.first_layer_partials(codes.to(torch.bfloat16), weights, spec, cx)
        if RX != R:
            B = torch.empty(R * R * 64, dtype=B.dtype, device="cuda")[: B.numel()].view(B.shape).copy_(B)
        out = dg.density_mlp(A, B, C, weights, spec)
        torch.cuda.synchronize()
        ref = dg.density_mlp_plain(A, B, C, weights, spec)
        d, d_ref = (t.log() - spec.density_bias for t in (out, ref))
        err = (d - d_ref).abs().max().item()
        spread = (d_ref - d_ref.mean()).abs().max().item()
        limit = K2_SPREAD_SHARE * spread
        name = f"density grid R={R}" if RX == R else f"density grid slab {RX}x{R}x{R}"
        line = {"check": "K2", "case": name, "dtype": "bfloat16", "max_abs_err": err,
                "limit": limit, "d_spread": spread, "activated_max_abs_err": (out - ref).abs().max().item()}
        if not (torch.isfinite(out).all() and err <= limit):
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: max_abs_err of d {err} > {limit}")
            continue
        if (R, RX) not in ((256, 256), (512, 129)) or not timed:
            log(json.dumps({**line, "check_passed": True}))
            result = result or (err, limit, None, None)
            continue
        points = RX * R * R
        flops = points * (L * 2 * 64 * 64 + 2 * 64)  # hidden layers + output channel 0
        nbytes = (RX * R + R * RX + R * R) * 64 * 2 + L * 64 * 64 * 2 + points * 4
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        # SiLUs: the first layer and each hidden layer, 64 channels per point;
        # one tanh.approx.bf16x2 per two, at 16 SFU results per clock per SM
        sfu_floor = 1e3 * points * 64 * (L + 1) / 2 / (16 * torch.cuda.get_device_properties(0).multi_processor_count
                                                      * sm_clock_hz())
        row = {
            "ms": cuda_ms(lambda: dg.density_mlp(A, B, C, weights, spec), iters=10),
            "plain_ms": cuda_ms(lambda: dg.density_mlp_plain(A, B, C, weights, spec), iters=3, graph=False),
            "bound_ms": bound,
            "library_ms": None,
        }
        log(json.dumps({**line, "check_passed": True, **row, "bound_by": by, "sfu_floor_ms": sfu_floor,
                        "bound_share": bound / row["ms"], "launches_per_asset": 1}))
        if RX == R:
            result = (err, limit, row, by)
        else:
            slab = {"slab_shape": [RX, R, R], **{f"slab_{k}": row[k] for k in ("ms", "plain_ms", "bound_ms")},
                    "slab_bound_by": by}
    if failures:
        raise AssertionError("K2 " + "; ".join(failures))
    if timed:
        result[2].update(slab)
    return result


def check_grid_multihead(g, sf3d, timed=True):
    """K5 at R = 161 (SF3D's tet lattice), 33 (a ragged k tail: 161 is
    itself 2 x 64 + 33) and 65 (one row past a whole tile, so the last
    tile of every (i, j) row holds a single point) with the full-width SF3D
    decoder's density and vertex-offset heads (fan-in normal weights, as
    ``SF3DModule.reset_parameters`` makes them, and random biases, see
    K5_BIAS_STD) on random unit-scale codes, against its plain version on
    the same bf16 partials: each raw output channel within K5_SPREAD_SHARE
    of its spread. The weights are packed once, as ``SF3D`` keeps them.
    Every case is checked and printed before a failure raises; with
    ``timed``, R = 161 also gets its time (the kernel alone), the weights'
    packing apart (``weights_pack_ms``, once per model), the plain
    version's time, its bound and its SFU floor."""
    from sculptmate_tpu_torch.ops import density_grid as dg

    heads = [[(w, K5_BIAS_STD * torch.randn(b.shape, device="cuda", generator=g)) for w, b in layers]
             for layers in sf3d.lattice_head_weights().values()]
    packed = dg.pack_multihead_weights(heads, "cuda")
    result, failures = None, []
    for R in (161, 33, 65):
        spec = dataclasses.replace(sf3d.grid_spec(torch.bfloat16), resolution=R, slab=7)
        codes = torch.randn(3, sf3d.config.upsample_out_channels, 384, 384, device="cuda", generator=g)
        A, B, C = dg.multihead_partials(codes.to(torch.bfloat16), heads, dg.lattice_coords_tets(R - 1, "cuda"), spec)
        out = dg.grid_multihead(A, B, C, heads, spec, packed=packed)
        torch.cuda.synchronize()
        ref = dg.grid_multihead_plain(A, B, C, heads, spec)
        errs = [(out[k] - ref[k]).abs().max().item() for k in range(len(ref))]
        spreads = [(ref[k] - ref[k].mean()).abs().max().item() for k in range(len(ref))]
        bad = [k for k in range(len(ref)) if not errs[k] <= K5_SPREAD_SHARE * spreads[k]]
        line = {"check": "K5", "case": f"two-head tet grid R={R}", "dtype": "bfloat16", "max_abs_err": max(errs),
                "max_abs_err_per_channel": errs, "limit_per_channel": [K5_SPREAD_SHARE * sp for sp in spreads]}
        if bad or not torch.isfinite(out).all():
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"R={R}: channels {bad} past {K5_SPREAD_SHARE} of their spread")
            continue
        if R != 161 or not timed:
            log(json.dumps({**line, "check_passed": True}))
            continue
        K = len(ref)
        # per point and head: the 64x64 hidden layer and the output layer;
        # bytes: the three partials, the weights and the f32 output
        flops = R**3 * sum(2 * 64 * 64 + 2 * 64 * w[-1][0].shape[1] for w in heads)
        nbytes = 3 * R * R * 128 * 2 + 2 * (64 * 64 + 8 * 64) * 2 + K * R**3 * 4
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        # SiLUs: the first and the hidden layer of both heads, 64 channels
        # each; one tanh.approx.bf16x2 per two, 16 SFU results per clock per SM
        sfu_floor = 1e3 * R**3 * 64 * 2 * 2 / 2 / (16 * torch.cuda.get_device_properties(0).multi_processor_count
                                                   * sm_clock_hz())
        row = {
            "ms": cuda_ms(lambda: dg.grid_multihead(A, B, C, heads, spec, packed=packed), iters=10),
            "weights_pack_ms": cuda_ms(lambda: dg.pack_multihead_weights(heads, "cuda"), iters=10),
            "plain_ms": cuda_ms(lambda: dg.grid_multihead_plain(A, B, C, heads, spec), iters=3, graph=False),
            "bound_ms": bound,
            "library_ms": None,
        }
        log(json.dumps({**line, "check_passed": True, **row, "bound_by": by, "sfu_floor_ms": sfu_floor,
                        "bound_share": bound / row["ms"], "launches_per_asset": 1}))
        result = (max(errs), row, by)
    if failures:
        raise AssertionError("K5 " + "; ".join(failures))
    return result


def sf3d_scene(fast):
    """The full-width SF3D asset the texture and K7 checks run on: the
    matted disc image, its threshold (the 99th percentile of exp(d - 1) on
    a 41^3 lattice: random weights never reach the config's 10), its codes
    and material estimates, K7's inputs (the 161^3 sdf and raw offsets, as
    ``SF3D._extract_wire`` forms them), its decimated mesh, that mesh's atlas from the plain version of K9
    (which rasterizes on the plain K8) with the inputs of its two
    visibility rasters (recorded), so that the K8 and K9 checks do not rest
    on the kernels they check, and the texel points of its fused 512^2 bake
    as K6 gets them."""
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud
    from sculptmate_tpu_torch.geometry.uv_unwrap import _main_axis_rotation
    from sculptmate_tpu_torch.ops import density_grid as dg

    sf3d = fast.model
    rng = np.random.default_rng(4)
    image = rng.random((512, 512, 4)).astype(np.float32)  # random colors inside a disc of alpha 1
    yy, xx = np.mgrid[:512, :512]
    image[..., 3] = ((yy - 256) ** 2 + (xx - 256) ** 2 < 180**2).astype(np.float32)
    mask, rgb = sf3d.prepare_image(torch.from_numpy(image[None]).cuda())
    codes, _ = sf3d.get_scene_codes(rgb)
    materials = sf3d.estimate_materials(rgb * mask)
    d41 = dg.query_grid_multihead(codes[0], sf3d.lattice_head_weights(), dg.lattice_coords_tets(40, "cuda"),
                                  dataclasses.replace(sf3d.grid_spec(sf3d.extract_dtype), resolution=41))["density"]
    threshold = float(torch.quantile(torch.exp(d41[0].flatten() - 1.0), 0.99))
    log(f"# sf3d threshold (99th percentile of the 41^3 density): {threshold}")
    grids = sf3d.query_lattice(codes[0])  # K7's inputs, as SF3D._extract_wire forms them
    mt_inputs = [(torch.exp(grids["density"][0] - 1.0) - threshold).contiguous()]
    mt_inputs += [o.contiguous() for o in grids["vertex_offset"]]
    verts, faces, nv = sf3d.extract_mesh(codes[0], threshold)
    verts, faces, _ = sf3d.decimate_mesh(verts, faces, nv, "high", False)
    rp = verts @ _main_axis_rotation(verts).T
    pos = torch.from_numpy(np.ascontiguousarray(rp.T)).cuda()
    f = torch.from_numpy(np.ascontiguousarray(faces.T, np.int32)).cuda()
    recorded, winner_fn = [], ud.binned_winner_plain
    ud.binned_winner_plain = lambda *a, **k: recorded.append(a) or winner_fn(*a, **k)
    try:
        uv6, _, angles = ud.unwrap_core_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2])
    finally:
        ud.binned_winner_plain = winner_fn
    texels, query = [], sf3d._surface_query
    sf3d._surface_query = lambda code, *pts: texels.append(pts) or query(code, *pts)
    try:
        sf3d.unwrap_bake_wait(sf3d.unwrap_bake_async(verts, faces, codes[0], materials, 512))
    finally:
        del sf3d._surface_query
    covered = int((texels[0][0].abs() + texels[0][1].abs() + texels[0][2].abs() > 0).sum())
    log(json.dumps({"sf3d_scene": "full-width asset for the texture and K7 checks", "verts": len(verts),
                    "faces": len(faces), "mt_raw_verts": nv, "threshold": threshold,
                    "round2_faces": int((recorded[1][6] < ud.WINNER_SINK - 1).sum()),
                    "texels": texels[0][0].numel(), "texels_off_the_origin": covered,
                    "codes_dtype": str(codes.dtype)}))
    return {"image": image, "threshold": threshold, "codes": codes, "materials": materials, "verts": verts,
            "faces": faces, "pos": pos, "f": f, "uv6": uv6, "angles": angles, "round1": recorded[0],
            "round2": recorded[1],
            "mt": mt_inputs, "mt_res": sf3d.config.isosurface_resolution, "mt_nv": nv, "texels": [t.contiguous() for t in texels[0]]}


def check_raster(scene, timed=True):
    """K8 against its plain version, which it must equal on every texel: at
    the bake (512^2, face ids, margin 0) of the full-width asset's atlas,
    at the unwrap's two visibility rasters of its mesh (1024^2,
    ~sortable(depth) keys, margin 0.05; in round 2 only the faces round 1
    hid take part, the rest carry zero UVs and the sink key), and at a
    ragged 100^2 (not a multiple of 64: the JAX package's brute-force
    branch) with oversized faces; then K8's unwrap form, which K9 launches
    for its two rounds (where the package has it): from the plain
    version's rotated UVs, slices, depths and lo/hi, the corners and keys
    its loader forms equal to those the plain round rasterized, and its
    winner equal to theirs. With ``timed``, the three path cases get their
    time, the plain version's and their bound, summed over a textured
    asset's three launches."""
    from sculptmate_tpu_torch.geometry import texture_bake as tb
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud

    uv = scene["uv6"]
    F = uv.shape[1]
    rng = np.random.default_rng(5)
    small = rng.random((20000, 1, 2)) + rng.standard_normal((20000, 3, 2)) * 1.5 / 100
    o = rng.random((64, 1, 2)) * 0.5
    big = o + np.array([[0, 0], [0.4, 0], [0, 0.45]]) * (0.4 + rng.random((64, 1, 1)))
    tri = np.concatenate([small, big]).astype(np.float32)
    ragged = [torch.from_numpy(np.ascontiguousarray(tri[:, c, d])).cuda() for c in range(3) for d in range(2)]
    cases = [
        ("bake 512^2, face ids", [uv[k].contiguous() for k in range(6)],
         torch.arange(F, dtype=torch.int32, device="cuda"), 512, 0.0, 1),
        ("unwrap round 1 1024^2, depth keys, margin 0.05", [t.contiguous() for t in scene["round1"][:6]],
         scene["round1"][6], 1024, 0.05, 1),
        ("unwrap round 2 1024^2, depth keys, margin 0.05", [t.contiguous() for t in scene["round2"][:6]],
         scene["round2"][6], 1024, 0.05, 1),
        ("ragged 100^2, oversized faces", ragged, torch.arange(len(tri), dtype=torch.int32, device="cuda"), 100, 0.0,
         0),
    ]
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    failures = []
    for name, corners, key, res, margin, n in cases:
        got = tb.binned_winner(*corners, key, res, margin)
        torch.cuda.synchronize()
        ref = tb.binned_winner_plain(*corners, key, res, margin)
        differ = int((got != ref).sum())
        line = {"check": "K8", "case": name, "faces": len(key), "texels_differing": differ, "limit": 0,
                "covered": int((ref < tb.WINNER_SINK).sum())}
        if differ:
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: {differ} texels differ")
            continue
        if not (timed and n):
            log(json.dumps({**line, "check_passed": True}))
            continue
        # bytes: six f32 corner UVs and an int32 key per face in, the int32
        # winner per texel out; the tests are a few per face
        bound, by = bound_ms(0, 28 * len(key) + 4 * res * res, PEAK_F32_FLOPS)
        row = {"ms": cuda_ms(lambda: tb.binned_winner(*corners, key, res, margin), iters=10),
               "plain_ms": cuda_ms(lambda: tb.binned_winner_plain(*corners, key, res, margin), iters=2, warmup=1,
                                   graph=False),
               "bound_ms": bound}
        log(json.dumps({**line, "check_passed": True, **row, "bound_by": by, "bound_share": bound / row["ms"],
                        "launches_per_asset": n}))
        for k in totals:
            totals[k] += n * row[k]
    if hasattr(ud, "unwrap_round"):
        pos, f = scene["pos"], scene["f"]
        index, depth, r6, lo6, hi6, _ = ud.unwrap_slices_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2],
                                                               scene["angles"])
        vis0 = scene["round2"][6] == tb.WINNER_SINK - 1  # round 0's visible faces sit out round 1
        for r, recorded in enumerate((scene["round1"], scene["round2"])):
            corners, key, winner = ud.unwrap_round(r6, index, depth, lo6, hi6, vis0 if r else None)
            torch.cuda.synchronize()
            ref = tb.binned_winner_plain(*recorded[:6], recorded[6], 1024, 0.05)
            line = {"check": "K8", "case": f"unwrap form round {r + 1} from K9's state",
                    "corners_equal": bool(torch.equal(corners, torch.stack(recorded[:6]))),
                    "keys_equal": bool(torch.equal(key, recorded[6])),
                    "texels_differing": int((winner != ref).sum()), "limit": 0}
            line["check_passed"] = line["corners_equal"] and line["keys_equal"] and not line["texels_differing"]
            log(json.dumps(line))
            if not line["check_passed"]:
                failures.append(f"{line['case']}: corners equal {line['corners_equal']}, keys equal "
                                f"{line['keys_equal']}, {line['texels_differing']} texels differ")
    if failures:
        raise AssertionError("K8 " + "; ".join(failures))
    return totals


def check_points(g, sf3d, scene, timed=True):
    """K6 against its plain version, with every case checked and printed
    before a failure raises:
    - at 512^2 = 262 144 points uniform in the radius cube of random
      unit-scale (3, 40, 384, 384) bf16 codes, with the full-width
      decoder's features and perturb-normal heads and N(0, K5_BIAS_STD)
      biases: each raw channel within K6_SPREAD_SHARE of its spread; and
      its planes' relayout, equal to its plain version;
    - at the asset's 512^2 bake texels (``sf3d_scene``: mostly the origin,
      where uncovered texels sit, the rest on the surface) with its codes
      and the model's own heads (fan-in weights, zero biases): each channel
      within K4_NOISE_FACTOR times the plain bf16 version's own error
      against the same function in f32 on the same bf16 weights and codes.
    With ``timed``, the kernel's time alone on both (planes and weights
    packed before), the relayout's (once per scene code) and the weights'
    packing (once per model) apart, the plain version's time and the
    bounds."""
    from sculptmate_tpu_torch.ops import density_grid as dg

    heads = [[(w, K5_BIAS_STD * torch.randn(b.shape, device="cuda", generator=g)) for w, b in layers]
             for layers in sf3d.texel_head_weights().values()]
    spec = sf3d.grid_spec(torch.bfloat16)
    codes = torch.randn(3, sf3d.config.upsample_out_channels, 384, 384, device="cuda", generator=g).to(torch.bfloat16)
    N = 512 * 512
    pts = [(torch.rand(N, device="cuda", generator=g) * 2 - 1) * spec.radius for _ in range(3)]
    failures = []
    out = dg.points_multihead(codes, heads, *pts, spec)
    planes_equal = bool(torch.equal(dg.points_planes(codes), dg.points_planes_plain(codes)))
    torch.cuda.synchronize()
    ref = dg.points_multihead_plain(codes, heads, *pts, spec)
    errs = [(out[k] - ref[k]).abs().max().item() for k in range(len(ref))]
    limits = [K6_SPREAD_SHARE * (ref[k] - ref[k].mean()).abs().max().item() for k in range(len(ref))]
    bad = [k for k in range(len(ref)) if not errs[k] <= limits[k]]
    line = {"check": "K6", "case": "texel query, 512^2 points", "dtype": "bfloat16", "max_abs_err": max(errs),
            "max_abs_err_per_channel": errs, "limit_per_channel": limits, "planes_relayout_equal": planes_equal,
            "check_passed": not bad and planes_equal and bool(torch.isfinite(out).all())}
    if not line["check_passed"]:
        failures.append(f"channels {bad} past {K6_SPREAD_SHARE} of their spread; planes relayout equal to its plain "
                        f"version: {planes_equal}")
    # the asset's texels with its codes and the model's heads: the plain
    # version in bf16 against the same function in f32 on the same bf16
    # values gives its own error
    texels, main_codes = scene["texels"], scene["codes"][0]
    main_heads = list(sf3d.texel_head_weights().values())
    got = dg.points_multihead(main_codes, main_heads, *texels, spec)
    ref_t = dg.points_multihead_plain(main_codes, main_heads, *texels, spec)
    exact = dg.points_multihead_plain(
        main_codes.to(torch.bfloat16).float(),
        [[(w.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()) for w, b in layers] for layers in main_heads],
        *texels, sf3d.grid_spec(torch.float32))
    t_errs = [(got[k] - ref_t[k]).abs().max().item() for k in range(len(ref_t))]
    noise = [(ref_t[k] - exact[k]).abs().max().item() for k in range(len(ref_t))]
    t_bad = [k for k in range(len(ref_t)) if not t_errs[k] <= K4_NOISE_FACTOR * noise[k]]
    t_line = {"check": "K6", "case": "the asset's 512^2 bake texels, the model's heads", "dtype": str(main_codes.dtype),
              "points": texels[0].numel(), "max_abs_err": max(t_errs), "max_abs_err_per_channel": t_errs,
              "plain_bf16_err_per_channel": noise, "limit_per_channel": [K4_NOISE_FACTOR * n for n in noise],
              "check_passed": not t_bad and bool(torch.isfinite(got).all())}
    del ref_t, exact
    if not t_line["check_passed"]:
        failures.append(f"the asset's texels: channels {t_bad} past {K4_NOISE_FACTOR} x the plain bf16 version's error")
    if failures or not timed:
        log(json.dumps(line))
        log(json.dumps(t_line))
        if failures:
            raise AssertionError("K6 " + "; ".join(failures))
        return None
    # per point: 120 -> 2 x 64, two hidden 64 x 64 layers per head, 2 x 64 -> 3
    # (the block-diagonal zeros are no work); bytes: the bf16 codes read once,
    # three f32 coordinates in, six f32 outputs out
    flops = N * 2 * (120 * 128 + 2 * 2 * 64 * 64 + 2 * 64 * 3)
    bound, by = bound_ms(flops, codes.numel() * 2 + N * (12 + 24), PEAK_BF16_FLOPS)
    # the relayout moves bytes only: the codes read once, the bf16 planes written
    relayout_bound, _ = bound_ms(0, codes.numel() * (codes.element_size() + 2), PEAK_F32_FLOPS)
    packed = dg.pack_points_inputs(codes, heads)
    packed_main = dg.pack_points_inputs(main_codes, main_heads)
    row = {"ms": cuda_ms(lambda: dg.points_multihead(codes, heads, *pts, spec, packed=packed), iters=10),
           "relayout_ms": cuda_ms(lambda: dg.points_planes(codes), iters=10), "relayout_bound_ms": relayout_bound,
           "weights_pack_ms": cuda_ms(lambda: dg.pack_points_weights(heads, "cuda"), iters=10),
           "plain_ms": cuda_ms(lambda: dg.points_multihead_plain(codes, heads, *pts, spec), iters=3, graph=False),
           "bound_ms": bound}
    # SiLUs: three 64-wide layers per head and point; one tanh.approx.bf16x2
    # per two, at 16 SFU results per clock per SM
    sfu_floor = 1e3 * N * 64 * 3 * 2 / 2 / (16 * torch.cuda.get_device_properties(0).multi_processor_count
                                           * sm_clock_hz())
    log(json.dumps({**line, **row, "bound_by": by, "bound_share": bound / row["ms"], "sfu_floor_ms": sfu_floor,
                    "launches_per_asset": 1}))
    t_row = {"ms": cuda_ms(lambda: dg.points_multihead(main_codes, main_heads, *texels, spec, packed=packed_main),
                           iters=10),
             "plain_ms": cuda_ms(lambda: dg.points_multihead_plain(main_codes, main_heads, *texels, spec), iters=3,
                                 graph=False)}
    log(json.dumps({**t_line, **t_row, "bound_ms": bound, "bound_by": by}))
    return max(errs), {**row, "asset_texels_ms": t_row["ms"]}, by


def layered_sheets(n=80, backs=21):
    """A flat n x n sheet of 2 n^2 faces facing +z at z = 1 (x in [1, 3]:
    off the z axis, so the slice's mean expected tangent is well defined),
    and ``backs``
    copies of it at z = -0.8, -0.81, ... (2 (backs + 1) n^2 faces; 281 600
    by default). Round 0 hides every back copy behind the sheet; in round
    1 the copy at -0.8 wins and the others lie 0.01 apart behind it, within
    a depth range of 0.2 of the whole 2: the tolerance over round 1's
    participants (0.004) hides them into the pool, one over all faces
    (0.04) would keep the nearest ones. The pool's ~0.24 M faces span five
    scan tiles of the pool flags. -> (positions (3, Nv) f32, faces (3, F)
    int32) on the card."""
    x, y = np.meshgrid(np.linspace(1, 3, n + 1), np.linspace(-1, 1, n + 1), indexing="ij")
    grid = np.stack([x, y], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).reshape(-1)
    b, c, d = a + (n + 1), a + 1, a + (n + 2)  # (x + 1, y), (x, y + 1), (x + 1, y + 1)
    sheet = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])  # counter-clockwise in xy: +z
    zs = [1.0] + [-0.8 - 0.01 * k for k in range(backs)]
    pos = np.concatenate([np.concatenate([grid, np.full((len(grid), 1), z)], 1) for z in zs])
    faces = np.concatenate([sheet + k * len(grid) for k in range(len(zs))])
    return (torch.from_numpy(np.ascontiguousarray(pos.T, np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(faces.T, np.int32)).cuda())


def check_unwrap(scene, timed=True):
    """K9 against its plain version given the kernel's slice angles: the
    same atlas index on K9_ATLAS_SHARE of the faces, UVs within
    K9_UV_LIMIT where it agrees; and the kernel's angles against the plain
    version's own sums within K9_ANGLE_LIMIT. On the full-width asset's
    mesh (timed with ``timed``) and on ``layered_sheets``, where round 1's
    depth range and the pool's later scan tiles decide the result."""
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud

    cases = [("unwrap of the full-width mesh", scene["pos"], scene["f"]), ("layered sheets", *layered_sheets())]
    failures, result = [], None
    for name, pos, f in cases:
        uv, atlas, angles = ud.unwrap_core(pos[0], pos[1], pos[2], f[0], f[1], f[2])
        torch.cuda.synchronize()
        ref_uv, ref_atlas, _ = ud.unwrap_core_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2], angles=angles)
        _, _, own_angles = ud.unwrap_core_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2])
        same = atlas == ref_atlas
        share = same.float().mean().item()
        uv_err = (uv - ref_uv)[:, same].abs().max().item() if bool(same.any()) else float("inf")
        ang_err = (angles - own_angles).abs().max().item()
        line = {"check": "K9", "case": name, "faces": int(f.shape[1]),
                "atlas_equal_share": share, "uv_max_abs_err": uv_err, "angle_max_abs_err": ang_err,
                "limits": {"atlas_equal_share": K9_ATLAS_SHARE, "uv": K9_UV_LIMIT, "angles": K9_ANGLE_LIMIT},
                "classes": torch.bincount(atlas // 6, minlength=3).tolist()}
        ok = share >= K9_ATLAS_SHARE and uv_err <= K9_UV_LIMIT and ang_err <= K9_ANGLE_LIMIT and bool(
            torch.isfinite(uv).all())
        if not ok:
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: atlas share {share}, uv err {uv_err}, angle err {ang_err}")
            continue
        if not (timed and result is None):
            log(json.dumps({**line, "check_passed": True}))
            continue
        # bytes: positions and faces in, per-corner f32 UVs and the atlas
        # index out, plus the two visibility rasters' (faces in, 1024^2
        # winners out)
        F, Nv = int(f.shape[1]), int(pos.shape[1])
        bound, by = bound_ms(0, 12 * Nv + 12 * F + 28 * F + 2 * (28 * F + 4 * 1024 * 1024), PEAK_F32_FLOPS)
        row = {"ms": cuda_ms(lambda: ud.unwrap_core(pos[0], pos[1], pos[2], f[0], f[1], f[2]), iters=5),
               "plain_ms": cuda_ms(lambda: ud.unwrap_core_plain(pos[0], pos[1], pos[2], f[0], f[1], f[2]), iters=2,
                                   warmup=1, graph=False),
               "bound_ms": bound}
        log(json.dumps({**line, "check_passed": True, **row, "bound_by": by, "bound_share": bound / row["ms"],
                        "launches_per_asset": 1}))
        result = (max(uv_err, 1.0 - share), row, by)
    if failures:
        raise AssertionError("K9 " + "; ".join(failures))
    return result


def lean_scene(tsr):
    """The Lean asset the K3, K4 and K10 checks run on: the main path's
    image, its codes and threshold (as ``main_path`` sets it), its 256^3
    level from K2, the world positions of its wire's vertices from the plain
    K3, and view 0's render sample positions at the defaults (8.39 M)."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.rays import get_spherical_cameras

    image = np.random.default_rng(0).random((512, 512, 3), np.float32)
    codes = tsr.scene_codes(image[None])
    weights = tsr.decoder_weights()
    d64 = dg.query_density_grid(codes[0], weights, tsr.grid_spec(64, tsr.extract_dtype))
    threshold = float(torch.quantile(d64.flatten().float(), 0.99))
    level = dg.query_density_grid(codes[0], weights, tsr.grid_spec(256, tsr.extract_dtype)) - threshold
    recorded = []
    wire, _ = mc.mc_wire_device_plain(level, 1 << 20, lambda *v: recorded.append(torch.stack(v)) or v)
    nv = int.from_bytes(wire[-8:-4].cpu().numpy().tobytes(), "little")
    r = tsr.config.radius
    verts = recorded[0][:, :nv] * (2 * r / 255.0) - r
    rays_o, rays_d = get_spherical_cameras(8, 0.0, 1.9, 40.0, 256, 256, device="cuda")
    render_pts, _, _ = tsr._render_points(rays_o[0], rays_d[0], 128)
    log(json.dumps({"lean_scene": "the main path's asset for the K3, K4 and K10 checks",
                    "codes_dtype": str(codes.dtype),
                    "threshold": threshold, "verts": nv, "render_points": render_pts[0].numel()}))
    return {"image": image, "codes": codes, "threshold": threshold, "level": level.contiguous(),
            "verts": [v.contiguous() for v in verts], "render_pts": render_pts, "nv": nv}


def check_triplane_points(tsr, scene, timed=True):
    """K4 at the Lean asset's wire vertices, at view 0's 8.39 M render
    samples and at a ragged N with a tenth of the points outside the box,
    on random unit-scale bf16 codes with the full-width decoder (weights
    K4_WEIGHT_GAIN times their fan-in scale, N(0, K5_BIAS_STD) biases),
    against its plain version on the same inputs: each output within
    K4_SPREAD_SHARE of its spread. Then at the vertices again with the main
    path's own decoder and codes, each output within K4_NOISE_FACTOR times
    the plain bf16 version's own error. Every case is checked and printed
    before a failure raises; with ``timed``, the vertex and render cases also
    get their time, the plain version's and their bound."""
    from sculptmate_tpu_torch.ops import density_grid as dg

    g = torch.Generator(device="cuda").manual_seed(4)  # the same inputs in every call
    weights = [(K4_WEIGHT_GAIN * w, K5_BIAS_STD * torch.randn(b.shape, device="cuda", generator=g))
               for w, b in tsr.decoder_weights()]
    spec = tsr.grid_spec(2, torch.bfloat16)
    codes = torch.randn(3, tsr.config.upsample_out_channels, 64, 64, device="cuda", generator=g).to(torch.bfloat16)
    n_ragged = 100_003
    ragged = [(torch.rand(n_ragged, device="cuda", generator=g) * 2.2 - 1.1) * spec.radius for _ in range(3)]
    cases = [("Lean asset's vertices", scene["verts"]), ("render view 0 samples", scene["render_pts"]),
             ("ragged, a tenth outside the box", ragged)]
    rows, failures = {}, []
    packed = dg.pack_triplane_inputs(codes, weights)
    on_log = lambda t: torch.cat([t[:1], t[1:2].log(), t[2:]])  # noqa: E731
    for name, pts in cases:
        out = dg.triplane_points(codes, weights, *pts, spec)
        torch.cuda.synchronize()
        ref = on_log(dg.triplane_points_plain(codes, weights, *pts, spec))
        got = on_log(out)
        errs = [(got[k] - ref[k]).abs().max().item() for k in range(5)]
        limits = [K4_SPREAD_SHARE * (ref[k] - ref[k].mean()).abs().max().item() for k in range(5)]
        del ref, got
        bad = [k for k in range(5) if not errs[k] <= limits[k]]
        N = pts[0].numel()
        line = {"check": "K4", "case": name, "points": N, "dtype": "bfloat16", "max_abs_err": max(errs),
                "max_abs_err_per_output": errs, "limit_per_output": limits, "outputs": "d, log exp(d + bias), r, g, b"}
        if bad or not torch.isfinite(out).all():
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: outputs {bad} past {K4_SPREAD_SHARE} of their spread")
            continue
        if not timed or name.startswith("ragged"):
            log(json.dumps({**line, "check_passed": True}))
            continue
        # per point: 120 -> 64, 8 hidden 64 x 64, 64 -> 4; bytes: the codes
        # read once, three f32 coordinates in, five f32 outputs out
        flops = N * 2 * (120 * 64 + 8 * 64 * 64 + 64 * 4)
        bound, by = bound_ms(flops, codes.numel() * codes.element_size() + N * (12 + 20), PEAK_BF16_FLOPS)
        # SiLUs: nine 64-wide layers per point; one tanh.approx.bf16x2 per
        # two, at 16 SFU results per clock per SM
        sfu_floor = 1e3 * N * 64 * 9 / 2 / (16 * torch.cuda.get_device_properties(0).multi_processor_count
                                            * sm_clock_hz())
        row = {"ms": cuda_ms(lambda: dg.triplane_points(codes, weights, *pts, spec, packed=packed), iters=5),
               "relayout_ms": cuda_ms(lambda: dg.pack_triplane_planes(codes), iters=10),
               "weights_pack_ms": cuda_ms(lambda: dg.pack_triplane_weights(weights, codes.device), iters=10),
               "plain_ms": cuda_ms(lambda: dg.triplane_points_plain(codes, weights, *pts, spec), iters=2, warmup=1,
                                   graph=False),
               "bound_ms": bound, "bound_by": by, "library_ms": None}
        log(json.dumps({**line, "check_passed": True, **row, "bound_share": bound / row["ms"],
                        "sfu_floor_ms": sfu_floor}))
        rows[name] = (max(errs), row)
    # the main path's decoder and codes: the plain version in bf16 against
    # the same function in f32 on the same bf16 values gives its own error
    main_weights = tsr.decoder_weights()
    main_codes = scene["codes"][0]
    pts = scene["verts"]
    out = on_log(dg.triplane_points(main_codes, main_weights, *pts, spec))
    ref = on_log(dg.triplane_points_plain(main_codes, main_weights, *pts, spec))
    exact = on_log(dg.triplane_points_plain(
        main_codes.float(), [(w.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()) for w, b in main_weights],
        *pts, tsr.grid_spec(2, torch.float32)))
    errs = [(out[k] - ref[k]).abs().max().item() for k in range(5)]
    noise = [(ref[k] - exact[k]).abs().max().item() for k in range(5)]
    # one bf16 ulp of each output's largest magnitude
    ulps = [2.0 ** (math.floor(math.log2(ref[k].abs().max().item())) - 7) for k in range(5)]
    bad = [k for k in range(5) if not errs[k] <= K4_NOISE_FACTOR * noise[k]]
    line = {"check": "K4", "case": "the main path's decoder and codes at the Lean asset's vertices",
            "points": pts[0].numel(), "dtype": str(main_codes.dtype), "max_abs_err": max(errs),
            "max_abs_err_per_output": errs, "plain_bf16_err_per_output": noise,
            "limit_per_output": [K4_NOISE_FACTOR * n for n in noise],
            "max_abs_err_ulps": [e / u for e, u in zip(errs, ulps)],
            "plain_bf16_err_ulps": [n / u for n, u in zip(noise, ulps)],
            "spread_ulps": [(ref[k] - ref[k].mean()).abs().max().item() / ulps[k] for k in range(5)],
            "outputs": "d, log exp(d + bias), r, g, b", "check_passed": not bad and bool(torch.isfinite(out).all())}
    del out, ref, exact
    log(json.dumps(line))
    if not line["check_passed"]:
        failures.append(f"main path's decoder: outputs {bad} past {K4_NOISE_FACTOR} x the plain bf16 version's error")
    if failures:
        raise AssertionError("K4 " + "; ".join(failures))
    return rows


def _ragged_level(shape=(64, 72, 80)):
    """A lattice of a smooth field with a cut surface through most blocks:
    by default 64 x 72 x 80 (its z side, 80, not a multiple of K10's
    32-edge words)."""
    rng = np.random.default_rng(7)
    coarse = torch.from_numpy(rng.standard_normal((1, 1, 9, 10, 11)).astype(np.float32))
    return torch.nn.functional.interpolate(coarse, size=shape, mode="trilinear")[0, 0].cuda().contiguous()


def _padded_slab(level, rows=129):
    """An x-slab as the sharded extraction makes one: the level's first
    ``rows`` x rows (a shard's own and its halo), padded with -1 (outside)
    to a multiple of 8 rows."""
    return torch.nn.functional.pad(level[:rows], (0, 0, 0, 0, 0, (-rows) % 8), value=-1.0).contiguous()


def check_mc_wire(scene, timed=True):
    """K3 against its plain version, which it must equal byte for byte
    (and in the vertex positions it hands the color query): on the Lean
    asset's 256^3 level, on a ragged 64 x 72 x 80 lattice, on a 72 x 80 x
    96 lattice whose 3 NB = 3 240 block counts fill one of the scan's
    2 048-count tiles and end in a partial one, at half the asset's
    vertex count (overflow: exact counters, the leading ids kept), and on
    a padded x-slab of the asset's level at x limits 128 and 127.
    With ``timed``, the asset's case also gets its time (the wire alone),
    the plain version's and its bound."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc

    level, nv = scene["level"], scene["nv"]
    slab = _padded_slab(level)
    cases = [("Lean asset 256^3", level, 1 << 20, -1), ("ragged 64x72x80", _ragged_level(), 1 << 18, -1),
             ("scan-ragged 72x80x96", _ragged_level((72, 80, 96)), 1 << 18, -1),
             ("Lean asset 256^3, half the vertex capacity", level, nv // 2, -1),
             ("Lean slab 136x256x256, x limit 128", slab, 1 << 19, 128),
             ("Lean slab 136x256x256, x limit 127", slab, 1 << 19, 127)]
    result, failures = None, []
    for name, lev, mv, limit in cases:
        rec = {}

        def colors(tag):
            def fn(vx, vy, vz):
                rec[tag] = torch.stack([vx, vy, vz])
                return vx * 0, vy * 0, vz * 0
            return fn

        got, _ = mc.mc_wire_device(lev, mv, colors("kernel"), valid_x_limit=limit)
        torch.cuda.synchronize()
        ref, _ = mc.mc_wire_device_plain(lev, mv, colors("plain"), valid_x_limit=limit)
        differ = int((got != ref).sum())
        pos_differ = int((rec["kernel"] != rec["plain"]).sum())
        count = int.from_bytes(ref[-8:-4].cpu().numpy().tobytes(), "little")
        line = {"check": "K3", "case": name, "shape": list(lev.shape), "max_verts": mv, "num_verts": count,
                "valid_x_limit": limit, "bytes_differing": differ, "positions_differing": pos_differ, "limit": 0}
        if differ or pos_differ:
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: {differ} wire bytes and {pos_differ} positions differ")
            continue
        if not (timed and name == "Lean asset 256^3"):
            log(json.dumps({**line, "check_passed": True}))
            continue
        # bytes: the f32 level read once; the bits, 2 B of t per vertex and
        # the counters written
        n3 = lev.numel()
        bound, by = bound_ms(0, 4 * n3 + n3 // 8 + 2 * count + 8, PEAK_F32_FLOPS)
        row = {"ms": cuda_ms(lambda: mc.mc_wire_device(lev, mv), iters=10),
               "plain_ms": cuda_ms(lambda: mc.mc_wire_device_plain(lev, mv), iters=3, graph=False),
               "bound_ms": bound, "bound_by": by, "library_ms": None}
        log(json.dumps({**line, "check_passed": True, **row, "bound_share": bound / row["ms"]}))
        result = row
    if failures:
        raise AssertionError("K3 " + "; ".join(failures))
    return result


def check_marching_cubes(scene, timed=True):
    """K10 against its plain version, which it must equal in every
    position, face, counter and vertex edge (``return_edges``): on the Lean
    asset's 256^3 level, on the ragged 64 x 72 x 80 lattice, at half the
    asset's vertex and face counts, and on a padded x-slab of the asset's
    level at x limits 128 and 127. With ``timed``, the asset's case also
    gets its time (as the packed path calls it, without the edges;
    ``edges_ms`` with them), the plain version's and its bound."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc

    level, nv = scene["level"], scene["nv"]
    slab = _padded_slab(level)
    cases = [("Lean asset 256^3", level, 1 << 20, 1 << 21, -1),
             ("ragged 64x72x80", _ragged_level(), 1 << 18, 1 << 19, -1),
             ("Lean asset 256^3, half the capacities", level, nv // 2, nv, -1),
             ("Lean slab 136x256x256, x limit 128", slab, 1 << 19, 1 << 20, 128),
             ("Lean slab 136x256x256, x limit 127", slab, 1 << 19, 1 << 20, 127)]
    result, failures = None, []
    for name, lev, mv, mf, limit in cases:
        got = mc.marching_cubes(lev, mv, mf, valid_x_limit=limit, return_edges=True)
        torch.cuda.synchronize()
        ref = mc.marching_cubes_plain(lev, mv, mf, valid_x_limit=limit, return_edges=True)
        differ = {k: int((getattr(got, k) != getattr(ref, k)).sum()) for k in mc.MCResult._fields}
        counts = [int(c) for c in ref[6:10]]
        line = {"check": "K10", "case": name, "shape": list(lev.shape), "capacities": [mv, mf], "counts": counts,
                "valid_x_limit": limit, "differing": {k: v for k, v in differ.items() if v}, "limit": 0}
        if any(differ.values()):
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: {sum(differ.values())} entries differ")
            continue
        if not (timed and name == "Lean asset 256^3"):
            log(json.dumps({**line, "check_passed": True}))
            continue
        # bytes: the f32 level read once; 12 B per vertex and per face and
        # the counters written
        bound, by = bound_ms(0, 4 * lev.numel() + 12 * counts[0] + 12 * counts[1] + 16, PEAK_F32_FLOPS)
        row = {"ms": cuda_ms(lambda: mc.marching_cubes(lev, mv, mf), iters=10),
               "plain_ms": cuda_ms(lambda: mc.marching_cubes_plain(lev, mv, mf), iters=2, warmup=1, graph=False),
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "edges_ms": cuda_ms(lambda: mc.marching_cubes(lev, mv, mf, return_edges=True), iters=10),
               "edges_bound_ms": bound_ms(0, 4 * lev.numel() + 20 * counts[0] + 12 * counts[1] + 16,
                                          PEAK_F32_FLOPS)[0]}
        log(json.dumps({**line, "check_passed": True, **row, "bound_share": bound / row["ms"]}))
        result = row
    if failures:
        raise AssertionError("K10 " + "; ".join(failures))
    return result


HOST_LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"}


def device_split(key, what, fn):
    """``fn`` once under torch.profiler, after a warm-up call: device time
    and launches by kernel name, the launches in all, their summed time and
    the range from the first kernel's start to the last one's end, and the
    host's launch calls (``HOST_LAUNCH_CALLS``: one per kernel, copy or fill
    launched op by op, one per CUDA graph replayed), printed as one
    ``{key: what, ...}`` line."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # with the CPU activity on as well: CUDA alone has dropped the region's
    # first kernel, launched at once
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    split = {}
    for e in events:
        ms, n = split.get(e.name[:60], (0.0, 0))
        split[e.name[:60]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    line = {key: what,
            "kernels_ms": {k: [ms, n] for k, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0])},
            "launches": len(events),
            "sum_ms": sum(ms for ms, _ in split.values()) if events else "not measured",
            "range_ms": ((max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) / 1e3
                         if events else "not measured"),
            "host_launches": sum(e.name in HOST_LAUNCH_CALLS for e in prof.events())}
    log(json.dumps(line))
    return line


def k10_split(scene):
    """One K10 call at the Lean asset's 256^3 level (the timed case's
    capacities), split by kernel name (``device_split``)."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc

    level = scene["level"]
    return device_split("K10_split", "one marching_cubes call, Lean asset 256^3",
                        lambda: mc.marching_cubes(level, 1 << 20, 1 << 21))


def k3_split(scene):
    """One K3 call at the Lean asset's 256^3 level (the timed case's
    capacity, no colors), split by kernel name (``device_split``)."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc

    level = scene["level"]
    return device_split("K3_split", "one mc_wire_device call, Lean asset 256^3",
                        lambda: mc.mc_wire_device(level, 1 << 20))


def k5_split(sf3d, codes):
    """One ``SF3D.query_lattice`` (the ``sf3d.grid`` span: the resample,
    the factorized first layer and K5, with K5's weights as the model keeps
    them) at the 161^3 lattice on the given codes, split by kernel name
    (``device_split``): its launches per asset."""
    return device_split("K5_split", "one SF3D.query_lattice (sf3d.grid), 161^3",
                        lambda: sf3d.query_lattice(codes))


def k6_split(sf3d, codes, n=512 * 512):
    """One ``SF3D._surface_query`` (the ``sf3d.texel_query`` span: the
    planes' relayout, K6 with the heads as the model keeps them, the
    sigmoid and the normalisation) at ``n`` texel points uniform in the
    radius cube of the given codes, split by kernel name
    (``device_split``): its launches per textured asset."""
    g = torch.Generator(device="cuda").manual_seed(12)
    r = sf3d.config.radius
    pts = [(torch.rand(n, device="cuda", generator=g) * 2 - 1) * r for _ in range(3)]
    return device_split("K6_split", f"one SF3D._surface_query (sf3d.texel_query), {n} points",
                        lambda: sf3d._surface_query(codes, *pts))


def k7_split(scene):
    """One K7 call on the full-width SF3D asset's 161^3 lattice (snap_eps
    0.2, the timed case's capacity), split by kernel name
    (``device_split``)."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt

    return device_split("K7_split", "one mt_wire_device call, SF3D asset 161^3, snap 0.2",
                        lambda: mt.mt_wire_device(*scene["mt"], scene["mt_res"], 1 << 21, 0.2))


def k8_split(scene):
    """One K8 bake raster at 512^2 (face ids, margin 0) of the full-width
    asset's atlas, split by kernel name (``device_split``): the winner's
    fill and the raster."""
    from sculptmate_tpu_torch.geometry import texture_bake as tb

    rows = [scene["uv6"][k].contiguous() for k in range(6)]
    key = torch.arange(rows[0].shape[0], dtype=torch.int32, device="cuda")
    return device_split("K8_split", "one binned_winner call, bake 512^2, face ids",
                        lambda: tb.binned_winner(*rows, key, 512))


def k9_split(scene):
    """One K9 ``unwrap_core`` on the full-width asset's mesh, its two K8
    rasters included, split by kernel name (``device_split``): every launch
    and copy of the call, PyTorch's glue between the passes included."""
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud

    pos, f = scene["pos"], scene["f"]
    return device_split("K9_split", "one unwrap_core call, SF3D asset mesh",
                        lambda: ud.unwrap_core(pos[0], pos[1], pos[2], f[0], f[1], f[2]))


def _ragged_border_mt(N=38):
    """A ragged tet lattice (by default res = 37: N = 38 points, not a
    multiple of 8) of a smooth field whose sdf is positive on all six faces,
    so the classes that step along two or three axes reach past the last
    real point unless the domain mask holds; offsets N(0, 1)."""
    rng = np.random.default_rng(11)
    x = np.linspace(-1, 1, N, dtype=np.float32)
    g = np.stack(np.meshgrid(x, x, x, indexing="ij"))
    sdf = np.sin(3 * g[0]) * np.cos(2 * g[1]) + 0.5 * g[2] + 0.1 * rng.standard_normal((N, N, N))
    border = np.zeros((N, N, N), bool)
    for a in range(3):
        border[(slice(None),) * a + (0,)] = border[(slice(None),) * a + (-1,)] = True
    sdf = np.where(border, np.abs(sdf) + 0.1, sdf).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (sdf, *(rng.standard_normal((N, N, N)).astype(np.float32)
                                                         for _ in range(3)))]


def check_mt_wire(scene, timed=True):
    """K7 against its plain version, which it must equal byte for byte
    (occupancy bits, the u16 positions and the counters): on the full-width
    SF3D asset's 161^3 lattice (its sdf and raw offsets) at snap_eps 0.2
    (the default weld_eps) and 0, on the ragged res = 37 lattice with a
    surface on its faces, on a res = 100 lattice of the same kind whose
    7 NB = 15 379 block counts fill 7 of the scan's 2 048-count tiles and
    end in a partial eighth, and at a third of the asset's vertex count
    (overflow: exact counters, the leading ids kept). With ``timed``, the
    asset's case at 0.2 also gets its time, the plain version's and its
    bound."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt

    sdf, dx, dy, dz = scene["mt"]
    res = scene["mt_res"]
    nv = scene["mt_nv"]
    cases = [("SF3D asset 161^3, snap 0.2", (sdf, dx, dy, dz), res, 1 << 21, 0.2),
             ("SF3D asset 161^3, snap 0", (sdf, dx, dy, dz), res, 1 << 21, 0.0),
             ("ragged res 37, surface on the faces", _ragged_border_mt(), 37, 1 << 17, 0.2),
             ("multi-tile res 100, 8 scan tiles", _ragged_border_mt(101), 100, 1 << 20, 0.2),
             ("SF3D asset 161^3, a third of the vertex capacity", (sdf, dx, dy, dz), res, nv // 3, 0.2)]
    result, failures = None, []
    for name, inputs, r, mv, eps in cases:
        got = mt.mt_wire_device(*inputs, r, mv, eps)
        torch.cuda.synchronize()
        ref = mt.mt_wire_device_plain(*inputs, r, mv, eps)
        n_bits = (-(-(r + 1) // 8) * 8) ** 3 // 8
        q = lambda w: (w[n_bits:-8].reshape(6, mv)[0::2].int() | (w[n_bits:-8].reshape(6, mv)[1::2].int() << 8))  # noqa: E731
        count = int.from_bytes(ref[-8:-4].cpu().numpy().tobytes(), "little")
        line = {"check": "K7", "case": name, "resolution": r, "max_verts": mv, "snap_eps": eps, "num_verts": count,
                "bits_differing": int((got[:n_bits] != ref[:n_bits]).sum()),
                "position_bytes_differing": int((got[n_bits:-8] != ref[n_bits:-8]).sum()),
                "max_u16_step_differing": int((q(got) - q(ref)).abs().max()),
                "counters_equal": bool(torch.equal(got[-8:], ref[-8:])), "limit": "byte-equal"}
        if not torch.equal(got, ref):
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: {line['bits_differing']} bit bytes, {line['position_bytes_differing']} position "
                            f"bytes differ, counters equal {line['counters_equal']}")
            continue
        if not (timed and name == "SF3D asset 161^3, snap 0.2"):
            log(json.dumps({**line, "check_passed": True}))
            continue
        # bytes: the f32 sdf and three offsets read once; the bits, 6 B per
        # vertex and the counters written
        N = r + 1
        bound, by = bound_ms(0, 16 * N**3 + n_bits + 6 * min(count, mv) + 8, PEAK_F32_FLOPS)
        row = {"ms": cuda_ms(lambda: mt.mt_wire_device(*inputs, r, mv, eps), iters=10),
               "plain_ms": cuda_ms(lambda: mt.mt_wire_device_plain(*inputs, r, mv, eps), iters=3, graph=False),
               "bound_ms": bound, "bound_by": by, "library_ms": None}
        log(json.dumps({**line, "check_passed": True, **row, "bound_share": bound / row["ms"]}))
        result = row
    if failures:
        raise AssertionError("K7 " + "; ".join(failures))
    return result


def check_marching_tets(scene, timed=True):
    """K11 against its plain version, which it must equal in every
    position, face and counter: on the full-width SF3D asset's 161^3
    lattice (its sdf and raw offsets), on the ragged res = 37 lattice with
    a surface on its faces, on a res = 100 lattice whose block counts span
    several scan tiles (2 197 face counts over two, 15 379 class flags over
    eight), and at a third of the asset's vertex and face counts
    (overflow: exact counters, the leading rows kept). With ``timed``, the
    asset's case also gets its time, the plain version's and its bound."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt

    res = scene["mt_res"]
    asset = scene["mt"]
    sized = mt.marching_tets_plain(*asset, res, 1 << 21, 1 << 22)
    nv, nf = int(sized.num_verts), int(sized.num_faces)
    cases = [("SF3D asset 161^3", asset, res, 1 << 21, 1 << 22),
             ("ragged res 37, surface on the faces", _ragged_border_mt(), 37, 1 << 17, 1 << 18),
             ("multi-tile res 100", _ragged_border_mt(101), 100, 1 << 20, 1 << 21),
             ("SF3D asset 161^3, a third of the capacities", asset, res, nv // 3, nf // 3)]
    result, failures = None, []
    for name, inputs, r, mv, mf in cases:
        got = mt.marching_tets(*inputs, r, mv, mf)
        torch.cuda.synchronize()
        ref = mt.marching_tets_plain(*inputs, r, mv, mf)
        differ = {k: int((getattr(got, k) != getattr(ref, k)).sum()) for k in mt.MTResult._fields}
        counts = [int(c) for c in ref[6:]]
        line = {"check": "K11", "case": name, "resolution": r, "capacities": [mv, mf], "counts": counts,
                "differing": {k: v for k, v in differ.items() if v}, "limit": 0}
        if any(differ.values()) or counts[0] == 0:
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"K11 {name}: {sum(differ.values())} entries differ, counts {counts}")
            continue
        if not (timed and name == "SF3D asset 161^3"):
            log(json.dumps({**line, "check_passed": True}))
            continue
        # bytes: the f32 sdf and three offsets read once; 12 B per vertex and
        # per face and the five counters written
        N = r + 1
        bound, by = bound_ms(0, 16 * N**3 + 12 * counts[0] + 12 * counts[1] + 20, PEAK_F32_FLOPS)
        row = {"ms": cuda_ms(lambda: mt.marching_tets(*inputs, r, mv, mf), iters=10),
               "plain_ms": cuda_ms(lambda: mt.marching_tets_plain(*inputs, r, mv, mf), iters=2, warmup=1, graph=False),
               "bound_ms": bound, "bound_by": by, "library_ms": None}
        log(json.dumps({**line, "check_passed": True, **row, "bound_share": bound / row["ms"]}))
        result = row
    if failures:
        raise AssertionError("; ".join(failures))
    return result


def k11_split(scene):
    """One K11 call on the full-width SF3D asset's 161^3 lattice (the timed
    case's capacities), split by kernel name (``device_split``)."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt

    return device_split("K11_split", "one marching_tets call, SF3D asset 161^3",
                        lambda: mt.marching_tets(*scene["mt"], scene["mt_res"], 1 << 21, 1 << 22))


def randomize_modulations(sf3d, generator, share=0.1):
    """Nonzero AdaLN modulation weights (the module zero-initialises them,
    so a seeded model would never exercise the camera conditioning):
    fan-in normal scaled by ``share``, drawn in f32 and rounded to the
    weight's own dtype (bf16 on a bf16 model, as autocast would round)."""
    for layer in sf3d.module.image_tokenizer.model.encoder.layer:
        for mod in (layer.norm1_modulation, layer.norm2_modulation):
            w = mod.linear2.weight
            w.copy_(torch.empty(w.shape, device=w.device).normal_(0.0, share * w.shape[1] ** -0.5,
                                                                  generator=generator))


def randomize_lattice_biases(sf3d, generator):
    """Nonzero biases in every layer of the density and vertex-offset heads
    (N(0, K5_BIAS_STD); the module zero-initialises them)."""
    for name in ("density", "vertex_offset"):
        for m in sf3d.module.decoder.heads[name].modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.normal_(0.0, K5_BIAS_STD, generator=generator)


def sf3d_small_check():
    """A narrow SF3D (64-wide heads everywhere, so K1 runs; f32, TF32 off;
    nonzero modulations and lattice-head biases; R = 32, a ragged 33-point
    lattice) on the card
    against the same weights on the CPU: scene codes within 1e-4 of max
    |codes|, and the raw lattice query of the card's codes (K5, bf16)
    against the CPU's plain version (bf16) within K5_SPREAD_SHARE of each
    channel's spread."""
    from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

    cfg = SF3DConfig(cond_image_size=56, isosurface_resolution=32, plane_size=8, num_channels=64,
                     num_attention_heads=1, attention_head_dim=64, num_latents=32, num_blocks=1, num_basic_blocks=1,
                     upsample_scale_factor=2, upsample_conv_layers=2, dinov2_hidden_size=128, dinov2_num_layers=2,
                     dinov2_num_heads=2, dinov2_intermediate_size=256, clip_width=128, clip_layers=2, clip_heads=2)
    cpu = SF3D(cfg, seed=1, dtype=torch.float32, extract_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        randomize_modulations(cpu, torch.Generator().manual_seed(1), share=1.0)
        randomize_lattice_biases(cpu, torch.Generator().manual_seed(2))
    card = SF3D(cfg, state_dict=cpu.module.state_dict(), dtype=torch.float32, extract_dtype=torch.bfloat16,
                device="cuda")
    img = torch.from_numpy(np.random.default_rng(1).random((1, 56, 56, 4), np.float32))
    ref, _ = cpu.get_scene_codes(cpu.prepare_image(img)[1])
    got, _ = card.get_scene_codes(card.prepare_image(img.cuda())[1])
    err, limit = (got.cpu() - ref).abs().max().item(), 1e-4 * ref.abs().max().item()
    grid = card.query_lattice(got[0])
    grid_ref = cpu.query_lattice(got[0].cpu())
    gerr = {n: [(grid[n][k].cpu() - grid_ref[n][k]).abs().max().item() for k in range(len(grid_ref[n]))]
            for n in grid_ref}
    glim = {n: [K5_SPREAD_SHARE * (c - c.mean()).abs().max().item() for c in grid_ref[n]] for n in grid_ref}
    ok = err <= limit and all(e <= lim for n in gerr for e, lim in zip(gerr[n], glim[n]))
    log(json.dumps({"check": "small SF3D, card vs CPU", "codes_max_abs_err": err, "codes_limit": limit,
                    "grid_max_abs_err": gerr, "grid_limit": glim, "check_passed": ok}))
    if not ok:
        raise AssertionError("small SF3D disagrees between the card and the CPU")


def sf3d_mesh_ok(mesh, sf3d):
    """An SF3D mesh as the path must give it: non-empty, faces in range,
    vertices finite and inside the lattice's bbox (the radius plus the
    deformation's reach of one lattice step), UVs in [0, 1]."""
    v, f, uv = mesh["verts"], mesh["faces"], mesh["uvs"]
    reach = sf3d.config.radius * (1 + 2 / sf3d.config.isosurface_resolution)
    return (
        len(v) > 0 and len(f) > 0 and f.min() >= 0 and f.max() < len(v)
        and np.isfinite(v).all() and np.abs(v).max() <= reach + 1e-5
        and uv.shape == (len(v), 2) and uv.min() >= 0 and uv.max() <= 1
    )


def sf3d_path(gen, scene):
    """Full-width SF3D path, untextured: Fast3DGenerator once with the
    launch counters around it (the unwrap is K9's on the card), then a
    warm-up and 3 timed assets through run_image, then a profile of one
    asset."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.geometry import texture_bake as tb
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.attention import flash_attention

    sf3d = gen.model
    image, threshold = scene["image"], scene["threshold"]
    with tempfile.TemporaryDirectory() as tmp:
        glb = os.path.join(tmp, "asset.glb")
        torch.cuda.synchronize()
        flash_attention.launches = dg.grid_multihead.launches = tb.binned_winner.launches = 0
        ud.unwrap_core.launches = mt.mt_wire_device.launches = 0
        rc = gen.generate_mesh(image, output_path=glb, enable_texture=False, threshold=threshold)
        torch.cuda.synchronize()
        launches = {"K1": flash_attention.launches, "K5": dg.grid_multihead.launches,
                    "K7": mt.mt_wire_device.launches, "K8": tb.binned_winner.launches,
                    "K9": ud.unwrap_core.launches}
        glb_bytes = os.path.getsize(glb) if rc == 0 else 0
    log(json.dumps({"sf3d_path": "Fast3DGenerator.generate_mesh(enable_texture=False)", "rc": rc,
                    "launches": launches, "glb_bytes": glb_bytes}))
    if rc != 0:
        raise RuntimeError(f"Fast3DGenerator.generate_mesh returned {rc}")
    if (launches["K1"] != 68 or launches["K5"] < 1 or launches["K7"] < 1 or launches["K9"] < 1
            or launches["K8"] < 2):
        raise AssertionError(f"SF3D path missed a kernel: {launches}")

    runs, meshes = [], []
    for it in range(4):  # 1 warm-up + 3 timed
        timings = {}
        t0 = time.perf_counter()
        mesh = sf3d.run_image(image[None], enable_texture=False, threshold=threshold, timings=timings)
        sec = time.perf_counter() - t0
        if it:
            runs.append((sec, timings))
            meshes.append(mesh)
    bad = [i for i, m in enumerate(meshes) if m is None or not sf3d_mesh_ok(m, sf3d)]
    split = {k: 1e3 * float(np.median([t[k] for _, t in runs])) for k in runs[0][1]}
    sec = float(np.median([r[0] for r in runs]))
    log(json.dumps({"sf3d_path": "SF3D.run_image(enable_texture=False)", "sf3d_sec_per_asset": sec,
                    "stage_ms": split, "runs_sec": [round(r[0], 4) for r in runs],
                    "verts": [len(m["verts"]) for m in meshes if m], "faces": [len(m["faces"]) for m in meshes if m],
                    "threshold": threshold, "meshes_failing_checks": bad}))
    if bad:
        raise AssertionError(f"SF3D meshes {bad} failed their checks")
    where_time_goes("one SF3D asset (run_image, untextured)",
                    lambda: sf3d.run_image(image[None], enable_texture=False, threshold=threshold),
                    prefixes=("sf3d.",))
    return launches


def textures_ok(mesh, res):
    """A textured SF3D mesh's maps as the bake must give them: albedo and
    bump (res, res, 3) in [0, 1] and finite, a covered share of the atlas
    above zero (the UVs rasterized by K8), roughness and metallic in
    [0, 1], three PNGs; returns (ok, covered share)."""
    from sculptmate_tpu_torch.geometry import texture_bake as tb

    tex = mesh["textures"]
    uv = mesh["uvs"].reshape(-1, 3, 2)
    corners = [torch.from_numpy(np.ascontiguousarray(uv[:, c, d])).cuda() for c in range(3) for d in range(2)]
    covered = float((tb.rasterize_device(*corners, res)[3] >= 0).float().mean())
    maps_ok = all(
        tex[k].shape == (res, res, 3) and np.isfinite(tex[k]).all() and tex[k].min() >= 0 and tex[k].max() <= 1
        for k in ("albedo", "bump")
    )
    pngs = mesh["texture_pngs"]
    ok = (maps_ok and covered > 0 and 0 <= mesh["roughness"] <= 1 and 0 <= mesh["metallic"] <= 1
          and set(pngs) == {"baseColor", "normal", "metallicRoughness"} and all(len(v) > 100 for v in pngs.values()))
    return ok, covered


def sf3d_textured_path(gen, scene):
    """Full-width textured SF3D path (the fused unwrap and bake, 512^2):
    Fast3DGenerator once with the launch counters around it (K1 = 68, K5,
    K9, K8 >= 3: two visibility rounds and the bake, K6) and a GLB holding
    three images; then a warm-up and 3 timed run_image assets, every mesh
    and map checked; then a profile of one asset."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.geometry import texture_bake as tb
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.attention import flash_attention

    sf3d = gen.model
    image, threshold = scene["image"], scene["threshold"]
    with tempfile.TemporaryDirectory() as tmp:
        glb = os.path.join(tmp, "asset.glb")
        torch.cuda.synchronize()
        flash_attention.launches = dg.grid_multihead.launches = tb.binned_winner.launches = 0
        ud.unwrap_core.launches = dg.points_multihead.launches = mt.mt_wire_device.launches = 0
        rc = gen.generate_mesh(image, output_path=glb, threshold=threshold)  # enable_texture defaults to True
        torch.cuda.synchronize()
        data = b""
        launches = {"K1": flash_attention.launches, "K5": dg.grid_multihead.launches,
                    "K6": dg.points_multihead.launches, "K7": mt.mt_wire_device.launches,
                    "K8": tb.binned_winner.launches, "K9": ud.unwrap_core.launches}
        images = 0
        if rc == 0:
            with open(glb, "rb") as fh:
                data = fh.read()
            gltf = json.loads(data[20 : 20 + int.from_bytes(data[12:16], "little")])
            images = len(gltf.get("images", []))
    log(json.dumps({"sf3d_textured_path": "Fast3DGenerator.generate_mesh()", "rc": rc, "launches": launches,
                    "glb_bytes": len(data), "glb_images": images}))
    if rc != 0:
        raise RuntimeError(f"Fast3DGenerator.generate_mesh returned {rc}")
    if (launches["K1"] != 68 or launches["K5"] < 1 or launches["K6"] < 1 or launches["K7"] < 1
            or launches["K8"] < 3 or launches["K9"] < 1 or images != 3):
        raise AssertionError(f"textured SF3D path missed a kernel or a texture: {launches}, {images} images")

    runs, meshes = [], []
    for it in range(4):  # 1 warm-up + 3 timed
        timings = {}
        t0 = time.perf_counter()
        mesh = sf3d.run_image(image[None], threshold=threshold, timings=timings)
        sec = time.perf_counter() - t0
        if it:
            runs.append((sec, timings))
            meshes.append(mesh)
    checks = [textures_ok(m, 512) if m is not None else (False, 0.0) for m in meshes]
    bad = [i for i, m in enumerate(meshes) if m is None or not sf3d_mesh_ok(m, sf3d) or not checks[i][0]]
    split = {k: 1e3 * float(np.median([t[k] for _, t in runs])) for k in runs[0][1]}
    sec = float(np.median([r[0] for r in runs]))
    log(json.dumps({"sf3d_textured_path": "SF3D.run_image(enable_texture=True)", "sf3d_textured_sec_per_asset": sec,
                    "stage_ms": split, "runs_sec": [round(r[0], 4) for r in runs], "bake_resolution": 512,
                    "verts": [len(m["verts"]) for m in meshes if m], "faces": [len(m["faces"]) for m in meshes if m],
                    "covered_share": [round(c, 4) for _, c in checks],
                    "roughness_metallic": [[m["roughness"], m["metallic"]] for m in meshes if m],
                    "meshes_failing_checks": bad}))
    if bad:
        raise AssertionError(f"textured SF3D meshes {bad} failed their checks")
    where_time_goes("one textured SF3D asset (run_image, fused unwrap and bake 512^2)",
                    lambda: sf3d.run_image(image[None], threshold=threshold), prefixes=("sf3d.",))
    return launches


def sf3d_async_contract(sf3d, scene):
    """The fused unwrap and bake's dispatch (``unwrap_bake_async``) of two
    in-flight assets under ``torch.cuda.set_sync_debug_mode("error")``: a
    host sync anywhere there raises. Then the waits; their UVs and maps are
    checked."""
    verts, faces = scene["verts"], scene["faces"]
    code, mats = scene["codes"][0], scene["materials"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [sf3d.unwrap_bake_async(verts, faces, code, mats, 512) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pending = not handles[1].events[-1].query()
    results = [sf3d.unwrap_bake_wait(h) for h in handles]
    same = bool(np.array_equal(results[0][0], results[1][0]))
    ok = all(np.isfinite(uv).all() and uv.min() >= 0 and uv.max() <= 1 and uv.shape == (len(faces), 3, 2)
             for uv, _ in results)
    log(json.dumps({"check": "no host sync in unwrap_bake_async", "assets_in_flight": 2, "passed": ok,
                    "second_pending_after_dispatch": pending, "both_uvs_equal": same}))
    if not ok or not same:
        raise AssertionError("the fused unwrap and bake's results failed their checks")


def sf3d_farm_path(sf3d, scene):
    """``SF3DFarm.generate_batch`` on four matted 512^2 RGBA images (the
    scene's disc, then three with other colors), textured at 512^2: one
    warm-up batch, one timed; every mesh and map checked."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.parallel.sf3d_farm import SF3DFarm

    batch = 4
    rng = np.random.default_rng(6)
    images = np.repeat(scene["image"][None], batch, axis=0)
    images[1:, ..., :3] = rng.random((batch - 1, 512, 512, 3)).astype(np.float32)
    farm = SF3DFarm(sf3d)
    farm.generate_batch(images[:1], threshold=scene["threshold"])  # warm-up
    torch.cuda.synchronize()
    mt.mt_wire_device.launches = 0
    t0 = time.perf_counter()
    meshes = farm.generate_batch(images, threshold=scene["threshold"])
    sec = time.perf_counter() - t0
    k7 = mt.mt_wire_device.launches
    checks = [textures_ok(m, 512) if m is not None else (False, 0.0) for m in meshes]
    bad = [i for i, m in enumerate(meshes) if m is None or not sf3d_mesh_ok(m, sf3d) or not checks[i][0]]
    log(json.dumps({"sf3d_farm_path": "SF3DFarm.generate_batch (textured 512^2)", "batch": batch,
                    "launches": {"K7": k7},
                    "sf3d_farm_sec_per_asset": sec / batch, "batch_sec": round(sec, 4),
                    "faces": [len(m["faces"]) for m in meshes if m], "covered_share": [round(c, 4) for _, c in checks],
                    "meshes_failing_checks": bad}))
    if bad or len(meshes) != batch:
        raise AssertionError(f"SF3D farm meshes {bad} failed their checks")
    if k7 < batch:
        raise AssertionError(f"the SF3D farm's extraction missed K7: {k7} launches for {batch} assets")
    where_time_goes("one SF3D farm batch of 2 (textured)", lambda: farm.generate_batch(images[:2],
                    threshold=scene["threshold"]), prefixes=("sf3d_farm.", "sf3d."))
    return {"K7": k7}


def _wire_to_packed(sdf, res):
    """For each MT wire vertex (block-major order), the index of the same
    cut edge among the packed mesh's vertices (class-major, raster
    order)."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt

    N = res + 1
    Np = -(-N // 8) * 8
    occ = torch.zeros((Np, Np, Np), dtype=torch.bool, device=sdf.device)
    occ[:N, :N, :N] = sdf.reshape(N, N, N) > 0
    masks = mt._cut_masks(occ, N)
    edge_ids = torch.arange(masks.numel(), device=sdf.device).reshape(masks.shape)
    wire_edges = mt._to_blocks(edge_ids)[mt._to_blocks(masks)]
    return torch.searchsorted(torch.nonzero(masks.reshape(-1)).reshape(-1), wire_edges).cpu().numpy()


def _triangle_set(faces):
    """Faces as sorted rows, each rotated to start at its smallest id
    (orientation kept)."""
    f = np.asarray(faces, np.int64)
    r = np.argmin(f, axis=1)
    f = np.stack([f[np.arange(len(f)), (r + k) % 3] for k in range(3)], 1)
    return f[np.lexsort(f.T[::-1])]


def sf3d_packed_path(fast, scene):
    """The packed SF3D extraction at full width: one
    ``SF3D._extract_packed_mesh`` on the asset's codes with K11's counter
    read around it, held to the wire extraction of the same codes at
    snap_eps 0 (the same vertex and face counts, each vertex within one u16
    step of the wire's at the same cut edge, the same triangles as sets);
    then a warm-up and three timed assets of each (encode + extraction)."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.geometry import mt_wire

    sf3d = fast.model
    code, threshold, res, r = scene["codes"][0], scene["threshold"], scene["mt_res"], sf3d.config.radius
    mv, mf = 1 << 21, 1 << 22
    torch.cuda.synchronize()
    mt.marching_tets.launches = 0
    verts, faces, counts = sf3d._extract_packed_mesh(code, threshold, mv, mf)
    torch.cuda.synchronize()
    launches = {"K11": mt.marching_tets.launches}
    wire = sf3d._extract_wire(code, threshold, mv, 0.0).cpu().numpy()
    wv, wf, wcounts = mt_wire.decode_wire(wire, res, mv)
    nv, nf = int(counts[0]), int(counts[1])
    same_counts = nv == len(wv) == int(wcounts[0]) and nf == len(wf) and nv <= mv and nf <= mf
    pos_err = tri_equal = None
    step = (1 + 2 / res) / 65535  # one u16 step of the wire, in lattice units
    if same_counts:
        match = _wire_to_packed(scene["mt"][0], res)
        lattice = (verts.astype(np.float64) + r) / (2 * r)
        pos_err = float(np.abs(lattice[match] - wv).max())
        tri_equal = bool(np.array_equal(_triangle_set(faces), _triangle_set(match[wf])))
    ok = bool(same_counts and pos_err <= step and tri_equal and faces.dtype == np.int32
              and np.isfinite(verts).all() and faces.min() >= 0 and faces.max() < nv)
    log(json.dumps({"sf3d_packed_path": "SF3D._extract_packed_mesh vs the wire at snap_eps 0", "launches": launches,
                    "verts": [nv, len(wv)], "faces": [nf, len(wf)], "counters": counts.tolist(),
                    "max_pos_err_lattice_units": pos_err, "limit": step, "triangles_equal": tri_equal,
                    "passed": ok}))
    if not ok:
        raise AssertionError("the packed SF3D mesh disagrees with the wire mesh")
    if launches["K11"] < 1:
        raise AssertionError(f"the packed SF3D path missed K11: {launches}")

    image = scene["image"][None]
    runs = {"packed": [], "wire": []}
    for it in range(4):  # 1 warm-up + 3 timed, the two in turns
        for kind in ("packed", "wire"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mask, rgb = sf3d.prepare_image(torch.from_numpy(image).cuda())
            codes, _ = sf3d.get_scene_codes(rgb)
            if kind == "packed":
                sf3d._extract_packed_mesh(codes[0], threshold, mv, mf)
            else:
                sf3d.extract_mesh(codes[0], threshold)
            torch.cuda.synchronize()
            if it:
                runs[kind].append(time.perf_counter() - t0)
    log(json.dumps({"sf3d_packed_path": "timed (encode + extraction)",
                    "sf3d_packed_sec_per_asset": float(np.median(runs["packed"])),
                    "sf3d_wire_extract_sec_per_asset": float(np.median(runs["wire"])),
                    "runs_sec": {k: [round(t, 4) for t in v] for k, v in runs.items()}}))
    return launches


def marching_cubes_host_check():
    """``marching_cubes_host`` on the card (K10) against the CPU (its plain
    version) on a ragged 37 x 45 x 50 level (padded to multiples of 8 with
    -1 inside), at its default capacities and at capacities it must retry
    past: the same vertices and faces."""
    from sculptmate_tpu_torch.geometry import marching_cubes_host

    rng = np.random.default_rng(13)
    g = np.meshgrid(*(np.linspace(-1, 1, n, dtype=np.float32) for n in (37, 45, 50)), indexing="ij")
    level = (0.7 - np.sqrt(sum(x**2 for x in g)) + 0.2 * rng.standard_normal((37, 45, 50))).astype(np.float32)
    failures = []
    for caps in ((0, 0), (1000, 2000)):
        v, f = marching_cubes_host(level, *caps)
        cv, cf = marching_cubes_host(level, *caps, device="cpu")
        ok = len(f) > 0 and np.array_equal(v, cv) and np.array_equal(f, cf)
        log(json.dumps({"check": "marching_cubes_host card vs CPU", "shape": [37, 45, 50], "capacities": list(caps),
                        "verts": [len(v), len(cv)], "faces": [len(f), len(cf)], "check_passed": ok}))
        if not ok:
            failures.append(f"capacities {caps}")
    if failures:
        raise AssertionError("marching_cubes_host differs between the card and the CPU at " + ", ".join(failures))


class _AtThreshold:
    """A generator whose ``generate_mesh`` gets a fixed iso-level: the
    random weights never reach the configs' levels, and the panel passes
    none."""

    def __init__(self, gen, threshold):
        self.gen, self.threshold = gen, threshold

    def generate_mesh(self, image, **kw):
        return self.gen.generate_mesh(image, threshold=self.threshold, **kw)


def _fake_children(obj):
    """The attribute names a fake-bpy recording object was given."""
    return set(object.__getattribute__(obj, "_children"))


def addon_path(gen, fast, lean, scene):
    """The Blender add-on under ``tests/fake_bpy.py`` installed as bpy: the
    panel's ``GenerationWorker`` run synchronously on a 512^2 numpy RGBA
    image with the full-width Lean and Pro generators that ``main`` holds
    (the Pro model textured at the panel's default detail), each at its
    scene's threshold. The fake scene must hold one object per asset with
    the generator's vertex and face counts, the Lean one a vertex-color
    layer, the Pro one a UV layer and the albedo and bump images; the
    kernels' counters are read around each run. Prints the generation and
    ``import_mesh`` seconds per asset. bpy is removed again afterwards."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.geometry import texture_bake as tb
    from sculptmate_tpu_torch.geometry import uv_unwrap_device as ud
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.attention import flash_attention

    counters = {"K1": flash_attention, "K2": dg.density_mlp, "K3": mc.mc_wire_device, "K4": dg.triplane_points,
                "K5": dg.grid_multihead, "K6": dg.points_multihead, "K7": mt.mt_wire_device, "K8": tb.binned_winner,
                "K9": ud.unwrap_core, "K10": mc.marching_cubes}
    need = {"lean": ("K1", "K2", "K10", "K4"), "fast": ("K1", "K5", "K6", "K7", "K8", "K9")}
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    try:
        import fake_bpy
    finally:
        sys.path.pop(0)
    bpy = fake_bpy.install()
    from sculptmate_tpu_torch.addon import blender_io

    import_mesh = blender_io.import_mesh
    try:
        from sculptmate_tpu_torch.addon import panel

        panel.register()
        wm = bpy.context.window_manager
        panel._generators["lean"] = _AtThreshold(gen, lean["threshold"])
        panel._generators["fast"] = _AtThreshold(fast, scene["threshold"])
        imported = []

        def timed_import(verts, faces, **kw):
            t0 = time.perf_counter()
            obj = import_mesh(verts, faces, **kw)
            imported.append({"verts": len(verts), "faces": len(faces), "sec": time.perf_counter() - t0, "obj": obj})
            return obj

        blender_io.import_mesh = timed_import
        rgba_lean = np.concatenate([lean["image"], np.ones_like(lean["image"][..., :1])], -1)
        lines, failures = {}, []
        for model, image in (("lean", rgba_lean), ("fast", scene["image"])):
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            worker = panel.GenerationWorker(image, model, "high", True, f"{model}_asset")
            t0 = time.perf_counter()
            worker.run()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items() if c.launches}
            got = imported[-1] if imported and imported[-1]["obj"].name == f"{model}_asset" else None
            obj = got["obj"] if got else None
            if obj is not None:
                mesh = obj.data
                layers = _fake_children(mesh.vertex_colors)
                ok = (len(mesh.verts) == got["verts"] and len(mesh.faces) == got["faces"] and got["faces"] > 0
                      and (f"[{model}_asset_VC]" in layers if model == "lean"
                           else "active" in _fake_children(mesh.uv_layers)))
            else:
                ok = False
            ok = ok and wm.sm_message.startswith("Done") and all(launches.get(k, 0) >= 1 for k in need[model])
            lines[model] = {"message": wm.sm_message, "generation_sec": sec - (got["sec"] if got else 0.0),
                            "import_mesh_sec": got["sec"] if got else None, "verts": got and got["verts"],
                            "faces": got and got["faces"], "launches": launches, "passed": ok}
            if not ok:
                failures.append(model)
        images = sorted(object.__getattribute__(img, "_name") for img in bpy.data.images.items)
        objects = [o.name for o in bpy.context.linked_objects]
        scene_ok = objects == ["lean_asset", "fast_asset"] and images == ["BaseColor", "Bump"]
        log(json.dumps({"addon_path": "panel.GenerationWorker(...).run() under fake bpy",
                        "lean": lines["lean"], "pro_textured_high": lines["fast"], "objects": objects,
                        "images": images, "scene_ok": scene_ok}))
        log(json.dumps({"addon_path_sec": {"lean_generation": lines["lean"]["generation_sec"],
                                           "lean_import_mesh": lines["lean"]["import_mesh_sec"],
                                           "pro_generation": lines["fast"]["generation_sec"],
                                           "pro_import_mesh": lines["fast"]["import_mesh_sec"]}}))
        if failures or not scene_ok:
            raise AssertionError(f"the add-on path failed for {failures or 'the scene'}: {objects}")
        panel.unregister()
    finally:
        blender_io.import_mesh = import_mesh
        sys.modules.pop("bpy", None)


# The tensor-parallel codes of the multi-device phase. In f32 (a full-width
# TSR with the served model's weights, TF32 off) the split only reorders
# sums, so the tp codes are held to CARD_CPU_SHARE of max |codes|, the
# smoke's card-against-CPU codes limit. In bf16, as served, each row-split
# projection's partials are rounded to bf16 before they are summed (in
# f32), one bf16 rounding more than the unsplit product's, 48 of them per
# Lean encode (44 per SF3D): about sqrt(48) x 2^-9 of max |codes| if they
# add up at random, ~19 % if every one adds up the same way. A dropped head
# or partial moves codes by a large share of max |codes|. The bf16 codes
# are held within TP_BF16_SHARE of it
TP_BF16_SHARE = 0.05
MULTI_R = 512  # the high-resolution extraction's lattice (BASELINE config 4)
MULTI_SP = 4


def mesh_devices(n=MULTI_SP):
    """n shards over the visible cards: one card n times, or one card each
    (round robin)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def edge_stats(faces):
    """(directed edges, directed edges whose reverse is missing): a failed
    seam weld leaves duplicated vertices and so unpaired edges
    (``tests/test_parallel.py``'s ``edge_stats``, its sorts on the card,
    not on its shared host: a directed edge is paired when its undirected
    key appears twice among the distinct directed edges)."""
    f = torch.from_numpy(np.asarray(faces, np.int64)).cuda()
    n = int(f.max()) + 1
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    fwd = torch.unique(e[:, 0] * n + e[:, 1])
    a, b = fwd // n, fwd % n
    und = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b)).values
    single = torch.ones_like(und, dtype=torch.bool)
    twin = und[1:] == und[:-1]
    single[1:] &= ~twin
    single[:-1] &= ~twin
    return len(fwd), int(single.sum()) - int((a == b).sum())  # (a, a) is its own reverse


def _triangle_hash_sum(faces):
    """A multiset hash of the triangles: each rotated to start at its least
    vertex (the winding kept), mixed to 64 bits (splitmix64's finalizer),
    summed with wraparound."""
    f = np.asarray(faces, np.uint64)
    k = np.argmin(f, axis=1)
    rows = np.arange(len(f))
    h = np.zeros(len(f), np.uint64)
    with np.errstate(over="ignore"):
        for i in range(3):
            h = (h ^ f[rows, (k + i) % 3]) * np.uint64(0x9E3779B97F4A7C15)
            h ^= h >> np.uint64(31)
        return int(h.sum(dtype=np.uint64))


def on_their_edges(verts, edges, shape):
    """Whether each vertex lies on its cut edge (``edges`` as K10 numbers
    them in a lattice of ``shape``): its other two coordinates the edge's
    start, its own between the start and the start + 1."""
    RX, RY, RZ = shape
    a, lin = edges // (RX * RY * RZ), edges % (RX * RY * RZ)
    start = np.stack([lin // (RY * RZ), (lin // RZ) % RY, lin % RZ], axis=1).astype(np.float32)
    off = verts - start
    rows = np.arange(len(verts))
    along = off[rows, a]
    off[rows, a] = 0
    return bool((along >= 0).all() and (along <= 1).all() and not off.any())


def unwelded_match(got, whole, R, wire=False):
    """A sharded mesh against the whole lattice's K10 mesh as it comes
    (verts, faces and each vertex's cut edge, nothing welded): the same
    vertex count; vertex v on the cut edge of the whole lattice's vertex v
    (so the same cut edges, in the same order) and within one f32 ulp of
    it (for the wire a u16 t step, 1 / 65535, and the ulp of i + t's f32
    rounding: 3.05e-5 past x = 256); the same directed edges
    (``edge_stats``); the packed form's faces equal to the whole lattice's,
    the wire's the same triangles with their winding (a multiset hash) ->
    (ok, the numbers)."""
    (gv, gf), (wv, wf, we) = got, whole
    stats = {"verts": [len(gv), len(wv)], "faces": [len(gf), len(wf)]}
    if len(gv) != len(wv) or len(gf) != len(wf):
        return False, stats
    d = np.abs(gv - wv)
    ulps = d / np.spacing(np.maximum(np.abs(gv), np.abs(wv)))
    stats.update(edge_stats=[edge_stats(gf), edge_stats(wf)], on_the_same_cut_edges=on_their_edges(gv, we, (R, R, R)),
                 max_vertex_dist=float(d.max()), max_ulps=float(ulps.max()))
    if wire:
        stats["triangles_equal"] = _triangle_hash_sum(gf) == _triangle_hash_sum(wf)
        close = bool((d <= 1.0 / 65535 + np.spacing(np.maximum(np.abs(gv), np.abs(wv)))).all())
    else:
        stats["faces_equal"] = bool(np.array_equal(gf, wf))
        close = stats["max_ulps"] <= 1.0
    return bool(close and stats["on_the_same_cut_edges"] and stats["edge_stats"][0] == stats["edge_stats"][1]
                and stats.get("triangles_equal", stats.get("faces_equal"))), stats


def merge_every_duplicate(shards, *_):
    """The planted weld fault, ``_seam_weld``'s signature: the weld before
    it, every shard's vertices (halo rows too) through
    ``merge_exact_duplicates``, so coincident vertices of different cut
    edges merge."""
    offsets = np.cumsum([0] + [len(v) for v, _, _ in shards[:-1]])
    return merge_exact_duplicates(np.concatenate([v for v, _, _ in shards]),
                                  np.concatenate([f + o for (_, f, _), o in zip(shards, offsets)]))


def merge_exact_duplicates(verts, faces):
    """The JAX package's weld: exact duplicate vertices merged (a numeric
    lexsort for its ``np.unique(axis=0)``: the vertices come in (x, y, z)
    order), unused vertices dropped."""
    order = np.lexsort((verts[:, 2], verts[:, 1], verts[:, 0]))
    sv = verts[order]
    new = np.ones(len(sv), bool)
    new[1:] = (sv[1:] != sv[:-1]).any(axis=1)
    inv = np.empty(len(sv), np.int64)
    inv[order] = np.cumsum(new) - 1
    faces = inv[faces]
    used = np.zeros(int(new.sum()), bool)
    used[faces.ravel()] = True
    return sv[new][used], (np.cumsum(used) - 1)[faces]


def _timed(fn):
    """``fn()`` after a device sync -> (its result, seconds to the end of
    its device work, peak bytes allocated during it, the peak above the
    bytes allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return out, sec, peak, peak - start


def sharded_extraction_path(tsr, lean):
    """The Lean asset's code extracted at 512^3 over sp = 4 x-slabs at the
    Lean threshold itself (``sharded_extract``, K2 and K10 four launches
    each) against K2 and K10 on the whole lattice on the card, its mesh as
    it comes (``unwelded_match``); the wire form (``sharded_extract_wire``,
    K3 four launches) against it too; ``sharded_density_grid`` bit-equal to
    the whole lattice's density; each call once counted, once timed, with
    its peak bytes. The Lean threshold is a lattice value (K2's densities
    are the exp of a bf16 d), so cut edges from a point where the level is
    exactly 0 put coincident vertices on it, which the seam weld keeps
    apart; then a planted weld that merges every exact duplicate, which
    the check must catch, and both welds timed on the same shard outputs. Then K3 and K10 at one shard's padded slab (136
    x 512 x 512, x limit 128; K10 with its vertices' edges, as the sharded
    extraction asks), equal to their plain versions and timed."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.parallel import farm as farm_mod
    from sculptmate_tpu_torch.parallel.mesh import gather, make_mesh

    R, n = MULTI_R, MULTI_SP
    mesh = make_mesh((n,), ("sp",), devices=mesh_devices(n))
    code, w = lean["codes"][0], tsr.decoder_weights()
    spec = tsr.grid_spec(R, tsr.extract_dtype)
    thr = lean["threshold"]

    def counted(key, fn):
        """``fn`` once, its launches counted, timed and its peak bytes read."""
        dg.density_mlp.launches = mc.marching_cubes.launches = mc.mc_wire_device.launches = 0
        result, sec, peak, above = _timed(fn)
        launches[key] = {"K2": dg.density_mlp.launches, "K3": mc.mc_wire_device.launches,
                         "K10": mc.marching_cubes.launches}
        out[key] = {"sec": sec, "peak_bytes": peak, "peak_above_start_bytes": above}
        return result

    mv_whole = 32 * R * R

    def whole():
        res = mc.marching_cubes(dg.query_density_grid(code, w, spec) - thr, mv_whole, 2 * mv_whole,
                                return_edges=True)
        nv, nf = int(res.num_verts), int(res.num_faces)
        if nv > mv_whole or nf > 2 * mv_whole:
            raise AssertionError(f"whole-lattice extraction overflowed: {nv} vertices, {nf} faces")
        return (res.verts[:nv].cpu().numpy(), res.faces[:nf].cpu().numpy().astype(np.int64),
                res.edges[:nv].cpu().numpy())

    def sharded():
        return farm_mod.sharded_extract(mesh, code, w, spec, thr)

    def wire():
        return farm_mod.sharded_extract_wire(mesh, code, w, spec, thr)

    t0, out, launches = time.perf_counter(), {}, {}
    sm = counted("sharded_extract", sharded)
    ref = counted("whole_lattice", whole)
    ok_mesh, stats = unwelded_match(sm, ref, R)
    wm = counted("sharded_extract_wire", wire)
    wire_ok, wire_stats = unwelded_match(wm, ref, R, wire=True)
    del sm, wm
    slabs = counted("sharded_density_grid", lambda: farm_mod.sharded_density_grid(mesh, code, w, spec))
    dens = dg.query_density_grid(code, w, spec)
    # the design takes each slab's rows of the whole lattice's partials, so
    # the slabs are bit-equal to the whole lattice's density (limit 0): a
    # slab evaluated apart put the mesh 20 faces off at 8.4e-5
    joined = gather(slabs, "cuda")
    dens_equal, dens_err = bool(torch.equal(joined, dens)), (joined - dens).abs().max().item()
    zeros = int((joined == thr).sum())
    del slabs, dens, joined
    log(json.dumps({"multi_device_path": f"sharded extraction {R}^3 over sp = {n}",
                    "devices": [str(d) for d in mesh.devices.ravel()], "threshold": thr,
                    "lattice_points_at_the_threshold": zeros, "launches": launches, **out,
                    "packed_vs_whole_lattice": {"passed": ok_mesh, **stats},
                    "wire_vs_whole_lattice": {"passed": wire_ok, **wire_stats},
                    "sharded_density_grid_bit_equal": dens_equal, "sharded_density_grid_max_abs_err": dens_err,
                    "sharded_density_grid_limit": 0,
                    "phase_sec": time.perf_counter() - t0}))
    if not ok_mesh:
        raise AssertionError(f"the sharded extraction differs from the whole lattice's mesh: {stats}")
    if not wire_ok:
        raise AssertionError(f"the sharded wire extraction differs from the whole lattice's mesh: {wire_stats}")
    if not dens_equal:
        raise AssertionError(f"sharded_density_grid is not bit-equal to the whole lattice's density: {dens_err}")
    for key, want in (("sharded_extract", {"K2": n, "K10": n}), ("sharded_extract_wire", {"K2": n, "K3": n}),
                      ("sharded_density_grid", {"K2": n})):
        if any(launches[key][k] != v for k, v in want.items()):
            raise AssertionError(f"{key} launched {launches[key]}, not {want}")

    # the planted weld fault: the exact-duplicate weld must fail the check
    seam_weld, shards = farm_mod._seam_weld, []

    def planted_weld(*args):
        shards.append(args)
        return merge_every_duplicate(*args)

    farm_mod._seam_weld = planted_weld
    try:
        faulty = sharded()
    finally:
        farm_mod._seam_weld = seam_weld
    fault_passed, fault_stats = unwelded_match(faulty, ref, R)
    merged = len(ref[0]) - len(faulty[0])
    # both welds on these same shard outputs, alternated, three times each
    weld_sec = {"_seam_weld": [], "merge_every_duplicate": []}
    for _ in range(3):
        for name, weld in (("_seam_weld", seam_weld), ("merge_every_duplicate", merge_every_duplicate)):
            t_weld = time.perf_counter()
            weld(*shards[0])
            weld_sec[name].append(time.perf_counter() - t_weld)
    log(json.dumps({"planted_fault": "the sharded weld merges every exact duplicate", "caught": not fault_passed,
                    "vertices_merged": merged, "by": fault_stats, "host_weld_sec_on_the_same_shards": weld_sec}))
    if fault_passed:
        raise AssertionError("planted fault 'the sharded weld merges every exact duplicate' passed its check")
    del faulty, ref

    # K3 and K10 at a shard's slab shape, against their plain versions
    slab = R // n
    level = farm_mod._slab_level(code, w, spec, thr, 1, slab, slab + 1 + (-(slab + 1)) % 8, torch.device("cuda"), {})
    mv, mf = 16 * R * R // n + 65536, 2 * (16 * R * R // n + 65536)
    times = {}
    k10, k10_ref = (f(level, mv, mf, valid_x_limit=slab, return_edges=True)
                    for f in (mc.marching_cubes, mc.marching_cubes_plain))
    k3, k3_ref = (f(level, mv, valid_x_limit=slab) for f in (mc.mc_wire_device, mc.mc_wire_device_plain))
    differ = sum(int((getattr(k10, k) != getattr(k10_ref, k)).sum()) for k in mc.MCResult._fields)
    wire_differ = int((k3 != k3_ref).sum())
    nv10, nf10 = int(k10_ref.num_verts), int(k10_ref.num_faces)
    nv3 = int.from_bytes(k3_ref[-8:-4].cpu().numpy().tobytes(), "little")
    n3 = level.numel()
    for name, fn, plain, nbytes in (
            ("K10", lambda: mc.marching_cubes(level, mv, mf, valid_x_limit=slab, return_edges=True),
             lambda: mc.marching_cubes_plain(level, mv, mf, valid_x_limit=slab, return_edges=True),
             4 * n3 + 20 * nv10 + 12 * nf10 + 16),
            ("K3", lambda: mc.mc_wire_device(level, mv, valid_x_limit=slab),
             lambda: mc.mc_wire_device_plain(level, mv, valid_x_limit=slab), 4 * n3 + n3 // 8 + 2 * nv3 + 8)):
        bound, by = bound_ms(0, nbytes, PEAK_F32_FLOPS)
        times[name] = {"slab_shape": list(level.shape), "slab_valid_x_limit": slab,
                       "slab_ms": cuda_ms(fn, iters=10),
                       "slab_plain_ms": cuda_ms(plain, iters=1, warmup=1, graph=False),
                       "slab_bound_ms": bound, "slab_bound_by": by}
    log(json.dumps({"check": "K3 and K10 at a 512^3 shard's slab", "phase_sec": time.perf_counter() - t0,
                    "shape": list(level.shape),
                    "valid_x_limit": slab, "K10_entries_differing": differ, "K3_bytes_differing": wire_differ,
                    "counts": [nv10, nf10], **{k: v for k, v in times.items()}, "limit": 0}))
    if differ or wire_differ:
        raise AssertionError(f"K10 ({differ} entries) or K3 ({wire_differ} bytes) differ at a 512^3 shard's slab")
    return launches, times, out


def tp_farm_path(tsr, matting, threshold):
    """``AssetFarm`` over a (dp 2, tp 2) mesh on the full-width Lean model:
    four raw 512^2 RGBA images through ``generate_batch_rgba`` with
    full-u2net matting, colors and chunks of 2 (each chunk one image per dp
    shard), counted (K1 = 4 x (12 + 32 x 2): four encodes, the backbone's
    32 attentions each split over 2 shards) and timed; every mesh checked as
    the serving path checks its meshes. The four images' codes against
    the one-device farm's (TP_BF16_SHARE of max |codes|), and one encode of
    an f32 copy of the model over the tp group against its unsplit encode
    (CARD_CPU_SHARE)."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.attention import flash_attention
    from sculptmate_tpu_torch.parallel.farm import AssetFarm
    from sculptmate_tpu_torch.parallel.mesh import make_mesh
    from sculptmate_tpu_torch.systems.tsr import TSR, upload

    t0 = time.perf_counter()
    mesh = make_mesh((2, 2), ("dp", "tp"), devices=mesh_devices(4))
    farm, one = AssetFarm(tsr, mesh, tp_axis="tp"), AssetFarm(tsr)
    rgba = np.random.default_rng(11).random((4, 512, 512, 4))

    def run():
        return farm.generate_batch_rgba(rgba, matting=matting, ratio=0.75, resolution=256, threshold=threshold,
                                        has_vertex_color=True, chunk=2)

    torch.cuda.synchronize()
    flash_attention.launches = dg.density_mlp.launches = mc.marching_cubes.launches = dg.triplane_points.launches = 0
    meshes = run()
    torch.cuda.synchronize()
    launches = {"K1": flash_attention.launches, "K2": dg.density_mlp.launches, "K10": mc.marching_cubes.launches,
                "K4": dg.triplane_points.launches}
    _, sec, _, _ = _timed(run)
    x = upload(rgba, farm.device)
    got, ref = [], []
    for s in range(0, 4, 2):
        got += [farm._front(p, matting, 0.75, farm._tp[i]).to(x.device) for i, p in farm._split(x[s : s + 2])]
        ref.append(one._front(x[s : s + 2], matting, 0.75))
    got, ref = torch.cat(got).float(), torch.cat(ref).float()
    err, limit = (got - ref).abs().max().item(), TP_BF16_SHARE * ref.abs().max().item()
    tsr32 = TSR(tsr.config, state_dict=tsr.module.state_dict(), dtype=torch.float32, device="cuda")
    cond = one._prep_cond(x[:1], matting, 0.75)
    a32, b32 = tsr32.scene_codes(cond, mesh.groups("dp", "tp")[0]), tsr32.scene_codes(cond)
    err32, limit32 = (a32 - b32).abs().max().item(), CARD_CPU_SHARE * b32.abs().max().item()
    del tsr32
    bad = [i for i, m in enumerate(meshes) if not mesh_ok(*m, tsr.config.radius)]
    want_k1 = 4 * (12 + 32 * 2)
    log(json.dumps({"multi_device_path": "AssetFarm over (dp 2, tp 2): generate_batch_rgba, 4 images, chunk 2",
                    "devices": [str(d) for d in mesh.devices.ravel()], "launches": launches, "K1_expected": want_k1,
                    "tp_farm_sec_per_asset": sec / 4, "verts": [len(m[0]) for m in meshes],
                    "codes_bf16_max_abs_err": err, "codes_bf16_limit": limit,
                    "codes_f32_max_abs_err": err32, "codes_f32_limit": limit32, "meshes_failing_checks": bad,
                    "phase_sec": time.perf_counter() - t0}))
    if launches["K1"] != want_k1 or min(launches["K2"], launches["K10"], launches["K4"]) < 4:
        raise AssertionError(f"the (2, 2) farm missed a kernel: {launches}")
    if err > limit or err32 > limit32:
        raise AssertionError(f"tp codes disagree: bf16 {err} > {limit} or f32 {err32} > {limit32}")
    if bad or len(meshes) != 4:
        raise AssertionError(f"(2, 2) farm meshes {bad} failed their checks")
    return launches


def sf3d_tp_farm_path(sf3d, scene):
    """``SF3DFarm`` over a (dp 2, tp 2) mesh: two textured assets at full
    width (the scene's image and one of other colors), counted (K1 = 2 x
    (24 + 12 + 32 x 2), K7 = 2), every mesh and map checked; one encode
    over the tp group against the unsplit one (TP_BF16_SHARE), and the
    same with an f32 copy of the model (CARD_CPU_SHARE)."""
    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.ops.attention import flash_attention
    from sculptmate_tpu_torch.parallel.mesh import make_mesh
    from sculptmate_tpu_torch.parallel.sf3d_farm import SF3DFarm
    from sculptmate_tpu_torch.systems.sf3d import SF3D
    from sculptmate_tpu_torch.systems.tsr import upload

    t0 = time.perf_counter()
    mesh = make_mesh((2, 2), ("dp", "tp"), devices=mesh_devices(4))
    farm = SF3DFarm(sf3d, mesh, tp_axis="tp")
    images = np.repeat(scene["image"][None], 2, axis=0)
    images[1, ..., :3] = np.random.default_rng(12).random((512, 512, 3)).astype(np.float32)
    torch.cuda.synchronize()
    flash_attention.launches = mt.mt_wire_device.launches = 0
    meshes, sec, _, _ = _timed(lambda: farm.generate_batch(images, threshold=scene["threshold"]))
    launches = {"K1": flash_attention.launches, "K7": mt.mt_wire_device.launches}
    _, rgb = sf3d.prepare_image(upload(images[:1], sf3d.device))
    group = mesh.groups("dp", "tp")[0]
    a, b = (sf3d.get_scene_codes(rgb, tp)[0].float() for tp in (group, None))
    err, limit = (a - b).abs().max().item(), TP_BF16_SHARE * b.abs().max().item()
    del a, b
    sf32 = SF3D(sf3d.config, state_dict=sf3d.module.state_dict(), dtype=torch.float32, device="cuda")
    a32, b32 = (sf32.get_scene_codes(rgb, tp)[0] for tp in (group, None))
    err32, limit32 = (a32 - b32).abs().max().item(), CARD_CPU_SHARE * b32.abs().max().item()
    del sf32, a32, b32
    torch.cuda.empty_cache()
    checks = [textures_ok(m, 512) if m is not None else (False, 0.0) for m in meshes]
    bad = [i for i, m in enumerate(meshes) if m is None or not sf3d_mesh_ok(m, sf3d) or not checks[i][0]]
    want_k1 = 2 * (24 + 12 + 32 * 2)
    log(json.dumps({"multi_device_path": "SF3DFarm over (dp 2, tp 2): generate_batch, 2 textured assets",
                    "launches": launches, "K1_expected": want_k1, "batch_sec_first_call": sec,
                    "faces": [len(m["faces"]) for m in meshes if m], "codes_bf16_max_abs_err": err,
                    "codes_bf16_limit": limit, "codes_f32_max_abs_err": err32, "codes_f32_limit": limit32,
                    "meshes_failing_checks": bad, "phase_sec": time.perf_counter() - t0}))
    if launches["K1"] != want_k1 or launches["K7"] != 2:
        raise AssertionError(f"the (2, 2) SF3D farm missed a kernel: {launches}")
    if err > limit or err32 > limit32:
        raise AssertionError(f"SF3D tp codes disagree: bf16 {err} > {limit} or f32 {err32} > {limit32}")
    if bad or len(meshes) != 2:
        raise AssertionError(f"(2, 2) SF3D farm meshes {bad} failed their checks")
    return launches


def multi_device_path(tsr, sf3d, lean, scene, matting, threshold):
    """The multi-device paths on a mesh of four shards (``mesh_devices``):
    the 512^3 sharded extraction, then the Lean and SF3D farms over (dp 2,
    tp 2). Returns the launches and the slab-shape times."""
    launches, times, extraction = sharded_extraction_path(tsr, lean)
    return {"extraction": launches, "slab_times": times, "extraction_sec": extraction,
            "lean_farm": tp_farm_path(tsr, matting, threshold), "sf3d_farm": sf3d_tp_farm_path(sf3d, scene)}


def all_of(*checks):
    """Run every check, then raise one AssertionError naming each that
    failed."""
    failures = []
    for check in checks:
        try:
            check()
        except AssertionError as e:
            failures.append(str(e))
    if failures:
        raise AssertionError("; ".join(failures))


def planted_faults(g, tsr, sf3d, scene, lean):
    """Rebuild each kernel from a copy of the sources with one planted fault
    (PLANTED_FAULTS) and run its check, which must fail, at the cases in
    PLANTED_MUST_FAIL among others; then return to the real kernels. The
    copies live in the ignored build directory."""
    from sculptmate_tpu_torch.runtime import kernels

    root = os.path.join(kernels.BUILD_DIR, "planted")
    shutil.rmtree(root, ignore_errors=True)
    for i, (name, kernel, text, replacement, *file) in enumerate(PLANTED_FAULTS):
        csrc = os.path.join(root, str(i))
        shutil.copytree(kernels.CSRC, csrc)
        path = os.path.join(csrc, file[0] if file else f"{kernel}.cu")
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise RuntimeError(f"planted fault {name!r}: its text is not once in {os.path.basename(path)}")
        with open(path, "w") as f:
            f.write(src.replace(text, replacement))
        checks = {"flash_attn": lambda: check_attention(g, timed=False),
                  "density_grid": lambda: check_density(g, tsr, timed=False),
                  "grid_multihead": lambda: check_grid_multihead(g, sf3d, timed=False),
                  "raster_winner": lambda: check_raster(scene, timed=False),
                  "points_multihead": lambda: check_points(g, sf3d, scene, timed=False),
                  "uv_unwrap": lambda: check_unwrap(scene, timed=False),
                  "triplane_points": lambda: check_triplane_points(tsr, lean, timed=False),
                  "marching_cubes": lambda: all_of(lambda: check_mc_wire(lean, timed=False),
                                                   lambda: check_marching_cubes(lean, timed=False)),
                  "marching_tets": lambda: all_of(lambda: check_mt_wire(scene, timed=False),
                                                  lambda: check_marching_tets(scene, timed=False))}
        with kernels.sources_from(csrc):
            try:
                checks[kernel]()
            except AssertionError as e:
                missed = [case for case in PLANTED_MUST_FAIL.get(name, ()) if case not in str(e)]
                log(json.dumps({"planted_fault": name, "caught": not missed, "by": str(e),
                                "must_fail": PLANTED_MUST_FAIL.get(name, []), "passed_there": missed}))
                if missed:
                    raise AssertionError(f"planted fault {name!r} passed the check at {missed}") from e
                continue
        raise AssertionError(f"planted fault {name!r} passed its check")


def f1_check(tsr, sf3d, scene):
    """The encoders' matrix weights are stored in bf16 once, so autocast
    casts none of them per call. For one Lean encode (``tsr.scene_codes``)
    and one SF3D encode (the ``sf3d.encode`` stage: prepare, codes,
    material estimate), against the same seeded weights kept in f32 and run
    under autocast (the encode as it ran before): the cast ops
    (``aten::_to_copy``), the copy kernels and their device time, and the
    encode span's device range, each under the profiler; and the codes (and
    SF3D's direct codes and materials) bit-equal to the f32 weights' under
    autocast. The cast kernels must fall below half."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from sculptmate_tpu_torch.systems.sf3d import SF3D
    from sculptmate_tpu_torch.systems.tsr import TSR, upload

    cuda = torch.autograd.DeviceType.CUDA

    def profiled(fn, span):
        """fn() under the profiler inside ``span``: the casts, the copy
        kernels and the device range and busy time of the kernels."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(span):
                out = fn()
            torch.cuda.synchronize()
        events = prof.events()
        kernels_ = [e for e in events if e.device_type == cuda and not e.name.startswith(("tsr.", "sf3d."))]
        copies = [e for e in kernels_ if "copy_kernel" in e.name]
        return out, {"cast_ops": sum(e.name == "aten::_to_copy" for e in events), "copy_kernels": len(copies),
                     "copy_kernel_ms": sum(e.time_range.elapsed_us() for e in copies) / 1e3,
                     "kernels": len(kernels_),
                     "device_busy_ms": sum(e.time_range.elapsed_us() for e in kernels_) / 1e3,
                     "device_range_ms": (max(e.time_range.end for e in kernels_)
                                         - min(e.time_range.start for e in kernels_)) / 1e3}

    def under_autocast(fn):
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            return fn()

    out = {}
    image = np.random.default_rng(0).random((1, 512, 512, 3), np.float32)
    ref = TSR(seed=0, dtype=torch.float32, device="cuda")  # the main path's seed, kept in f32
    x = upload(image, tsr.device)
    tsr.scene_codes(image)  # warm-up
    new, after = profiled(lambda: tsr.scene_codes(image), "tsr.encode")
    old, before = profiled(lambda: under_autocast(lambda: ref.module(x)), "tsr.encode")
    out["lean"] = {"after": after, "before": before, "codes_bit_equal": bool(torch.equal(new, old)),
                   "dtype": str(new.dtype)}
    del ref

    ref = SF3D(seed=0, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        randomize_modulations(ref, torch.Generator(device="cuda").manual_seed(0))  # as main() does to the model
    img = torch.from_numpy(scene["image"][None]).cuda()

    def encode(m):
        mask, rgb = m.prepare_image(img)
        return (*m.get_scene_codes(rgb), m.estimate_materials(rgb * mask))

    def encode_f32(m):
        mask, rgb = m.prepare_image(img)
        codes, direct = m.module(rgb, m._c2w.expand(1, 4, 4), m._Kn.expand(1, 3, 3))
        return codes, direct, m.module.image_estimator(rgb * mask)

    encode(sf3d)  # warm-up
    new, after = profiled(lambda: encode(sf3d), "sf3d.encode")
    old, before = profiled(lambda: under_autocast(lambda: encode_f32(ref)), "sf3d.encode")
    equal = torch.equal(new[0], old[0]) and torch.equal(new[1], old[1]) and all(
        torch.equal(new[2][k], old[2][k]) for k in old[2])
    out["sf3d"] = {"after": after, "before": before, "codes_bit_equal": bool(equal), "dtype": str(new[0].dtype)}
    del ref
    torch.cuda.empty_cache()
    log(json.dumps({"check": "F1: encoder weights cast once (after) against f32 weights under autocast (before)",
                    **out}))
    for path, r in out.items():
        if not r["codes_bit_equal"] or not r["after"]["copy_kernels"] < r["before"]["copy_kernels"] / 2:
            raise AssertionError(f"F1 {path}: codes bit-equal {r['codes_bit_equal']}, copy kernels "
                                 f"{r['after']['copy_kernels']} after against {r['before']['copy_kernels']} before")
    return out


# stabilityai/stable-fast-3d's config.yaml layout (the keys SF3DConfig reads
# and their neighbours), the default SF3DConfig's values, with interpolations
SF3D_CONFIG_YAML = """
cond_image_size: 512
isosurface_resolution: 160
isosurface_threshold: 10.0
radius: 0.87
background_color: [0.5, 0.5, 0.5]
default_fovy_deg: 40.0
default_distance: 1.6
camera_embedder_cls: sf3d.models.camera.LinearCameraEmbedder
camera_embedder:
  in_channels: 25
  out_channels: 768
  conditions: [c2w_cond, intrinsic_normed_cond]
image_tokenizer_cls: sf3d.models.tokenizers.image.DINOV2SingleImageTokenizer
image_tokenizer:
  pretrained_model_name_or_path: "facebook/dinov2-large"
  width: ${cond_image_size}
  height: ${cond_image_size}
  modulation_cond_dim: ${camera_embedder.out_channels}
tokenizer_cls: sf3d.models.tokenizers.triplane.TriplaneLearnablePositionalEmbedding
tokenizer:
  plane_size: 96
  num_channels: 1024
backbone_cls: sf3d.models.transformers.backbone.TwoStreamInterleaveTransformer
backbone:
  num_attention_heads: 16
  attention_head_dim: 64
  raw_triplane_channels: ${tokenizer.num_channels}
  triplane_channels: ${tokenizer.num_channels}
  raw_image_channels: 1024
  num_latents: 1792
  num_blocks: 4
  num_basic_blocks: 3
post_processor_cls: sf3d.models.network.PixelShuffleUpsampleNetwork
post_processor:
  in_channels: ${tokenizer.num_channels}
  out_channels: 40
  scale_factor: 4
  conv_layers: ${backbone.num_blocks}
decoder_cls: sf3d.models.network.MaterialMLP
decoder:
  in_channels: 120
  n_neurons: 64
  activation: silu
  heads:
    - {name: density, out_channels: 1, out_bias: -1.0, n_hidden_layers: 2, output_activation: trunc_exp}
    - {name: features, out_channels: 3, n_hidden_layers: 3, output_activation: sigmoid}
    - {name: perturb_normal, out_channels: 3, n_hidden_layers: 3, output_activation: normalize_channel_last}
    - {name: vertex_offset, out_channels: 3, n_hidden_layers: 2}
"""

_ST_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64",
             torch.int32: "I32"}


def write_safetensors(path, tensors):
    """A minimal ``.safetensors`` writer (CPU tensors): the 8-byte
    little-endian header length, the JSON header padded to 8 bytes, then
    each tensor's raw little-endian bytes in order."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def sf3d_checkpoint_path(fast, scene):
    """SF3D from its checkpoint directory: the full-width model's weights
    written as ``model.safetensors`` in F16 (``write_safetensors``) and,
    where ``yaml`` imports, ``config.yaml`` in the published layout with
    interpolations, in a temporary directory; ``Fast3DGenerator().
    initiate_model(dir)`` on the card (its seconds and the file's size);
    one untextured asset of the loaded model, which must equal, vertex for
    vertex and face for face, the mesh of ``SF3D(state_dict=...)`` given
    the same F16-rounded weights directly. Both models and the directory
    are freed afterwards."""
    import importlib.util

    from sculptmate_tpu_torch.geometry import marching_tets as mt
    from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator
    from sculptmate_tpu_torch.systems.sf3d import SF3D, SF3DConfig

    image, threshold = scene["image"][None], scene["threshold"]
    sd16 = {k: v.to(torch.float16).cpu() for k, v in fast.model.module.state_dict().items()}
    has_yaml = importlib.util.find_spec("yaml") is not None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.safetensors")
        t0 = time.perf_counter()
        write_safetensors(path, sd16)
        write_sec = time.perf_counter() - t0
        if has_yaml:
            with open(os.path.join(tmp, "config.yaml"), "w") as f:
                f.write(SF3D_CONFIG_YAML)
        gen = Fast3DGenerator()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = gen.initiate_model(tmp, device="cuda")
        torch.cuda.synchronize()
        load_sec = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
    if rc != 0:
        raise RuntimeError(f"Fast3DGenerator.initiate_model(checkpoint_dir) returned {rc}")
    mt.mt_wire_device.launches = 0
    got = gen.model.run_image(image, enable_texture=False, threshold=threshold)
    k7 = mt.mt_wire_device.launches
    direct = SF3D(state_dict={k: v.float() for k, v in sd16.items()}, device="cuda")
    ref = direct.run_image(image, enable_texture=False, threshold=threshold)
    same = got is not None and ref is not None and all(np.array_equal(got[k], ref[k]) for k in ("verts", "faces"))
    line = {"sf3d_checkpoint": "Fast3DGenerator.initiate_model(dir) with model.safetensors (F16)"
                               + (" and config.yaml" if has_yaml else ", no config.yaml (yaml does not import)"),
            "yaml_imports": has_yaml, "config_from_yaml_is_default": gen.model.config == SF3DConfig(),
            "file_bytes": file_bytes, "tensors": len(sd16), "write_sec": write_sec, "load_sec": load_sec,
            "launches": {"K7": k7}, "verts": [len(m["verts"]) for m in (got, ref) if m],
            "faces": [len(m["faces"]) for m in (got, ref) if m], "equal_to_direct_state_dict": same}
    log(json.dumps(line))
    del gen, direct, sd16
    torch.cuda.empty_cache()
    if not same or not sf3d_mesh_ok(got, fast.model) or k7 < 1:
        raise AssertionError("the model loaded from its checkpoint directory disagrees with the same weights "
                             "given directly")
    return line


def small_model_check():
    """A narrow TSR on the card (f32: the f32 attention kernel, no TF32)
    against the same weights on the CPU: codes within 1e-4 of max |codes|."""
    from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

    cfg = TSRConfig(cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=1,
                    attention_head_dim=64, num_layers=2, cross_attention_dim=128, vit_hidden_size=128,
                    vit_num_layers=2, vit_num_heads=2, vit_intermediate_size=256)
    cpu = TSR(cfg, seed=1, dtype=torch.float32, device="cpu")
    card = TSR(cfg, state_dict=cpu.module.state_dict(), dtype=torch.float32, device="cuda")
    img = np.random.default_rng(1).random((1, 64, 64, 3), np.float32)
    ref = cpu.scene_codes(img)
    got = card.scene_codes(img).cpu()
    err = (got - ref).abs().max().item()
    limit = 1e-4 * ref.abs().max().item()
    log(json.dumps({"check": "small model, card vs CPU", "max_abs_err": err, "limit": limit}))
    if err > limit:
        raise AssertionError(f"small-model codes disagree: {err} > {limit}")


def mesh_ok(verts, faces, colors, radius):
    """A mesh as the main path must give it: non-empty, faces in range,
    vertices finite and inside the radius, colors in [0, 1]."""
    return (
        len(verts) > 0 and len(faces) > 0
        and faces.min() >= 0 and faces.max() < len(verts)
        and np.isfinite(verts).all() and np.abs(verts).max() <= radius + 1e-5
        and colors is not None and colors.shape == verts.shape and colors.min() >= 0 and colors.max() <= 1
    )


def main_path(gen):
    """Full-width Lean path: TripoGenerator once with the launch counters
    around it, then a warm-up and 3 timed assets."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.attention import flash_attention

    tsr = gen.model
    image = np.random.default_rng(0).random((512, 512, 3), np.float32)

    # threshold: the 99th percentile of a 64^3 grid (random weights give a
    # noise-like field; this keeps the surface the size of a real object's)
    codes = tsr.scene_codes(image[None])
    d64 = dg.query_density_grid(codes[0], tsr.decoder_weights(), tsr.grid_spec(64, tsr.extract_dtype))
    threshold = float(torch.quantile(d64.flatten().float(), 0.99))
    log(f"# threshold (99th percentile of the 64^3 grid): {threshold}")

    gen.mc_resolution = 256
    with tempfile.TemporaryDirectory() as tmp:
        glb = os.path.join(tmp, "asset.glb")
        torch.cuda.synchronize()
        flash_attention.launches = dg.density_mlp.launches = mc.mc_wire_device.launches = 0
        dg.triplane_points.launches = mc.marching_cubes.launches = 0
        rc = gen.generate_mesh(image, output_path=glb, threshold=threshold)
        torch.cuda.synchronize()
        launches = {"K1": flash_attention.launches, "K2": dg.density_mlp.launches, "K3": mc.mc_wire_device.launches,
                    "K4": dg.triplane_points.launches, "K10": mc.marching_cubes.launches}
        glb_bytes = os.path.getsize(glb) if rc == 0 else 0
    # on the card the default path builds the faces with K10 (K3 never
    # runs); K2, K10 and K4 run twice when the first 256^3 extraction
    # outgrows the default capacities: the exact counters trigger one
    # re-extraction
    log(json.dumps({"main_path": "TripoGenerator.generate_mesh", "rc": rc, "launches": launches,
                    "glb_bytes": glb_bytes}))
    if rc != 0:
        raise RuntimeError(f"generate_mesh returned {rc}")
    if launches["K1"] != 44 or launches["K2"] < 1 or launches["K10"] < 1 or launches["K4"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")
    if launches["K3"]:
        raise AssertionError(f"the main path on the card ran the wire (K3): {launches}")

    times = []
    for it in range(4):  # 1 warm-up + 3 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = tsr.scene_codes(image[None])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        verts, faces, colors = tsr.extract_mesh(codes, has_vertex_color=True, resolution=256, threshold=threshold)[0]
        t2 = time.perf_counter()
        if it:
            times.append((1e3 * (t1 - t0), 1e3 * (t2 - t1), t2 - t0))
    ok = (
        codes.shape == (1, 3, 40, 64, 64) and bool(torch.isfinite(codes).all())
        and mesh_ok(verts, faces, colors, tsr.config.radius)
    )
    enc, ext, sec = (float(np.median([t[i] for t in times])) for i in range(3))
    log(json.dumps({"main_path": "scene_codes -> extract_mesh(256, colors)", "verts": len(verts), "faces": len(faces),
                    "encode_ms": enc, "extract_ms": ext, "sec_per_asset": sec,
                    "per_asset_runs": [[round(a, 3), round(b, 3), round(c, 4)] for a, b, c in times]}))
    if not ok:
        raise AssertionError("main-path mesh failed its checks")
    where_time_goes(
        "one asset (encode + extract_mesh 256^3 + colors)",
        lambda: tsr.extract_mesh(tsr.scene_codes(image[None]), has_vertex_color=True, resolution=256,
                                 threshold=threshold),
    )
    return launches, sec


def render_path(tsr, scene):
    """Full-width novel views: one ``TSR.render_views`` of the Lean asset at
    the defaults (8 views, 256^2, 128 samples) from its encode, with the K1
    and K4 counters read around both; the views checked (finite, in [0, 1],
    partly opaque) and view 0 written through ``io/png.py``; then a warm-up
    and three timed renders of the same codes, and a profile of one."""
    from sculptmate_tpu_torch.io.png import write_png
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.attention import flash_attention
    from sculptmate_tpu_torch.ops.rays import get_spherical_cameras

    torch.cuda.synchronize()
    flash_attention.launches = dg.triplane_points.launches = 0
    codes = tsr.scene_codes(scene["image"][None])
    views = tsr.render_views(codes)[0]
    torch.cuda.synchronize()
    launches = {"K1": flash_attention.launches, "K4": dg.triplane_points.launches}
    rays_o, rays_d = get_spherical_cameras(8, 0.0, 1.9, 40.0, 256, 256, device="cuda")
    _, opacity = tsr._render_rays(codes[0], rays_o[0], rays_d[0], 128)
    opaque = float((opacity > 0.01).float().mean())
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "view_0.png")
        write_png(png, (np.clip(views[0], 0, 1) * 255).astype(np.uint8))
        with open(png, "rb") as fh:
            head = fh.read(24)
    png_ok = head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == (256).to_bytes(4, "big") * 2
    ok = bool(views.shape == (8, 256, 256, 3) and np.isfinite(views).all() and views.min() >= 0
              and views.max() <= 1 + 1e-5 and opaque > 0 and png_ok)
    times = []
    for it in range(4):  # 1 warm-up + 3 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tsr.render_views(codes)
        if it:
            times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    points = 8 * 256 * 256 * 128
    log(json.dumps({"render_path": "TSR.render_views (8 views, 256^2, 128 samples)", "launches": launches,
                    "codes_dtype": str(codes.dtype), "render_sec": sec, "points_per_sec": points / sec,
                    "runs_sec": [round(t, 4) for t in times], "opaque_share_view0": opaque, "png_ok": png_ok,
                    "view_min_max": [float(views.min()), float(views.max())], "views_ok": ok}))
    if not ok:
        raise AssertionError("rendered views failed their checks")
    if launches["K1"] != 44 or launches["K4"] != 8:
        raise AssertionError(f"render path missed a kernel: {launches}")
    where_time_goes("one render (8 views, 256^2, 128 samples)", lambda: tsr.render_views(codes),
                    prefixes=("tsr.render",))
    return launches, sec


def small_render_check():
    """A narrow TSR's render on the card (K4, bf16) against the same
    weights on the CPU (plain K4, bf16) from the card's codes: 2 views,
    32^2, 32 samples, within RENDER_LIMIT."""
    from sculptmate_tpu_torch.systems.tsr import TSR, TSRConfig

    cfg = TSRConfig(cond_image_size=64, plane_size=8, num_channels=64, num_attention_heads=1,
                    attention_head_dim=64, num_layers=2, cross_attention_dim=128, vit_hidden_size=128,
                    vit_num_layers=2, vit_num_heads=2, vit_intermediate_size=256)
    cpu = TSR(cfg, seed=1, dtype=torch.float32, extract_dtype=torch.bfloat16, device="cpu")
    card = TSR(cfg, state_dict=cpu.module.state_dict(), dtype=torch.float32, extract_dtype=torch.bfloat16,
               device="cuda")
    codes = card.scene_codes(np.random.default_rng(1).random((1, 64, 64, 3), np.float32))
    kw = dict(n_views=2, height=32, width=32, num_samples=32)
    got = card.render_views(codes, **kw)[0]
    ref = cpu.render_views(codes.cpu(), **kw)[0]
    err = float(np.abs(got - ref).max())
    log(json.dumps({"check": "small model render, card vs CPU (bf16)", "max_abs_err": err, "limit": RENDER_LIMIT,
                    "view_mean": float(ref.mean())}))
    if not err <= RENDER_LIMIT:
        raise AssertionError(f"small-model render disagrees: {err} > {RENDER_LIMIT}")


def _matched_to_packed(level):
    """For each wire vertex (block-major order), the index of the same cut
    edge among the packed mesh's vertices (axis-major, flat order)."""
    from sculptmate_tpu_torch.geometry.marching_cubes import _cut_masks, _to_blocks

    masks = _cut_masks(level > 0)
    edge_ids = torch.arange(masks.numel(), device=level.device).reshape(masks.shape)
    wire_edges = _to_blocks(edge_ids)[_to_blocks(masks)]
    return torch.searchsorted(torch.nonzero(masks.reshape(-1)).reshape(-1), wire_edges)


def packed_path(tsr, scene, wire_sec):
    """Full-width packed extraction: one asset's ``extract_mesh(mode=
    "packed", has_vertex_color=True)`` at 256^3 with the K2, K4 and K10
    counters read around it, against wire mode on the same codes (the same
    vertex and face counts, each vertex within 2/65535 lattice units of the
    wire's at the same lattice edge, the same triangles, colors within the
    wire's u8 step); then a warm-up and three timed assets (encode + packed
    extraction), beside the same run's wire ``sec_per_asset``; one farm
    packed batch of 2; and a profile of one asset."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.parallel.farm import AssetFarm

    image, threshold, r = scene["image"], scene["threshold"], tsr.config.radius
    codes = scene["codes"]  # the codes of the scene's level, which matches the two meshes' vertices
    torch.cuda.synchronize()
    dg.density_mlp.launches = dg.triplane_points.launches = mc.marching_cubes.launches = 0
    vp, fp, cp = tsr.extract_mesh(codes, has_vertex_color=True, resolution=256, threshold=threshold, mode="packed")[0]
    torch.cuda.synchronize()
    launches = {"K2": dg.density_mlp.launches, "K4": dg.triplane_points.launches, "K10": mc.marching_cubes.launches}
    vw, fw, cw = tsr.extract_mesh(codes, has_vertex_color=True, resolution=256, threshold=threshold, mode="wire")[0]
    scale = 2 * r / 255.0
    same_counts = len(vp) == len(vw) and len(fp) == len(fw)
    pos_err = tri_equal = col_err = None
    if same_counts:
        match = _matched_to_packed(scene["level"]).cpu().numpy()
        pos_err = float(np.abs(vp[match] - vw).max() / scale)
        col_err = float(np.abs(cp[match] - cw).max())
        key = lambda f: np.sort((f[:, 0] * len(vp) + f[:, 1]) * len(vp) + f[:, 2])  # noqa: E731
        tri_equal = bool(np.array_equal(key(fp), key(match[fw])))
    ok = bool(same_counts and pos_err <= 2 / 65535 and tri_equal and col_err <= 1 / 255 + 1e-6
              and mesh_ok(vp, fp, cp, r))
    log(json.dumps({"packed_path": "extract_mesh(mode='packed', has_vertex_color=True) vs wire", "launches": launches,
                    "verts": [len(vp), len(vw)], "faces": [len(fp), len(fw)],
                    "max_pos_err_lattice_units": pos_err, "triangles_equal": tri_equal,
                    "max_color_err": col_err, "passed": ok}))
    if not ok:
        raise AssertionError("the packed mesh disagrees with the wire mesh")
    if launches["K10"] < 1 or launches["K4"] < 1 or launches["K2"] < 1:
        raise AssertionError(f"packed path missed a kernel: {launches}")

    times = []
    for it in range(4):  # 1 warm-up + 3 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tsr.extract_mesh(tsr.scene_codes(image[None]), has_vertex_color=True, resolution=256, threshold=threshold,
                         mode="packed")
        if it:
            times.append(time.perf_counter() - t0)
    farm = AssetFarm(tsr)
    cond = np.stack([image, np.random.default_rng(8).random((512, 512, 3), np.float32)])
    mc.marching_cubes.launches = 0
    res = farm.generate_batch(cond, resolution=256, threshold=threshold, mode="packed")
    nv, nf = res.num_verts.cpu().numpy(), res.num_faces.cpu().numpy()
    mv, mf = res.vx.shape[1], res.fa.shape[1]
    farm_ok = bool(res.vx.shape[0] == 2 and (nv > 0).all() and (nf > 0).all()
                   and all(int(res.faces[b, : min(nf[b], mf)].max()) < nv[b] for b in range(2)))
    log(json.dumps({"packed_path": "timed", "packed_sec_per_asset": float(np.median(times)),
                    "wire_sec_per_asset": wire_sec, "runs_sec": [round(t, 4) for t in times],
                    "farm_packed_batch": {"launches_K10": mc.marching_cubes.launches, "num_verts": nv.tolist(),
                                          "num_faces": nf.tolist(), "capacities": [mv, mf], "ok": farm_ok}}))
    if not farm_ok or mc.marching_cubes.launches != 2:
        raise AssertionError("the farm's packed batch failed its checks")
    where_time_goes("one packed asset (encode + extract_mesh packed 256^3 + colors)",
                    lambda: tsr.extract_mesh(tsr.scene_codes(image[None]), has_vertex_color=True, resolution=256,
                                             threshold=threshold, mode="packed"))
    return launches, float(np.median(times))


def where_time_goes(label, fn, prefixes=("tsr.",)):
    """``fn`` once under torch.profiler: the host and device range of each
    stage span whose name starts with one of ``prefixes``, device time by
    kernel, and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # a span is a host range and, where it launched kernels, a device range
    # from its first kernel's start to its last kernel's end; its device
    # launches are the device events (kernels, copies, fills) inside that
    spans = {}
    device = [e.time_range for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(prefixes)]
    for e in prof.events():
        if e.name.startswith(prefixes):
            side = "host_ms" if e.device_type == torch.autograd.DeviceType.CPU else "device_span_ms"
            span = spans.setdefault(e.name, {"host_ms": 0.0, "device_span_ms": 0.0, "count": 0,
                                             "device_launches": 0})
            span[side] += e.time_range.elapsed_us() / 1e3
            span["count"] += side == "host_ms"
            if side == "device_span_ms":
                r = e.time_range
                span["device_launches"] += sum(1 for k in device if r.start <= k.start and k.end <= r.end)
    dev = sorted(((e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count) for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0.0) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in spans),
                 key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in dev)
    log(json.dumps({"profile": label, "wall_ms": wall_ms,
                    "spans": spans,
                    "device_busy_ms": busy if dev else "not measured",
                    "device_idle_share": (1 - busy / wall_ms) if dev else "not measured",
                    "top_kernels_ms": [[k[:80], round(ms, 3), n] for k, ms, n in dev[:12]]}))


def frontend_checks():
    """A narrow u2net at 64^2 on the card against the same weights on the
    CPU (f32, TF32 off: d0 within 1e-4 of max |d0|); the full u2net at
    320^2 on the card (finite masks in [0, 1]); the fused preprocess on the
    card against the CPU on the same RGBA (within 1e-5). Returns the card's
    full-u2net matting (seed 0) for the serving path."""
    from sculptmate_tpu_torch.frontend.matting import U2NetMatting
    from sculptmate_tpu_torch.frontend.preprocess import preprocess_batch_device
    from sculptmate_tpu_torch.frontend.u2net import U2Net

    rng = np.random.default_rng(2)
    cpu = U2Net("small")
    cpu.reset_parameters(torch.Generator().manual_seed(2))
    card = U2Net("small").cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(rng.standard_normal((1, 3, 64, 64), np.float32))
    with torch.no_grad():
        ref = cpu.eval()(x)[0]
        got = card.eval()(x.cuda())[0].cpu()
    err, limit = (got - ref).abs().max().item(), 1e-4 * ref.abs().max().item()
    log(json.dumps({"check": "u2net small 64^2, card vs CPU", "max_abs_err": err, "limit": limit}))
    if not err <= limit:
        raise AssertionError(f"small u2net disagrees: {err} > {limit}")

    matting = U2NetMatting(seed=0)
    imgs = torch.from_numpy(rng.random((2, 320, 320, 3), np.float32)).cuda()
    mask = matting.predict_mask_batch(imgs)
    ok = bool(torch.isfinite(mask).all()) and mask.min().item() >= 0.0 and mask.max().item() <= 1.0
    log(json.dumps({"check": "u2net full 320^2 on the card", "shape": list(mask.shape), "finite_in_0_1": ok,
                    "mask_mean": mask.mean().item()}))
    if not ok or mask.shape != (2, 320, 320):
        raise AssertionError("full u2net mask is not finite in [0, 1]")

    rgba = rng.random((2, 512, 512, 4), np.float32)
    rgba[..., 3] = 0.0
    rgba[0, 100:400, 60:300, 3] = 1.0
    rgba[1, 5:500, 250:510, 3] = rng.random((495, 260), np.float32)
    ref = preprocess_batch_device(torch.from_numpy(rgba), ratio=0.75, out_size=512)
    got = preprocess_batch_device(torch.from_numpy(rgba).cuda(), ratio=0.75, out_size=512).cpu()
    err = (got - ref).abs().max().item()
    log(json.dumps({"check": "preprocess_batch_device 512^2, card vs CPU", "max_abs_err": err, "limit": 1e-5}))
    if not err <= 1e-5:
        raise AssertionError(f"fused preprocess disagrees: {err} > 1e-5")
    return matting


def _addon_photo(seed=12, side=1024):
    """A side^2 RGB photo of the add-on's kind: a noisy backdrop and a
    bright object that fills most of the frame."""
    from PIL import Image, ImageDraw

    a = (np.random.default_rng(seed).random((side, side, 3)) * 60 + 20).astype(np.uint8)
    image = Image.fromarray(a)
    ImageDraw.Draw(image).ellipse([side // 8, side // 16, side - side // 6, side - side // 10], fill=(220, 150, 90))
    return image


def check_pil_resample(matting, timed=True):
    """K12 (``csrc/pil_resample.cu``) at the add-on's shapes, each wrapper
    on card tensors byte-equal to its plain version on the CPU: a 1024^2
    photo to the u2net's 320^2 in float32 (``resample_photo``), a 320^2
    mask back to 1024^2 as L with its bbox (``resample_mask``; a mask whose
    box spans the frame), the Lean condition image from that box's ~1364^2
    padded square to 1024^2 (``condition_image``) and the Pro's ~1203^2
    RGBA square (``padded_cutout``); each timed (a CUDA graph), beside its
    plain version on the card and its byte bound (each input byte read once,
    each output byte written once). Then ``preprocess_image`` on an add-on
    photo with ``matting`` on the card, for the Lean and the Pro buttons,
    K12's launch counts zeroed just before each call and read after it
    (2/2/2/0 and 2/2/0/1), its result byte-equal to the host path with the
    same session, and a Lean call with no session (the add-on panel's)
    counted too; with ``timed``, the host ms of a request on each path.
    Returns the kernels line's K12 entry."""
    from sculptmate_tpu_torch.frontend.preprocess import preprocess_image, preprocess_image_host
    from sculptmate_tpu_torch.ops import pil_resample as pr

    rng = np.random.default_rng(12)
    H = W = 1024
    photo = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    yy, xx = np.mgrid[:320, :320] / 319.0 * 2 - 1
    soft = np.clip(1.6 - np.hypot(yy, xx), 0, 1) * (0.6 + 0.4 * rng.random((320, 320)))
    mask_f = torch.from_numpy(soft.astype(np.float32))
    dev_photo, dev_mask_f = photo.cuda(), mask_f.cuda()
    small = pr.resample_photo(dev_photo, matting.input_size)
    mask, bbox = pr.resample_mask(dev_mask_f, (W, H))
    ref_mask, ref_bbox = pr.resample_mask(mask_f, (W, H))
    y1, y2, x1, x2 = pr.bbox_bounds(bbox, H, W)
    hc, wc = y2 - y1, x2 - x1
    size = max(hc, wc)
    crops = {}
    for button, ratio in (("lean", 0.75), ("pro", 0.85)):
        side = int(size / ratio)
        p0 = (side - size) // 2
        crops[button] = pr.Crop(y1, x1, hc, wc, p0 + (size - hc) // 2, p0 + (size - wc) // 2, side)
    lean, pro = crops["lean"], crops["pro"]
    steps = {
        "downsize": (torch.equal(small.cpu(), pr.resample_photo(photo, matting.input_size)),
                     lambda: pr.resample_photo(dev_photo, matting.input_size),
                     lambda: pr.resample_photo_plain(dev_photo, matting.input_size), H * W * 3 + 320 * 320 * 3 * 4),
        "upsize": (torch.equal(mask.cpu(), ref_mask) and torch.equal(bbox.cpu(), ref_bbox),
                   lambda: pr.resample_mask(dev_mask_f, (W, H)),
                   lambda: pr.resample_mask_plain(dev_mask_f, (W, H)), 320 * 320 * 4 + H * W + 16),
        "condition": (torch.equal(pr.condition_image(dev_photo, mask, lean, 1024).cpu(),
                                  pr.condition_image(photo, ref_mask, lean, 1024)),
                      lambda: pr.condition_image(dev_photo, mask, lean, 1024),
                      lambda: pr.condition_image_plain(dev_photo, mask, lean, 1024), hc * wc * 4 + 1024 * 1024 * 3),
        "cutout": (torch.equal(pr.padded_cutout(dev_photo, mask, pro).cpu(), pr.padded_cutout(photo, ref_mask, pro)),
                   lambda: pr.padded_cutout(dev_photo, mask, pro),
                   lambda: pr.padded_cutout_plain(dev_photo, mask, pro), hc * wc * 4 + pro.side ** 2 * 4),
    }
    rows = {}
    for step, (equal, fn, plain, nbytes) in steps.items():
        bound, _ = bound_ms(0, nbytes, PEAK_F32_FLOPS)
        rows[step] = {"equal": equal, "bound_ms": bound, "bytes": nbytes}
        if timed:
            rows[step].update(ms=cuda_ms(fn), plain_ms=cuda_ms(plain, iters=5, warmup=1, graph=False))
        log(json.dumps({"check": f"K12 {step}, card vs plain (byte-equal)", "crop": str(lean if step != "cutout"
                                                                                       else pro), **rows[step]}))
    if not all(r["equal"] for r in rows.values()):
        raise AssertionError(f"K12 differs from its plain version: {rows}")

    wrappers = {"resample_photo": pr.resample_photo, "resample_mask": pr.resample_mask,
                "condition_image": pr.condition_image, "padded_cutout": pr.padded_cutout}
    image = _addon_photo()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same mask from the same input on both paths
    launches, frontend_ms = {}, {}
    try:
        for path, ratio, use_alpha, session in (("lean", 0.75, False, matting), ("pro", 0.85, True, matting),
                                                ("lean_no_session", 0.75, False, None)):
            torch.cuda.synchronize()
            for f in wrappers.values():
                f.launches = 0
            got = preprocess_image(image, ratio, use_alpha, session)
            launches[path] = {name: f.launches for name, f in wrappers.items()}
            expect = (2, 2, 0, 1) if use_alpha else (2, 2, 2, 0)
            if tuple(launches[path].values()) != expect:
                raise AssertionError(f"preprocess_image ({path}) missed K12: {launches[path]}, expected {expect}")
            if session is None:
                continue
            ref = preprocess_image_host(image, ratio, use_alpha, session)
            if got is None or ref is None or got.mode != ref.mode or not np.array_equal(np.asarray(got),
                                                                                        np.asarray(ref)):
                raise AssertionError(f"preprocess_image's card path ({path}) differs from its host path")
            if timed:
                for name, fn in (("host", preprocess_image_host), ("card", preprocess_image)):
                    times = []
                    for _ in range(6):  # 1 warm-up + 5 timed
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn(image, ratio, use_alpha, session)
                        times.append(1e3 * (time.perf_counter() - t0))
                    frontend_ms[f"{path}_{name}"] = float(np.median(times[1:]))
    finally:
        torch.backends.cudnn.deterministic = saved
    log(json.dumps({"addon_frontend": "preprocess_image, card path vs host path on a 1024^2 photo",
                    "launches": launches, "byte_equal": True, "host_ms_per_request": frontend_ms}))
    per_lean = ("downsize", "upsize", "condition")
    return {"name": "pil_resample", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/pil_resample.cu",
            "replaces": "no TPU kernel: PIL and numpy on the host (frontend/preprocess.py:preprocess_image_host)",
            "launches": sum(launches["lean"].values()), "launches_by_path": launches, "max_abs_err": 0.0,
            "limit": "byte-equal to the plain versions and the host path", "check": "pass",
            **({key: sum(rows[s][key] for s in per_lean) for key in ("ms", "plain_ms")} if timed else {}),
            "bound_ms": sum(rows[s]["bound_ms"] for s in per_lean), "bound_by": "bytes", "library_ms": None,
            "steps": rows, "frontend_ms": frontend_ms}


def card_vs_cpu(name, cpu_fn, card_fn):
    """``card_fn()`` on the card against ``cpu_fn()`` on the CPU (each a
    tuple of tensors): within CARD_CPU_SHARE of max |CPU output| each."""
    ref, got = cpu_fn(), card_fn()
    errs = [(g.cpu() - r).abs().max().item() for g, r in zip(got, ref)]
    limits = [CARD_CPU_SHARE * r.abs().max().item() for r in ref]
    ok = all(e <= lim for e, lim in zip(errs, limits)) and all(bool(torch.isfinite(g).all()) for g in got)
    log(json.dumps({"check": f"{name}, card vs CPU", "max_abs_err": errs, "limit": limits, "check_passed": ok}))
    if not ok:
        raise AssertionError(f"{name} disagrees between the card and the CPU: {errs} > {limits}")


def _seeded_batchnorm(net, rng):
    """Random BatchNorm scales, biases and running statistics (a
    checkpoint's are not 1, 0, 0, 1)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return net.eval()


def session_zoo_path():
    """The rembg session zoo at full width with seeded weights, each session
    made by ``new_session`` on the card and driven through its device method
    at its input size: u2netp, u2net_human_seg and silueta at 320^2, ISNet
    (isnet-general-use) at 1024^2, the cloth session at 768^2 (its class
    map in 0..3), SAM ViT-B (one encode of a 1024^2 canvas, then a point
    prompt and a box prompt decoded) and one ViT-H encode. Masks finite in
    [0, 1]; ms per image (CUDA events, after a warm-up), and for the
    matting sessions one call's device time and launches (``device_split``,
    a ``session_split`` line each). The u2net-recipe sessions (all but the
    cloth one) replay a CUDA graph: their lines give the same numbers for
    the recipe launched op by op (``_predict_eager``, an ``eager``
    ``session_split`` line) and whether the two masks are byte-equal, which
    they must be. Then a narrow ISNet
    (64^2) and a tiny SAM (dim 32, 128^2) on the card against the CPU."""
    from sculptmate_tpu_torch.frontend.isnet import ISNet
    from sculptmate_tpu_torch.frontend.sam import Sam, SamSession
    from sculptmate_tpu_torch.frontend.sessions import new_session

    rng = np.random.default_rng(9)
    ms_per_image, failures = {}, []

    def record(name, shape, ok, ms, **extra):
        ms_per_image[name] = ms
        log(json.dumps({"session_zoo": name, "shape": list(shape), "finite_in_range": ok, "ms_per_image": ms,
                        **extra}))
        if not ok:
            failures.append(name)

    for name in ("u2netp", "u2net_human_seg", "silueta", "isnet-general-use", "u2net_cloth_seg"):
        sess = new_session(name, device="cuda")
        imgs = torch.from_numpy(rng.random((1, *sess.input_size, 3), np.float32)).cuda()
        if name == "u2net_cloth_seg":
            fn = lambda sess=sess, imgs=imgs: sess.predict_classes_batch(imgs)  # noqa: E731
            out = fn()
            ok = out.shape == (1, *sess.input_size) and int(out.min()) >= 0 and int(out.max()) <= 3
            extra = {"class_counts": torch.bincount(out.flatten(), minlength=4).tolist()}
        else:
            # the session's call replays its CUDA graph; the same recipe op by
            # op beside it, and the two masks byte-equal
            fn = lambda sess=sess, imgs=imgs: sess.predict_mask_batch(imgs)  # noqa: E731
            eager = lambda sess=sess, imgs=imgs: sess._predict_eager(imgs)  # noqa: E731
            out = fn()
            equal = bool(torch.equal(out, eager()))
            ok = (equal and out.shape == (1, *sess.input_size) and bool(torch.isfinite(out).all())
                  and out.min().item() >= 0.0 and out.max().item() <= 1.0)
            esplit = device_split("session_split", f"{name} eager", eager)
            extra = {"mask_mean": out.mean().item(), "replay_equals_eager": equal,
                     "eager_ms_per_image": cuda_ms(eager, iters=5, warmup=3, graph=False),
                     "eager_device_sum_ms": esplit["sum_ms"], "eager_launches": esplit["launches"],
                     "eager_host_launches": esplit["host_launches"]}
        split = device_split("session_split", name, fn)
        extra.update(device_sum_ms=split["sum_ms"], device_range_ms=split["range_ms"], launches=split["launches"],
                     host_launches=split["host_launches"])
        record(name, out.shape, ok, cuda_ms(fn, iters=5, warmup=3, graph=False), **extra)
        del sess
    new_session.cache_clear()

    sam = new_session("sam", device="cuda")  # ViT-B
    canvas = torch.from_numpy(255 * rng.random((1, 1024, 1024, 3), np.float32)).cuda()
    emb = sam.encode_batch(canvas)
    prompts = {"point": ([[500.0, 400.0], [0.0, 0.0]], [1, -1]),
               "box": ([[100.0, 150.0], [800.0, 900.0], [0.0, 0.0]], [2, 3, -1])}
    decode_ms = {}
    for kind, (pts, lbl) in prompts.items():
        pts_t = torch.tensor([pts], device="cuda")
        lbl_t = torch.tensor([lbl], device="cuda")
        masks, iou = sam.decode_batch(emb, pts_t, lbl_t)
        best = sam.predict_mask_batch(canvas, pts_t, lbl_t)
        ok = (masks.shape == (1, 4, 256, 256) and bool(torch.isfinite(masks).all())
              and bool(torch.isfinite(iou).all()) and set(best.unique().tolist()) <= {0.0, 1.0})
        decode_ms[kind] = cuda_ms(lambda: sam.decode_batch(emb, pts_t, lbl_t), iters=5, warmup=1, graph=False)
        record(f"sam vit_b decode ({kind})", masks.shape, ok, decode_ms[kind], mask_share=best.mean().item())
    ok = emb.shape == (1, 256, 64, 64) and bool(torch.isfinite(emb).all())
    record("sam vit_b encode", emb.shape, ok, cuda_ms(lambda: sam.encode_batch(canvas), iters=3, warmup=1,
                                                      graph=False))
    del sam, emb
    new_session.cache_clear()
    vit_h = SamSession(variant="vit_h", device="cuda")
    emb = vit_h.encode_batch(canvas)
    ok = emb.shape == (1, 256, 64, 64) and bool(torch.isfinite(emb).all())
    record("sam vit_h encode", emb.shape, ok, cuda_ms(lambda: vit_h.encode_batch(canvas), iters=2, warmup=0,
                                                      graph=False))
    del vit_h, emb
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"session zoo outputs out of range: {failures}")

    cpu = ISNet()
    cpu.reset_parameters(torch.Generator().manual_seed(9))
    _seeded_batchnorm(cpu, rng)
    card = ISNet().cuda()
    card.load_state_dict(cpu.state_dict())
    card.eval()
    x = torch.from_numpy(rng.standard_normal((1, 3, 64, 64), np.float32))
    with torch.no_grad():
        card_vs_cpu("isnet 64^2", lambda: cpu(x)[1], lambda: card(x.cuda())[1])

    cpu_sam = Sam(32, 2, 2, img_size=128)
    cpu_sam.reset_parameters(torch.Generator().manual_seed(9))
    with torch.no_grad():
        for name, prm in cpu_sam.named_parameters():
            if name.endswith("bias") or "rel_pos" in name or name.endswith("pos_embed"):
                prm.copy_(torch.from_numpy(0.2 * rng.standard_normal(prm.shape).astype(np.float32)))
    card_sam = Sam(32, 2, 2, img_size=128).cuda()
    card_sam.load_state_dict(cpu_sam.state_dict())
    img = torch.from_numpy(rng.standard_normal((1, 3, 128, 128), np.float32))
    pts = torch.tensor([[[30.0, 40.0], [10.0, 20.0], [90.0, 100.0], [0.0, 0.0]]])
    lbl = torch.tensor([[1, 2, 3, -1]])
    with torch.no_grad():
        card_vs_cpu("sam tiny (dim 32, 128^2)", lambda: cpu_sam.eval()(img, pts, lbl),
                    lambda: card_sam.eval()(img.cuda(), pts.cuda(), lbl.cuda()))
    return ms_per_image


def sam_cutout_path():
    """The SAM cutout (``frontend/preprocess.py:sam_segment``) with a box
    prompt on a seeded 640 x 480 RGB image (a disc over noise) through SAM
    ViT-B at its published widths, seeded weights, on the card: the uint8
    array form, which needs no PIL (``SamSession.predict_rgb``, every
    resize on the card, as for a PIL image). Timed per image (wall clock to the cutout on the
    host, after a warm-up, median of 3); its mask held against the same
    call on the CPU with the same weights: the RGB equal, at most
    ``SAM_MASK_SHARE`` of the alpha more than 1 apart. Then
    ``image_preprocess_sam`` on the cutout (host, PIL), or a line saying it
    was skipped where PIL is not installed -> ms per image."""
    from sculptmate_tpu_torch.frontend.preprocess import image_preprocess_sam, sam_segment
    from sculptmate_tpu_torch.frontend.sam import SamSession

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    img = rng.random((480, 640, 3)) * 110
    yy, xx = np.mgrid[:480, :640]
    img[(yy - 250) ** 2 + (xx - 300) ** 2 < 150**2] += 140
    img = img.clip(0, 255).astype(np.uint8)
    bbox = (140.0, 95.5, 470.0, 410.0)
    card = SamSession(seed=0, device="cuda")  # ViT-B
    cutout = sam_segment(img, bbox, session=card)  # warm-up
    secs = []
    for _ in range(3):
        t = time.perf_counter()
        cutout = sam_segment(img, bbox, session=card)
        secs.append(time.perf_counter() - t)
    cpu = SamSession(state_dict={k: v.cpu() for k, v in card.module.state_dict().items()}, device="cpu")
    del card
    torch.cuda.empty_cache()
    ref = sam_segment(img, bbox, session=cpu)
    diff = np.abs(cutout[..., 3].astype(int) - ref[..., 3].astype(int))
    line = {"sam_cutout_path": "sam_segment, box prompt, SAM vit_b, 640 x 480 uint8 RGB", "bbox": list(bbox),
            "shape": list(cutout.shape), "ms_per_image": 1e3 * float(np.median(secs)),
            "foreground_share": float((cutout[..., 3] > 127).mean()),
            "alpha_max_abs_diff_vs_cpu": int(diff.max()), "alpha_share_over_1_vs_cpu": float((diff > 1).mean()),
            "limit": f"at most {SAM_MASK_SHARE} of the alpha more than 1 apart, the RGB equal"}
    ok = (cutout.shape == (480, 640, 4) and cutout.dtype == np.uint8 and np.array_equal(cutout[..., :3], img)
          and line["alpha_share_over_1_vs_cpu"] <= SAM_MASK_SHARE)
    log(json.dumps({**line, "check_passed": bool(ok), "phase_sec": time.perf_counter() - t0}))
    if not ok:
        raise AssertionError(f"the SAM cutout on the card differs from the CPU's: {line}")
    try:
        from PIL import Image
    except ImportError:
        log(json.dumps({"sam_cutout_path": "image_preprocess_sam skipped: PIL is not installed on this machine"}))
        return line["ms_per_image"]
    out, scale = image_preprocess_sam(Image.fromarray(cutout))
    if out.size != (1024, 1024) or out.mode != "RGB" or not 0 < scale < float("inf"):
        raise AssertionError(f"image_preprocess_sam gave a {out.mode} {out.size} image, scale {scale}")
    log(json.dumps({"sam_cutout_path": "image_preprocess_sam", "size": list(out.size), "scale": scale}))
    return line["ms_per_image"]


def dead_upstream_path():
    """SF3D's unused backbone modules at full width, seeded weights, bf16
    autocast as the SF3D encode runs: one ``SingleStreamTransformer`` at its
    class defaults (1 024 channels, 16 layers, 16 heads x 88) over 3 x 96^2 =
    27 648 tokens, K1 counted (32 launches: two attentions a layer) and the
    call timed; ``TriplaneAttention`` full at res 96 (dim 1 024, 16 heads,
    one K1 launch) and masked at res 32 (plain, its O(N^2) bias; no K1
    launch). Then narrow versions of both on the card in f32 (K1's f32
    kernel at head dim 88 and 64) against the CPU."""
    from sculptmate_tpu_torch.models.two_stream import SingleStreamTransformer, TriplaneAttention
    from sculptmate_tpu_torch.ops.attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(12)
    sst = SingleStreamTransformer().cuda().eval()
    sst.reset_parameters(g)
    x = torch.randn(1, 1024, 3 * 96 * 96, device="cuda", generator=g)

    def bf16(module, inp):
        def run():
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                return module(inp)
        return run

    lines = {}
    for key, label, module, inp, want in (
        ("single_stream_transformer", "SingleStreamTransformer (16 x 88, 16 layers, 27 648 tokens)", sst, x, 32),
        ("triplane_attention_full_res96", "TriplaneAttention full, res 96 (dim 1 024, 16 heads)", None, 96, 1),
        ("triplane_attention_masked_res32", "TriplaneAttention masked, res 32 (dim 1 024, 16 heads)", None, 32, 0),
    ):
        if module is None:
            module = TriplaneAttention(1024, inp, 16, full_attention=want > 0).cuda().eval()
            module.reset_parameters(g)
            inp = torch.randn(1, 3 * inp * inp, 1024, device="cuda", generator=g)
        run = bf16(module, inp)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        out = run()
        torch.cuda.synchronize()
        launches = flash_attention.launches
        ok = out.shape == inp.shape and bool(torch.isfinite(out).all())
        ms = cuda_ms(run, iters=3, warmup=1, graph=False)
        lines[key] = {"label": label, "K1_launches": launches, "ms": ms}
        log(json.dumps({"dead_upstream_path": label, "key": key, "shape": list(out.shape), "finite": ok,
                        "launches": {"K1": launches}, "ms": ms, "out_std": out.float().std().item()}))
        if not ok or launches != want:
            raise AssertionError(f"{label}: finite {ok}, K1 launches {launches} (want {want})")
        del module, out
    del sst, x
    torch.cuda.empty_cache()

    gc = torch.Generator().manual_seed(13)
    cpu = SingleStreamTransformer(2, 88, 64, 2)
    cpu.reset_parameters(gc)
    card = SingleStreamTransformer(2, 88, 64, 2).cuda()
    card.load_state_dict(cpu.state_dict())
    xs = torch.randn(2, 64, 3 * 8 * 8, generator=gc)
    with torch.no_grad():
        card_vs_cpu("SingleStreamTransformer narrow (2 x 88, 2 layers)", lambda: (cpu(xs),), lambda: (card(xs.cuda()),))
    for full in (True, False):
        cpu = TriplaneAttention(128, 8, 2, qkv_bias=True, full_attention=full)
        cpu.reset_parameters(gc)
        card = TriplaneAttention(128, 8, 2, qkv_bias=True, full_attention=full).cuda()
        card.load_state_dict(cpu.state_dict())
        xt = torch.randn(2, 3 * 8 * 8, 128, generator=gc)
        with torch.no_grad():
            card_vs_cpu(f"TriplaneAttention narrow ({'full' if full else 'masked'}, res 8)", lambda: (cpu(xt),),
                        lambda: (card(xt.cuda()),))
    return lines


def serving_path(tsr, matting):
    """``AssetFarm.generate_batch_rgba`` on eight raw 512^2 RGBA images, as
    ``bench.py:bench_farm`` drives the JAX farm: the counted batch (also
    the warm-up), then three timed batches; every mesh checked."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.ops.attention import flash_attention
    from sculptmate_tpu_torch.parallel.farm import AssetFarm

    batch = 8
    farm = AssetFarm(tsr)
    rng = np.random.default_rng(0)
    rgba = rng.random((batch, 512, 512, 4))
    # threshold: the 99th percentile of a 64^3 grid, as bench.py sets it
    codes = tsr.scene_codes(rng.random((1, 512, 512, 3)).astype(np.float32))
    d64 = dg.query_density_grid(codes[0], tsr.decoder_weights(), tsr.grid_spec(64, tsr.extract_dtype))
    threshold = float(torch.quantile(d64.flatten().float(), 0.99))

    def run():
        return farm.generate_batch_rgba(rgba, matting=matting, ratio=0.75, resolution=256, threshold=threshold,
                                        has_vertex_color=True)

    torch.cuda.synchronize()
    flash_attention.launches = dg.density_mlp.launches = mc.marching_cubes.launches = dg.triplane_points.launches = 0
    mc.mc_wire_device.launches = 0
    meshes = run()
    torch.cuda.synchronize()
    launches = {"K1": flash_attention.launches, "K2": dg.density_mlp.launches, "K3": mc.mc_wire_device.launches,
                "K4": dg.triplane_points.launches, "K10": mc.marching_cubes.launches}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meshes = run()
        times.append(time.perf_counter() - t0)
    r = tsr.config.radius
    bad = [i for i, m in enumerate(meshes) if not mesh_ok(*m, r)]
    log(json.dumps({"serving_path": "AssetFarm.generate_batch_rgba", "batch": batch, "launches": launches,
                    "verts": [len(m[0]) for m in meshes], "faces": [len(m[1]) for m in meshes],
                    "farm_sec_per_asset": float(np.median(times)) / batch,
                    "batch_sec": [round(t, 4) for t in times], "threshold": threshold, "meshes_failing_checks": bad}))
    if launches["K1"] != 44 * batch or min(launches["K2"], launches["K10"], launches["K4"]) < batch or launches["K3"]:
        raise AssertionError(f"serving path missed a kernel or ran the wire (K3): {launches}")
    if bad or len(meshes) != batch:
        raise AssertionError(f"serving-path meshes {bad} failed their checks")
    return farm, rgba, threshold, launches, meshes


def async_contract(farm, matting, rgba, threshold, served):
    """The dispatch half of three in-flight assets (the farm's front, then
    ``extract_mesh_async``) under ``set_sync_debug_mode("error")``: a host
    sync anywhere there raises. Then the waits, in order; whether asset 2's
    last copy was still pending when asset 0's wait returned is printed for
    information."""
    from sculptmate_tpu_torch.geometry import marching_cubes as mc
    from sculptmate_tpu_torch.ops import density_grid as dg
    from sculptmate_tpu_torch.systems.tsr import upload

    n = 3
    x = upload(rgba[:n], farm.device)
    torch.cuda.synchronize()
    mc.marching_cubes.launches = dg.triplane_points.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [farm.extract_batch_wire_async(farm._front(x[i : i + 1], matting, 0.75), 256, threshold, 0, True)
                   for i in range(n)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    first = farm.extract_batch_wire_wait(handles[0])
    pending = not handles[2][0].host.events[-1].query()
    meshes = first + [m for h in handles[1:] for m in farm.extract_batch_wire_wait(h)]
    r = farm.tsr.config.radius
    same = [len(m[0]) == len(s[0]) and len(m[1]) == len(s[1]) for m, s in zip(meshes, served)]
    dispatched = {"K10": mc.marching_cubes.launches, "K4": dg.triplane_points.launches}
    log(json.dumps({"check": "no host sync on the dispatch path", "assets_in_flight": n, "passed": True,
                    "kernels_dispatched": dispatched,
                    "asset2_pending_when_asset0_returned": pending, "counts_as_served": same}))
    if min(dispatched.values()) < n:
        raise AssertionError(f"the dispatch under sync debug mode missed K10 or K4: {dispatched}")
    if not all(mesh_ok(*m, r) for m in meshes):
        raise AssertionError("meshes of the async-contract run failed their checks")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = phase_environment()
    g = torch.Generator(device="cuda").manual_seed(0)

    from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator, TripoGenerator

    gen = TripoGenerator()  # the Lean path's model: default TSRConfig, seed 0
    if gen.initiate_model(device="cuda") != 0:
        raise RuntimeError("TripoGenerator.initiate_model failed")
    fast = Fast3DGenerator()  # the SF3D path's model: default SF3DConfig, seed 0
    if fast.initiate_model(device="cuda") != 0:
        raise RuntimeError("Fast3DGenerator.initiate_model failed")
    with torch.no_grad():
        randomize_modulations(fast.model, torch.Generator(device="cuda").manual_seed(0))
    scene = sf3d_scene(fast)
    lean = lean_scene(gen.model)
    k1_err, k1, k1_by, k1_d88 = check_attention(g)
    k2_err, k2_limit, k2, k2_by = check_density(g, gen.model)
    k5_err, k5, k5_by = check_grid_multihead(g, fast.model)
    k5_split(fast.model, scene["codes"][0])
    k8 = check_raster(scene)
    k8_launches = k8_split(scene)["launches"]
    k6_err, k6, k6_by = check_points(g, fast.model, scene)
    k6_split(fast.model, scene["codes"][0])
    k9_err, k9, k9_by = check_unwrap(scene)
    k9_launches = k9_split(scene)["launches"]
    k4 = check_triplane_points(gen.model, lean)
    k3 = check_mc_wire(lean)
    k3_split(lean)
    k10 = check_marching_cubes(lean)
    k10_split(lean)
    k7 = check_mt_wire(scene)
    k7_split(scene)
    k11 = check_marching_tets(scene)
    k11_split(scene)
    planted_faults(g, gen.model, fast.model, scene, lean)
    f1_check(gen.model, fast.model, scene)
    small_model_check()
    small_render_check()
    lean_launches, wire_sec = main_path(gen)
    render_launches, _ = render_path(gen.model, lean)
    packed_launches, _ = packed_path(gen.model, lean, wire_sec)
    matting = frontend_checks()
    k12 = check_pil_resample(matting)
    session_ms = session_zoo_path()
    sam_cutout_ms = sam_cutout_path()
    farm, rgba, threshold, launches, served = serving_path(gen.model, matting)
    async_contract(farm, matting, rgba, threshold, served)
    where_time_goes(
        "one farm chunk (matting + preprocess + encode + extract 256^3 + colors)",
        lambda: farm.generate_batch_rgba(rgba[:1], matting=matting, resolution=256, threshold=threshold,
                                         has_vertex_color=True),
        prefixes=("farm.", "matting.", "tsr."),
    )
    sf3d_small_check()
    sf3d_launches = sf3d_path(fast, scene)
    tex_launches = sf3d_textured_path(fast, scene)
    sf3d_async_contract(fast.model, scene)
    farm_launches = sf3d_farm_path(fast.model, scene)
    multi = multi_device_path(gen.model, fast.model, lean, scene, matting, threshold)
    sf3d_checkpoint_path(fast, scene)
    sf3d_packed_launches = sf3d_packed_path(fast, scene)
    dead_upstream = dead_upstream_path()
    marching_cubes_host_check()
    addon_path(gen, fast, lean, scene)

    sf3d_k1 = {f"sf3d_{key}": value for key, value in k1["sf3d"].items()}
    kernels_line = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/flash_attn.cu",
         "replaces": "sculptmate_tpu/ops/attention.py:30", "launches": launches["K1"],
         "launches_by_path": {"tripo_generator": lean_launches["K1"], "serving_batch_of_8": launches["K1"],
                              "fast3d_generator": sf3d_launches["K1"],
                              "asset_farm_dp2_tp2_batch_of_4": multi["lean_farm"]["K1"],
                              "sf3d_farm_dp2_tp2_batch_of_2": multi["sf3d_farm"]["K1"],
                              **{key: v["K1_launches"] for key, v in dead_upstream.items() if v["K1_launches"]}},
         "max_abs_err": k1_err[0], "limit": f"min({K1_BF16_LIMIT}, {K1_BF16_ULP} x max |ref|) per shape",
         "max_err_over_limit": k1_err[1], "check": "pass",
         "ms": k1["lean"]["ms"], "plain_ms": k1["lean"]["plain_ms"], "bound_ms": k1["lean"]["bound_ms"],
         "bound_by": k1_by["lean"], "library_ms": k1["lean"]["library_ms"],
         "sf3d_launches": sf3d_launches["K1"], **sf3d_k1, "sf3d_bound_by": k1_by["sf3d"],
         "d88_shape": [1, 27648, 27648, 16, 88], "d88_ms": k1_d88["ms"], "d88_plain_ms": k1_d88["plain_ms"],
         "d88_bound_ms": k1_d88["bound_ms"], "d88_bound_by": k1_d88["bound_by"],
         "d88_library_ms": k1_d88["library_ms"]},
        {"name": "density_grid_mlp", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/density_grid.cu",
         "replaces": "sculptmate_tpu/ops/density_grid.py:129", "launches": launches["K2"], "max_abs_err": k2_err,
         "limit": k2_limit, "check": "pass",
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2_by,
         "library_ms": None, **{key: v for key, v in k2.items() if key.startswith("slab")},
         "launches_by_path": {"serving_batch_of_8": launches["K2"],
                              "asset_farm_dp2_tp2_batch_of_4": multi["lean_farm"]["K2"],
                              **{f"{key}_{MULTI_R}_sp{MULTI_SP}": v["K2"] for key, v in multi["extraction"].items()
                                 if key != "whole_lattice"}}},
        {"name": "grid_multihead_mlp", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/grid_multihead.cu",
         "replaces": "sculptmate_tpu/ops/density_grid.py:231", "launches": sf3d_launches["K5"],
         "max_abs_err": k5_err, "limit": f"{K5_SPREAD_SHARE} of each channel's spread", "check": "pass",
         "ms": k5["ms"], "weights_pack_ms": k5["weights_pack_ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5_by, "library_ms": None},
        {"name": "points_multihead_mlp", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/points_multihead.cu",
         "replaces": "sculptmate_tpu/ops/density_grid.py:323", "launches": tex_launches["K6"],
         "max_abs_err": k6_err, "limit": f"{K6_SPREAD_SHARE} of each channel's spread", "check": "pass",
         "ms": k6["ms"], "relayout_ms": k6["relayout_ms"], "relayout_bound_ms": k6["relayout_bound_ms"],
         "weights_pack_ms": k6["weights_pack_ms"], "asset_texels_ms": k6["asset_texels_ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound_ms"],
         "bound_by": k6_by, "library_ms": None},
        {"name": "raster_winner", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/raster_winner.cu",
         "replaces": "sculptmate_tpu/geometry/texture_bake.py:234", "launches": tex_launches["K8"],
         "launches_untextured": sf3d_launches["K8"], "max_abs_err": 0.0, "limit": "bit-equal winners",
         "check": "pass", "ms": k8["ms"], "plain_ms": k8["plain_ms"], "bound_ms": k8["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "device_ops_per_bake_raster": k8_launches},
        {"name": "uv_unwrap", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/uv_unwrap.cu",
         "replaces": "sculptmate_tpu/geometry/uv_unwrap_device.py:114", "launches": tex_launches["K9"],
         "launches_untextured": sf3d_launches["K9"], "max_abs_err": k9_err,
         "limit": f"atlas equal on {K9_ATLAS_SHARE}, UVs within {K9_UV_LIMIT}", "check": "pass",
         "ms": k9["ms"], "plain_ms": k9["plain_ms"], "bound_ms": k9["bound_ms"], "bound_by": k9_by,
         "library_ms": None, "device_ops_per_call": k9_launches},
        {"name": "mc_wire", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/marching_cubes.cu",
         "replaces": "sculptmate_tpu/geometry/marching_cubes.py:454", "launches": lean_launches["K3"],
         "launches_by_path": {"tripo_generator": lean_launches["K3"], "serving_batch_of_8": launches["K3"],
                              f"sharded_extract_wire_{MULTI_R}_sp{MULTI_SP}":
                                  multi["extraction"]["sharded_extract_wire"]["K3"]},
         **multi["slab_times"]["K3"],
         "max_abs_err": 0.0, "limit": "byte-equal wire and equal positions", "check": "pass",
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
        {"name": "triplane_points_mlp", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/triplane_points.cu",
         "replaces": "sculptmate_tpu/ops/density_grid.py:366", "launches": lean_launches["K4"],
         "launches_by_path": {"tripo_generator": lean_launches["K4"], "serving_batch_of_8": launches["K4"],
                              "render": render_launches["K4"], "packed_asset": packed_launches["K4"]},
         "max_abs_err": max(e for e, _ in k4.values()),
         "limit": f"{K4_SPREAD_SHARE} of each output's spread (exp(d + bias) on its log); with the main path's"
                  f" decoder, {K4_NOISE_FACTOR} x the plain bf16 version's own error",
         "check": "pass", **{key: k4["Lean asset's vertices"][1][key] for key in
                             ("ms", "relayout_ms", "weights_pack_ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
         **{f"render_view_{key}": k4["render view 0 samples"][1][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "marching_cubes", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/marching_cubes.cu",
         "replaces": "sculptmate_tpu/geometry/marching_cubes.py:538", "launches": packed_launches["K10"],
         "launches_by_path": {"tripo_generator": lean_launches["K10"], "serving_batch_of_8": launches["K10"],
                              "asset_farm_dp2_tp2_batch_of_4": multi["lean_farm"]["K10"],
                              "packed_asset": packed_launches["K10"],
                              f"sharded_extract_{MULTI_R}_sp{MULTI_SP}": multi["extraction"]["sharded_extract"]["K10"]},
         **multi["slab_times"]["K10"],
         "max_abs_err": 0.0, "limit": "equal positions, faces, counters and vertex edges", "check": "pass",
         "ms": k10["ms"], "plain_ms": k10["plain_ms"], "bound_ms": k10["bound_ms"], "bound_by": k10["bound_by"],
         "library_ms": None, "edges_ms": k10["edges_ms"], "edges_bound_ms": k10["edges_bound_ms"]},
        {"name": "mt_wire", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/marching_tets.cu",
         "replaces": "sculptmate_tpu/geometry/marching_tets.py:388", "launches": sf3d_launches["K7"],
         "launches_by_path": {"fast3d_generator": sf3d_launches["K7"], "fast3d_generator_textured": tex_launches["K7"],
                              "sf3d_farm_batch_of_4": farm_launches["K7"],
                              "sf3d_farm_dp2_tp2_batch_of_2": multi["sf3d_farm"]["K7"]},
         "max_abs_err": 0.0, "limit": "byte-equal wire (bits, u16 positions, counters)", "check": "pass",
         "ms": k7["ms"], "plain_ms": k7["plain_ms"], "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None},
        {"name": "marching_tets", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/marching_tets.cu",
         "replaces": "sculptmate_tpu/geometry/marching_tets.py:454", "launches": sf3d_packed_launches["K11"],
         "max_abs_err": 0.0, "limit": "equal positions, faces and counters", "check": "pass",
         "ms": k11["ms"], "plain_ms": k11["plain_ms"], "bound_ms": k11["bound_ms"], "bound_by": k11["bound_by"],
         "library_ms": None},
        k12,
    ]}
    log("# kernel times per asset: K1's ms, plain_ms, bound_ms and library_ms sum its 44 Lean launches (16 attn1 +"
        " 16 attn2 + 12 ViT) and its launches are those of one 8-asset serving batch, as before the SF3D path;"
        " the sf3d_* keys sum its 68 SF3D launches (24 DINOv2-L + 4 fuse-in + 4 fuse-out + 12 latent self + 12"
        " latent cross + 12 CLIP) and count those of one Fast3DGenerator asset; K2 is the 256^3 grid (launches of"
        " the serving batch), K5 the 161^3 tet lattice (launches of the Fast3DGenerator asset; ms the kernel alone,"
        " weights_pack_ms its heads' packing, once per model in SF3D._k5_weights_packed); K2's max_abs_err"
        " is on d before the exp; K6, K8 and K9 count the textured Fast3DGenerator asset's launches; K6's ms is the"
        " kernel alone at 262 144 scattered points and asset_texels_ms at the asset's own 512^2 bake texels, its"
        " relayout_ms the planes' bf16 channels-last pass (once per scene code, beside its bound)"
        " and weights_pack_ms its heads' packing (once per model in SF3D._k6_weights_packed); K8's times sum its"
        " bake raster (512^2) and its two unwrap rasters (1024^2), each measured, and its launches count the two"
        " unwrap rasters K9 runs as K8's unwrap form, device_ops_per_bake_raster the fill and raster of one bake"
        " (K8_split); K9's ms include its two K8 rasters, its plain_ms the plain K8's, device_ops_per_call the"
        " launches and copies of one call (K9_split); K9's max_abs_err is the larger of its UV error"
        " and the share of faces whose atlas index differs; K3 is the Lean asset's 256^3 wire (its launches the"
        " TripoGenerator asset's, ms the wire without the color positions); K4's launches are the TripoGenerator"
        " asset's (per path beside them), its ms the asset's ~0.6 M vertices and render_view_ms one view's 8.39 M"
        " samples, relayout_ms its planes' channels-last copy (once per code) and weights_pack_ms its decoder's"
        " packing (once per model); K10 is the asset's 256^3 packed mesh, its launches those of"
        " the packed asset; K7 is the full-width SF3D asset's 161^3 wire at snap_eps 0.2, its launches the untextured"
        " Fast3DGenerator asset's (per path beside them); K11 is the same lattice's packed mesh, its launches those of"
        " one SF3D._extract_packed_mesh; K1's d88_* keys are one call at head dim 88 at"
        " SingleStreamTransformer's shape (1, 27648, 27648, 16, 88), and launches_by_path counts its 32 launches in"
        " one SingleStreamTransformer call and its 1 in one full TriplaneAttention at res 96; each launches_by_path"
        " also counts the multi-device phase (the (dp 2, tp 2) farms' batches, K1 split over 2 tp shards, and one"
        " call of each 512^3 sharded function over sp = 4); K2's slab_* keys time it at a shard's 129 x 512 x 512"
        " slab, K3's and K10's at a shard's padded 136 x 512 x 512 level, x limit 128 (K10 with its vertices' edges, as"
        " sharded_extract calls it); K10's edges_ms is the asset's 256^3 mesh with its vertices' edges; K12's"
        " launches are one Lean preprocess_image's (per button and for the panel's call with no session beside"
        " them), its ms, plain_ms and bound_ms sum a Lean request's three resizes at the add-on's shapes, each"
        " step's under steps, and frontend_ms the host ms of a request on the host path and on the card path")
    log(json.dumps({"session_zoo_ms_per_image": session_ms, "sam_cutout_ms_per_image": sam_cutout_ms,
                    "dead_upstream_ms": {key: v["ms"] for key, v in dead_upstream.items()}}))
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
