"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Environment and build: the card (``nvidia-smi`` name and power limit),
   torch and CUDA versions, and every kernel in ``sculptmate_tpu_torch/csrc``
   built from source with ``nvcc`` (timed). TF32 is switched off for
   matmuls and convolutions so the f32 checks compare full-precision math.
2. Kernel checks at the main path's shapes: each kernel against its plain
   PyTorch version on the same inputs, with its time, the plain version's
   time, a library yardstick where one exists, and the least time the card
   could take (bound). Then each check is run on kernels rebuilt with a
   planted fault (``PLANTED_FAULTS``), and must fail every one of them.
3. The Lean main path at full width (default ``TSRConfig``: ViT-B/16,
   16 x 1024 backbone, 256^3 grid) with seeded random weights: one asset
   through ``TripoGenerator`` with the launch counters read around it, then
   a warm-up and three timed assets through the same calls
   (``scene_codes`` -> ``extract_mesh``); and a narrow model on the card
   against the same model on the CPU.
4. One ``{"kernels": [...]}`` line, then the card line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It needs one CUDA card and exits non-zero without one, printing no result.
"""

import json
import os
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
# rounds its output to bf16 (half an ulp: under 2e-3 for |o| < 1) and P to
# bf16 before P V. With randn q, k, v at D = 64 the outputs have std
# sqrt(e / Nk) (0.03-0.05 here) and reach ~0.5; dropping one key of 1025
# moves the worst output by ~0.08
K1_BF16_LIMIT = 4e-3
K1_F32_LIMIT = 1e-5
# K2 is held on the decoder's output d before the exp, within this share of
# the spread max |d - mean d| of the plain version: the kernel and the plain
# version differ by bf16 rounding, about one ulp of d
K2_SPREAD_SHARE = 0.1

# Deliberate faults, each one edit to a kernel source, that the kernel
# checks must fail: (name, kernel, text, replacement)
PLANTED_FAULTS = (
    ("K1 skips the last key tile", "flash_attn",
     "for (int kt = 0; kt < Nk; kt += BK) {\n        __syncthreads();  // previous tile fully consumed",
     "for (int kt = 0; kt + BK < Nk; kt += BK) {\n        __syncthreads();  // previous tile fully consumed"),
    ("K1 masks the whole ragged key tail", "flash_attn",
     "const bool valid = col + e < Nk;", "const bool valid = col + e < (Nk & ~(BK - 1));"),
    ("K2 reads B[i, k] for B[k, i]", "density_grid",
     "B + ((size_t)kk * R + i) * HW", "B + ((size_t)i * R + kk) * HW"),
    ("K2 drops the first layer (h1 = 0)", "density_grid",
     "out[e] = pack_bf16(silu(a.x + b.x + cc.x), silu(a.y + b.y + cc.y));", "out[e] = 0u;"),
)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    t0 = time.perf_counter()
    per_kernel = kernels.build_all()
    log(f"# built {sorted(per_kernel)} in {time.perf_counter() - t0:.2f} s (parallel nvcc; per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(per_kernel.items())) + ")")
    for name in sorted(per_kernel):
        for line in kernels.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("# TF32 off for matmuls and cuDNN convolutions: f32 checks compare full-precision math")
    return card


def check_attention(g):
    """K1 at the three attention shapes of the Lean path in bf16, and once
    in f32, against the plain version (absolute limits above). Every case
    is checked and printed before a failure raises."""
    from sculptmate_tpu_torch.ops.attention import dot_product_attention_plain, flash_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention  # yardstick only
    cases = [  # (name, B, Nq, Nk, H, launches per asset, dtype)
        ("backbone attn1", 1, 3072, 3072, 16, 16, torch.bfloat16),
        ("backbone attn2", 1, 3072, 1025, 16, 16, torch.bfloat16),
        ("vit self-attention", 1, 1025, 1025, 12, 12, torch.bfloat16),
        ("backbone attn2 f32", 1, 3072, 1025, 16, 0, torch.float32),
    ]
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    worst, bound_by, failures = 0.0, set(), []
    for name, B, Nq, Nk, H, per_asset, dt in cases:
        D = 64
        q = torch.randn(B, Nq, H, D, device="cuda", generator=g).to(dt)
        k = torch.randn(B, Nk, H, D, device="cuda", generator=g).to(dt)
        v = torch.randn(B, Nk, H, D, device="cuda", generator=g).to(dt)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = dot_product_attention_plain(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        limit = K1_BF16_LIMIT if dt == torch.bfloat16 else K1_F32_LIMIT
        line = {"check": "K1", "case": name, "shape": [B, Nq, Nk, H, D], "dtype": str(dt).split(".")[-1],
                "max_abs_err": err, "limit": limit, "max_abs_ref": ref.abs().max().item()}
        if not (torch.isfinite(out).all() and err <= limit):
            log(json.dumps({**line, "check_passed": False}))
            failures.append(f"{name}: max_abs_err {err} > {limit}")
            continue
        esize = 2 if dt == torch.bfloat16 else 4
        bound, by = bound_ms(4 * B * H * Nq * Nk * D, esize * B * H * D * (2 * Nq + 2 * Nk),
                             PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS)
        row = {
            "ms": cuda_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": cuda_ms(lambda: dot_product_attention_plain(q, k, v), iters=5),
            "bound_ms": bound,
            "library_ms": cuda_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))),
        }
        log(json.dumps({**line, "check_passed": True, **row, "bound_by": by, "launches_per_asset": per_asset}))
        if dt == torch.bfloat16:
            worst = max(worst, err)
            bound_by.add(by)
            for key in total:
                total[key] += per_asset * row[key]
    if failures:
        raise AssertionError("K1 " + "; ".join(failures))
    return worst, total, "/".join(sorted(bound_by))  # worst bf16 error, per-asset sums


def check_density(g, tsr):
    """K2 at R = 256 with the main path's decoder (fan-in normal weights,
    zero biases, as ``TSRModule.reset_parameters`` makes them) on random
    unit-scale codes, held on d before the exp (see K2_SPREAD_SHARE)."""
    from sculptmate_tpu_torch.ops import density_grid as dg

    R = 256
    weights = tsr.decoder_weights()
    spec = tsr.grid_spec(R, torch.bfloat16)
    codes = torch.randn(3, tsr.config.upsample_out_channels, 64, 64, device="cuda", generator=g)
    A, B, C = dg.first_layer_partials(codes.to(torch.bfloat16), weights, spec)
    out = dg.density_mlp(A, B, C, weights, spec)
    torch.cuda.synchronize()
    ref = dg.density_mlp_plain(A, B, C, weights, spec)
    d, d_ref = (t.log() - spec.density_bias for t in (out, ref))
    err = (d - d_ref).abs().max().item()
    spread = (d_ref - d_ref.mean()).abs().max().item()
    limit = K2_SPREAD_SHARE * spread
    line = {"check": "K2", "case": "density grid R=256", "dtype": "bfloat16", "max_abs_err": err,
            "limit": limit, "d_spread": spread, "activated_max_abs_err": (out - ref).abs().max().item()}
    if not (torch.isfinite(out).all() and err <= limit):
        log(json.dumps({**line, "check_passed": False}))
        raise AssertionError(f"K2: max_abs_err of d {err} > {limit}")
    L = len(weights) - 2
    flops = R**3 * (L * 2 * 64 * 64 + 2 * 64)  # hidden layers + output channel 0
    nbytes = 3 * R * R * 64 * 2 + L * 64 * 64 * 2 + R**3 * 4
    bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    row = {
        "ms": cuda_ms(lambda: dg.density_mlp(A, B, C, weights, spec), iters=10),
        "plain_ms": cuda_ms(lambda: dg.density_mlp_plain(A, B, C, weights, spec), iters=3),
        "bound_ms": bound,
        "library_ms": None,
    }
    log(json.dumps({**line, "check_passed": True, **row, "bound_by": by, "launches_per_asset": 1}))
    return err, limit, row, by


def planted_faults(g, tsr):
    """Rebuild each kernel from a copy of the sources with one planted fault
    (PLANTED_FAULTS) and run its check, which must fail; then return to the
    real kernels. The copies live in the ignored build directory."""
    from sculptmate_tpu_torch.runtime import kernels

    root = os.path.join(kernels.BUILD_DIR, "planted")
    shutil.rmtree(root, ignore_errors=True)
    for i, (name, kernel, text, replacement) in enumerate(PLANTED_FAULTS):
        csrc = os.path.join(root, str(i))
        shutil.copytree(kernels.CSRC, csrc)
        path = os.path.join(csrc, f"{kernel}.cu")
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise RuntimeError(f"planted fault {name!r}: its text is not once in {kernel}.cu")
        with open(path, "w") as f:
            f.write(src.replace(text, replacement))
        with kernels.sources_from(csrc):
            try:
                check_attention(g) if kernel == "flash_attn" else check_density(g, tsr)
            except AssertionError as e:
                log(json.dumps({"planted_fault": name, "caught": True, "by": str(e)}))
                continue
        raise AssertionError(f"planted fault {name!r} passed its check")


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


def main_path(gen):
    """Full-width Lean path: TripoGenerator once with the launch counters
    around it, then a warm-up and 3 timed assets."""
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
        flash_attention.launches = dg.density_mlp.launches = 0
        rc = gen.generate_mesh(image, output_path=glb, threshold=threshold)
        torch.cuda.synchronize()
        launches = {"K1": flash_attention.launches, "K2": dg.density_mlp.launches}
        glb_bytes = os.path.getsize(glb) if rc == 0 else 0
    # K2 runs twice when the first 256^3 extraction outgrows the default
    # vertex capacity: the exact counter triggers one re-extraction
    log(json.dumps({"main_path": "TripoGenerator.generate_mesh", "rc": rc, "launches": launches,
                    "glb_bytes": glb_bytes}))
    if rc != 0:
        raise RuntimeError(f"generate_mesh returned {rc}")
    if launches["K1"] != 44 or launches["K2"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")

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
    r = tsr.config.radius
    ok = (
        codes.shape == (1, 3, 40, 64, 64) and bool(torch.isfinite(codes).all())
        and len(verts) > 0 and len(faces) > 0
        and faces.min() >= 0 and faces.max() < len(verts)
        and np.isfinite(verts).all() and np.abs(verts).max() <= r + 1e-5
        and colors.shape == verts.shape and colors.min() >= 0 and colors.max() <= 1
    )
    enc, ext, sec = (float(np.median([t[i] for t in times])) for i in range(3))
    log(json.dumps({"main_path": "scene_codes -> extract_mesh(256, colors)", "verts": len(verts), "faces": len(faces),
                    "encode_ms": enc, "extract_ms": ext, "sec_per_asset": sec,
                    "per_asset_runs": [[round(a, 3), round(b, 3), round(c, 4)] for a, b, c in times]}))
    if not ok:
        raise AssertionError("main-path mesh failed its checks")
    where_time_goes(tsr, image, threshold)
    return launches


def where_time_goes(tsr, image, threshold):
    """One asset under torch.profiler: the host and device range of each
    ``tsr.*`` stage span, device time by kernel, and the device's idle
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tsr.extract_mesh(tsr.scene_codes(image[None]), has_vertex_color=True, resolution=256, threshold=threshold)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # a span is a host range and, where it launched kernels, a device range
    # from its first kernel's start to its last kernel's end
    spans = {}
    for e in prof.events():
        if e.name.startswith("tsr."):
            side = "host_ms" if e.device_type == torch.autograd.DeviceType.CPU else "device_span_ms"
            span = spans.setdefault(e.name, {"host_ms": 0.0, "device_span_ms": 0.0})
            span[side] += e.time_range.elapsed_us() / 1e3
    dev = sorted(((e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count) for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0.0) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in spans),
                 key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in dev)
    log(json.dumps({"profile": "one asset (encode + extract_mesh 256^3 + colors)", "wall_ms": wall_ms,
                    "spans": spans,
                    "device_busy_ms": busy if dev else "not measured",
                    "device_idle_share": (1 - busy / wall_ms) if dev else "not measured",
                    "top_kernels_ms": [[k[:80], round(ms, 3), n] for k, ms, n in dev[:12]]}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = phase_environment()
    g = torch.Generator(device="cuda").manual_seed(0)

    from sculptmate_tpu_torch.pipelines.generate import TripoGenerator

    gen = TripoGenerator()  # the main path's model: default TSRConfig, seed 0
    if gen.initiate_model(device="cuda") != 0:
        raise RuntimeError("TripoGenerator.initiate_model failed")
    k1_err, k1, k1_by = check_attention(g)
    k2_err, k2_limit, k2, k2_by = check_density(g, gen.model)
    planted_faults(g, gen.model)
    small_model_check()
    launches = main_path(gen)

    kernels_line = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/flash_attn.cu",
         "replaces": "sculptmate_tpu/ops/attention.py:30", "launches": launches["K1"], "max_abs_err": k1_err,
         "limit": K1_BF16_LIMIT, "check": "pass",
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1_by,
         "library_ms": k1["library_ms"]},
        {"name": "density_grid_mlp", "route": "cuda", "source": "sculptmate_tpu_torch/csrc/density_grid.cu",
         "replaces": "sculptmate_tpu/ops/density_grid.py:129", "launches": launches["K2"], "max_abs_err": k2_err,
         "limit": k2_limit, "check": "pass",
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2_by,
         "library_ms": None},
    ]}
    log("# kernel times per asset: K1 sums its 44 launches (16 attn1 + 16 attn2 + 12 ViT), K2 is the 256^3 grid;"
        " K2's max_abs_err is on d before the exp")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
