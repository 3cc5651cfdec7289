"""The Pro cell at a size a test run holds: a tiny Stable Fast 3D cell
added from files alone runs end to end on the CPU through ``run.run``; a
run with the answer altered where ``SF3D.run_image`` produces it comes out
not correct, once for each fault a textured mesh can have (vertices
shifted, faces wound the other way, a part dropped, UVs outside [0, 1],
the albedo tinted, two corners' UVs swapped, the roughness wrong); the
control (the reference one precision step below the configuration's)
reads past the limits; and ``counts/sf3d.py`` counts a tiny configuration
as worked out by hand."""

import json
import os
import shutil

import numpy as np
import pytest

import control
import run

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
CELL = "tiny-pro-addon"


@pytest.fixture(scope="session")
def tiny_pro_bench(tiny_bench):
    """The tiny cells' copy of the benchmark with a tiny Pro cell added from
    files alone: a configuration file (the ``sf3d-pro`` module beside it),
    a traffic file, the cell's limits and BENCHMARK.json entries."""
    root = os.path.dirname(tiny_bench)
    b = os.path.join(root, "bench_port")
    shutil.copy(os.path.join(TINY, "tiny-pro.json"), os.path.join(b, "configs", "tiny-pro.json"))
    shutil.copy(os.path.join(b, "configs", "sf3d-pro.py"), os.path.join(b, "configs", "tiny-pro.py"))
    shutil.copy(os.path.join(TINY, "tiny-pro-photo.json"), os.path.join(b, "traffic", "tiny-pro-photo.json"))
    shutil.copy(os.path.join(TINY, "tiny-pro-cell.json"), os.path.join(b, "cells", f"{CELL}.json"))
    with open(tiny_bench) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-pro", "source": "https://huggingface.co/stabilityai/stable-fast-3d",
                             "file": "bench_port/configs/tiny-pro.json", "reduced": [],
                             "why": "a tiny Stable Fast 3D for CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny-pro", "traffic": "tiny-pro-photo", "chips": 1,
                               "why": "CPU test of the Pro add-on loop"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pro-addon-textured" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(tiny_bench, "w") as f:
        json.dump(bench, f)
    return tiny_bench


def _run(bench, seed=2**35 + 3, trace=False):
    return run.run(CELL, seed, 1.0, trace, require_cuda=False, benchmark_path=bench, device="cpu")


def test_the_cell_runs_from_its_files(tiny_pro_bench):
    out = _run(tiny_pro_bench)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"latency_p50_s", "latency_p90_s", "setup_s"}  # no memory peak on the CPU
    assert set(out["checks"]) == set(json.load(open(os.path.join(TINY, "tiny-pro-cell.json")))["limits"])


def test_a_traced_run_reads_the_program_spans(tiny_pro_bench):
    """On the CPU the staged bake runs (no ``sf3d.unwrap_bake``) and no
    device operation is traced: the host spans' readers read, the rest
    read nothing."""
    metrics = _run(tiny_pro_bench, seed=2**40 + 9, trace=True)["metrics"]
    assert {"wire_decode_ms.pro_single", "decimate_ms.pro_single", "capacity_retries.pro_single",
            "mfu.pro_single"} <= set(metrics)
    assert not {"encode_ms.pro_single", "unwrap_bake_ms.pro_single", "bake_host_ms.pro_single",
                "attention_roofline.pro_single", "grid_roofline.pro_single"} & set(metrics)


def _shift_vertices(out):
    return {**out, "verts": out["verts"] + np.float32(0.25)}


def _rewind_faces(out):
    return {**out, "faces": np.ascontiguousarray(out["faces"][:, ::-1])}


def _drop_a_part(out):
    centroid_x = out["verts"][out["faces"]].mean(1)[:, 0]
    return {**out, "faces": out["faces"][centroid_x < np.median(centroid_x)]}


def _uvs_outside(out):
    return {**out, "uvs": out["uvs"] * 1.5 - 0.25}


def _tint_albedo(out):
    return {**out, "textures": {**out["textures"], "albedo": np.clip(out["textures"]["albedo"] + 0.2, 0, 1)}}


def _swap_uv_corners(out):
    uv = out["uvs"].reshape(-1, 3, 2)[:, [1, 0, 2]]
    return {**out, "uvs": np.ascontiguousarray(uv.reshape(-1, 2))}


def _wrong_roughness(out):
    return {**out, "roughness": (out["roughness"] + 0.5) % 1.0}


FAULTS = [_shift_vertices, _rewind_faces, _drop_a_part, _uvs_outside, _tint_albedo, _swap_uv_corners,
          _wrong_roughness]
FAULT_IDS = ["vertices-shifted", "faces-rewound", "part-dropped", "uvs-outside", "albedo-tinted",
             "uv-corners-swapped", "roughness-wrong"]


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_an_altered_answer_is_not_correct(tiny_pro_bench, monkeypatch, fault):
    from sculptmate_tpu_torch.systems.sf3d import SF3D

    run_image = SF3D.run_image
    monkeypatch.setattr(SF3D, "run_image", lambda self, *a, **k: fault(run_image(self, *a, **k)))
    out = _run(tiny_pro_bench)
    assert out["correct"] is False and out["attempted"] >= 1


def test_the_control_reads_past_the_limits(tiny_pro_bench):
    limits = json.load(open(os.path.join(TINY, "tiny-pro-cell.json")))["limits"]
    readings = control.readings(CELL, 2**33 + 5, 2, "cpu", tiny_pro_bench)
    assert [k for k, lim in limits.items() if k in readings and readings[k] > lim], json.dumps(readings)


def test_sound_runs_are_correct_on_other_seeds(tiny_pro_bench):
    assert _run(tiny_pro_bench, seed=77)["correct"] is True


def test_counts_by_hand():
    """A one-block, one-basic-block configuration: 4 x 4 image patches
    (17 tokens), 2 x 2 CLIP patches (5 tokens), 3 x 2^2 triplane tokens,
    17 + 3 latent rows, one head of 8; heads of width 64; a 3^3 lattice."""
    from counts import sf3d

    with open(os.path.join(TINY, "tiny-pro.json")) as f:
        c = json.load(f)
    c["cond_image_size"], c["isosurface_resolution"] = 56, 2
    c["image_tokenizer"].update(hidden_size=8, num_hidden_layers=1, num_attention_heads=1, intermediate_size=16)
    c["image_estimator"].update(clip_width=8, clip_layers=1, clip_heads=1, image_size=64, hidden_features=4)
    c["tokenizer"].update(plane_size=2, num_channels=8)
    c["backbone"].update(num_attention_heads=1, attention_head_dim=8, num_latents=3, num_blocks=1,
                         num_basic_blocks=1)
    c["post_processor"].update(out_channels=2, scale_factor=2, conv_layers=2)
    assert sf3d.calls(c) == [(1, 17, 17, 1, 8), (1, 5, 5, 1, 8), (1, 20, 12, 1, 8), (1, 20, 20, 1, 8),
                             (1, 20, 17, 1, 8), (1, 12, 20, 1, 8)]
    # K5: 27 points x (two 64 x 64 layers and 1 + 3 output channels), the
    # three 3^2 x 128 partial planes, both heads' weights and the 4 outputs
    flops = 27 * (2 * (2 * 64 * 64) + 2 * 64 * 4)
    nbytes = 3 * 9 * 2 * 64 * 2 + 2 * (64 * 64 + 8 * 64) * 2 + 4 * 27 * 4
    assert sf3d.grid_bound_s(c) == max(flops / 989e12, nbytes / 3.35e12)
    # per point: the density head 2 (6 x 64 + 64 x 64 + 64), the offsets
    # 2 (6 x 64 + 64 x 64 + 3 x 64); per texel the two three-layer heads
    lattice = 27 * (2 * (6 * 64 + 64 * 64 + 64) + 2 * (6 * 64 + 64 * 64 + 3 * 64))
    texels = 4 * 4 * 2 * 2 * (6 * 64 + 2 * 64 * 64 + 3 * 64)
    attention = 4 * 8 * (17 * 17 + 20 * 12 + 20 * 20 + 20 * 17 + 12 * 20)
    clip_attention = 4 * 8 * 5 * 5
    camera = 2 * 25 * 768
    dino = 2 * 16 * 3 * 14 * 14 * 8 + 2 * 17 * (4 * 64 + 2 * 8 * 16) + 2 * 2 * 768 * 16
    ff = lambda n, d: 2 * n * (d * 8 * d + 4 * d * d)  # noqa: E731
    block = (2 * 20 * 2 * 64 + 2 * 12 * 2 * 64 + ff(20, 8)
             + 2 * 20 * 4 * 64 + 2 * 20 * 2 * 64 + 2 * 17 * 2 * 64 + ff(20, 8)
             + 2 * 12 * 2 * 64 + 2 * 20 * 2 * 64 + ff(12, 8))
    backbone = 2 * 12 * 64 + 2 * 17 * 64 + 2 * 3 * 64 + block + 2 * 12 * 64
    upsample = 3 * 4 * 2 * 9 * 8 * (8 + 2 * 4)
    clip = 2 * 4 * 3 * 32 * 32 * 8 + 2 * 5 * 12 * 64 + 2 * 8 * 4 + 2 * 2 * 4 * 4 * (3 + 2)
    total = camera + dino + backbone + upsample + attention + clip + clip_attention + lattice + texels
    assert sf3d.request_flops(c, 4) == pytest.approx(total, rel=1e-12)
