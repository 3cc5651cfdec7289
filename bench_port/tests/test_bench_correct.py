"""``correct`` at a size a test run holds: the control (the reference one
precision step below the configuration's, in the program's place) reads
past the cell's limits, and a run with the timed path broken underneath
comes out not correct, once for each fault the cells can have: an answer
altered where it is produced (the mesh's vertices, its colors, its faces
half dropped, wound the other way or joined to the wrong vertices), and
half of the farm's batch left out (its second half answered with the first
half's meshes). The chip's look is skipped; the rest of the run is
whole."""

import json

import numpy as np
import pytest

import control
import run


def _run(tiny_bench, workload, seed=2**35 + 3):
    return run.run(workload, seed, 1.0, False, require_cuda=False, benchmark_path=tiny_bench, device="cpu")


@pytest.mark.parametrize("workload", ["tiny-addon", "tiny-farm"])
def test_control_reads_past_the_limits(tiny_bench, workload):
    limits = json.load(open(tiny_bench.replace("BENCHMARK.json", f"bench_port/cells/{workload}.json")))["limits"]
    readings = control.readings(workload, 2**33 + 5, 2, "cpu", tiny_bench)
    failed = [k for k, lim in limits.items() if readings[k] > lim]
    assert failed, json.dumps(readings)


def _shift_vertices(mesh):
    verts, faces, colors = mesh
    return verts + 0.02, faces, colors


def _tint_colors(mesh):
    verts, faces, colors = mesh
    return verts, faces, np.clip(colors + 0.2, 0, 1)


def _drop_half_the_faces(mesh):
    verts, faces, colors = mesh
    return verts, faces[::2], colors


def _rewind_faces(mesh):
    verts, faces, colors = mesh
    return verts, faces[:, ::-1], colors


def _garble_faces(mesh):
    verts, faces, colors = mesh
    return verts, np.random.default_rng(0).permutation(len(verts))[faces], colors


FAULTS = [_shift_vertices, _tint_colors, _drop_half_the_faces, _rewind_faces, _garble_faces]
FAULT_IDS = ["vertices", "colors", "faces-halved", "faces-rewound", "faces-garbled"]


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_an_altered_answer_is_not_correct(tiny_bench, monkeypatch, fault):
    from sculptmate_tpu_torch.systems.tsr import TSR

    image_to_mesh = TSR.image_to_mesh
    monkeypatch.setattr(TSR, "image_to_mesh", lambda self, *a, **k: fault(image_to_mesh(self, *a, **k)))
    out = _run(tiny_bench, "tiny-addon")
    assert out["correct"] is False and out["attempted"] >= 1


@pytest.mark.parametrize("fault", FAULTS[2:], ids=FAULT_IDS[2:])
def test_altered_faces_in_the_farm_are_not_correct(tiny_bench, monkeypatch, fault):
    from sculptmate_tpu_torch.parallel.farm import AssetFarm

    generate = AssetFarm.generate_batch_rgba
    monkeypatch.setattr(AssetFarm, "generate_batch_rgba",
                        lambda self, *a, **k: [fault(m) for m in generate(self, *a, **k)])
    out = _run(tiny_bench, "tiny-farm")
    assert out["correct"] is False
    assert out["checks"]["face_gap"]["value"] > out["checks"]["face_gap"]["limit"]


def test_half_the_batch_left_out_is_not_correct(tiny_bench, monkeypatch):
    from sculptmate_tpu_torch.parallel.farm import AssetFarm

    generate = AssetFarm.generate_batch_rgba

    def first_half(self, rgba, **kw):
        meshes = generate(self, rgba[: len(rgba) // 2], **kw)
        return meshes + meshes

    monkeypatch.setattr(AssetFarm, "generate_batch_rgba", first_half)
    out = _run(tiny_bench, "tiny-farm")
    assert out["correct"] is False
    assert out["checks"]["surface_gap"]["value"] > out["checks"]["surface_gap"]["limit"]


@pytest.mark.parametrize("workload", ["tiny-addon", "tiny-farm"])
def test_sound_runs_are_correct_on_other_seeds(tiny_bench, workload):
    assert _run(tiny_bench, workload, seed=77)["correct"] is True
