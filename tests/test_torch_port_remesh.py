"""Port parity of the host remesh helpers and ``marching_cubes_host`` on the
CPU: ``isotropic_remesh`` (the port's copy of ``isotropic_remesh.cpp``),
``Mesh.subdivide``, ``triangle_remesh`` and ``quad_remesh`` against the JAX
package's, and ``marching_cubes_host`` (the plain K10) against the JAX one.

The JAX package builds its native sources with ``-march=native``, which
lets g++ contract multiply-adds into FMAs; the port builds them portable.
So the exact comparisons load the port's sources built with the JAX
package's flags, and the port's own build is held to the counts."""

import ctypes
import subprocess

import numpy as np
import pytest

from sculptmate_tpu.geometry.marching_cubes import marching_cubes_host as j_marching_cubes_host
from sculptmate_tpu.geometry.mesh import Mesh as JMesh
from sculptmate_tpu.geometry.remesh import isotropic_remesh as j_isotropic_remesh
from sculptmate_tpu_torch.geometry import marching_cubes_host, native, remesh
from sculptmate_tpu_torch.geometry.mesh import Mesh
from sculptmate_tpu_torch.geometry.remesh import isotropic_remesh


def _lumpy_sphere(n=12):
    """A closed-cap lat-long band of a lumpy sphere: 276 vertices, 506 faces."""
    th, ph = np.meshgrid(np.linspace(0.2, np.pi - 0.2, n), np.linspace(0, 2 * np.pi, 2 * n)[:-1], indexing="ij")
    r = 1 + 0.15 * np.cos(3 * ph) * np.sin(2 * th)
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)
    m = 2 * n - 1
    i, j = np.arange(n - 1)[:, None] * m, np.arange(m)[None, :]
    a, b, c, d = i + j, i + (j + 1) % m, i + m + j, i + m + (j + 1) % m
    f = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3), np.stack([b, c, d], -1).reshape(-1, 3)])
    return v.reshape(-1, 3).astype(np.float32), f


MESH = _lumpy_sphere()


@pytest.fixture(scope="module")
def same_flags(tmp_path_factory):
    """The port's decimator and remesher sources built with the JAX
    package's flags, loaded in place of the port's own builds for the
    module's tests that ask for them."""
    out = tmp_path_factory.mktemp("native")
    libs = {}
    for name in ("quadric_decimate", "isotropic_remesh"):
        so = out / f"lib{name}.so"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread", "-march=native", "-funroll-loops",
                        f"{native._DIR}/{name}.cpp", "-o", str(so)], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


@pytest.fixture
def jax_flags(same_flags, monkeypatch):
    for name, lib in same_flags.items():
        monkeypatch.setitem(native._LIBS, name, lib)


@pytest.mark.parametrize("h", [None, 0.11])
def test_isotropic_remesh_matches_jax(jax_flags, h):
    """The same C++ with the same flags: byte-equal vertices and faces, at
    the mean edge length and at a target that grows the mesh 5x (inside the
    output's 6x headroom)."""
    v, f = isotropic_remesh(*MESH, h, 5)
    jv, jf = j_isotropic_remesh(*MESH, h, 5)
    assert v.dtype == jv.dtype and f.dtype == jf.dtype == np.int64
    assert np.array_equal(v, jv) and np.array_equal(f, jf)
    assert len(f) > 0 and f.max() < len(v)


def test_isotropic_remesh_past_the_headroom_is_rerun(jax_flags):
    """A target that grows the mesh 24x: the JAX package returns the output
    cut at its 6x headroom (1 656 vertices, faces pointing past them); the
    port reruns it with more room and returns it whole, its leading
    vertices those the JAX package kept."""
    v, f = isotropic_remesh(*MESH, 0.05, 5)
    jv, jf = j_isotropic_remesh(*MESH, 0.05, 5)
    assert len(jv) == 6 * len(MESH[0]) and jf.max() >= len(jv)
    assert len(v) > 6 * len(MESH[0]) and f.min() >= 0 and f.max() < len(v)
    assert np.array_equal(v[: len(jv)], jv)


def test_isotropic_remesh_portable_build():
    """The port's own (portable) build: vertex and face counts within 5 % of
    the JAX package's, faces in range."""
    v, f = isotropic_remesh(*MESH, 0.11, 5)
    jv, jf = j_isotropic_remesh(*MESH, 0.11, 5)
    assert abs(len(v) - len(jv)) <= 0.05 * len(jv) and abs(len(f) - len(jf)) <= 0.05 * len(jf)
    assert f.min() >= 0 and f.max() < len(v) and np.isfinite(v).all()


def test_isotropic_remesh_without_the_library_warns(monkeypatch):
    """Without a built library the remesh warns and returns its input."""
    monkeypatch.setattr(remesh, "load_native", lambda name: None)
    with pytest.warns(RuntimeWarning, match="NO-OP"):
        v, f = isotropic_remesh(*MESH)
    assert np.array_equal(v, MESH[0]) and np.array_equal(f, MESH[1]) and f.dtype == np.int64


@pytest.mark.parametrize("iters", [1, 2])
def test_subdivide_matches_jax(iters):
    got, ref = Mesh(*MESH).subdivide(iters), JMesh(*MESH).subdivide(iters)
    assert np.array_equal(got.v_pos, ref.v_pos) and np.array_equal(got.t_pos_idx, ref.t_pos_idx)


@pytest.mark.parametrize("case", ["growth", "growth, isotropic", "reduction", "reduction, isotropic",
                                  "edge multiplier"])
def test_triangle_remesh_matches_jax(jax_flags, case):
    """Growth (subdivision, then decimation to the count), reduction, each
    with and without the isotropic pass, and an edge-length multiplier
    alone: vertices within 1e-6 and faces equal."""
    if case == "edge multiplier":
        kw = {"triangle_average_edge_length_multiplier": 1.5}
    else:
        kw = {"triangle_vertex_count": 2000 if case.startswith("growth") else 100, "isotropic": "isotropic" in case}
    got, ref = Mesh(*MESH).triangle_remesh(**kw), JMesh(*MESH).triangle_remesh(**kw)
    assert got.v_pos.shape == ref.v_pos.shape and np.array_equal(got.t_pos_idx, ref.t_pos_idx)
    np.testing.assert_allclose(got.v_pos, ref.v_pos, rtol=0, atol=1e-6)


def test_triangle_remesh_portable_build():
    """The port's own builds: growth to 2000 vertices lands within 3 % of
    the JAX package's count."""
    got, ref = Mesh(*MESH).triangle_remesh(2000), JMesh(*MESH).triangle_remesh(2000)
    assert abs(len(got.v_pos) - len(ref.v_pos)) <= 0.03 * len(ref.v_pos)
    assert got.t_pos_idx.max() < len(got.v_pos)


def test_quad_remesh_is_the_identity():
    got = Mesh(*MESH, source="test").quad_remesh(500)
    assert np.array_equal(got.v_pos, MESH[0]) and np.array_equal(got.t_pos_idx, MESH[1])
    assert Mesh(*MESH, source="test").extras == {"source": "test"} == JMesh(*MESH, source="test").extras


def _sphere_level(shape):
    g = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape), indexing="ij")
    c = [(s - 1) / 2 for s in shape]
    return (0.35 * min(shape) - np.sqrt(sum((x - ci) ** 2 for x, ci in zip(g, c)))).astype(np.float32)


@pytest.mark.parametrize("case", ["sphere 16^3", "ragged 13 x 21 x 18", "ragged, a capacity retry"])
def test_marching_cubes_host_matches_jax(case):
    """``marching_cubes_host`` on the CPU (the plain K10) against the JAX
    one: vertices within 1e-6, faces equal. A ragged level is padded to
    multiples of 8 with -1 as the JAX package pads it; at capacities under
    the counts both retry and return the whole mesh."""
    if case == "sphere 16^3":
        level = _sphere_level((16, 16, 16))
    else:
        rng = np.random.default_rng(4)
        level = _sphere_level((13, 21, 18)) + 0.5 * rng.standard_normal((13, 21, 18)).astype(np.float32)
    caps = (300, 500) if "retry" in case else (0, 0)
    v, f = marching_cubes_host(level, *caps, device="cpu")
    jv, jf = j_marching_cubes_host(level, *caps)
    assert len(f) > 0 and v.shape == jv.shape and f.dtype == np.int32
    if "retry" in case:
        assert len(v) > caps[0] and len(f) > caps[1]
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-6)
    assert np.array_equal(f, jf)
