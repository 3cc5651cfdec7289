"""What the harness and the reference load: no JAX, no JAX package (top-
level module names compared whole, so ``sculptmate_tpu_torch`` passes),
and in the reference nothing of the port. Each check runs in a fresh
interpreter."""

import ast
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)

_PROBE = """
import sys
sys.path[:0] = [{bench!r}, {repo!r}]
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_modules(body: str):
    code = _PROBE.format(bench=BENCH_DIR, repo=REPO_DIR, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": ""})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_whole_tiny_run_loads_no_jax(tiny_bench):
    body = f"""
import run
out = run.run("tiny-addon", 5, 0.5, True, require_cuda=False, benchmark_path={tiny_bench!r}, device="cpu")
assert run.forbidden_modules() == []
"""
    loaded = _top_level_modules(body)
    assert not loaded & {"jax", "jaxlib", "flax", "sculptmate_tpu"}
    assert "sculptmate_tpu_torch" in loaded  # the program ran: a whole-name check lets it pass


def test_the_reference_loads_nothing_of_the_program():
    body = """
import importlib, pkgutil, reference
for m in pkgutil.iter_modules(reference.__path__):
    importlib.import_module("reference." + m.name)
from harness.cell import load_module
load_module(%r)
""" % os.path.join(BENCH_DIR, "configs", "triposr-lean.py")
    loaded = _top_level_modules(body)
    assert not loaded & {"jax", "jaxlib", "flax", "sculptmate_tpu", "sculptmate_tpu_torch"}


def test_reference_sources_import_nothing_of_the_program():
    for name in os.listdir(os.path.join(BENCH_DIR, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(BENCH_DIR, "reference", name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in {"jax", "jaxlib", "flax", "sculptmate_tpu", "sculptmate_tpu_torch"}, \
                    (name, m)


def test_forbidden_names_are_compared_whole():
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["sculptmate_tpu_torch_probe"] = sys
        assert "sculptmate_tpu" not in run.forbidden_modules() or "sculptmate_tpu" in saved
        sys.modules["jaxlib_probe.x"] = sys
        assert "jaxlib" not in run.forbidden_modules() or "jaxlib" in saved
    finally:
        sys.modules.pop("sculptmate_tpu_torch_probe", None)
        sys.modules.pop("jaxlib_probe.x", None)
