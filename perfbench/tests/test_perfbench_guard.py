"""Nothing the benchmark loads is JAX or the JAX package, and the
reference takes nothing of the program."""

import ast
import subprocess
import sys

import pytest

from perfbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "radar_tpu"}
FILES = sorted(manifest.PACKAGE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(manifest.PACKAGE)))
def test_sources_import_no_jax(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if "reference" in path.parts:
        assert "radar_tpu_torch" not in names
        assert not {n for n in names if n == "perfbench"} - {"perfbench"}


def test_reference_imports_only_numpy_and_torch():
    for path in (manifest.PACKAGE / "reference").glob("*.py"):
        assert top_level_imports(path) <= {"__future__", "math", "contextlib",
                                           "numpy", "torch"}


def test_loaded_modules():
    """Every module of the benchmark, imported in a fresh process: no
    module whose top-level name is JAX's or the JAX package's."""
    mods = [".".join(p.relative_to(manifest.REPO).with_suffix("").parts)
            for p in FILES if "tests" not in p.parts
            and p.name.count(".") == 1]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
