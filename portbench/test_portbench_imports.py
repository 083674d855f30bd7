"""Import hygiene: nothing in the benchmark imports jax, jaxlib, flax or the
JAX package ``repro`` (top-level names compared whole, so ``repro_torch`` is
not ``repro``), the references import nothing of the port either, and a whole
run leaves none of them in ``sys.modules``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "portbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_the_walk_sees_the_benchmark():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"portbench/run.py", "portbench/harness.py", "portbench/reference/sz_tiled.py",
            "portbench/reference/zfp_fixed.py", "portbench/metrics/sz_compress_roofline.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    if "reference" in path.parts:
        assert not [m for m in _imports(path) if m.split(".")[0] == "repro_torch"]


def test_a_run_loads_none_of_them():
    code = ("import sys; sys.path.insert(0, 'src'); from portbench import harness; "
            "harness.run('hacc1024.zfp_r8', 1, 0.05, False, device='cpu', "
            "config_overrides={'grid': 8, 'particles': 500}, "
            "compressor_args={'backend': 'kernel'}); "
            "print(harness.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
