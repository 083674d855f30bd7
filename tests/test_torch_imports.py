"""Import hygiene of the port: nothing under ``src/repro_torch/``, nothing in
the port's examples (``examples/torch_*.py``) and nothing in
``chip_smoke.py`` imports ``jax`` or anything of the JAX package ``repro``
(it keeps its own copies of what it needs)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "repro")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path) -> list[tuple[int, str]]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, alias.name) for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.lineno, node.module))
    return out


def test_the_walk_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/core/api.py" in names and "chip_smoke.py" in names
    for module in ("configs/registry.py", "configs/starcoder2_3b.py", "models/layers.py",
                   "models/transformer.py", "models/interop.py", "kernels/kvc_attention.py",
                   "serving/engine.py", "serving/kv_pages.py", "launch/serve.py",
                   "analysis/halos.py", "foresight/__init__.py", "foresight/cbench.py",
                   "foresight/pat.py", "foresight/cinema.py", "foresight/guideline.py",
                   "dist/sharding.py", "dist/insitu.py", "dist/collectives.py", "dist/spmd.py",
                   "launch/train.py", "launch/mesh.py", "serving/router.py",
                   "serving/faults.py", "optim/adamw.py", "optim/schedules.py",
                   "data/tokens.py", "train/step.py", "train/loop.py", "train/elastic.py",
                   "train/faults.py", "train/supervisor.py", "models/moe.py",
                   "models/rwkv6.py", "models/hybrid.py", "models/encdec.py",
                   "launch/dryrun.py", "launch/costrun.py"):
        assert f"src/repro_torch/{module}" in names, module
    for example in ("torch_quickstart.py", "torch_foresight_workflow.py",
                    "torch_serve_batched.py", "torch_train_lm_compressed.py"):
        assert f"examples/{example}" in names, example
    assert _forbidden("jax.numpy") and _forbidden("repro.core") and not _forbidden("repro_torch.core")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_imports(path):
    bad = [f"{path.relative_to(ROOT)}:{line}: {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, "the port imports jax or the JAX package:\n" + "\n".join(bad)
