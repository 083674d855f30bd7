"""Per-layer metric readers, one file a metric, named as the metric
(``<name>.py``, dots and all) and loaded by path: ``read(ctx)`` takes a
:class:`portbench.tracing.Context` and returns the number, or ``None`` where
it finds nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
