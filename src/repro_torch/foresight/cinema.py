"""Cinema — Foresight's visualization component (paper §IV-A3).

The paper groups result plots into a *Cinema Explorer database*: a
directory with a ``data.csv`` index whose rows point at per-case artifact
files. We emit exactly that structure (CSV index + JSON artifacts per
case + optional pk-ratio / halo-ratio curves as artifact columns), which a
Cinema viewer can load; plotting libraries aren't available offline, so
artifacts carry the plot *data*, not rasterized images.

A verbatim copy of the JAX package's ``repro.foresight.cinema`` (no jax):
the port imports nothing of ``repro``.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Iterable, Sequence

import numpy as np


class CinemaDatabase:
    def __init__(self, directory: str | Path, name: str = "foresight"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.rows: list[dict[str, Any]] = []

    def add_case(self, case: dict[str, Any],
                 curves: dict[str, tuple[Sequence, Sequence]] | None = None) -> None:
        """case: flat scalar columns; curves: name -> (x, y) arrays stored
        as sidecar JSON artifacts referenced from the index row."""
        row = dict(case)
        idx = len(self.rows)
        if curves:
            for cname, (x, y) in curves.items():
                fn = f"case_{idx:04d}_{cname}.json"
                (self.dir / fn).write_text(json.dumps({
                    "x": np.asarray(x).tolist(),
                    "y": np.asarray(y).tolist(),
                }))
                row[f"FILE_{cname}"] = fn
        self.rows.append(row)

    def write(self) -> Path:
        if not self.rows:
            raise ValueError("empty database")
        cols: list[str] = []
        for r in self.rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        path = self.dir / "data.csv"
        with path.open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols)
            w.writeheader()
            for r in self.rows:
                w.writerow(r)
        (self.dir / "info.json").write_text(json.dumps(
            {"name": self.name, "type": "cinema_explorer_like", "n_cases": len(self.rows)}))
        return path
