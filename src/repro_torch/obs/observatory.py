"""The compression observatory: per-snapshot, per-bucket compression
records persisted beside each manifest, aggregated into a run-level
rate-quality trajectory.

The paper's core loop is *observe compressor behavior, then pick
configuration*; this module is the "observe" half for the checkpoint
path.  The drain thread (checkpoint.manager._write_into) builds one
record per manifest leaf — codec, error bound, raw/stored bytes, launch
count, and the fetch/encode/write wall it actually spent — and drops them
as ``obs_iNNNNNNNNN.json`` next to ``MANIFEST.json``.  The byte totals
are computed from the *same* ``len(payload)`` values the manifest stores,
so they match the persisted payload sizes exactly (asserted in
tests/test_obs.py).

The obs file is advisory: it is excluded from the manifest digest,
written before the manifest (so it is durable whenever the snapshot is
adoptable), and never a fault-injection victim (corruption drills pick
``*.bin`` payloads).

``run_trajectory`` walks a checkpoint directory's surviving steps into a
rate-quality time series; ``foresight.guideline.rate_quality_feedback``
reads that series to report ratio trend and stall — the hook the online
autotuner (ROADMAP: "foresight in the loop") hangs off.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

__all__ = ["SCHEMA", "obs_name", "build_doc", "read_obs", "run_trajectory"]

SCHEMA = "obs_snapshot/v1"


def obs_name(step: int) -> str:
    """File name for a step's observatory record (zero-padded like the
    ``step_*`` dirs so lexicographic order is step order)."""
    return f"obs_i{step:09d}.json"


def build_doc(step: int, records: list[dict], retries: int = 0) -> dict:
    """Assemble the per-snapshot document from per-leaf records.  Each
    record carries at least ``raw_bytes``/``stored_bytes``; totals and the
    headline ratio are derived here, once."""
    for r in records:
        if "ratio" not in r and r.get("stored_bytes"):
            r["ratio"] = round(r.get("raw_bytes", 0) / r["stored_bytes"], 4)
    total_raw = int(sum(r.get("raw_bytes", 0) for r in records))
    total_stored = int(sum(r.get("stored_bytes", 0) for r in records))
    return {
        "schema": SCHEMA,
        "step": int(step),
        "total_raw_bytes": total_raw,
        "total_stored_bytes": total_stored,
        "ratio": round(total_raw / max(total_stored, 1), 4),
        "retries": int(retries),
        "records": records,
    }


def read_obs(step_dir: str | Path) -> Optional[dict]:
    """Load the observatory record from one ``step_*`` directory, or None
    for pre-observatory snapshots (they restore fine without one)."""
    for p in sorted(Path(step_dir).glob("obs_i*.json")):
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError):
            return None  # advisory data: unreadable != corrupt snapshot
        if doc.get("schema") == SCHEMA:
            return doc
    return None


def run_trajectory(ckpt_dir: str | Path) -> list[dict]:
    """Aggregate every surviving snapshot's observatory record into a
    run-level rate-quality trajectory, oldest step first.  Steps without a
    record (pre-observatory, or quarantined away) are skipped."""
    out: list[dict] = []
    for d in sorted(Path(ckpt_dir).glob("step_*")):
        doc = read_obs(d)
        if doc is None:
            continue
        recs = doc.get("records", [])
        out.append({
            "step": doc["step"],
            "ratio": doc["ratio"],
            "total_raw_bytes": doc["total_raw_bytes"],
            "total_stored_bytes": doc["total_stored_bytes"],
            "retries": doc.get("retries", 0),
            "codecs": sorted({str(r.get("codec")) for r in recs}),
            "n_records": len(recs),
        })
    out.sort(key=lambda r: r["step"])
    return out
