"""repro_torch.obs — run-wide telemetry: metrics, tracing, and the compression
observatory (DESIGN.md §11).  The port's own copy of ``repro.obs``, with the
same behaviour, so the port imports nothing of the JAX package.

Deliberately stdlib-only (no jax, no numpy, no torch): importing or updating
an instrument can never pull in device state or add a sync, and the disabled
path is a single attribute check per call.

  * :mod:`repro_torch.obs.metrics`     — counters / gauges / ring-buffer
    histograms in a process-global registry, JSONL export + summary();
  * :mod:`repro_torch.obs.trace`       — nested span timers on the profiler's
    clock, with call and parent ids, Chrome-trace JSON, one track per thread;
  * :mod:`repro_torch.obs.observatory` — per-snapshot per-bucket compression
    records beside the manifest, run-level rate-quality trajectory.
"""

from repro_torch.obs import metrics, observatory, trace
from repro_torch.obs.metrics import (counter, disable, enable, enabled, event,
                               export_snapshot, gauge, histogram, summary)
from repro_torch.obs.trace import span

__all__ = [
    "metrics", "trace", "observatory",
    "counter", "gauge", "histogram", "event",
    "enable", "disable", "enabled", "export_snapshot", "summary", "span",
]
