"""saxml-style admission control: sorted batch-size ladder + max-live-batches
(the port of ``repro.serving.admission``; no JAX in it, copied as it is).

A servable method in saxml declares a sorted ladder of batch sizes; the
server packs requests into batches whose padded size walks that ladder, and
``max_live_batches`` bounds how many such batches may be in flight at once.
Here the engine executes one fused step over ``batch_slots`` lanes, so the
ladder quantizes the *live-lane target*: admission fills lanes up to the
smallest rung >= demand (queued + live), and the live count never exceeds
``max_live_batches * top_rung`` (nor ``batch_slots``). Everything else —
slot choice, page reservation — stays with the engine; this module only
answers "how many lanes may be live right now?".

Why a ladder at all: on a real accelerator each distinct batch size is a
compiled program; walking a small sorted ladder instead of chasing the exact
live count keeps the program cache tiny and the padding predictable. The
rung is also the honest denominator for occupancy accounting (a batch of 3
on a rung of 4 is 75% full, not 3/batch_slots).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """``ladder``: sorted batch sizes; () means a single rung at
    ``batch_slots``. ``max_live_batches``: cap on concurrent top-rung
    batches worth of live lanes."""

    ladder: tuple[int, ...] = ()
    max_live_batches: int = 1


class AdmissionController:
    def __init__(self, cfg: AdmissionConfig, batch_slots: int):
        ladder = tuple(sorted(cfg.ladder)) or (batch_slots,)
        if any(b <= 0 for b in ladder):
            raise ValueError(f"ladder rungs must be positive: {ladder}")
        if ladder[-1] > batch_slots:
            raise ValueError(
                f"top rung {ladder[-1]} exceeds batch_slots {batch_slots}")
        if cfg.max_live_batches <= 0:
            raise ValueError(
                f"max_live_batches must be positive: {cfg.max_live_batches}")
        self.ladder = ladder
        self.max_live = min(batch_slots, cfg.max_live_batches * ladder[-1])

    def rung(self, demand: int) -> int:
        """Smallest ladder rung >= demand (top rung if demand exceeds it)."""
        for b in self.ladder:
            if b >= demand:
                return b
        return self.ladder[-1]

    def target_live(self, live: int, queued: int) -> int:
        """Lanes that may be live this tick: demand quantized up onto the
        ladder (whole batches of the top rung beyond it), capped by
        max_live_batches."""
        demand = live + queued
        top = self.ladder[-1]
        if demand <= top:
            target = self.rung(demand)
        else:
            target = -(-demand // top) * top  # whole top-rung batches
        return min(target, self.max_live)

    def admittable(self, live: int, queued: int) -> int:
        """How many queued requests may be admitted right now."""
        return max(0, self.target_live(live, queued) - live)
