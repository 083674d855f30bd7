"""The comparison that decides ``correct``.

For every call of the snapshot, one observed output is held against the
plain reference computed from the benchmark's own input.  What is observed of
a call is its stream, a digest of its reconstruction (``reference.bits.
digest``: exact weighted sums of each run of 2^16 values' bits), and the
numbers of the guarantees the configuration states; :func:`observe` takes the
last two from the reconstruction on the device, so no second full set of
outputs has to stay alive through the window.

* ``stream_mismatch``: elements of the stream (every key the reference
  emits) whose bits differ from the reference's; limit 0, the stream is the
  contract;
* ``recon_chunk_mismatch``: runs of 2^16 reconstructed values whose digest
  differs from that of the reference's decode of its own stream; limit 0;
* ``calls_unchecked``: calls with no observed output; limit 0;
* the guarantees the configuration states (``reference.LIMITS``, such as
  ``max_err_over_eb`` <= 1 for SZ ABS), the worst call's value.

The reference runs one call at a time, after the program's state is freed,
so it fits beside the kept outputs.  Where a reference states
``CHECK_VALUES``, a run judges calls drawn from the seed until they hold that
many values (one at least), so the check stays shorter than the window;
otherwise every call."""

from __future__ import annotations

import math
import random

import torch

from portbench import reference as references
from portbench.reference.bits import digest, mismatches


def judged_calls(snap, ref, seed: int) -> list[int]:
    """The calls a run judges: all of them, or where the reference states
    ``CHECK_VALUES``, calls drawn from the seed while they hold no more."""
    order = list(range(len(snap.calls)))
    budget = getattr(ref, "CHECK_VALUES", None)
    if budget is None:
        return order
    random.Random(f"portbench-check-{seed}").shuffle(order)
    out, values = [], 0
    for j in order:
        values += snap.calls[j].x.numel()
        if out and values > budget:
            break
        out.append(j)
    return sorted(out)


def observe(ref, call, recon: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """What the check keeps of a reconstruction: its digest and the
    guarantees' numbers, computed on its device without waiting."""
    return digest(recon), ref.guarantees(call.x, recon, call.kwargs)


def _number(t) -> float:
    v = float(t)
    return v if math.isfinite(v) else math.inf


def judge(snap, observed: dict[int, tuple], ref,
          calls: list[int] | None = None) -> tuple[dict[str, tuple[float, float]], int]:
    """``observed[j] = (stream dict or None, digest or None, guarantees)``
    for call ``j`` of ``snap``, judged for each of ``calls`` (default all).
    Returns ``({name: (value, limit)}, failed calls)``."""
    stream_mm = recon_mm = unchecked = failed = 0
    worst = {k: -math.inf for k in ref.LIMITS}
    for j in range(len(snap.calls)) if calls is None else calls:
        call = snap.calls[j]
        if j not in observed:
            unchecked += 1
            failed += 1
            continue
        stream, got_digest, got = observed[j]
        want = ref.compress(call.x, call.kwargs)
        s_mm = sum(mismatches(v, stream[k]) if stream is not None and k in stream else v.numel()
                   for k, v in want.items())
        want_digest = digest(ref.decompress(want, tuple(call.x.shape), call.kwargs))
        if got_digest is None or got_digest.shape != want_digest.shape:
            r_mm = want_digest.shape[0]
        else:
            r_mm = int((got_digest.to(want_digest.device) != want_digest).any(dim=1).sum())
        bad = s_mm or r_mm
        for k, lim in ref.LIMITS.items():
            v = _number(got[k]) if k in got else math.inf
            worst[k] = max(worst[k], v)
            bad = bad or not v <= lim
        stream_mm += s_mm
        recon_mm += r_mm
        failed += bool(bad)
        del want, want_digest
    checks = {"stream_mismatch": (stream_mm, 0), "recon_chunk_mismatch": (recon_mm, 0),
              "calls_unchecked": (unchecked, 0)}
    checks.update({k: (worst[k] if worst[k] > -math.inf else math.inf, lim)
                   for k, lim in ref.LIMITS.items()})
    return checks, failed


def judge_program(snap, kept: dict[int, tuple],
                  calls: list[int] | None = None) -> tuple[dict[str, tuple[float, float]], int]:
    """Judge the program's kept ``(result, digest, guarantees)`` per call,
    for each of ``calls`` (default all)."""
    ref = references.load(snap.reference)
    observed = {}
    for j, (result, got_digest, got) in kept.items():
        try:
            stream = ref.program_stream(result)
        except (AttributeError, KeyError, TypeError, IndexError):
            stream = None  # a result the reference cannot read is a wrong answer
        observed[j] = (stream, got_digest, got)
    with torch.no_grad():
        return judge(snap, observed, ref, calls)
