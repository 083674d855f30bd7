"""Device policy: the port runs on CUDA unless the CPU is asked for.

There is no quiet fallback.  An entry point called without a device on a
machine with no CUDA device raises; only an explicit ``device="cpu"`` runs
the plain PyTorch versions on the CPU (as the tests do).

``device="meta"`` is the abstract device of the cost sweep
(:mod:`repro_torch.launch.dryrun`): tensors carry shapes and dtypes and no
data, so a model builds and a step traces at any size on any machine.  It is
never a default, and a meta tensor that reaches a hand-written kernel's
wrapper raises, as a CUDA tensor whose library cannot load does.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA; ``"cpu"`` the plain versions on the CPU;
    ``"meta"`` shapes without data.

    Raises ``RuntimeError`` when CUDA is wanted and absent, and ``ValueError``
    for any other device type."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless device='cpu' is passed, "
                "and torch.cuda.is_available() is False")
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; want cuda, cpu or meta")
    return dev
