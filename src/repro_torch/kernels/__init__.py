"""Hand-written Hopper kernels for the TPU kernels of ``repro.kernels``.

Each kernel module keeps a ``launches`` dict counting its CUDA launches (and
nothing else: the plain versions on the CPU do not count).  Sources live in
``csrc/`` and are built by :mod:`repro_torch.kernels._build` at first use.
"""

from __future__ import annotations

from repro_torch.kernels import kvc_attention, lorenzo3d, sz_fused, zfp3d, zfp_fused

_COUNTERS = (lorenzo3d.launches, sz_fused.launches, zfp3d.launches, zfp_fused.launches,
             kvc_attention.launches)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by kernel."""
    out: dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
