"""Foresight — the paper's benchmark/analysis framework: CBench (sweeps),
PAT (workflows, SLURM or local), Cinema (artifact DB), guideline (§V-D).
The port of ``repro.foresight``."""

from repro_torch.foresight import cbench, cinema, guideline, pat

__all__ = ["cbench", "cinema", "guideline", "pat"]
