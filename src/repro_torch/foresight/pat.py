"""PAT — Foresight's workflow component (paper §IV-A2): a lightweight Job /
Workflow pair that tracks dependencies, writes SLURM submission scripts
(the deployable path), and ships a local topological executor so the same
workflow runs in-container (the test/CI path).

A copy of the JAX package's ``repro.foresight.pat`` (no jax): the port
imports nothing of ``repro``.  A job's SLURM line names ``fn.__module__``,
so the port's scripts name ``repro_torch`` modules, and the submission
script names this module.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Optional


@dataclasses.dataclass
class Job:
    """One schedulable unit. Exactly the paper's Job class surface: SLURM
    requirements + dependencies; `fn` is the in-process equivalent of the
    command line (used by the local executor)."""

    name: str
    fn: Optional[Callable[..., Any]] = None
    command: Optional[str] = None
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    depends_on: list[str] = dataclasses.field(default_factory=list)
    nodes: int = 1
    time_limit: str = "01:00:00"
    partition: str = "standard"

    def sbatch_script(self, workdir: str = ".") -> str:
        dep = ""
        if self.depends_on:
            dep = "#SBATCH --dependency=afterok:{deps}\n".format(
                deps=":".join("${JOB_%s}" % d.upper().replace("-", "_")
                              for d in self.depends_on))
        cmd = self.command or f"python -m {self.fn.__module__} # {self.fn.__name__}"
        return (
            "#!/bin/bash\n"
            f"#SBATCH --job-name={self.name}\n"
            f"#SBATCH --nodes={self.nodes}\n"
            f"#SBATCH --time={self.time_limit}\n"
            f"#SBATCH --partition={self.partition}\n"
            f"{dep}"
            f"cd {workdir}\n"
            f"{cmd}\n"
        )


class Workflow:
    """Tracks job dependencies; emits a single SLURM submission script or
    executes locally in topological order (paper: 'The Workflow class tracks
    the dependencies between jobs and writes the submission script')."""

    def __init__(self, name: str):
        self.name = name
        self.jobs: dict[str, Job] = {}
        self.results: dict[str, Any] = {}

    def add(self, job: Job) -> Job:
        if job.name in self.jobs:
            raise ValueError(f"duplicate job {job.name}")
        for d in job.depends_on:
            if d not in self.jobs:
                raise ValueError(f"{job.name} depends on unknown job {d}")
        self.jobs[job.name] = job
        return job

    def _topo_order(self) -> list[str]:
        order: list[str] = []
        seen: set[str] = set()
        temp: set[str] = set()

        def visit(n: str):
            if n in seen:
                return
            if n in temp:
                raise ValueError(f"dependency cycle through {n}")
            temp.add(n)
            for d in self.jobs[n].depends_on:
                visit(d)
            temp.discard(n)
            seen.add(n)
            order.append(n)

        for n in self.jobs:
            visit(n)
        return order

    # ------------------------------------------------------------ SLURM --
    def write_submission_script(self, path: str | Path, workdir: str = ".") -> Path:
        path = Path(path)
        lines = ["#!/bin/bash", f"# workflow: {self.name} (generated by repro_torch.foresight.pat)"]
        scripts_dir = path.parent / f"{self.name}_jobs"
        scripts_dir.mkdir(parents=True, exist_ok=True)
        for n in self._topo_order():
            job = self.jobs[n]
            s = scripts_dir / f"{n}.sbatch"
            s.write_text(job.sbatch_script(workdir))
            var = "JOB_" + n.upper().replace("-", "_")
            lines.append(f'{var}=$(sbatch --parsable "{s}")')
            lines.append(f'echo "submitted {n} -> ${{{var}}}"')
        path.write_text("\n".join(lines) + "\n")
        path.chmod(0o755)
        return path

    # ------------------------------------------------------------ local --
    def run_local(self) -> dict[str, Any]:
        """Execute jobs in dependency order in-process. A job's fn receives
        the results of its dependencies as keyword args (by job name)."""
        for n in self._topo_order():
            job = self.jobs[n]
            if job.fn is None:
                raise ValueError(f"job {n} has no callable for local execution")
            dep_results = {d.replace("-", "_"): self.results[d] for d in job.depends_on}
            t0 = time.time()
            self.results[n] = job.fn(*job.args, **job.kwargs, **dep_results)
        return self.results
