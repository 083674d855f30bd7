"""The paper's full Foresight pipeline on the PyTorch/CUDA port, as a PAT
workflow: CBench sweep -> power-spectrum analyses -> Cinema database, run
locally (the same Workflow object emits a SLURM submission script for
cluster deployment; both land in the output directory).

    PYTHONPATH=src python examples/torch_foresight_workflow.py                  # on the card
    PYTHONPATH=src python examples/torch_foresight_workflow.py --device cpu \\
        --out /tmp/foresight_demo --n 32
"""

import argparse
from pathlib import Path

from repro_torch.analysis import spectrum
from repro_torch.data import cosmo
from repro_torch.foresight import cbench, cinema, pat

DEFAULT_OUT = Path("experiments/foresight_demo_torch")


def job_generate(n):
    return cosmo.nyx_fields(n=n)


def job_cbench(generate, device):
    spec = {"cases": [
        {"compressor": "tpu-sz", "fields": ["baryon_density"],
         "configs": [{"eb": 100.0}, {"eb": 10.0}, {"eb": 3.0}]},
        {"compressor": "tpu-sz", "fields": ["vx"],
         "configs": [{"eb": 2e6}, {"eb": 5e5}]},
        {"compressor": "tpu-zfp", "fields": ["baryon_density", "vx"],
         "configs": [{"rate": 4}, {"rate": 8}]},
    ]}
    return cbench.run_sweep(spec, generate, keep_reconstruction=True, device=device)


def job_spectra(generate, cbench_sweep):
    out = []
    for r in cbench_sweep:
        k, ratio = spectrum.pk_ratio(generate[r.field], r.reconstructed)
        ok, dev = spectrum.pk_gate(generate[r.field], r.reconstructed)
        out.append((r, k, ratio, ok, dev))
    return out


def job_cinema(spectra, out_dir):
    db = cinema.CinemaDatabase(Path(out_dir) / "cinema_db", name="nyx-demo")
    for r, k, ratio, ok, dev in spectra:
        db.add_case({"compressor": r.compressor, "field": r.field,
                     "config": str(r.config), "cr": round(r.ratio, 2),
                     "psnr_db": round(r.psnr, 2), "pk_gate": ok,
                     "worst_pk_dev": round(dev, 4)},
                    curves={"pk_ratio": (k, ratio)})
    return db.write()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT, help="output directory")
    ap.add_argument("--n", type=int, default=48, help="Nyx grid side")
    args = ap.parse_args(argv)

    wf = pat.Workflow("foresight-demo")
    wf.add(pat.Job("generate", fn=job_generate, kwargs={"n": args.n}))
    wf.add(pat.Job("cbench-sweep", fn=job_cbench, kwargs={"device": args.device},
                   depends_on=["generate"]))
    wf.add(pat.Job("spectra", fn=job_spectra, depends_on=["generate", "cbench-sweep"]))
    wf.add(pat.Job("cinema", fn=job_cinema, kwargs={"out_dir": args.out},
                   depends_on=["spectra"]))

    args.out.mkdir(parents=True, exist_ok=True)
    slurm = wf.write_submission_script(args.out / "submit_all.sh", workdir=".")
    print(f"SLURM submission script written to {slurm} (deployable path)")

    results = wf.run_local()
    print(f"Cinema database written to {results['cinema']}")
    print(f"\npk gate summary (tol 1%, device {args.device}):")
    for r, _, _, ok, dev in results["spectra"]:
        print(f"  {r.compressor:8s} {r.field:16s} {str(r.config):14s} "
              f"CR={r.ratio:6.2f}x  gate={'PASS' if ok else 'fail'} (dev {dev*100:.2f}%)")
    return results


if __name__ == "__main__":
    main()
