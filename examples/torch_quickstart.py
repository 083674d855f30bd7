"""Quickstart of the PyTorch/CUDA port: compress a synthetic Nyx field with
TPU-SZ and TPU-ZFP, check the paper's domain gate (power-spectrum ratio
within 1%), and print the §V-D style summary.

    PYTHONPATH=src python examples/torch_quickstart.py                 # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # plain versions
"""

import argparse

import torch

from repro_torch.analysis import metrics, spectrum
from repro_torch.core.api import get_compressor
from repro_torch.data import cosmo


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    ap.add_argument("--n", type=int, default=64, help="Nyx grid side")
    args = ap.parse_args(argv)

    print(f"generating {args.n}^3 synthetic Nyx baryon-density field...")
    field = cosmo.nyx_fields(n=args.n)["baryon_density"]
    out = {}
    for name, cfg in (("tpu-sz", {"eb": 10.0}), ("tpu-zfp", {"rate": 8})):
        comp = get_compressor(name, device=args.device)
        x = torch.as_tensor(field, device=comp.device)
        r = comp.compress(x, **cfg)
        recon = comp.decompress(r).cpu().numpy()
        d = metrics.distortion(field, recon)
        ok, dev = spectrum.pk_gate(field, recon)
        out[name] = (r.ratio, d, ok, dev)
        print(f"\n== {name} {cfg} on {comp.device}")
        print(f"   compression ratio : {r.ratio:6.2f}x  ({r.nbytes/1e6:.2f} MB from {r.raw_nbytes/1e6:.2f} MB)")
        print(f"   PSNR              : {d.psnr:6.2f} dB   max|err|: {d.max_abs_err:.3g}")
        print(f"   pk-ratio gate     : {'PASS' if ok else 'FAIL'} (worst dev {dev*100:.2f}%, tol 1%)")

    print("\nthe paper's guideline: among gate-passing configs, deploy the")
    print("highest-ratio one — see examples/torch_foresight_workflow.py and")
    print("repro_torch.foresight.guideline.best_fit_per_field.")
    return out


if __name__ == "__main__":
    main()
