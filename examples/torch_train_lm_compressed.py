"""End-to-end training driver on the PyTorch/CUDA port: train a small LM
with the paper's compression at a system seam —

  * lossy checkpoints (TPU-SZ, PW_REL bound),
  * (on meshes with a ``pod`` axis) the int8 + error-feedback cross-pod
    gradient hop of ``train/step.py``,

with fault-tolerant resume: rerun the script and it continues exactly from
the checkpoint chain.

    PYTHONPATH=src python examples/torch_train_lm_compressed.py --steps 60               # card
    PYTHONPATH=src python examples/torch_train_lm_compressed.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm_compressed.py --scale 100m --steps 300  # ~100M
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager, CodecPolicy
from repro_torch.configs import registry
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.spec import param_count
from repro_torch.train import loop as loop_lib
from repro_torch.train import step as step_lib

SCALES = {
    # ~10M: fits a CPU-core demo;  ~100M: the reference size
    "10m": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, d_ff=1024, vocab=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32768),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", choices=list(SCALES), default="10m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = registry.get_config("minicpm-2b").scaled(**SCALES[args.scale], max_seq=args.seq)
    model = registry.build_model(cfg, device=device)
    n_params = param_count(model.specs())
    print(f"arch=minicpm-family scale={args.scale}: {n_params/1e6:.1f}M params on {device}, "
          f"WSD schedule (the arch's documented trait)")

    scfg = step_lib.TrainStepConfig(peak_lr=3e-4, warmup_steps=20, total_steps=args.steps,
                                    schedule="wsd")
    state = step_lib.init_state(model, None, torch.Generator(device=device).manual_seed(0),
                                step_cfg=scfg)
    train_step = step_lib.build_train_step(model, None, step_cfg=scfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=0))

    policy = CodecPolicy(mode="sz_pwrel", eb=1e-4, min_bytes=1 << 18)
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2, policy=policy, device=device)

    t0 = time.time()
    state, res = loop_lib.run(
        train_step, state, pipe, ckpt,
        loop_lib.LoopConfig(total_steps=args.steps, ckpt_every=20, log_every=10))
    dt = time.time() - t0
    steps = len(res.losses)
    print(f"\ntrained to step {res.final_step} ({steps} steps this run) in {dt:.1f}s "
          f"({args.batch * args.seq * steps / dt:.0f} tok/s)")
    if res.losses:
        print(f"loss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    saved = ckpt.wait()
    if saved:
        print(f"checkpoint: {saved.path.name}, lossy ratio {saved.ratio:.2f}x "
              f"({saved.nbytes_raw/1e6:.1f} MB -> {saved.nbytes_stored/1e6:.1f} MB)")
    print("re-run this script to watch it resume from the checkpoint chain.")


if __name__ == "__main__":
    main()
