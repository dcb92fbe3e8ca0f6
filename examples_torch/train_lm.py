"""End-to-end training on the port: a phi4-family model trained for a few
hundred steps on the synthetic pipeline, with checkpointing and
straggler monitoring.

The port's counterpart of examples/train_lm.py.  It drives
repro_torch.launch.train (the einsum path under autograd; no kernel has
a backward) and checkpoints to repro_torch_train_lm under the temporary
directory ($TMPDIR, else /tmp), not the reference's /tmp/repro_train_lm:
the two checkpoint formats must not meet on a resume.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 200]
          [--device cpu]

(d_model 512, 8 layers on the phi4 block; use --steps 50 for a quick
pass.)
"""
import argparse
import os
import tempfile

from repro_torch.device import resolve
from repro_torch.launch import train

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def run(device="cuda", *, steps=200, d_model=512, n_layers=8, batch=8,
        seq=512, lr=1e-3, ckpt_dir=CKPT_DIR, ckpt_every=100,
        log_every=10, resume=False) -> list[float]:
    """Train through the launcher; returns its losses, one a step.  With
    `resume`, it starts from the newest checkpoint in `ckpt_dir`."""
    resolve(device)
    return train.main([
        "--arch", "phi4-mini-3.8b", "--smoke",
        "--d-model", str(d_model), "--n-layers", str(n_layers),
        "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
        "--lr", str(lr), "--ckpt-dir", str(ckpt_dir),
        "--ckpt-every", str(ckpt_every), "--log-every", str(log_every),
        "--device", str(device),
    ] + (["--resume"] if resume else []))


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device, steps=args.steps)


if __name__ == "__main__":
    main()
