"""Batched serving on the port: prefill + decode with KV caches on the
RecurrentGemma hybrid (constant-memory recurrent state + windowed
attention), plus a dense model for contrast.

The port's counterpart of examples/serve_batch.py.  On the card the
prefill runs the attention kernel and, in recurrentgemma's recurrent
layers, the RG-LRU scan kernel.

Run:  PYTHONPATH=src python examples_torch/serve_batch.py [--device cpu]
"""
import argparse

from repro_torch.device import resolve
from repro_torch.launch import serve


def run(device="cuda", *, archs=("recurrentgemma-2b", "gemma2-27b"),
        batch=2, prompt_len=48, gen=12) -> dict:
    """Serve each arch's smoke config through the serve CLI; returns each
    arch's generated tokens (batch, gen)."""
    resolve(device)
    out = {}
    for arch in archs:
        print(f"\n=== {arch} (smoke config) ===")
        out[arch] = serve.main(["--arch", arch, "--smoke", "--batch",
                                str(batch), "--prompt-len", str(prompt_len),
                                "--gen", str(gen), "--device", str(device)])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
